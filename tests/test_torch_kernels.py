"""The port's kernels (acg_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them.

On the CPU every wrapper takes its kernel's plain PyTorch version, so
these tests pin the arithmetic the CUDA kernels reproduce (the CUDA
kernels are built with --fmad=false and are held bitwise against the
plain versions on the card by chip_smoke.py and by
tests/test_torch_card.py).

Tolerances: XLA:CPU contracts ``y + p * x`` into a fused multiply-add,
while PyTorch's separate ops -- and the CUDA kernels, built with
--fmad=false -- round the product first.  Where a product is inexact the
two differ by an ulp or so per term, so random-plane cases use the JAX
tests' own Pallas-vs-XLA tolerance (rtol = atol = 1e-5); where every
product is exact (stencil planes of -1/4, the phase-kernel shapes of
test_fused_cg.py) vector outputs are bitwise-equal.  Dots are summed in
another order than the Pallas kernels' SMEM accumulation, so they are
compared with an f64 value at the JAX tests' ``rel``.  For bf16 vectors
the JAX phase kernels cast beta/alpha to bf16 and round every
operation, where the port rounds once on store: those cases are held to
bf16 rounding instead.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.io.generators import poisson_dia as jax_poisson_dia
from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.ops.spmv import dia_mv as jax_dia_mv
from acg_tpu_torch.io.generators import poisson_dia
from acg_tpu_torch.ops import kernels as K

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

TILE = pk.TILE


def _t(a, dtype=torch.float32):
    # a copy: in-place wrappers must not write into numpy buffers that a
    # still-running asynchronous JAX computation may read
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(dtype)


def _np(t):
    return t.to(torch.float64).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


# the shapes of tests/test_pallas_kernels.py::test_dia_spmv_matches_xla
@pytest.mark.parametrize("n,offsets", [
    (1000, (-32, -1, 0, 1, 32)),          # ragged: padded route on the TPU
    (20000, (-141, -1, 0, 1, 141)),
    (500, (0,)),
    (700, (-3, 2)),                        # asymmetric offsets
    (2 * TILE, (-128, -1, 0, 1, 128)),     # fast route, 2 tiles
    (TILE, (-64, 0, 64)),                  # fast route, single tile
    (4 * TILE, (-TILE, -1, 0, 1, TILE)),   # fast route, band == tile
])
def test_dia_spmv_plain_matches_pallas(n, offsets):
    rng = np.random.default_rng(0)
    planes = rng.standard_normal((len(offsets), n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    want = pk.dia_spmv(tuple(jnp.asarray(p) for p in planes), offsets,
                       jnp.asarray(x), interpret=True)
    got = K.dia_spmv(torch.from_numpy(planes), offsets, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert K.launches["dia_spmv"] == 0  # CPU tensors: plain, not counted


# the non-clustered shapes of test_pallas_kernels.py::test_dia_spmv_dot_fused
@pytest.mark.parametrize("n,offsets", [(3 * TILE, (-3, -1, 0, 1, 3)),
                                       (1000, (-3, 0, 3))])
def test_dia_spmv_dot_plain_matches_pallas(n, offsets):
    rng = np.random.default_rng(1)
    planes = rng.random((len(offsets), n)).astype(np.float32)
    x = rng.random(n).astype(np.float32)
    yj, _ = pk.dia_spmv_dot(tuple(jnp.asarray(p) for p in planes), offsets,
                            jnp.asarray(x), interpret=True)
    y, d = K.dia_spmv(torch.from_numpy(planes), offsets,
                      torch.from_numpy(x), with_dot=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=2e-6)
    dref = float(x.astype(np.float64) @ np.asarray(yj, np.float64))
    assert d.dtype == torch.float32
    assert float(d) == pytest.approx(dref, rel=3e-4)


@pytest.mark.parametrize("pdt,xdt", [(torch.float64, torch.float64),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
def test_dia_spmv_plain_dtypes_match_dia_mv(pdt, xdt):
    """The other kernel instantiations (f64; bf16 planes with bf16 or
    f32 x, accumulating in f32) against the JAX dia_mv formulation."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32,
           torch.bfloat16: jnp.bfloat16}
    planes, offsets, N = poisson_dia(24, 2)
    x = np.random.default_rng(2).standard_normal(N)
    want = jax_dia_mv(tuple(jnp.asarray(p, jdt[pdt]) for p in planes),
                      offsets, N, jnp.asarray(x, jdt[xdt]))
    got = K.dia_spmv(_t(np.stack(planes), pdt), offsets, _t(x, xdt))
    assert got.dtype == xdt
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float64))


def _fused_dia(n=128, dtype=np.float32):
    planes, offsets, N = jax_poisson_dia(n, 2, dtype=np.float64)
    return np.stack(planes).astype(dtype), offsets, N


def test_cg_phase_a_plain_matches_pallas():
    """test_fused_cg.py::test_phase_a_matches_reference's shapes."""
    planes, offsets, N = _fused_dia()
    rng = np.random.default_rng(0)
    r = rng.standard_normal(N).astype(np.float32)
    p_old = rng.standard_normal(N).astype(np.float32)
    pj, tj, dj = pk.cg_phase_a(tuple(jnp.asarray(p) for p in planes),
                               offsets, jnp.asarray(r), jnp.asarray(p_old),
                               jnp.float32(2.0), jnp.float32(4.0),
                               interpret=True)
    p, t, d = K.cg_phase_a(torch.from_numpy(planes), offsets,
                           torch.from_numpy(r), torch.from_numpy(p_old),
                           torch.tensor(2.0), torch.tensor(4.0))
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    dref = float(np.asarray(pj, np.float64) @ np.asarray(tj, np.float64))
    assert float(d) == pytest.approx(dref, rel=1e-6)
    assert float(dj) == pytest.approx(dref, rel=1e-6)


def test_cg_phase_a_first_iteration_beta_zero_and_frozen():
    """gamma_prev = inf gives beta = 0 exactly (p = r, junk p_old must
    not leak); a false live flag takes p = p_old (the frozen state)."""
    planes, offsets, N = _fused_dia()
    r = torch.from_numpy(
        np.random.default_rng(1).standard_normal(N).astype(np.float32))
    junk = torch.full((N,), 1e30)
    p, _, _ = K.cg_phase_a(torch.from_numpy(planes), offsets, r, junk,
                           torch.tensor(3.0), torch.tensor(np.inf))
    assert torch.equal(p, r)
    p2, t2, _ = K.cg_phase_a(torch.from_numpy(planes), offsets, r, p,
                             torch.tensor(3.0), torch.tensor(1.0),
                             live=torch.tensor(False))
    assert torch.equal(p2, p)
    assert torch.equal(t2, K.dia_spmv(torch.from_numpy(planes), offsets, p))


def test_cg_phase_b_plain_matches_pallas():
    N = TILE
    rng = np.random.default_rng(2)
    x, p, r, t = (rng.standard_normal(N).astype(np.float32)
                  for _ in range(4))
    xj, rj, gj = pk.cg_phase_b(*(jnp.asarray(v) for v in (x, p, r, t)),
                               jnp.float32(3.0), jnp.float32(1.5),
                               interpret=True)
    xt, rt = torch.from_numpy(x.copy()), torch.from_numpy(r.copy())
    xo, ro, g = K.cg_phase_b(xt, torch.from_numpy(p), rt,
                             torch.from_numpy(t), torch.tensor(3.0),
                             torch.tensor(1.5))
    assert xo is xt and ro is rt  # updated in place
    np.testing.assert_array_equal(xo.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(ro.numpy(), np.asarray(rj))
    rref = np.asarray(rj, np.float64)
    assert float(g) == pytest.approx(float(rref @ rref), rel=1e-6)
    # frozen: x and r untouched, gamma' recomputed from the same r
    xs, rs = xo.clone(), ro.clone()
    _, _, g2 = K.cg_phase_b(xo, torch.from_numpy(p), ro,
                            torch.from_numpy(t), torch.tensor(3.0),
                            torch.tensor(1.5), live=torch.tensor(False))
    assert torch.equal(xo, xs) and torch.equal(ro, rs)
    assert torch.equal(g2, g)


def test_fused_phases_bf16_within_rounding_of_pallas():
    """bf16 vectors: the port computes in f32 and rounds once on store,
    the Pallas kernels round beta/alpha and every operation to bf16 --
    the two stay within bf16 rounding of each other."""
    planes, offsets, N = _fused_dia(dtype=np.float64)
    rng = np.random.default_rng(3)
    r, p_old, x = (rng.standard_normal(N) for _ in range(3))
    jb = jnp.bfloat16
    pj, tj, _ = pk.cg_phase_a(tuple(jnp.asarray(p, jb) for p in planes),
                              offsets, jnp.asarray(r, jb),
                              jnp.asarray(p_old, jb), jnp.float32(2.0),
                              jnp.float32(4.0), interpret=True)
    bf = torch.bfloat16
    p, t, _ = K.cg_phase_a(_t(planes, bf), offsets, _t(r, bf),
                           _t(p_old, bf), torch.tensor(2.0),
                           torch.tensor(4.0))
    scale = np.abs(np.asarray(pj, np.float64)).max()
    np.testing.assert_allclose(_np(p), np.asarray(pj, np.float64),
                               atol=2 ** -7 * scale)
    tscale = np.abs(np.asarray(tj, np.float64)).max()
    np.testing.assert_allclose(_np(t), np.asarray(tj, np.float64),
                               atol=2 ** -6 * tscale)
    xj, rj, _ = pk.cg_phase_b(jnp.asarray(x, jb), pj, jnp.asarray(r, jb),
                              tj, jnp.float32(3.0), jnp.float32(1.5),
                              interpret=True)
    xo, ro, _ = K.cg_phase_b(_t(x, bf), p, _t(r, bf), t, torch.tensor(3.0),
                             torch.tensor(1.5))
    for got, want in ((xo, xj), (ro, rj)):
        w = np.asarray(want, np.float64)
        np.testing.assert_allclose(_np(got), w,
                                   atol=2 ** -5 * np.abs(w).max())


def test_pipelined_update_plain_matches_pallas_f32():
    """f32: the loop-body form agrees with the Pallas kernel (alpha/beta
    already f32; XLA:CPU's fused multiply-adds differ by an ulp)."""
    rng = np.random.default_rng(1)
    n = 20000
    vecs = [rng.standard_normal(n).astype(np.float32) for _ in range(7)]
    a, b = np.float32(0.37), np.float32(0.81)
    want = pk.fused_pipelined_update(*(jnp.asarray(v) for v in vecs),
                                     jnp.float32(a), jnp.float32(b),
                                     interpret=True)
    tv = [torch.from_numpy(v.copy()) for v in vecs]
    got = K.pipelined_update(*tv, torch.tensor(a), torch.tensor(b))
    assert all(g is v for g, v in zip(got, tv))  # in place
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["bf16", "f64"])
def test_pipelined_update_plain_matches_jax_loop_body(dtype):
    """The bf16 (and f64) update is held against the JAX pipelined loop
    body (solvers/jax_cg.py:963-973): f32/f64 scalars, each vector
    rounded once on store -- not against the standalone JAX kernel,
    which casts alpha/beta to bf16."""
    jdt, tdt, sdt = {"bf16": (jnp.bfloat16, torch.bfloat16, jnp.float32),
                     "f64": (jnp.float64, torch.float64, jnp.float64)}[dtype]
    rng = np.random.default_rng(4)
    n = 5000
    x, r, w, p, t, z, q = (rng.standard_normal(n) for _ in range(7))
    alpha = jnp.asarray(0.37, sdt)
    beta = jnp.asarray(0.81, sdt)
    J = [jnp.asarray(v, jdt) for v in (x, r, w, p, t, z, q)]
    jx, jr, jw, jp, jt, jz, jq = J

    def store(v):
        return v.astype(jdt)

    jz = store(jq + beta * jz)
    jt = store(jw + beta * jt)
    jp = store(jr + beta * jp)
    jx = store(jx + alpha * jp)
    jr = store(jr - alpha * jt)
    jw = store(jw - alpha * jz)
    T = [_t(v, tdt) for v in (x, r, w, p, t, z, q)]
    tsd = torch.float32 if dtype == "bf16" else torch.float64
    got = K.pipelined_update(*T, torch.tensor(0.37, dtype=tsd),
                             torch.tensor(0.81, dtype=tsd))
    for g, want in zip(got, (jx, jr, jw, jp, jt, jz)):
        np.testing.assert_array_equal(_np(g), np.asarray(want, np.float64))


def test_pipelined_update_frozen_leaves_vectors():
    rng = np.random.default_rng(5)
    T = [torch.from_numpy(rng.standard_normal(100)) for _ in range(7)]
    before = [v.clone() for v in T[:6]]
    K.pipelined_update(*T, torch.tensor(0.5, dtype=torch.float64),
                       torch.tensor(0.25, dtype=torch.float64),
                       live=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(T[:6], before))


def test_fused_route_refusals_match_jax():
    """The copied route predicates agree with the JAX package's."""
    for offsets, n, dt in [((-128, -1, 0, 1, 128), 16384, np.float32),
                           ((-90, -1, 0, 1, 90), 8100, np.float32),
                           ((-128, -1, 0, 1, 128), 16384, np.float64),
                           ((-512, -1, 0, 1, 512), 262144, np.float32),
                           ((-2048, -1, 0, 1, 2048), 2048 ** 2, np.float32),
                           ((-2048, -1, 0, 1, 2048), 2048 ** 2, "bf16")]:
        jdt = jnp.bfloat16 if dt == "bf16" else dt
        tdt = {np.float32: torch.float32, np.float64: torch.float64,
               "bf16": torch.bfloat16}[dt]
        assert K.fused_cg_route(offsets, n, tdt) == \
            pk.fused_cg_route(offsets, n, jdt)
        assert K.dia_spmv_route(offsets, n, tdt) == \
            pk.dia_spmv_route(offsets, n, jdt)


_FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
%s
"""


@pytest.mark.parametrize("ok", [True, False])
def test_kernel_build_compiles_each_source_or_raises(tmp_path, monkeypatch,
                                                    ok):
    """The build runs one nvcc per source and links their objects into
    one library under a source-hash directory; a failing compiler raises
    with its output and leaves no library behind (no fallback).  Driven
    by a stand-in nvcc: the real one exists only on the card machine."""
    from acg_tpu_torch.ops import _build

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC % ('echo "ptxas info: Used 32 registers"; '
                                  'touch "$out"' if ok
                                  else 'echo "error: no such type"; exit 1'))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    lib = _build.library_path()
    assert lib.parent.name == _build.source_hash()
    if ok:
        assert _build.build() == lib and lib.exists()
        log = (lib.parent / "build.log").read_text()
        srcs = sorted(p.name for p in _build.CSRC.glob("*.cu"))
        assert srcs == ["cg_fused.cu", "dia_spmv.cu", "halo_put.cu",
                        "pipelined_update.cu", "stencil_spmv.cu"]
        assert all(f"-c {_build.CSRC / s}" in log for s in srcs)
        assert "sm_90a" in log and "--fmad=false" in log
    else:
        with pytest.raises(RuntimeError, match="no such type"):
            _build.build()
        assert not lib.exists()
        assert not any((tmp_path / "build").glob("build-*"))
