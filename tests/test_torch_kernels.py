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


@pytest.mark.parametrize("case", ["3d-7pt", "odd-n", "offsets>=0",
                                  "offsets<=0"])
def test_cg_phase_a_plain_edge_shapes_match_jax(case):
    """K3's edge shapes on the CPU: the 3D 7-point planes (n = 32, two
    tiles) against the Pallas kernel in interpret mode; odd n and
    one-sided offsets, which the Pallas kernel refuses (no fast route),
    against the JAX formulation it computes (p = r + beta p_old, t =
    dia_mv(planes, p)), as tests/test_fused_cg.py holds the kernel.
    Stencil planes: every product exact, so p and t are bitwise-equal;
    random planes: within the JAX tests' 1e-5 (XLA:CPU contracts into
    fused multiply-adds)."""
    rng = np.random.default_rng(11)
    if case == "3d-7pt":
        planes, offsets, N = jax_poisson_dia(32, 3, dtype=np.float64)
        planes = np.stack(planes).astype(np.float32)
    elif case == "odd-n":
        planes, offsets, N = jax_poisson_dia(63, 2, dtype=np.float64)
        planes = np.stack(planes).astype(np.float32)
    else:
        offsets = (0, 1, 2, 300, 1024) if case == "offsets>=0" \
            else (-1024, -300, -2, -1, 0)
        N = 4001
        planes = rng.standard_normal((len(offsets), N)).astype(np.float32)
    r = rng.standard_normal(N).astype(np.float32)
    p_old = rng.standard_normal(N).astype(np.float32)
    p, t, d = K.cg_phase_a(torch.from_numpy(planes), offsets,
                           torch.from_numpy(r), torch.from_numpy(p_old),
                           torch.tensor(2.0), torch.tensor(4.0))
    if case == "3d-7pt":
        pj, tj, _ = pk.cg_phase_a(tuple(jnp.asarray(q) for q in planes),
                                  offsets, jnp.asarray(r),
                                  jnp.asarray(p_old), jnp.float32(2.0),
                                  jnp.float32(4.0), interpret=True)
    else:
        assert pk.fused_cg_route(offsets, N, jnp.float32) is None
        pj = jnp.asarray(r) + jnp.float32(0.5) * jnp.asarray(p_old)
        tj = jax_dia_mv(tuple(jnp.asarray(q) for q in planes), offsets, N,
                        pj)
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    if case == "odd-n":
        np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-5,
                                   atol=1e-5)
    dref = float(np.asarray(pj, np.float64) @ np.asarray(tj, np.float64))
    scale = float(np.abs(np.asarray(pj, np.float64)
                         * np.asarray(tj, np.float64)).sum())
    assert abs(float(d) - dref) <= 1e-5 * scale


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


_PHASE_B_DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
                   "bf16": (np.float64, jnp.bfloat16, torch.bfloat16)}


def _phase_b_case(dtype, n, seed):
    """x, p, r, t as (numpy, torch) pairs of one dtype, the numpy arrays
    in the dtype JAX takes them from."""
    ndt, _, tdt = _PHASE_B_DTYPES[dtype]
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal(n).astype(ndt) for _ in range(4)]
    return vecs, [_t(v, tdt) for v in vecs]


def _check_phase_b(dtype, live, vecs, tv, gamma, pdott, want):
    """The port's K4 (its plain version here) on ``tv`` against ``want``
    = (x, r, gamma') of the JAX reference.  The reference has no live
    flag: absent or true, x and r are held to it (bitwise in f32, within
    the bf16 rounding of test_fused_phases_bf16_within_rounding_of_pallas
    in bf16) and gamma' to (r, r) of the port's own r; false, x and r
    come back unchanged and gamma' is (r, r) of the unchanged r."""
    xt, pt, rt, tt = tv
    x0, r0 = xt.clone(), rt.clone()
    lv = None if live is None else torch.tensor(live)
    xo, ro, g = K.cg_phase_b(xt, pt, rt, tt, torch.tensor(gamma),
                             torch.tensor(pdott), live=lv)
    assert xo is xt and ro is rt  # updated in place
    if live is False:
        assert torch.equal(xo, x0) and torch.equal(ro, r0)
        rf = r0.to(torch.float32)
        assert torch.equal(g, torch.dot(rf, rf))
        return
    for got, w in zip((xo, ro), want[:2]):
        w = np.asarray(w, np.float64)
        if dtype == "f32":
            np.testing.assert_array_equal(_np(got), w)
        else:
            np.testing.assert_allclose(_np(got), w,
                                       atol=2 ** -5 * np.abs(w).max())
    rr = float((_np(ro) ** 2).sum())
    assert float(g) == pytest.approx(rr, rel=1e-5)
    gj = float(want[2])
    assert abs(float(g) - gj) <= (1e-5 if dtype == "f32" else 2 ** -6) * gj


@pytest.mark.parametrize("n", [TILE, 2 * TILE])
@pytest.mark.parametrize("live", [None, True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cg_phase_b_plain_matches_pallas_with_live(dtype, live, n):
    """K4's plain version against the Pallas kernel in interpret mode,
    at the tile multiples it takes.  alpha = 3/1.5 = 2 is exact, so the
    interpret mode's fused multiply-adds round as the port's separate
    product and sum do (f32 bitwise)."""
    vecs, tv = _phase_b_case(dtype, n, 12)
    jdt = _PHASE_B_DTYPES[dtype][1]
    want = pk.cg_phase_b(*(jnp.asarray(v, jdt) for v in vecs),
                         jnp.float32(3.0), jnp.float32(1.5), interpret=True)
    _check_phase_b(dtype, live, vecs, tv, 3.0, 1.5, want)


@pytest.mark.parametrize("n", [1, 7, TILE + 5])
@pytest.mark.parametrize("live", [None, True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cg_phase_b_plain_ragged_matches_jax_formulation(dtype, live, n):
    """Ragged n, which the Pallas kernel refuses: K4's plain version
    against the kernel's formulation in jax.numpy, op by op (alpha in
    the vector dtype, x + alpha p, r - alpha t, (r, r) in f32), with an
    inexact alpha = 3/1.7 (eager jax.numpy contracts nothing, so f32 is
    bitwise)."""
    vecs, tv = _phase_b_case(dtype, n, 13)
    jdt = _PHASE_B_DTYPES[dtype][1]
    x, p, r, t = (jnp.asarray(v, jdt) for v in vecs)
    with pytest.raises(ValueError, match="not supported"):
        pk.cg_phase_b(x, p, r, t, jnp.float32(3.0), jnp.float32(1.7),
                      interpret=True)
    alpha = (jnp.float32(3.0) / jnp.float32(1.7)).astype(jdt)
    rj = r - alpha * t
    rf = rj.astype(jnp.float32)
    want = (x + alpha * p, rj, jnp.sum(rf * rf))
    _check_phase_b(dtype, live, vecs, tv, 3.0, 1.7, want)


@pytest.mark.parametrize("n,rows,nblocks", [
    (2048 ** 2, 4, 4096), (2047 ** 2, 4, 4093), (1, 4, 1), (9, 4, 1),
    (1025, 4, 2)])
def test_cg_phase_b_plan_worked_by_hand(n, rows, nblocks):
    """K4's cut: 16-byte vectors a thread (4 f32 rows, 8 bf16), 256
    threads a block, one partial a block: f32 as listed, bf16 with
    twice the rows and half the blocks (at least one)."""
    assert K.cg_phase_b_plan(n, torch.float32) == (rows, nblocks)
    assert K.cg_phase_b_plan(n, torch.bfloat16) == \
        (2 * rows, max(1, -(-n // 2048)))


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
                        "part_dot.cu", "pipelined_update.cu",
                        "stencil_spmv.cu"]
        assert all(f"-c {_build.CSRC / s}" in log for s in srcs)
        assert "sm_90a" in log and "--fmad=false" in log
    else:
        with pytest.raises(RuntimeError, match="no such type"):
            _build.build()
        assert not lib.exists()
        assert not any((tmp_path / "build").glob("build-*"))


# -- K1's launch plan (csrc/dia_spmv.cu takes it by value) ---------------

def _plan_case(name):
    """(offsets, n, dtype, nparts) of the plan cases worked by hand."""
    return {
        "2d-5pt": ((-2048, -1, 0, 1, 2048), 2048 ** 2, torch.float64, 1),
        "3d-7pt": ((-512 ** 2, -512, -1, 0, 1, 512, 512 ** 2), 512 ** 3,
                   torch.float64, 1),
        "band64": (tuple(200 * k for k in range(-32, 32)), 10 ** 6,
                   torch.float64, 1),
        "band64-huge": (tuple(200 * k for k in range(-32, 32)),
                        2 ** 25 + 1, torch.bfloat16, 1),
        "tiny": ((-3, 0, 3), 100, torch.float32, 3),
        # K3's plans (phase A cuts its rows as K1 does for its planes)
        "2d-5pt-bf16": ((-2048, -1, 0, 1, 2048), 2048 ** 2, torch.bfloat16,
                        1),
        "2d-5pt-f32-odd": ((-2047, -1, 0, 1, 2047), 2047 ** 2,
                           torch.float32, 1),
    }[name]


@pytest.mark.parametrize("name,rows,tile,nblocks,bits", [
    ("2d-5pt", 2, 512, 8192, 32),
    ("3d-7pt", 2, 512, 262144, 32),
    ("band64", 2, 512, 1954, 32),
    ("band64-huge", 8, 2048, 16385, 64),
    ("tiny", 4, 1024, 1, 32),
    ("2d-5pt-bf16", 8, 2048, 2048, 32),
    ("2d-5pt-f32-odd", 4, 1024, 4093, 32),
])
def test_dia_tile_plan_worked_by_hand(name, rows, tile, nblocks, bits):
    """R = 16 / plane itemsize rows a thread, T = 256 R rows a block,
    ceil(n / T) blocks a part (at least one: n = 100 is under one tile;
    4,190,209 = 4,092 x 1,024 + 1 takes 4,093); 64-bit indices once nd * P
    * n passes 2^31 (64 x (2^25 + 1) bf16 values), 32-bit for the 940M
    plane values of 3D 7-point at 512.  K3 takes the plan of its planes'
    dtype: 8 rows a thread under bf16 planes (mixed and bf16)."""
    offsets, n, dtype, nparts = _plan_case(name)
    plan = K.dia_tile_plan(offsets, n, dtype, nparts)
    assert (plan.rows_per_thread, plan.tile, plan.nblocks) == \
        (rows, tile, nblocks)
    assert plan.index_bits == bits and plan.offsets == offsets


def test_dia_tile_plan_packs_what_the_kernel_reads():
    """The int64 array acg_dia_spmv unpacks: rows, tile, nd, index bits,
    then the offsets in accumulation order (bf16 planes: R = 8)."""
    offsets = (2048, -1, 0, 1, -2048)   # accumulation order, not sorted
    plan = K.dia_tile_plan(offsets, 2048 ** 2, torch.bfloat16)
    assert list(K._packed_plan(plan)) == [8, 2048, 5, 32,
                                          2048, -1, 0, 1, -2048]
    with pytest.raises(ValueError, match="1 to 64 diagonals"):
        K.dia_tile_plan(tuple(range(65)), 1000, torch.float64)


# the edge shapes chip_smoke.py holds K1 to on the card, at small n
@pytest.mark.parametrize("offsets,n,nparts", [
    ((-33, -1, 0, 1, 33), 2001, 1),              # odd n
    ((-33, -1, 0, 1, 33), 2001, 3),              # odd n, parts off 16 B
    ((0, 1, 7, 300), 999, 1),                    # offsets >= 0
    ((-300, -7, -1, 0), 999, 3),                 # offsets <= 0
    (tuple(40 * k for k in range(-32, 32)), 3001, 1),   # 64 diagonals
    ((-3, 0, 3), 100, 2),                        # n under one tile
])
def test_dia_spmv_edge_shapes_match_dia_mv(offsets, n, nparts):
    """K1's plain version on its edge shapes against the JAX dia_mv of
    every part (random f64 planes: XLA may contract a product into a
    fused multiply-add, so within 1e-12)."""
    rng = np.random.default_rng(7)
    planes = rng.standard_normal((len(offsets), nparts, n))
    x = rng.standard_normal((nparts, n))
    got = K.dia_spmv(torch.from_numpy(planes if nparts > 1 else planes[:, 0]),
                     offsets, torch.from_numpy(x if nparts > 1 else x[0]))
    got = got.numpy().reshape(nparts, n)
    for p in range(nparts):
        want = jax_dia_mv(tuple(jnp.asarray(planes[d, p])
                                for d in range(len(offsets))), offsets, n,
                          jnp.asarray(x[p]))
        np.testing.assert_allclose(got[p], np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("vdt,sdt,rel", [
    (torch.float64, torch.float64, 1e-13),
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 1e-5),
])
def test_part_dot_plain_matches_jax_dot(vdt, sdt, rel):
    """The per-part dots against the JAX tier's ``jnp.dot(a, c,
    preferred_element_type=sdt)`` of each part (another summation
    order: within ``rel`` of the f64 sum of |a c|)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((3, 5001))).to(vdt)
    c = torch.from_numpy(rng.standard_normal((3, 5001))).to(vdt)
    got = K.part_dot(a, c, sdt)
    assert got.dtype == sdt and got.shape == (3,)
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[sdt]
    for p in range(3):
        ja, jc = (jnp.asarray(v[p].to(sdt).numpy()) for v in (a, c))
        want = float(jnp.dot(ja, jc, preferred_element_type=jdt))
        scale = float((a[p].double() * c[p].double()).abs().sum())
        assert abs(float(got[p]) - want) <= rel * scale


def test_part_dot_bits_do_not_depend_on_the_stack():
    """A part's dot has the same bits in a stack of 4, of 2, alone, and
    from a row that starts off a 16-byte boundary -- the property that
    makes a rank's dots (fewer parts stacked) the one-process tier's."""
    rng = np.random.default_rng(4)
    for dt in (torch.float64, torch.float32):
        a = torch.from_numpy(rng.standard_normal((4, 30011))).to(dt)
        c = torch.from_numpy(rng.standard_normal((4, 30011))).to(dt)
        whole = K.part_dot(a, c, dt)
        assert torch.equal(K.part_dot(a[1:3], c[1:3], dt), whole[1:3])
        for p in range(4):
            assert torch.equal(K.part_dot(a[p:p + 1], c[p:p + 1], dt),
                               whole[p:p + 1])
        buf = torch.empty(2 * 30011 + 1, dtype=dt)
        off = buf[1:].view(2, 30011)
        off.copy_(torch.stack([a[2], c[2]]))
        assert torch.equal(K.part_dot(off[:1], off[1:], dt), whole[2:3])


@pytest.mark.parametrize("shape_a,shape_c,dt,sdt", [
    ((4, 10, 2), (4, 10, 2), torch.float64, torch.float64),   # not 2-D
    ((4, 10), (4, 11), torch.float64, torch.float64),         # shapes differ
    ((4, 10), (4, 10), torch.float16, torch.float32),         # no f16 kernel
    ((4, 10), (4, 10), torch.float32, torch.bfloat16),        # bf16 sums
    ((4, 10), (4, 10), None, torch.float32),                  # two dtypes
])
def test_part_dot_refuses_what_the_kernel_does_not_take(shape_a, shape_c,
                                                        dt, sdt):
    """Off the CPU the wrapper checks its operands before it builds or
    launches anything (meta tensors stand in for the card's)."""
    a = torch.empty(shape_a, dtype=dt or torch.float32, device="meta")
    c = torch.empty(shape_c, dtype=dt or torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="part_dot"):
        K.part_dot(a, c, sdt)
