"""The port's operator module (acg_tpu_torch.ops.operator) and its
generators against the JAX package's (acg_tpu.ops.operator,
acg_tpu.io.generators).

Bitwise: spec parsing and ``build_operator``'s tuples and refusals, the
anisotropic tables, the generated planes (whole grid and per-part
windows), the device-built Poisson planes and the aniso COO triplets,
``matfree_nnz`` and ``identity``.  The shifted-view apply is bitwise
where every product is exact in both packages (Poisson 1D/2D: -1 * x and
2 * x, 4 * x); XLA:CPU contracts the 3D diagonal term 6 * x and the
anisotropic coefficient products into fused multiply-adds, so those
agree to one rounding (rtol 2e-6 f32, 1e-15 f64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.io.generators import aniso_poisson2d_coo as jax_aniso_coo
from acg_tpu.io.generators import poisson_dia as jax_poisson_dia
from acg_tpu.ops import operator as J
from acg_tpu_torch.errors import AcgError
from acg_tpu_torch.io.generators import aniso_poisson2d_coo, poisson_dia_device
from acg_tpu_torch.ops import operator as T

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
DT = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64,
                                                     torch.float64)}
RTOL = {"f32": 2e-6, "f64": 1e-15}


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("text", [
    None, "none", "", "stencil", "stencil:poisson1d:9",
    "stencil:poisson2d:64", "stencil:poisson3d:5", "stencil:aniso2d:32:0.05",
    "user:myop", "stencil:poisson4d:8", "stencil:poisson2d",
    "stencil:aniso2d:8", "stencil:aniso2d:8:0", "stencil:aniso2d:8:1.5",
    "stencil:poisson2d:1", "wat", "user:", "user:a:b"])
def test_spec_parsing_matches_jax(text):
    try:
        want = J.parse_operator_spec(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            T.parse_operator_spec(text)
        assert str(got.value) == str(e)
        return
    assert T.parse_operator_spec(text) == want


GEN = ("poisson", 2, 16, 256, None)


@pytest.mark.parametrize("spec,gen,aniso", [
    (("auto",), GEN, None), (("auto",), GEN, 0.25),
    (("auto",), ("poisson", 3, 5, 125, None), None),
    (("poisson", 2, 16), GEN, None), (("aniso2d", 16, 0.25), GEN, 0.25),
    (("aniso2d", 16, 0.25), None, None), (("poisson", 1, 7), None, None),
    # refusals
    (("auto",), None, None), (("auto",), ("irregular", 0, 256, 256, 16.0),
                              None),
    (("poisson", 2, 32), GEN, None), (("poisson", 2, 16), GEN, 0.5),
    (("poisson", 2, 16), ("irregular", 0, 256, 256, 16.0), None),
    (("aniso2d", 16, 0.01), GEN, None), (("aniso2d", 16, 0.01), GEN, 0.5),
    (("aniso2d", 8, 0.01), GEN, 0.01),
    (("aniso2d", 16, 0.5), ("poisson", 3, 16, 4096, None), 0.5),
    (("user", "x"), GEN, None), (("bogus",), None, None)])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_build_operator_matches_jax(spec, gen, aniso, dtype):
    """The same operator or the same refusal text; the tables bitwise."""
    jdt, tdt = DT[dtype]
    try:
        want = J.build_operator(spec, jdt, gen=gen, aniso=aniso)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            T.build_operator(spec, tdt, gen=gen, aniso=aniso, device=CPU)
        assert str(got.value) == str(e)
        return
    got = T.build_operator(spec, tdt, gen=gen, aniso=aniso, device=CPU)
    for name in ("kind", "grid", "param", "offsets", "nrows",
                 "ncols_padded"):
        assert getattr(got, name) == getattr(want, name)
    assert got.dtype == tdt and got.device.type == "cpu"
    assert got.identity() == want.identity()
    assert got.matfree_nnz() == want.matfree_nnz()
    assert got.table_bytes() == want.table_bytes()
    assert len(got.tables) == len(want.tables)
    for a, b in zip(got.tables, want.tables):
        assert a.dtype == tdt
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert T.operator_identity(got) == J.operator_identity(want)


@pytest.mark.parametrize("kind,n,dim", [("poisson", 9, 1), ("poisson", 7, 2),
                                        ("poisson", 4, 3),
                                        ("aniso2d", 7, 2)])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_planes_match_jax(kind, n, dim, dtype):
    """Generated planes bitwise: the whole grid, and part windows with
    a row offset and an owned-window mask (a per-part (P,) row0)."""
    jdt, tdt = DT[dtype]
    if kind == "poisson":
        jop = J.poisson_stencil(n, dim, dtype=jdt)
        top = T.poisson_stencil(n, dim, dtype=tdt, device=CPU)
    else:
        jop = J.aniso2d_stencil(n, 0.1, dtype=jdt)
        top = T.aniso2d_stencil(n, 0.1, dtype=tdt, device=CPU)
    want = np.stack([np.asarray(p) for p in jop.planes()])
    np.testing.assert_array_equal(_np(top.planes()), want)
    N = top.nrows
    rows0, nowns, nrows = [0, N // 3, N - 5], [N // 3, N // 2, 5], N // 2 + 2
    stacked = top.planes(row0=torch.tensor(rows0), nrows=nrows,
                         nowned=torch.tensor(nowns))
    if kind == "aniso2d":   # per-part tables, as arm_matfree stacks them
        stacked = T.stencil_planes(
            top.kind, top.grid, top.offsets,
            tuple(t.expand(3, -1) for t in top.tables), nrows, tdt,
            row0=torch.tensor(rows0), nowned=torch.tensor(nowns))
    for p, (r0, nown) in enumerate(zip(rows0, nowns)):
        w = np.stack([np.asarray(q) for q in jop.planes(
            row0=r0, nrows=nrows, nowned=nown)])
        np.testing.assert_array_equal(_np(stacked[:, p]), w)


@pytest.mark.parametrize("n,dim", [(9, 1), (6, 2), (5, 3), (2, 2)])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_poisson_dia_device_matches_poisson_dia(n, dim, dtype):
    jdt, tdt = DT[dtype]
    planes, offsets, N = poisson_dia_device(n, dim, dtype=tdt, device=CPU)
    jplanes, joffsets, jN = jax_poisson_dia(n, dim, dtype=np.dtype(
        str(jnp.dtype(jdt))))
    assert offsets == joffsets and N == jN
    assert planes.shape == (2 * dim + 1, N) and planes.is_contiguous()
    np.testing.assert_array_equal(_np(planes), np.stack(jplanes))
    assert offsets == T.poisson_stencil(n, dim, device=CPU).offsets


def test_aniso_coo_matches_jax():
    for n, eps in ((5, 0.3), (16, 0.01)):
        for a, b in zip(aniso_poisson2d_coo(n, eps), jax_aniso_coo(n, eps)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="stretch"):
        aniso_poisson2d_coo(4, 0.0)


@pytest.mark.parametrize("case", ["p1d", "p2d", "p3d", "aniso"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_matfree_apply_matches_jax(case, dtype):
    jdt, tdt = DT[dtype]
    n, dim = {"p1d": (40, 1), "p2d": (13, 2), "p3d": (6, 3),
              "aniso": (13, 2)}[case]
    if case == "aniso":
        jop = J.aniso2d_stencil(n, 0.07, dtype=jdt)
        top = T.aniso2d_stencil(n, 0.07, dtype=tdt, device=CPU)
    else:
        jop = J.poisson_stencil(n, dim, dtype=jdt)
        top = T.poisson_stencil(n, dim, dtype=tdt, device=CPU)
    x = np.random.default_rng(0).standard_normal(n ** dim)
    want = np.asarray(jop.matfree_apply(jnp.asarray(x, jdt)))
    got = _np(top.matfree_apply(torch.from_numpy(x).to(tdt)))
    assert got.dtype == want.dtype
    if case in ("p1d", "p2d"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                                   atol=RTOL[dtype])


def test_operator_refusals():
    with pytest.raises(ValueError, match="dim must be"):
        T.poisson_stencil(4, 4, device=CPU)
    with pytest.raises(ValueError, match="n >= 2"):
        T.poisson_stencil(1, 2, device=CPU)
    with pytest.raises(ValueError, match="stretch"):
        T.aniso2d_stencil(4, 1.5, device=CPU)
    with pytest.raises(ValueError, match="f32 or f64"):
        T.poisson_stencil(4, 2, dtype=torch.bfloat16, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(AcgError, match="no CUDA device"):
            T.poisson_stencil(4, 2)


def test_user_operator_registry():
    """Registration, instantiation and the not-registered refusals, as
    in acg_tpu (the registry is the port's own)."""
    n = 64
    d = torch.linspace(1.0, 4.0, n, dtype=torch.float64)
    T.register_operator("torch_testdiag", lambda caps, x: caps[0] * x,
                        nnz=n)
    op = T.user_operator("torch_testdiag", n, dtype=torch.float64,
                         captures=(d,), device=CPU)
    assert "torch_testdiag" in T.registered_operators()
    assert T.is_matrix_free(op) and op.identity() == "user:torch_testdiag"
    assert op.matfree_nnz() == n and op.table_bytes() == 8 * n
    x = torch.ones(n, dtype=torch.float64)
    assert torch.equal(op.matfree_apply(x), d)
    with pytest.raises(AcgError, match="not registered"):
        T.user_operator("no_such_torch_operator", n, device=CPU)
    with pytest.raises(ValueError, match="callable"):
        T.register_operator("bad", "not-a-function")
    stale = T.UserOperator(captures=(), name="never_registered", nrows=n,
                           ncols_padded=n, dtype=torch.float64,
                           device=torch.device(CPU))
    with pytest.raises(AcgError, match="not registered in this process"):
        stale.matfree_apply(x)
    with pytest.raises(ValueError, match="system size"):
        T.build_operator(("user", "torch_testdiag"), torch.float64)
    assert T.build_operator(("user", "torch_testdiag"), torch.float64,
                            nrows=n, device=CPU).nrows == n
