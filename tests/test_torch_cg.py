"""The port's single-device solvers (TorchCGSolver on the CPU) against
the JAX package's JaxCGSolver, on the same matrices and right-hand sides.

The JAX side runs the way its own tests run it: ``kernels="pallas"``
resolves to ``pallas-interpret`` and ``"fused"`` to ``fused-interpret``
on the CPU; the port's ``"pallas"``/``"fused"`` take the kernels' plain
versions there (``pallas-plain``/``fused-plain``).

Tolerances: f64 solves take the same number of iterations and agree to
1e-10 relative (the dots sum in another order than XLA's, and XLA:CPU
contracts multiply-adds, so bitwise agreement is not expected); f32 and
the fused tier use the JAX tests' own tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.io.generators import poisson2d_coo as jax_poisson2d_coo
from acg_tpu.io.generators import poisson_dia as jax_poisson_dia
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.ops.spmv import DiaMatrix as JaxDia
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dev_matrix
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch.errors import AcgError
from acg_tpu_torch.io.generators import poisson2d_coo, poisson_dia, poisson_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.spmv import (DiaMatrix, device_matrix_from_arrays,
                                    device_matrix_from_csr)
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"


@pytest.fixture(scope="module")
def poisson16():
    csr = SymCsrMatrix.from_mtx(poisson_mtx(16, dim=2)).to_csr()
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(16, dim=2)).to_csr()
    assert (csr != jcsr).nnz == 0
    return csr


@pytest.fixture(scope="module")
def poisson24():
    r, c, v, N = poisson2d_coo(24)
    jr, jc, jv, _ = jax_poisson2d_coo(24)
    assert np.array_equal(r, jr) and np.array_equal(v, jv)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def _manufactured(csr, seed=7):
    rng = np.random.default_rng(seed)
    xsol = rng.standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    return csr @ xsol


def _pair(csr, pipelined, kernels, jdt=jnp.float64, tdt=torch.float64):
    J = JaxCGSolver(jax_dev_matrix(csr, dtype=jdt), pipelined=pipelined,
                    kernels=kernels)
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=tdt, device=CPU),
                      pipelined=pipelined, kernels=kernels, device=CPU)
    return J, T


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("matrix", ["poisson16", "poisson24"])
def test_f64_solve_matches_jax(matrix, pipelined, kernels, request):
    csr = request.getfixturevalue(matrix)
    b = _manufactured(csr)
    J, T = _pair(csr, pipelined, kernels)
    if kernels == "pallas":
        assert J.kernels == "pallas-interpret"
        assert T.kernels == "pallas-plain"
    crit = dict(maxits=2000, residual_rtol=1e-10)
    xj = J.solve(b, criteria=JaxCrit(**crit))
    xt = T.solve(b, criteria=StoppingCriteria(**crit))
    assert T.stats.converged and J.stats.converged
    assert T.stats.niterations == J.stats.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    assert T.stats.r0nrm2 == pytest.approx(J.stats.r0nrm2, rel=1e-14)
    assert T.stats.rnrm2 == pytest.approx(J.stats.rnrm2, rel=1e-3)


@pytest.mark.parametrize("pipelined", [False, True])
def test_maxits_only_runs_exactly_maxits(poisson16, pipelined):
    """No tolerance: exactly maxits iterations, reported converged,
    the same iterate as the JAX fori_loop path."""
    J, T = _pair(poisson16, pipelined, "xla")
    b = np.ones(poisson16.shape[0])
    xj = J.solve(b, criteria=JaxCrit(maxits=13))
    xt = T.solve(b, criteria=StoppingCriteria(maxits=13))
    assert T.stats.niterations == 13 and T.stats.converged
    assert np.linalg.norm(xt - xj) <= 1e-12 * np.linalg.norm(xj)


@pytest.mark.parametrize("pipelined", [False, True])
def test_zero_rhs_converges_immediately(poisson16, pipelined):
    """b = 0 with x0 = 0 is converged at entry: x0 comes back in 0
    iterations (the pipelined gamma_prev = inf entry must not divide
    0/0)."""
    _, T = _pair(poisson16, pipelined, "xla")
    x = T.solve(np.zeros(poisson16.shape[0]),
                criteria=StoppingCriteria(maxits=50, residual_rtol=1e-8,
                                          residual_atol=1e-30))
    assert np.all(np.isfinite(x)) and np.all(x == 0.0)
    assert T.stats.niterations == 0 and T.stats.converged


@pytest.mark.parametrize("pipelined", [False, True])
def test_chunk_boundary_freezes_state(poisson16, pipelined, monkeypatch):
    """Convergence mid-chunk freezes x on the device: every chunk length
    gives the iteration count and iterate of a one-iteration chunk."""
    import acg_tpu_torch.solvers.cg as cg
    b = _manufactured(poisson16, seed=11)
    crit = StoppingCriteria(maxits=500, residual_rtol=1e-9)
    results = []
    for chunk in (1, 7, 64):
        monkeypatch.setattr(cg, "CHUNK", chunk)
        _, T = _pair(poisson16, pipelined, "pallas")
        results.append((T.solve(b, criteria=crit), T.stats.niterations))
    for x, k in results[1:]:
        assert k == results[0][1]
        np.testing.assert_array_equal(x, results[0][0])


def test_f32_reaches_loose_tolerance(poisson16):
    """test_jax_cg.py::test_jax_cg_float32's tolerance."""
    rng = np.random.default_rng(3)
    xsol = rng.standard_normal(poisson16.shape[0])
    xsol /= np.linalg.norm(xsol)
    b = (poisson16 @ xsol).astype(np.float32)
    J, T = _pair(poisson16, False, "xla", jnp.float32, torch.float32)
    crit = dict(maxits=3000, residual_rtol=1e-4)
    xj = J.solve(b, criteria=JaxCrit(**crit))
    xt = T.solve(b, criteria=StoppingCriteria(**crit))
    assert T.stats.converged
    assert np.linalg.norm(xt - xsol) < 1e-2
    assert abs(T.stats.niterations - J.stats.niterations) <= 2
    assert np.linalg.norm(xt - xj) < 1e-3


def test_mixed_bitwise_equals_f32(poisson16):
    """bf16 planes with f32 vectors: the stencil values are exact in
    bf16 and the SpMV accumulates in f32, so the solve is bitwise the
    f32 one."""
    b = _manufactured(poisson16).astype(np.float32)
    crit = StoppingCriteria(maxits=300)
    xs = []
    for mdt in (torch.float32, torch.bfloat16):
        for kernels in ("xla", "pallas"):
            A = device_matrix_from_csr(poisson16, dtype=mdt, device=CPU)
            T = TorchCGSolver(A, kernels=kernels, device=CPU,
                              vector_dtype=torch.float32)
            xs.append(T.solve(b, criteria=crit))
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])


@pytest.mark.parametrize("pipelined", [False, True])
def test_bf16_solve_tracks_jax(poisson16, pipelined):
    """bf16 vectors with f32 scalars, rounded once on store, as the JAX
    bf16 loop bodies compute them; the port's pipelined side runs the
    K5 wrapper (its plain version on the CPU) against the JAX body's
    XLA update.  The dots sum in another order, which bf16 storage
    turns into last-bit differences: a handful of iterations stays
    within 2e-2."""
    b = _manufactured(poisson16)
    J, _ = _pair(poisson16, pipelined, "xla", jnp.bfloat16, torch.bfloat16)
    _, T = _pair(poisson16, pipelined, "pallas", jnp.bfloat16,
                 torch.bfloat16)
    xj = np.asarray(J.solve(b, criteria=JaxCrit(maxits=5)), np.float64)
    xt = T.solve(b, criteria=StoppingCriteria(maxits=5))
    assert xt.dtype == np.float32
    assert np.linalg.norm(xt - xj) <= 2e-2 * np.linalg.norm(xj)


def _shifted_dia(n=128):
    """test_fused_cg.py::test_fused_solver_matches_xla_multi_tile's
    shifted matrix (A + 2I, kappa ~ 9/2) at N = 16384, in both packages."""
    planes, offsets, N = jax_poisson_dia(n, 2, dtype=np.float64)
    planes = [p.copy() for p in planes]
    planes[offsets.index(0)] += 2.0
    jA = JaxDia(data=tuple(jnp.asarray(p, jnp.float32) for p in planes),
                offsets=offsets, nrows=N, ncols_padded=N)
    tA = device_matrix_from_arrays(
        "dia", planes, {"offsets": offsets, "nrows": N, "ncols_padded": N},
        dtype=torch.float32, device=CPU)
    return jA, tA


def test_fused_tier_matches_fused_interpret():
    jA, tA = _shifted_dia()
    b = np.ones(tA.nrows, np.float32)
    crit = dict(maxits=500, residual_rtol=1e-6)
    J = JaxCGSolver(jA, kernels="fused")
    assert J.kernels == "fused-interpret"
    xj = np.asarray(J.solve(b, criteria=JaxCrit(**crit)))
    T = TorchCGSolver(tA, kernels="fused", device=CPU)
    assert T.kernels == "fused-plain"
    xt = T.solve(b, criteria=StoppingCriteria(**crit))
    X = TorchCGSolver(tA, kernels="xla", device=CPU)
    xx = X.solve(b, criteria=StoppingCriteria(**crit))
    assert T.stats.converged and J.stats.converged and X.stats.converged
    assert abs(T.stats.niterations - J.stats.niterations) <= 2
    assert np.linalg.norm(xt - xj) <= 1e-5 * np.linalg.norm(xj)
    assert np.linalg.norm(xt - xx) <= 1e-5 * np.linalg.norm(xx)


def test_fused_refusals():
    """test_fused_cg.py's refusals: a ragged N (no single-window route),
    pipelined, f64 (the route's align table has no 8-byte entry), and
    diff criteria."""
    planes, offsets, N = poisson_dia(90, 2)
    ragged = device_matrix_from_arrays(
        "dia", planes, {"offsets": offsets, "nrows": N, "ncols_padded": N},
        dtype=torch.float32, device=CPU)
    with pytest.raises(ValueError, match="fused"):
        TorchCGSolver(ragged, kernels="fused", device=CPU)
    _, tA = _shifted_dia()
    with pytest.raises(ValueError, match="fused"):
        TorchCGSolver(tA, kernels="fused", pipelined=True, device=CPU)
    a64 = DiaMatrix(data=tA.data.double(), offsets=tA.offsets,
                    nrows=tA.nrows, ncols_padded=tA.ncols_padded)
    with pytest.raises(ValueError, match="fused"):
        TorchCGSolver(a64, kernels="fused", device=CPU)
    T = TorchCGSolver(tA, kernels="fused", device=CPU)
    with pytest.raises(ValueError, match="residual"):
        T.solve(np.ones(tA.nrows, np.float32),
                criteria=StoppingCriteria(maxits=10, diff_atol=1e-3))


def test_fused_mixed_bitwise_equals_fused_f32():
    """test_fused_cg.py::test_fused_mixed_bitwise_equals_fused_f32."""
    _, tA = _shifted_dia()
    b = np.ones(tA.nrows, np.float32)
    crit = StoppingCriteria(maxits=40)
    x32 = TorchCGSolver(tA, kernels="fused", device=CPU).solve(b,
                                                               criteria=crit)
    A16 = DiaMatrix(data=tA.data.to(torch.bfloat16), offsets=tA.offsets,
                    nrows=tA.nrows, ncols_padded=tA.ncols_padded)
    xm = TorchCGSolver(A16, kernels="fused", device=CPU,
                       vector_dtype=torch.float32).solve(b, criteria=crit)
    np.testing.assert_array_equal(x32, xm)


def test_stats_block_and_diff_criterion(poisson16):
    A = device_matrix_from_csr(poisson16, device=CPU)
    T = TorchCGSolver(A, device=CPU)
    T.solve(np.ones(poisson16.shape[0]),
            criteria=StoppingCriteria(maxits=5000, diff_atol=1e-9))
    st = T.stats
    assert st.converged and st.dxnrm2 < 1e-9
    assert st.nflops > 0 and st.tsolve > 0
    text = st.fwrite()
    assert "total solver time: " in text and "timings:" in text


def test_solver_refuses_missing_card(poisson16):
    """The solver's default device is the card: without one it raises
    rather than solving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A = device_matrix_from_csr(poisson16, device=CPU)
    with pytest.raises(AcgError, match="no CUDA device"):
        TorchCGSolver(A)
