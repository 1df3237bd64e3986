"""The port's preconditioning tier against the JAX package's
``acg_tpu.precond``: spec parsing, the diagonal of every device format
and of the stencil operator, the jacobi/bjacobi/cheby state builders,
preconditioned classic and pipelined CG single-part and on 4 stacked
parts, the stats block's ``precond:`` section, and ``--precond``.

Tolerances: ``dinv`` is bitwise the JAX one; the Cholesky factors agree
within 1e-12 relative (f64).  The single-part power iteration draws its
start vector from a ``torch.Generator`` (the JAX package's threefry
stream cannot be reproduced), so its lambda estimate is held to the JAX
test's bounds; cheby solves carry the JAX ``(lmin, lmax)`` across with
``state_from_numpy``.  f64 PCG solves take the same iterations and agree
to 1e-10 relative; the stacked tier's cheby starts from numpy's
``default_rng(0)`` as the JAX mesh tier does, so it needs no carried
state.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from acg_tpu import precond as jprecond
from acg_tpu.cli import main as jax_main
from acg_tpu.io.generators import aniso_poisson2d_coo as jax_aniso
from acg_tpu.ops.operator import aniso2d_stencil as jax_aniso_op
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dev_matrix
from acg_tpu.ops.spmv import matrix_diagonal as jax_matrix_diagonal
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch import precond
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.errors import AcgError
from acg_tpu_torch.io.generators import aniso_poisson2d_coo
from acg_tpu_torch.io.mtxfile import read_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.operator import (aniso2d_stencil, poisson_stencil,
                                        register_operator, user_operator)
from acg_tpu_torch.ops.spmv import (device_matrix_from_csr, matrix_diagonal,
                                    spmv)
from acg_tpu_torch.parallel.dist import (DistCGSolver, DistributedProblem,
                                         arm_matfree)
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
FORMATS = ("dia", "ell", "coo", "bell")


def _aniso(n, eps):
    r, c, v, N = aniso_poisson2d_coo(n, eps)
    jr, jc, jv, _ = jax_aniso(n, eps)
    assert np.array_equal(r, jr) and np.array_equal(v, jv)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


@pytest.fixture(scope="module")
def a24():
    return _aniso(24, 0.05)


# -- spec parsing ---------------------------------------------------------

def test_parse_precond_matches_jax():
    for text in (None, "none", "", "jacobi", "bjacobi", "bjacobi:8",
                 "cheby:4", " cheby:64 "):
        got, want = precond.parse_precond(text), jprecond.parse_precond(text)
        if want is None:
            assert got is None
        else:
            assert (got.kind, got.degree, got.block, str(got)) == \
                (want.kind, want.degree, want.block, str(want))
    for bad in ("chebyshev", "cheby", "cheby:x", "cheby:0", "cheby:65",
                "jacobi:3", "bjacobi:0", "bjacobi:9999", "bjacobi:x",
                "bjacobi:8:2", "nope"):
        with pytest.raises(ValueError) as t:
            precond.parse_precond(bad)
        with pytest.raises(ValueError) as j:
            jprecond.parse_precond(bad)
        assert str(t.value) == str(j.value)


# -- the diagonal and the state builders ----------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_matrix_diagonal_and_dinv_match_jax(a24, fmt):
    """diag(A) of every format equals the JAX extraction; the Jacobi
    state is bitwise the JAX one."""
    A = device_matrix_from_csr(a24, dtype=torch.float64, format=fmt,
                               device=CPU)
    jA = jax_dev_matrix(a24, dtype=jnp.float64, format=fmt)
    d = matrix_diagonal(A).numpy()
    assert np.array_equal(d, np.asarray(jax_matrix_diagonal(jA)))
    assert np.array_equal(d, a24.diagonal())
    (dinv,) = precond.jacobi_state(A, torch.float64)
    (jdinv,) = jprecond.jacobi_state(jA, jnp.float64)
    assert np.array_equal(dinv.numpy(), np.asarray(jdinv))


def test_matrix_diagonal_of_operators():
    """The stencil operators' analytic diagonal equals the assembled
    one (and the JAX operator's); a user operator answers through its
    registered diagonal_fn, or refuses without one."""
    op = aniso2d_stencil(12, 0.1, dtype=torch.float64, device=CPU)
    d = matrix_diagonal(op).numpy()
    assert np.array_equal(d, np.asarray(
        jax_aniso_op(12, 0.1, dtype=jnp.float64).matfree_diagonal()))
    assert np.array_equal(d, _aniso(12, 0.1).diagonal())
    assert np.array_equal(op.host_diagonal(), d)
    p3 = poisson_stencil(5, 3, dtype=torch.float32, device=CPU)
    assert torch.equal(matrix_diagonal(p3), torch.full((125,), 6.0))
    assert np.array_equal(p3.host_diagonal(), np.full(125, 6.0))
    register_operator("pc_diag", lambda c, x: 2.0 * x,
                      diagonal_fn=lambda c: torch.full((10,), 2.0))
    register_operator("pc_nodiag", lambda c, x: 2.0 * x)
    assert torch.equal(matrix_diagonal(user_operator(
        "pc_diag", 10, torch.float64, device=CPU)), torch.full((10,), 2.0))
    with pytest.raises(AcgError, match="registered without a diagonal_fn"):
        matrix_diagonal(user_operator("pc_nodiag", 10, torch.float64,
                                      device=CPU))


@pytest.mark.parametrize("fmt", FORMATS)
def test_bjacobi_factors_match_jax(a24, fmt):
    """Cholesky factors of the diagonal blocks (ragged last block: 576
    rows in blocks of 7) within 1e-12 relative of the JAX ones."""
    A = device_matrix_from_csr(a24, dtype=torch.float64, format=fmt,
                               device=CPU)
    jA = jax_dev_matrix(a24, dtype=jnp.float64, format=fmt)
    (chol,) = precond.bjacobi_state(A, 7, torch.float64)
    (jchol,) = jprecond.bjacobi_state(jA, 7, jnp.float64)
    jchol = np.asarray(jchol)
    assert chol.shape == jchol.shape == (83, 7, 7)
    assert np.abs(chol.numpy() - jchol).max() <= 1e-12 * np.abs(jchol).max()


def test_bjacobi_apply_vs_scipy_cho_solve():
    """The batched triangular solves agree with scipy's cho_solve on
    each dense diagonal block, the ragged last one included."""
    csr = _aniso(5, 0.3)
    n, bs = csr.shape[0], 8
    spec = precond.parse_precond(f"bjacobi:{bs}")
    A = device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    mstate = precond.setup_single(spec, A, spmv, torch.float64)
    r = np.random.default_rng(0).standard_normal(n)
    z = precond.make_apply(spec, spmv)(mstate, A, torch.from_numpy(r))
    dense = csr.toarray()
    want = np.zeros(n)
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        want[lo:hi] = sla.cho_solve(
            (sla.cholesky(dense[lo:hi, lo:hi], lower=True), True), r[lo:hi])
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-10, atol=1e-12)


def test_bjacobi_non_spd_block_gives_nan_factor():
    """A block that is not positive definite leaves NaNs in its factor
    (the first apply carries them into (r, z)), the others stay finite."""
    csr = sp.csr_matrix(np.diag([4.0, 4.0, -1.0, 4.0]))
    A = device_matrix_from_csr(csr, dtype=torch.float64, format="dia",
                               device=CPU)
    (chol,) = precond.bjacobi_state(A, 2, torch.float64)
    assert torch.isnan(chol[1]).all() and torch.isfinite(chol[0]).all()


@pytest.mark.parametrize("kind", ["jacobi", "bjacobi:4", "cheby:3"])
def test_spd_preservation(kind):
    """M^-1 as the applies implement it is symmetric positive definite."""
    csr = _aniso(4, 0.2)
    n = csr.shape[0]
    spec = precond.parse_precond(kind)
    A = device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    mstate = precond.setup_single(spec, A, spmv, torch.float64)
    apply = precond.make_apply(spec, spmv)
    M = np.column_stack([apply(mstate, A, torch.from_numpy(e)).numpy()
                         for e in np.eye(n)])
    np.testing.assert_allclose(M, M.T, rtol=1e-10, atol=1e-12)
    assert np.linalg.eigvalsh(M).min() > 0


def test_cheby_lambda_estimate_within_jax_bounds():
    """tests/test_precond.py's bounds: 24 power iterations from a random
    start land within [0.7, 1] of the largest eigenvalue, and the state
    pads it by CHEBY_SAFETY."""
    r, c, v, N = aniso_poisson2d_coo(24, 1.0)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    A = device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    est = float(precond.estimate_lmax(spmv, A, A.nrows, torch.float64))
    true = float(sp.linalg.eigsh(csr, k=1, which="LA",
                                 return_eigenvectors=False)[0])
    assert 0.7 * true <= est <= true * (1 + 1e-9)
    lmin, lmax = precond.cheby_state(est, torch.float64)
    assert float(lmax) == pytest.approx(est * precond.CHEBY_SAFETY)
    assert float(lmin) == pytest.approx(float(lmax) / precond.CHEBY_RATIO)
    # the same seed draws the same start vector: the same estimate
    assert float(precond.estimate_lmax(spmv, A, A.nrows,
                                       torch.float64)) == est


# -- preconditioned solves ------------------------------------------------

def _stats_lines(text):
    """The stats block without its timing-dependent lines."""
    skip = ("total flop rate", "total solver time", "other", "transfer",
            "solve", "compile", "timings")
    return [ln for ln in text.splitlines()
            if not ln.strip().startswith(skip) and "seconds" not in ln]


def _ops(st):
    return {k: (o.n, o.bytes) for k, o in st.ops.items()}


@pytest.mark.parametrize("kind", ["jacobi", "bjacobi:8", "cheby:3"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_pcg_matches_jax(a24, kind, pipelined):
    """The same iterations, x within 1e-10, the same statistics block
    (the ``precond:`` section included); cheby takes the JAX interval."""
    b = np.ones(a24.shape[0])
    crit = dict(maxits=2000, residual_rtol=1e-10)
    J = JaxCGSolver(jax_dev_matrix(a24, dtype=jnp.float64),
                    pipelined=pipelined, precond=kind, kernels="pallas")
    xj = J.solve(b, criteria=JaxCrit(**crit))
    mstate = None
    if kind.startswith("cheby"):
        mstate = precond.state_from_numpy(
            kind, [np.asarray(a) for a in J._mstate], CPU)
    T = TorchCGSolver(device_matrix_from_csr(a24, dtype=torch.float64,
                                             device=CPU),
                      pipelined=pipelined, precond=kind, mstate=mstate,
                      kernels="pallas", device=CPU)
    xt = T.solve(b, criteria=StoppingCriteria(**crit))
    assert T.stats.niterations == J.stats.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    assert T.stats.precond == {k: J.stats.precond[k] for k in
                               T.stats.precond}
    assert set(T.stats.precond) == set(J.stats.precond)
    assert _ops(T.stats) == {k: v for k, v in _ops(J.stats).items()
                             if k in T.stats.ops}
    # every line but the timings and the final residual, which agree to
    # the dots' summation order, not in all 15 printed digits
    tl = [ln for ln in _stats_lines(T.stats.fwrite())
          if not ln.startswith("  residual 2-norm")]
    jl = [ln for ln in _stats_lines(J.stats.fwrite())
          if not ln.startswith("  residual 2-norm")]
    assert tl == jl
    assert T.stats.rnrm2 == pytest.approx(J.stats.rnrm2, rel=1e-4)


def test_pcg_state_built_by_the_port_matches_carried_state(a24):
    """jacobi/bjacobi built by the port give the JAX iterations with no
    carried state; cheby from the port's own power iteration converges
    with the JAX iteration count within one."""
    b = np.ones(a24.shape[0])
    crit = dict(maxits=2000, residual_rtol=1e-10)
    for kind in ("jacobi", "bjacobi:16", "cheby:4"):
        J = JaxCGSolver(jax_dev_matrix(a24, dtype=jnp.float64),
                        precond=kind)
        J.solve(b, criteria=JaxCrit(**crit))
        T = TorchCGSolver(device_matrix_from_csr(a24, dtype=torch.float64,
                                                 device=CPU),
                          precond=kind, device=CPU)
        T.solve(b, criteria=StoppingCriteria(**crit))
        assert T.stats.converged
        slack = 1 if kind.startswith("cheby") else 0
        assert abs(T.stats.niterations - J.stats.niterations) <= slack


@pytest.mark.parametrize("kind", ["jacobi", "cheby:4"])
def test_pcg_cuts_iterations_on_the_aniso_family(kind):
    """The JAX acceptance test's claim at a CPU size (eps = 0.01, n = 64):
    at twice the preconditioned count plain CG has not converged."""
    csr = _aniso(64, 0.01)
    b = np.ones(csr.shape[0])
    A = device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    s = TorchCGSolver(A, precond=kind, device=CPU)
    s.solve(b, criteria=StoppingCriteria(maxits=3000, residual_rtol=1e-6))
    s0 = TorchCGSolver(A, device=CPU)
    s0.solve(b, criteria=StoppingCriteria(
        maxits=2 * s.stats.niterations + 1, residual_rtol=1e-6),
        raise_on_divergence=False)
    assert s.stats.converged and not s0.stats.converged


@pytest.mark.parametrize("pipelined", [False, True])
def test_pcg_on_operator_equals_assembled(pipelined):
    """--operator stencil with jacobi and cheby: the operator's analytic
    diagonal and its apply give the assembled solve's iterations and
    bits; bjacobi refuses, as in the JAX package."""
    csr = _aniso(16, 0.1)
    b = np.ones(csr.shape[0])
    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-10)
    op = aniso2d_stencil(16, 0.1, dtype=torch.float64, device=CPU)
    A = device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    for kind in ("jacobi", "cheby:2"):
        xs = []
        for M in (A, op):
            s = TorchCGSolver(M, pipelined=pipelined, precond=kind,
                              device=CPU)
            xs.append((s.solve(b, criteria=crit), s.stats.niterations))
        assert xs[0][1] == xs[1][1]
        assert np.array_equal(xs[0][0], xs[1][0])
    s = TorchCGSolver(op, precond="bjacobi", device=CPU)
    with pytest.raises(AcgError, match="bjacobi factors stored diagonal"):
        s.solve(b, criteria=crit)


def test_precond_refusals_match_jax(a24):
    for dt, kw in ((torch.bfloat16, dict(precond="jacobi", replace_every=10)),
                   (torch.float32, dict(precond="jacobi", kernels="fused"))):
        jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
        csr = _aniso(128, 1.0)   # on the fused kernel route
        with pytest.raises(ValueError) as j:
            JaxCGSolver(jax_dev_matrix(csr, dtype=jdt), **kw)
        with pytest.raises(ValueError) as t:
            TorchCGSolver(device_matrix_from_csr(csr, dtype=dt, device=CPU),
                          device=CPU, **kw)
        assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="pass precond too"):
        TorchCGSolver(device_matrix_from_csr(a24, device=CPU), device=CPU,
                      mstate=(torch.ones(1),))


# -- the stacked tier -----------------------------------------------------

def test_stacked_state_matches_jax(a24):
    part = partition_rows(a24, 4, seed=0, method="band")
    prob = DistributedProblem.build(a24, part, 4)
    jprob = JaxProblem.build(a24, part, 4, dtype=jnp.float64)
    (d,) = precond.stacked_jacobi_state(prob, torch.float64)
    (jd,) = jprecond.stacked_jacobi_state(jprob, np.float64)
    assert np.array_equal(d, jd)
    (c,) = precond.stacked_bjacobi_state(prob, 8, torch.float64)
    (jc,) = jprecond.stacked_bjacobi_state(jprob, 8, np.float64)
    assert np.abs(c - jc).max() <= 1e-12 * np.abs(jc).max()


@pytest.mark.parametrize("kind", ["jacobi", "bjacobi:8", "cheby:3"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_stacked_pcg_matches_jax_mesh_and_single_part(a24, kind, pipelined):
    """4 stacked parts: the JAX mesh tier's iterations, x within 1e-10 and
    its precond: section (cheby's interval too: both start the power
    iteration from default_rng(0)); jacobi and cheby also match the
    single-part port as tests/test_precond.py:215 holds the JAX tiers
    (bjacobi factors per-part blocks, another M)."""
    b = np.ones(a24.shape[0])
    crit = dict(maxits=2000, residual_rtol=1e-10)
    part = partition_rows(a24, 4, seed=0, method="band")
    J = JaxDistCG(JaxProblem.build(a24, part, 4, dtype=jnp.float64),
                  pipelined=pipelined, precond=kind)
    xj = J.solve(b, criteria=JaxCrit(**crit))
    for comm in ("xla", "dma"):
        T = DistCGSolver(DistributedProblem.build(a24, part, 4),
                         pipelined=pipelined, precond=kind, comm=comm,
                         kernels="pallas", device=CPU)
        xt = T.solve(b, criteria=StoppingCriteria(**crit))
        assert T.stats.niterations == J.stats.niterations
        assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
        for k, v in J.stats.precond.items():
            assert T.stats.precond[k] == pytest.approx(v, rel=1e-12), k
        assert T.stats.ops["halo"].n == J.stats.ops["halo"].n
        assert T.stats.ops["precond"].n == J.stats.ops["precond"].n
    # the JAX mesh tier's state handed across (host arrays, a leading
    # parts axis) gives the same solve
    C = DistCGSolver(DistributedProblem.build(a24, part, 4),
                     pipelined=pipelined, precond=kind, device=CPU,
                     mstate=[np.asarray(a) for a in J._mstate])
    xc = C.solve(b, criteria=StoppingCriteria(**crit))
    assert C.stats.niterations == J.stats.niterations
    assert np.linalg.norm(xc - xj) <= 1e-10 * np.linalg.norm(xj)
    if kind != "bjacobi:8":
        S = TorchCGSolver(device_matrix_from_csr(a24, device=CPU),
                          pipelined=pipelined, precond=kind, device=CPU,
                          mstate=(None if kind == "jacobi" else
                                  tuple(a[:1] for a in T._mstate)))
        xs = S.solve(b, criteria=StoppingCriteria(**crit))
        assert abs(S.stats.niterations - T.stats.niterations) <= 2
        np.testing.assert_allclose(xt, xs, rtol=1e-5, atol=1e-8)


def test_stacked_operator_jacobi_equals_assembled():
    """arm_matfree: the operator's host diagonal sliced per part gives the
    assembled stacked Jacobi state bitwise, and the same solve."""
    csr = _aniso(16, 0.1)
    b = np.ones(csr.shape[0])
    part = partition_rows(csr, 3, seed=0, method="band")
    xs = []
    for armed in (False, True):
        prob = DistributedProblem.build(csr, part, 3)
        if armed:
            arm_matfree(prob, aniso2d_stencil(16, 0.1, dtype=torch.float64,
                                              device=CPU))
        s = DistCGSolver(prob, precond="jacobi", device=CPU)
        xs.append((s.solve(b, criteria=StoppingCriteria(
            maxits=2000, residual_rtol=1e-10)), s._mstate[0]))
    assert torch.equal(xs[0][1], xs[1][1])
    assert np.array_equal(xs[0][0], xs[1][0])
    with pytest.raises(AcgError, match="bjacobi factors stored local"):
        DistCGSolver(prob, precond="bjacobi", device=CPU).solve(b)


# -- the CLI ----------------------------------------------------------------

def _line(text, key):
    return next(line for line in text.splitlines()
                if line.strip().startswith(key + ":"))


def _section(text, name):
    """The indented lines of a top-level stats section."""
    lines = text.splitlines()
    i = lines.index(f"{name}:")
    out = []
    for ln in lines[i + 1:]:
        if not ln.startswith("  "):
            break
        out.append(ln)
    assert out
    return out


@pytest.mark.parametrize("extra", [
    ["--precond", "jacobi"], ["--precond", "bjacobi:8"],
    ["--precond", "jacobi", "--solver", "acg-pipelined"],
    ["--precond", "jacobi", "--operator", "stencil"],
    ["--precond", "cheby:3", "--nparts", "3", "--comm", "dma"],
    ["--precond", "bjacobi:8", "--nparts", "3"],
    ["--precond", "cheby:2", "--nparts", "3", "--solver",
     "acg-pipelined"]])
def test_cli_precond_matches_jax_cli(tmp_path, capsys, extra):
    """--precond through both CLIs on gen:poisson2d:20 --aniso 0.1: the
    same iteration lines and precond: section, x within 1e-10."""
    common = ["gen:poisson2d:20", "--aniso", "0.1",
              "--manufactured-solution", "--max-iterations", "3000",
              "--residual-rtol", "1e-10", "--warmup", "0"] + extra
    if "--nparts" not in extra:
        common += ["--comm", "none"]
    jx, tx = tmp_path / "j.bin", tmp_path / "t.bin"
    assert jax_main(common + ["-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(common + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    assert _line(terr, "iterations") == _line(jerr, "iterations")
    assert _section(terr, "precond") == _section(jerr, "precond")
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


def test_cli_precond_cheby_single_part(capsys):
    """Single-part cheby estimates its own interval: it converges with
    the JAX CLI's iterations within one."""
    argv = ["gen:poisson2d:20", "--aniso", "0.1", "--manufactured-solution",
            "--max-iterations", "3000", "--residual-rtol", "1e-10",
            "--warmup", "0", "-q", "--precond", "cheby:4"]
    assert jax_main(argv + ["--comm", "none"]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(argv + ["--device", "cpu"]) == 0
    terr = capsys.readouterr().err
    its = [int(_line(e, "iterations").split(":")[1]) for e in (jerr, terr)]
    assert abs(its[0] - its[1]) <= 1
    assert float(_line(terr, "error 2-norm").split(":")[1]) < 1e-8


@pytest.mark.parametrize("extra", [
    ["--precond", "cheby"], ["--precond", "jacobi", "--kernels", "fused"],
    ["--precond", "jacobi", "--replace-every", "4", "--dtype", "bf16"]])
def test_cli_precond_refusals_match_jax(capsys, extra):
    argv = ["gen:poisson2d:8", "--warmup", "0", "-q"] + extra
    msgs = []
    for main, more, prog in ((jax_main, ["--comm", "none"], "acg-tpu: "),
                             (torch_main, ["--device", "cpu"],
                              "acg-tpu-torch: ")):
        with pytest.raises(SystemExit) as e:
            main(argv + more)
        assert str(e.value.code).startswith(prog)
        msgs.append(str(e.value.code)[len(prog):])
    assert msgs[0] == msgs[1]
