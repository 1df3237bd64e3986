"""The port's batched multi-RHS tier (acg_tpu_torch.solvers.batched,
``--nrhs``, ``--block-cg``) against the JAX package's on the CPU.

Tolerances, and why: the port sums each column dot with one column
reduction, which adds in another order than ``torch.dot`` (the single-RHS
solver) and than XLA:CPU (the JAX batched solver), so the columns are
held to the same per-column iteration counts and to x within 1e-10
relative of JAX (1e-12 of the port's single-RHS solve), not to bits.
Block CG's B x B solves pivot as LAPACK does, not as XLA does: x within
1e-8 and the block trip count within 2 of JAX's and of the host oracle's,
as the JAX package holds its own device and host block recurrences.
The multi-column SpMV on DIA planes and the matrix-free apply multiply
element for element as the single-column forms do, so those are held
bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.io.generators import (aniso_poisson2d_coo, batched_rhs,
                                   poisson2d_coo)
from acg_tpu.matrix import SymCsrMatrix
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dm
from acg_tpu.solvers.batched import BatchedCGSolver as JaxBatched
from acg_tpu.solvers.batched import spmv_multi as jax_spmv_multi
from acg_tpu.solvers.host_cg import host_block_cg
from acg_tpu.solvers.stats import StoppingCriteria as JCrit
from acg_tpu_torch.ops.spmv import device_matrix_from_csr as torch_dm
from acg_tpu_torch.solvers.batched import BatchedCGSolver, spmv_multi
from acg_tpu_torch.solvers.cg import TorchCGSolver
from acg_tpu_torch.solvers.stats import StoppingCriteria

KW = dict(maxits=500, residual_rtol=1e-10)
CRIT = StoppingCriteria(**KW)


@pytest.fixture(scope="module")
def sys16():
    r, c, v, N = poisson2d_coo(16)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    return csr, torch_dm(csr, dtype=torch.float64, device="cpu"), \
        batched_rhs(N, 3, seed=0)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("fmt", ["dia", "ell", "coo", "bell"])
def test_spmv_multi_matches_jax(sys16, fmt):
    csr, _, B = sys16
    Aj = jax_dm(csr, dtype=jnp.float64, format=fmt)
    At = torch_dm(csr, dtype=torch.float64, format=fmt, device="cpu")
    Yj = np.asarray(jax_spmv_multi(Aj, jnp.asarray(B)))
    Yt = spmv_multi(At, torch.from_numpy(B)).numpy()
    if fmt == "dia":
        assert np.array_equal(Yt, Yj)
    else:
        np.testing.assert_allclose(Yt, Yj, rtol=0, atol=1e-14)
    # every column equals the single-vector SpMV of the same format
    from acg_tpu_torch.ops.spmv import spmv
    for j in range(B.shape[1]):
        yj = spmv(At, torch.from_numpy(B[:, j].copy())).numpy()
        np.testing.assert_allclose(Yt[:, j], yj, rtol=0, atol=1e-14)


@pytest.mark.parametrize("mode,precond", [
    ("batched", None), ("pipelined", None), ("batched", "jacobi"),
    ("batched", "bjacobi:8"), ("pipelined", "jacobi"),
])
def test_batched_matches_jax(sys16, mode, precond):
    csr, At, B = sys16
    Aj = jax_dm(csr, dtype=jnp.float64)
    sj = JaxBatched(Aj, mode=mode, precond=precond)
    Xj = sj.solve(B, criteria=JCrit(**KW))
    st = BatchedCGSolver(At, mode=mode, precond=precond, device="cpu")
    Xt = st.solve(B, criteria=CRIT)
    assert st.stats.batch["iterations"] == sj.stats.batch["iterations"]
    assert st.stats.niterations == sj.stats.niterations
    assert _rel(Xt, Xj) <= 1e-10


@pytest.mark.parametrize("mode", ["batched", "pipelined"])
@pytest.mark.parametrize("precond", [None, "cheby:3"])
def test_batched_matches_single_rhs_solver(sys16, mode, precond):
    _, At, B = sys16
    s = BatchedCGSolver(At, mode=mode, precond=precond, device="cpu")
    X = s.solve(B, criteria=CRIT)
    for j in range(3):
        s1 = TorchCGSolver(At, kernels="xla", device="cpu",
                           pipelined=mode == "pipelined", precond=precond)
        x1 = s1.solve(B[:, j], criteria=CRIT)
        assert s.stats.batch["iterations"][j] == s1.stats.niterations
        assert _rel(X[:, j], x1) <= 1e-12


def test_single_column_delegates_bitwise(sys16):
    _, At, B = sys16
    s = BatchedCGSolver(At, device="cpu")
    X = s.solve(B[:, :1], criteria=CRIT)
    s1 = TorchCGSolver(At, kernels="xla", device="cpu")
    x1 = s1.solve(B[:, 0], criteria=CRIT)
    assert X.shape == (B.shape[0], 1) and np.array_equal(X[:, 0], x1)
    assert s.stats.batch["nrhs"] == 1
    assert s.stats.batch["iterations"] == [s1.stats.niterations]


def test_converged_column_freezes(sys16):
    """A column converged at entry (x0 = its solution, absolute
    tolerance) stays bitwise frozen at 0 iterations."""
    csr, At, B = sys16
    x0 = np.zeros_like(B)
    x0[:, 0] = np.linalg.solve(csr.toarray(), B[:, 0])
    s = BatchedCGSolver(At, device="cpu")
    X = s.solve(B, x0=x0, criteria=StoppingCriteria(maxits=300,
                                                    residual_atol=1e-8))
    batch = s.stats.batch
    assert batch["iterations"][0] == 0
    assert np.array_equal(X[:, 0], x0[:, 0])
    assert all(batch["converged"])
    assert batch["iterations"][1] > 0 and batch["iterations"][2] > 0


@pytest.mark.parametrize("mode", ["batched", "pipelined"])
def test_early_converged_column_stays_frozen(sys16, mode):
    """A column that converges mid-run freezes: its value at the end of
    the run equals its value in a run cut at its own iteration count,
    while the batch ran on to its slowest column (and the iteration
    counts are JAX's)."""
    csr, At, B = sys16
    Bs = B.copy()
    Bs[:, 1] *= 1e-3
    crit = StoppingCriteria(maxits=500, residual_atol=1e-3)
    s = BatchedCGSolver(At, mode=mode, device="cpu")
    X = s.solve(Bs, criteria=crit)
    its = s.stats.batch["iterations"]
    assert its[1] < its[0] and its[1] < its[2]
    cut = BatchedCGSolver(At, mode=mode, device="cpu")
    Xc = cut.solve(Bs, criteria=StoppingCriteria(maxits=its[1],
                                                 residual_atol=1e-3),
                   raise_on_divergence=False)
    assert np.array_equal(X[:, 1], Xc[:, 1])
    sj = JaxBatched(jax_dm(csr, dtype=jnp.float64), mode=mode)
    sj.solve(Bs, criteria=JCrit(maxits=500, residual_atol=1e-3))
    assert its == sj.stats.batch["iterations"]


def test_unbounded_runs_exactly_maxits(sys16):
    _, At, B = sys16
    s = BatchedCGSolver(At, device="cpu")
    s.solve(B, criteria=StoppingCriteria(maxits=37))
    assert s.stats.niterations == 37
    assert s.stats.batch["iterations"] == [37, 37, 37]
    assert all(s.stats.batch["converged"])


def test_block_cg_matches_jax_and_host_oracle(sys16):
    csr, At, B = sys16
    s = BatchedCGSolver(At, mode="block", device="cpu")
    X = s.solve(B, criteria=CRIT)
    sj = JaxBatched(jax_dm(csr, dtype=jnp.float64), mode="block")
    Xj = sj.solve(B, criteria=JCrit(**KW))
    Xh, _, _, trips_h = host_block_cg(csr, B, criteria=JCrit(**KW))
    Xd = np.linalg.solve(csr.toarray(), B)
    for ref in (Xj, Xh, Xd):
        np.testing.assert_allclose(X, ref, rtol=0, atol=1e-8)
    trips = s.stats.batch["block_iterations"]
    assert abs(trips - sj.stats.batch["block_iterations"]) <= 2
    assert abs(trips - trips_h) <= 2
    assert s.stats.batch["total_iterations"] == 3 * trips


def test_block_cg_beats_independent_on_aniso():
    """Block-CG total iterations (trips x B) <= 0.7x the summed
    iterations of B independent solves on the anisotropic family (the
    JAX package's acceptance)."""
    r, c, v, N = aniso_poisson2d_coo(48, 0.05)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    A = torch_dm(csr, dtype=torch.float64, device="cpu")
    B = batched_rhs(N, 8, seed=0)
    crit = StoppingCriteria(maxits=20000, residual_rtol=1e-8)
    s = BatchedCGSolver(A, mode="block", device="cpu")
    X = s.solve(B, criteria=crit)
    trips = s.stats.batch["block_iterations"]
    batched = BatchedCGSolver(A, device="cpu")
    batched.solve(B, criteria=crit)
    indep = batched.stats.batch["iterations_sum"]
    assert trips * 8 <= 0.7 * indep, (trips, indep)
    res = np.linalg.norm(B - csr @ X, axis=0)
    assert (res <= 1e-8 * np.linalg.norm(B, axis=0) * 1.01).all()


def test_block_cg_deflates_parallel_rhs(sys16):
    csr, At, B = sys16
    Bp = np.column_stack([B[:, 0], 2.0 * B[:, 0], B[:, 1]])
    s = BatchedCGSolver(At, mode="block", device="cpu")
    X = s.solve(Bp, criteria=StoppingCriteria(maxits=500,
                                              residual_rtol=1e-8))
    assert np.isfinite(X).all()
    np.testing.assert_allclose(X, np.linalg.solve(csr.toarray(), Bp),
                               rtol=0, atol=1e-6)
    assert all(s.stats.batch["converged"])


@pytest.mark.parametrize("aniso", [None, 0.1])
@pytest.mark.parametrize("mode", ["batched", "pipelined", "block"])
def test_matfree_batched_equals_assembled(mode, aniso):
    """The multi-column stencil apply is the assembled DIA SpMV element
    for element: the same bits in every mode."""
    from acg_tpu_torch.io.generators import (aniso_poisson2d_coo as a2d,
                                             poisson2d_coo as p2d)
    from acg_tpu_torch.matrix import SymCsrMatrix as TSym
    from acg_tpu_torch.ops.operator import aniso2d_stencil, poisson_stencil
    n = 16
    r, c, v, N = p2d(n) if aniso is None else a2d(n, aniso)
    csr = TSym.from_coo(N, r, c, v).to_csr()
    A = torch_dm(csr, dtype=torch.float64, device="cpu")
    op = (poisson_stencil(n, 2, torch.float64, device="cpu")
          if aniso is None
          else aniso2d_stencil(n, aniso, torch.float64, device="cpu"))
    B = batched_rhs(N, 3, seed=1)
    assert torch.equal(spmv_multi(op, torch.from_numpy(B)),
                       spmv_multi(A, torch.from_numpy(B)))
    xa = BatchedCGSolver(A, mode=mode, device="cpu").solve(B, criteria=CRIT)
    xo = BatchedCGSolver(op, mode=mode, device="cpu").solve(B,
                                                            criteria=CRIT)
    assert np.array_equal(xa, xo)


def test_solver_refusals(sys16):
    _, At, _ = sys16
    with pytest.raises(ValueError, match="kernels='pallas' is single-RHS"):
        BatchedCGSolver(At, kernels="pallas", device="cpu")
    with pytest.raises(ValueError, match="precise_dots applies"):
        BatchedCGSolver(At, mode="block", precise_dots=True, device="cpu")
    for kw, what in ((dict(trace=4), "telemetry.py"),
                     (dict(ckpt=object()), "checkpoint.py")):
        if "trace" in kw:
            # the per-RHS ring is ported: it arms, and a negative size
            # still refuses
            assert BatchedCGSolver(At, device="cpu", **kw).trace == 4
            with pytest.raises(ValueError, match="trace/progress"):
                BatchedCGSolver(At, device="cpu", trace=-1)
            continue
        with pytest.raises(ValueError, match=what):
            BatchedCGSolver(At, device="cpu", **kw)
    from acg_tpu_torch.errors import AcgError
    with pytest.raises(AcgError, match="residual criteria only"):
        BatchedCGSolver(At, device="cpu").solve(
            np.ones((At.nrows, 2)),
            criteria=StoppingCriteria(maxits=5, diff_atol=1e-3))


def test_precise_dots_batched(sys16):
    _, At, B = sys16
    s = BatchedCGSolver(At, precise_dots=True, device="cpu")
    X = s.solve(B, criteria=CRIT)
    for j in range(3):
        s1 = TorchCGSolver(At, kernels="xla", device="cpu",
                           precise_dots=True)
        x1 = s1.solve(B[:, j], criteria=CRIT)
        assert s.stats.batch["iterations"][j] == s1.stats.niterations
        assert _rel(X[:, j], x1) <= 1e-12


# -- the CLI --------------------------------------------------------------

_REFUSAL_CASES = [
    ["--nrhs", "3", "--refine"],
    ["--nrhs", "3", "--kernels", "pallas", "--replace-every", "5"],
    ["--nrhs", "3", "--comm", "dma", "--diff-rtol", "1e-3"],
    ["--nrhs", "3", "--output-comm-matrix", "--kernels", "fused"],
    ["--nrhs", "3", "--solver", "host"],
    ["--block-cg"],
    ["--nrhs", "-1"],
    # the JAX CLI's default part count is the device count, the port's 1
    ["--nrhs", "3", "--block-cg", "--operator", "stencil", "--nparts", "1"],
    ["--nrhs", "3", "--operator", "stencil", "--nparts", "4"],
]


@pytest.mark.parametrize("flags", _REFUSAL_CASES)
def test_cli_refusals_match_jax(flags, capsys):
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main as torch_main
    msgs = []
    for main, extra, prog in ((jax_main, [], "acg-tpu: "),
                              (torch_main, ["--device", "cpu"],
                               "acg-tpu-torch: ")):
        with pytest.raises(SystemExit) as e:
            main(["gen:poisson2d:8", "--warmup", "0", "-q"] + flags + extra)
        msgs.append(str(e.value.code).replace(prog, ""))
    assert msgs[0] == msgs[1]


def test_cli_refuses_batched_parts_by_name(capsys):
    """--nrhs on stacked parts runs the batched multi-part tier
    (tests/test_torch_dist_batched.py holds it against acg_tpu); block
    CG on parts stays refused by name, as the reference refuses it."""
    from acg_tpu_torch.cli import main as torch_main
    assert torch_main(["gen:poisson2d:8", "--device", "cpu", "--nrhs", "2",
                       "--nparts", "2", "--warmup", "0", "-q"]) == 0
    assert "  nrhs: 2" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--block-cg is a single-device "
                                         "tier"):
        torch_main(["gen:poisson2d:8", "--device", "cpu", "--nrhs", "2",
                    "--nparts", "2", "--block-cg"])


def _block_lines(err: str):
    keep = ("  iterations:", "batch:", "  nrhs:", "  mode:",
            "  iterations_max:", "  iterations_sum:", "  unconverged:",
            "  block_iterations:", "  total_iterations:", "solves:",
            "total iterations:", "unknowns:")
    return [ln for ln in err.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("extra", [[], ["--solver", "acg-pipelined"],
                                   ["--precond", "jacobi"],
                                   ["--manufactured-solution"],
                                   ["--operator", "stencil"]])
def test_cli_nrhs_matches_jax_cli(tmp_path, capsys, extra):
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main as torch_main
    from acg_tpu_torch.io.mtxfile import read_mtx
    argv = ["gen:poisson2d:16", "--nrhs", "4", "--max-iterations", "500",
            "--residual-rtol", "1e-10", "--warmup", "1", "-q"] + extra
    jx, tx = tmp_path / "j.mtx", tmp_path / "t.mtx"
    assert jax_main(argv + ["--comm", "none", "-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(argv + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    assert _block_lines(terr) == _block_lines(jerr)
    assert "batch:" in terr and "  nrhs: 4" in terr
    # the norms are column reductions: the same to rounding
    for key in ("  right-hand side 2-norm:", "  initial residual 2-norm:"):
        vj, vt = (float([ln for ln in e.splitlines()
                         if ln.startswith(key)][0].split()[-1])
                  for e in (jerr, terr))
        assert vt == pytest.approx(vj, rel=1e-13)
    Xj, Xt = read_mtx(jx, binary=True), read_mtx(tx, binary=True)
    assert (Xt.nrows, Xt.ncols) == (Xj.nrows, Xj.ncols) == (256, 4)
    assert _rel(np.asarray(Xt.vals), np.asarray(Xj.vals)) <= 1e-10
    if "--manufactured-solution" in extra:
        wj = [ln for ln in jerr.splitlines() if ln.startswith("worst")]
        wt = [ln for ln in terr.splitlines() if ln.startswith("worst")]
        assert len(wt) == 1 and wt[0].split("(rhs")[1] == \
            wj[0].split("(rhs")[1]


def test_cli_nrhs_reads_column_files(tmp_path, capsys):
    """b and x0 as n x B dense array files (vector_columns), the block
    CG mode, and the JAX CLI on the same files."""
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main as torch_main
    from acg_tpu_torch.io.mtxfile import (multi_vector_mtx, read_mtx,
                                          write_mtx)
    B = batched_rhs(144, 3, seed=4)
    X0 = 0.01 * batched_rhs(144, 3, seed=5)
    write_mtx(tmp_path / "b.mtx", multi_vector_mtx(B))
    write_mtx(tmp_path / "x0.mtx", multi_vector_mtx(X0))
    argv = ["gen:poisson2d:12", str(tmp_path / "b.mtx"),
            str(tmp_path / "x0.mtx"), "--nrhs", "3", "--block-cg",
            "--max-iterations", "500", "--residual-rtol", "1e-10",
            "--warmup", "0", "-q"]
    assert jax_main(argv + ["--comm", "none", "-o",
                            str(tmp_path / "j.mtx")]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(argv + ["--device", "cpu", "-o",
                              str(tmp_path / "t.mtx")]) == 0
    terr = capsys.readouterr().err
    assert "  mode: block" in terr
    bj = [ln for ln in jerr.splitlines() if "block_iterations" in ln][0]
    bt = [ln for ln in terr.splitlines() if "block_iterations" in ln][0]
    assert abs(int(bj.split()[-1]) - int(bt.split()[-1])) <= 2
    Xj = np.asarray(read_mtx(tmp_path / "j.mtx", binary=True).vals)
    Xt = np.asarray(read_mtx(tmp_path / "t.mtx", binary=True).vals)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-8)
    assert torch_main(argv[:3] + ["--nrhs", "2", "--device", "cpu",
                                  "-q"]) == 1
    assert "needs a 144 x 2 array file" in capsys.readouterr().err


# -- the per-RHS ring and the heartbeat -----------------------------------

@pytest.mark.parametrize("mode", ["batched", "pipelined", "block"])
@pytest.mark.parametrize("window", [512, 16])
def test_batched_ring_matches_jax(sys16, mode, window):
    """The per-RHS residual ring (BatchedConvergenceTrace) records each
    loop iteration's column norms, as the reference's does (wrapped
    windows included): the frozen steps past the last column's
    convergence leave it alone."""
    csr, At, B = sys16
    sj = JaxBatched(jax_dm(csr, dtype=jnp.float64), mode=mode,
                    trace=window)
    sj.solve(B, criteria=JCrit(**KW))
    st = BatchedCGSolver(At, mode=mode, trace=window, device="cpu")
    st.solve(B, criteria=CRIT)
    tj, tt = sj.last_trace, st.last_trace
    assert st.stats.trace is tt
    assert (tt.capacity, tt.niterations, tt.nrhs, tt.wrapped,
            tt.solver) == (tj.capacity, tj.niterations, tj.nrhs,
                           tj.wrapped, tj.solver)
    assert np.array_equal(tt.iterations, tj.iterations)
    rj = np.asarray(tj.records)
    # the column norms to rounding: 1e-9 of the window's largest
    np.testing.assert_allclose(tt.records, rj, rtol=1e-6,
                               atol=1e-9 * np.abs(rj).max())
    assert tt.to_dict().keys() == tj.to_dict().keys()


def test_batched_unbounded_ring_and_heartbeat(sys16, capsys):
    _, At, B = sys16
    s = BatchedCGSolver(At, trace=8, progress=5, device="cpu")
    s.solve(B, criteria=StoppingCriteria(maxits=12))
    assert s.last_trace.niterations == 12
    assert list(s.last_trace.iterations) == list(range(4, 12))
    err = capsys.readouterr().err
    its = [ln.split(": iteration ")[1].split(":")[0]
           for ln in err.splitlines() if ": iteration " in ln]
    assert its == ["5", "10"]


def test_cli_convergence_log_with_nrhs_matches_jax(tmp_path, capsys):
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main
    from acg_tpu_torch.telemetry import read_convergence_log
    argv = ["gen:poisson2d:12", "--nparts", "1", "--nrhs", "3",
            "--max-iterations", "300", "--residual-rtol", "1e-10", "-q"]
    pt, pj = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    assert main(argv + ["--device", "cpu", "--convergence-log",
                        str(pt), "--progress", "10"]) == 0
    err = capsys.readouterr().err
    assert ": iteration 10:" in err
    assert jax_main(argv + ["--convergence-log", str(pj)]) == 0
    mt, rt = read_convergence_log(pt)
    mj, rj = read_convergence_log(pj)
    assert mt["nrhs"] == mj["nrhs"] == 3
    assert [r["it"] for r in rt] == [r["it"] for r in rj]
    np.testing.assert_allclose([r["worst"] for r in rt],
                               [r["worst"] for r in rj], rtol=1e-9)
