"""The port's distributed fused tier (``DistCGSolver(kernels="fused")``,
``--kernels fused --nparts N``) against the JAX package's
(``tests/test_fused_dist.py``), on the conftest's CPU mesh.

The interior/border split is bitwise JAX's; the port's overlapped SpMV
(the per-row form on the CPU) is bitwise its unsplit SpMV for DIA, ELL
and matrix-free local blocks under both transports, so the fused solves
take exactly the port's unsplit iterations and bits.  Against JAX's
fused tier the f64 solves take the same iterations with x within 1e-10
relative (the per-part dots sum in another order, and XLA:CPU contracts
multiply-adds).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.cli import main as jax_main
from acg_tpu.io.generators import irregular_spd_coo as jax_irregular
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.ops.operator import poisson_stencil as jax_poisson_stencil
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.parallel.dist import arm_matfree as jax_arm_matfree
from acg_tpu.parallel.dist import interior_border_split as jax_split
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.io.generators import irregular_spd_coo, poisson_mtx
from acg_tpu_torch.io.mtxfile import read_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.operator import poisson_stencil
from acg_tpu_torch.parallel.dist import (DistCGSolver, DistributedProblem,
                                         arm_matfree, interior_border_split,
                                         make_dist_spmv)
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
NPARTS = 4
# the local block formats: 20 x 20 Poisson on bands (DIA), 16 x 16 on a
# graph partition (ELL), the 20 x 20 bands with the stencil armed
FORMATS = {"dia": (20, "band", False), "ell": (16, "graph", False),
           "matfree": (20, "band", True)}


def _csr(n):
    csr = SymCsrMatrix.from_mtx(poisson_mtx(n, dim=2)).to_csr()
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(n, dim=2)).to_csr()
    assert (csr != jcsr).nnz == 0
    return csr


_PROBLEMS = {}


def _problems(fmt):
    """(csr, port problem, JAX problem) of a FORMATS entry, built once."""
    if fmt not in _PROBLEMS:
        n, method, matfree = FORMATS[fmt]
        csr = _csr(n)
        part = partition_rows(csr, NPARTS, seed=0, method=method)
        prob = DistributedProblem.build(csr, part, NPARTS)
        jprob = JaxProblem.build(csr, part, NPARTS, dtype=jnp.float64)
        if matfree:
            arm_matfree(prob, poisson_stencil(n, 2, dtype=torch.float64,
                                              device=CPU))
            jax_arm_matfree(jprob, jax_poisson_stencil(n, 2,
                                                       dtype=jnp.float64))
        assert prob.local.format == fmt == jprob.local.format
        _PROBLEMS[fmt] = (csr, prob, jprob)
    return _PROBLEMS[fmt]


def _rhs(csr, seed=1):
    return np.random.default_rng(seed).standard_normal(csr.shape[0])


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_split_matches_jax_and_partitions_owned_rows(fmt):
    """The interior rows are bitwise JAX's, and interior + border (the
    ghost block's coupled rows) partition each part's owned rows."""
    _, prob, jprob = _problems(fmt)
    irows = interior_border_split(prob)
    want = jax_split(jprob)
    assert irows.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(irows, want)
    brows = prob.ghost.rows
    for p, s in enumerate(prob.subs):
        ir = irows[p][irows[p] < prob.nmax_owned]
        br = brows[p][brows[p] < prob.nmax_owned]
        assert ir.size and br.size and np.intersect1d(ir, br).size == 0
        np.testing.assert_array_equal(np.sort(np.concatenate([ir, br])),
                                      np.arange(s.nowned))


@pytest.mark.parametrize("fmt", ["dia", "ell", "matfree"])
@pytest.mark.parametrize("comm", ["xla", "dma"])
def test_overlapped_spmv_bitwise_equals_unsplit(fmt, comm):
    csr, prob, _ = _problems(fmt)
    s = DistCGSolver(prob, kernels="fused", comm=comm, device=CPU)
    assert s.kernels == "fused-plain"
    unsplit = make_dist_spmv(prob, s._la, s._ga, s._halo, s._scnt, comm,
                             False, torch.zeros((NPARTS, NPARTS, max(
                                 prob.halo.maxcnt, 1)), dtype=torch.float64))
    x = torch.from_numpy(prob.scatter(_rhs(csr, 3)))
    y = s._spmv()(x)
    assert torch.equal(y, unsplit(x))
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0


_JAX_CACHE = {}


def _jax_fused(fmt, pipelined, comm, b, crit):
    key = (fmt, pipelined, comm, crit.maxits, crit.residual_rtol)
    if key not in _JAX_CACHE:
        _, _, jprob = _problems(fmt)
        s = JaxDistCG(jprob, pipelined=pipelined, kernels="fused",
                      comm=comm)
        x = s.solve(b, criteria=JaxCrit(maxits=crit.maxits,
                                        residual_rtol=crit.residual_rtol))
        _JAX_CACHE[key] = (np.asarray(x, np.float64), s.stats)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("fmt", ["dia", "ell", "matfree"])
@pytest.mark.parametrize("comm", ["xla", "dma"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_fused_solve_matches_jax_fused_tier(fmt, comm, pipelined):
    """JAX's fused-tier iterations, x within 1e-10; and the port's fused
    solve is bitwise its unsplit solve (the same per-row arithmetic)."""
    csr, prob, _ = _problems(fmt)
    b = _rhs(csr)
    crit = StoppingCriteria(maxits=200, residual_rtol=1e-9)
    xj, jst = _jax_fused(fmt, pipelined, comm, b, crit)
    T = DistCGSolver(prob, pipelined=pipelined, comm=comm, kernels="fused",
                     device=CPU)
    xt = T.solve(b, criteria=crit)
    assert T.stats.converged and jst.converged
    assert T.stats.niterations == jst.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    U = DistCGSolver(prob, pipelined=pipelined, comm=comm, kernels="xla",
                     device=CPU)
    xu = U.solve(b, criteria=crit)
    assert U.stats.niterations == T.stats.niterations
    np.testing.assert_array_equal(xt, xu)
    for key in ("gemv", "dot", "allreduce", "halo"):
        assert T.stats.ops[key].n == U.stats.ops[key].n


def test_fused_single_part_runs_plain():
    """One part, no halo: the fused tier runs its local block alone and
    matches the xla tier bitwise (the reference's own pin of this holds
    only to 3.6e-15 under XLA:CPU's contractions)."""
    csr = _csr(12)
    prob = DistributedProblem.build(csr, np.zeros(csr.shape[0], np.int64), 1)
    assert not prob.halo.has_ghosts
    b = np.ones(csr.shape[0])
    crit = StoppingCriteria(maxits=100, residual_rtol=1e-9)
    x_ref = DistCGSolver(prob, kernels="xla", device=CPU).solve(
        b, criteria=crit)
    x = DistCGSolver(prob, kernels="fused", device=CPU).solve(b,
                                                             criteria=crit)
    np.testing.assert_array_equal(x, x_ref)


def _messages(fn_jax, fn_torch):
    out = []
    for fn in (fn_jax, fn_torch):
        with pytest.raises(ValueError) as e:
            fn()
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("option,value", [
    ("precise_dots", True), ("precond", "jacobi"), ("algorithm", "sstep:4")])
def test_fused_refusals_match_jax(option, value):
    _, prob, jprob = _problems("dia")
    jmsg, tmsg = _messages(
        lambda: JaxDistCG(jprob, kernels="fused", **{option: value}),
        lambda: DistCGSolver(prob, kernels="fused", device=CPU,
                             **{option: value}))
    assert tmsg == jmsg and "kernels='fused'" in tmsg


def test_fused_refuses_replace_every_on_bf16_vectors():
    csr, prob, _ = _problems("dia")
    part = partition_rows(csr, NPARTS, seed=0, method="band")
    bprob = DistributedProblem.build(csr, part, NPARTS,
                                     dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"kernels='fused' \(dist\) does "
                                         r"not compose with replace_every"):
        DistCGSolver(bprob, kernels="fused", replace_every=8, device=CPU)


def test_fused_refuses_diff_criteria():
    csr, prob, _ = _problems("dia")
    s = DistCGSolver(prob, kernels="fused", device=CPU)
    with pytest.raises(ValueError, match="kernels='fused' supports "
                                         "residual criteria only"):
        s.solve(np.ones(prob.n), criteria=StoppingCriteria(maxits=10,
                                                           diff_atol=1e-3))


def test_fused_refuses_binnedell_local_blocks():
    """The length-binned layout has no per-row gather form: refused at
    setup with the reference's message."""
    r, c, v, N = irregular_spd_coo(600, avg_degree=7.0, seed=0)
    jr, jc, jv, _ = jax_irregular(600, avg_degree=7.0, seed=0)
    assert np.array_equal(r, jr) and np.array_equal(v, jv)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    part = partition_rows(csr, NPARTS, seed=0, method="graph")
    prob = DistributedProblem.build(csr, part, NPARTS, dtype=torch.float32)
    jprob = JaxProblem.build(csr, part, NPARTS, dtype=jnp.float32)
    assert prob.local.format == jprob.local.format == "binnedell"
    jmsg, tmsg = _messages(lambda: JaxDistCG(jprob, kernels="fused"),
                           lambda: DistCGSolver(prob, kernels="fused",
                                                device=CPU))
    assert tmsg == jmsg


def _line(text, key):
    return next(line for line in text.splitlines()
                if line.strip().startswith(key + ":"))


@pytest.mark.parametrize("extra", [["--comm", "dma"],
                                   ["--solver", "acg-pipelined"]])
def test_cli_fused_nparts_matches_jax_cli(tmp_path, capsys, extra):
    argv = ["gen:poisson2d:20", "--nparts", "4", "--kernels", "fused",
            "--manufactured-solution", "--max-iterations", "500",
            "--residual-rtol", "1e-10", "--warmup", "0"] + extra
    jx, tx = tmp_path / "jax.bin", tmp_path / "torch.bin"
    assert jax_main(argv + ["-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(argv + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    for key in ("iterations", "MPI_HaloExchange", "MPI_Allreduce"):
        assert _line(terr, key) == _line(jerr, key)
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    err = float(_line(terr, "error 2-norm").split(":")[1])
    assert err < 1e-8


def test_cli_fused_refusals_match_jax(capsys):
    """Each CLI refusal of --kernels fused is the reference's."""
    for extra in (["--precond", "jacobi"], ["--algorithm", "sstep:4"],
                  ["--nrhs", "3"]):
        codes = []
        for main, more in ((jax_main, []), (torch_main, ["--device",
                                                         "cpu"])):
            with pytest.raises(SystemExit) as e:
                main(["gen:poisson2d:12", "--nparts", "4", "--kernels",
                      "fused", "--warmup", "0"] + extra + more)
            codes.append(str(e.value.code).split(": ", 1)[1])
        assert codes[0] == codes[1], codes
