"""The port's --profile-ops replay (acg_tpu_torch.solvers.profile)
against the JAX package's: the same op classes and op counts, positive
per-call seconds, the stats rows scaled from them, and the refinement
driver unwrapped."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dev_matrix
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.profile import profile_ops as jax_profile_ops
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
from acg_tpu_torch.solvers.profile import profile_ops
from acg_tpu_torch.solvers.refine import RefinedSolver

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def csr():
    return JaxSymCsr.from_mtx(jax_poisson_mtx(16, dim=2)).to_csr()


def _pair(csr, tier, **kw):
    if tier == "single":
        return (JaxCGSolver(jax_dev_matrix(csr, dtype=jnp.float64),
                            kernels="xla", **kw),
                TorchCGSolver(device_matrix_from_csr(
                    csr, dtype=torch.float64, device="cpu"), device="cpu",
                    kernels="pallas", **kw))
    part = partition_rows(csr, 4, seed=0, method="band")
    return (JaxDistCG(JaxProblem.build(csr, part, 4, dtype=jnp.float64),
                      **kw),
            DistCGSolver(DistributedProblem.build(csr, part, 4),
                         comm="dma", device="cpu", **kw))


@pytest.mark.parametrize("tier,kw", [("single", {}),
                                     ("single", {"precond": "jacobi"}),
                                     ("stacked", {}),
                                     ("stacked", {"precond": "jacobi"})])
def test_profile_ops_matches_the_references_keys(csr, tier, kw):
    b = np.ones(csr.shape[0])
    J, T = _pair(csr, tier, **kw)
    J.solve(b, criteria=JaxCrit(maxits=20))
    T.solve(b, criteria=StoppingCriteria(maxits=20))
    jc = jax_profile_ops(J, b, reps=2)
    tc = profile_ops(T, b, reps=2)
    assert set(tc) == set(jc)
    assert tc["chain_overhead"] == tc["axpy"] and tc["dispatch"] > 0
    assert all(v > 0 for v in tc.values())
    for op in set(tc) - {"chain_overhead", "dispatch"}:
        assert T.stats.ops[op].n == J.stats.ops[op].n, op
        assert T.stats.ops[op].t == pytest.approx(
            tc[op] * T.stats.ops[op].n)


def test_profile_ops_unwraps_the_refinement_driver(csr):
    inner = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float32,
                                                 device="cpu"),
                          device="cpu")
    solver = RefinedSolver(inner, csr)
    b = np.ones(csr.shape[0])
    solver.solve(b, criteria=StoppingCriteria(maxits=50,
                                              residual_rtol=1e-6))
    per_call = profile_ops(solver, b, reps=2)
    assert per_call["gemv"] > 0 and inner.stats.ops["gemv"].t > 0


def test_cli_profile_ops_reports_its_terms(capsys):
    assert torch_main(["gen:poisson2d:16", "--device", "cpu", "-q",
                       "--warmup", "0", "--max-iterations", "300",
                       "--residual-rtol", "1e-8", "--profile-ops", "2"]) == 0
    err = capsys.readouterr().err
    line = next(ln for ln in err.splitlines()
                if ln.startswith("per-op replay (seconds a call): "))
    ops = dict(kv.split() for kv in line.split(": ", 1)[1].split(", "))
    assert set(ops) == {"gemv", "dot", "nrm2", "axpy", "copy"}
    assert "chain_overhead" in err and "dispatch" in err
    gemv = next(ln for ln in err.splitlines()
                if ln.strip().startswith("gemv:"))
    assert float(gemv.split()[1]) > 0
