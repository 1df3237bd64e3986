"""The port's recovery ladder (acg_tpu_torch.solvers.resilience) against
the JAX package's: the backoff sleeps, the restart budget, the stacked
tier's transport rung (dma -> xla), the host-fallback rungs of the
single-device and stacked tiers, the metric counters and telemetry
events each rung records, and p(l)'s restart rung.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu import faults as jf
from acg_tpu import metrics as jmetrics
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dm
from acg_tpu.parallel.dist import DistCGSolver as JaxDist
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.solvers import resilience as jres
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch import faults, metrics
from acg_tpu_torch.io.generators import poisson_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.precond import refresh_state, state_finite
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
from acg_tpu_torch.solvers import resilience as res
from acg_tpu_torch.solvers.resilience import RecoveryPolicy

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
KW = dict(maxits=500, residual_rtol=1e-10)


@pytest.fixture(autouse=True)
def _disarmed():
    prev = os.environ.pop(faults.ENV_VAR, None)
    faults.install(None)
    jf.install(None)
    yield
    faults.install(None)
    jf.install(None)
    if prev is not None:
        os.environ[faults.ENV_VAR] = prev


@pytest.fixture(scope="module")
def sys16():
    csr = SymCsrMatrix.from_mtx(poisson_mtx(16, dim=2)).to_csr()
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(16, dim=2)).to_csr()
    assert (csr != jcsr).nnz == 0
    b = csr @ np.random.default_rng(3).standard_normal(csr.shape[0])
    part = partition_rows(csr, 4, seed=1, method="graph", use_metis="never")
    return csr, b, part


def _kinds(st):
    return [e["kind"] for e in st.events]


def test_policy_defaults_match_the_reference():
    """The reference's defaults; the transport rung's is the reference's
    on the CPU and off on the card unless named (``fallback_comm=True``).
    The reference's ``agree_timeout`` has no counterpart: recovery is
    single-process here."""
    t, j = RecoveryPolicy(), jres.RecoveryPolicy()
    for f in ("max_restarts", "backoff", "fallback_host", "max_rollbacks"):
        assert getattr(t, f) == getattr(j, f)
    assert t.comm_fallback("cpu") == j.fallback_comm
    assert not t.comm_fallback("cuda")
    assert RecoveryPolicy(fallback_comm=True).comm_fallback("cuda")
    assert not RecoveryPolicy(fallback_comm=False).comm_fallback("cpu")
    assert not hasattr(t, "agree_timeout")


def test_backoff_sleeps_double_like_the_reference(sys16, monkeypatch):
    """The n-th restart sleeps backoff * 2**(n-1): a fault that recurs
    (the injector's shift kept from vanishing) spends the budget."""
    csr, b, _ = sys16
    calls = []
    # both packages sleep through the one time module
    monkeypatch.setattr(res.time, "sleep", calls.append)
    monkeypatch.setattr(faults.FaultSpec, "shift", lambda s, k: s)
    monkeypatch.setattr(jf.FaultSpec, "shift", lambda s, k: s)
    pol_kw = dict(max_restarts=3, backoff=0.25, fallback_host=False)
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU), device=CPU,
                      recovery=RecoveryPolicy(**pol_kw))
    J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64),
                    recovery=jres.RecoveryPolicy(**pol_kw))
    from acg_tpu.errors import BreakdownError as JB
    from acg_tpu_torch.errors import BreakdownError as TB
    with faults.injected("spmv:nan@3"), pytest.raises(TB) as te:
        T.solve(b, criteria=StoppingCriteria(**KW))
    slept_t, calls[:] = list(calls), []
    with jf.injected("spmv:nan@3"), pytest.raises(JB) as je:
        J.solve(b, criteria=JaxCrit(**KW))
    assert slept_t == calls == [0.25, 0.5, 1.0]
    assert T.stats.recovery_log == J.stats.recovery_log
    assert str(te.value).replace("torch-cg", "jax-cg") == str(je.value)


def test_transport_rung_retires_dma_like_the_reference(sys16, monkeypatch):
    """A link that keeps corrupting the dma payload (the fault kept
    armed while the solver is on dma): the first breakdown restarts,
    the second retires the transport -- its own rung, no restart
    spent -- and the solve converges on xla."""
    csr, b, part = sys16
    pol_kw = dict(max_restarts=3, fallback_host=False)
    T = DistCGSolver(DistributedProblem.build(csr, part, 4), comm="dma",
                     device=CPU, recovery=RecoveryPolicy(**pol_kw))
    J = JaxDist(JaxProblem.build(csr, part, 4, dtype=jnp.float64),
                comm="dma", recovery=jres.RecoveryPolicy(**pol_kw))
    for mod, s in ((faults, T), (jf, J)):
        orig = mod.FaultSpec.shift

        def keep(spec, consumed, s=s, orig=orig):
            return spec if s.comm == "dma" else orig(spec, consumed)

        monkeypatch.setattr(mod.FaultSpec, "shift", keep)
    with faults.injected("halo:nan@5"):
        xt = T.solve(b, criteria=StoppingCriteria(**KW))
    with jf.injected("halo:nan@5"):
        xj = np.asarray(J.solve(b, criteria=JaxCrit(**KW)))
    st, js = T.stats, J.stats
    assert T.comm == J.comm == "xla"
    assert (st.nbreakdowns, st.nrestarts, st.nfallbacks) == \
        (js.nbreakdowns, js.nrestarts, js.nfallbacks) == (2, 1, 1)
    assert st.recovery_log == js.recovery_log
    assert "fallback: halo transport dma -> xla" in st.fwrite()
    assert _kinds(st) == _kinds(js)
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


@pytest.mark.parametrize("tier", ["single", "dist"])
def test_host_fallback_rung_matches_the_reference(sys16, tier):
    csr, b, part = sys16
    pol_kw = dict(max_restarts=0)
    if tier == "single":
        T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                                 device=CPU), device=CPU,
                          recovery=RecoveryPolicy(**pol_kw),
                          host_matrix=csr)
        J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64),
                        recovery=jres.RecoveryPolicy(**pol_kw),
                        host_matrix=csr)
    else:
        T = DistCGSolver(DistributedProblem.build(csr, part, 4), device=CPU,
                         recovery=RecoveryPolicy(**pol_kw))
        J = JaxDist(JaxProblem.build(csr, part, 4, dtype=jnp.float64),
                    recovery=jres.RecoveryPolicy(**pol_kw))
    with faults.injected("spmv:nan@3"):
        xt = T.solve(b, criteria=StoppingCriteria(**KW))
    with jf.injected("spmv:nan@3"):
        xj = np.asarray(J.solve(b, criteria=JaxCrit(**KW)))
    st, js = T.stats, J.stats
    assert st.converged and st.nfallbacks == js.nfallbacks == 1
    assert st.recovery_log == js.recovery_log
    assert st.niterations == js.niterations
    assert np.array_equal(xt, xj)   # both the same f64 host oracle


@pytest.mark.parametrize("tier", ["single", "dist"])
def test_rungs_that_leave_the_kernels_are_cpu_only(sys16, tier):
    """The host rung re-solves on the CPU, so a solver on the card never
    takes it (its breakdown raises; tests/test_torch_card.py drives
    that); the transport rung, which retires K6, runs on the card only
    when the policy names it."""
    csr, _, part = sys16
    pol = RecoveryPolicy(max_restarts=0)
    if tier == "single":
        T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                                 device=CPU), device=CPU,
                          recovery=pol, host_matrix=csr)
    else:
        T = DistCGSolver(DistributedProblem.build(csr, part, 4), device=CPU,
                         comm="dma", recovery=pol)
    assert T._host_rung()
    assert T.recovery.comm_fallback(T.device)
    T.device = torch.device("cuda")
    assert not T._host_rung()
    assert not T.recovery.comm_fallback(T.device)
    T.recovery = RecoveryPolicy(fallback_comm=True)
    assert T.recovery.comm_fallback(T.device) and not T._host_rung()


def test_metrics_and_events_of_the_ladder(sys16):
    """Each rung bumps the reference's counters and records its event."""
    csr, b, _ = sys16
    metrics.arm()
    jmetrics.arm()
    try:
        counters = {"breakdowns": metrics.BREAKDOWNS,
                    "restarts": metrics.RESTARTS,
                    "fallbacks": metrics.FALLBACKS}
        before = {k: c.value for k, c in counters.items()}
        T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                                 device=CPU), device=CPU,
                          recovery=RecoveryPolicy(max_restarts=1),
                          host_matrix=csr)
        J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64),
                        recovery=jres.RecoveryPolicy(max_restarts=1),
                        host_matrix=csr)
        spec = "spmv:nan@3"
        for mod, s, crit in ((faults, T, StoppingCriteria),
                             (jf, J, JaxCrit)):
            with mod.injected(spec):
                s.solve(b, criteria=crit(**KW))
        after = {k: c.value for k, c in counters.items()}
        assert after["breakdowns"] - before["breakdowns"] == 1
        assert after["restarts"] - before["restarts"] == 1
        assert after["fallbacks"] == before["fallbacks"]
        assert _kinds(T.stats) == _kinds(J.stats)
        assert {"fault-armed", "breakdown", "restart"} <= set(
            _kinds(T.stats))
    finally:
        metrics.disarm()
        jmetrics.disarm()


def test_pl_restart_rung_keeps_its_budget():
    from acg_tpu_torch.recurrence import (PL_RESTART_BUDGET,
                                          pl_restart_policy)
    pol = pl_restart_policy()
    assert pol.max_restarts == PL_RESTART_BUDGET
    assert not pol.fallback_comm and not pol.fallback_host
    csr = SymCsrMatrix.from_mtx(poisson_mtx(8, dim=2)).to_csr()
    s = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU), device=CPU,
                      algorithm="pipelined:2")
    assert s.max_restarts == PL_RESTART_BUDGET
    own = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                               device=CPU), device=CPU,
                        algorithm="pipelined:2",
                        recovery=RecoveryPolicy(max_restarts=5))
    assert own.max_restarts == 5


def test_preconditioner_state_survives_or_rebuilds(sys16):
    csr, b, _ = sys16
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU), device=CPU,
                      precond="jacobi", recovery=RecoveryPolicy())
    T.solve(b, criteria=StoppingCriteria(maxits=5))
    driver = res.RecoveryDriver(RecoveryPolicy(), T.stats, "torch-cg")
    assert state_finite(T._mstate)
    assert refresh_state(T, driver) is False
    T._mstate = (T._mstate[0] * float("nan"),)
    assert not state_finite(T._mstate)
    assert refresh_state(T, driver) is True and state_finite(T._mstate)
    assert T.stats.recovery_log[-2:] == [
        "preconditioner (jacobi) state preserved across restart",
        "preconditioner (jacobi) state non-finite; rebuilt from the matrix"]


def test_give_up_names_the_snapshot_like_the_reference():
    from acg_tpu.solvers.stats import SolverStats as JStats
    from acg_tpu_torch.solvers.stats import SolverStats
    t = res.RecoveryDriver(RecoveryPolicy(), SolverStats(), "x")
    j = jres.RecoveryDriver(jres.RecoveryPolicy(), JStats(), "x")
    assert str(t.give_up(7, 1.5, snapshot="s.ckpt")) == \
        str(j.give_up(7, 1.5, snapshot="s.ckpt"))
    assert res.adopt_host_stats.__doc__ == jres.adopt_host_stats.__doc__
