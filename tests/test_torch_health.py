"""The port's numerical-health tier (acg_tpu_torch.health) against the
JAX package's: the in-loop true-residual audit, the stall detector, the
ABFT checksum test, the gap gates (warn, replace, abort) and the
spectrum estimate from the convergence ring, on the same systems.

Audit gaps agree within 1e-10 absolute (they are O(1e-16) on these
systems, the difference of two residuals each accurate to rounding);
counts, trips, restarts and iterations agree exactly; the spectrum's
kappa within 1e-10 relative.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu import faults as jf
from acg_tpu import health as jh
from acg_tpu.errors import BreakdownError as JaxBreakdown
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dm
from acg_tpu.parallel.dist import DistCGSolver as JaxDist
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.solvers.host_cg import HostCGSolver as JaxHost
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.resilience import RecoveryPolicy as JaxPolicy
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch import faults, health
from acg_tpu_torch.errors import BreakdownError
from acg_tpu_torch.io.generators import poisson_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
from acg_tpu_torch.solvers.host_cg import HostCGSolver
from acg_tpu_torch.solvers.resilience import RecoveryPolicy

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
KW = dict(maxits=600, residual_rtol=1e-10)


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
def sys24():
    csr = SymCsrMatrix.from_mtx(poisson_mtx(24, dim=2)).to_csr()
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(24, dim=2)).to_csr()
    assert (csr != jcsr).nnz == 0
    b = csr @ np.random.default_rng(5).standard_normal(csr.shape[0])
    return csr, b


def _pair(csr, spec_kw, pipelined=False, precond=None, trace=0,
          recovery=True):
    J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64), pipelined=pipelined,
                    precond=precond, trace=trace,
                    recovery=JaxPolicy() if recovery else None,
                    health=jh.make_spec(**spec_kw))
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU),
                      pipelined=pipelined, precond=precond, trace=trace,
                      kernels="pallas", device=CPU,
                      recovery=RecoveryPolicy() if recovery else None,
                      health=health.make_spec(**spec_kw))
    return J, T


def _same_health(th, jhd):
    assert th.keys() == jhd.keys()
    for k, v in jhd.items():
        if isinstance(v, dict):
            _same_health(th[k], v)
        elif isinstance(v, float) and v is not None and th[k] is not None:
            assert abs(th[k] - v) <= 1e-10 * max(1.0, abs(v)), k
        else:
            assert th[k] == v, k


@pytest.mark.parametrize("pipelined,precond", [(False, None), (True, None),
                                               (False, "jacobi"),
                                               (True, "jacobi")])
def test_audit_gaps_match_reference(sys24, pipelined, precond):
    csr, b = sys24
    J, T = _pair(csr, dict(every=5), pipelined, precond, trace=64,
                 recovery=False)
    xj = np.asarray(J.solve(b, criteria=JaxCrit(**KW)))
    xt = T.solve(b, criteria=StoppingCriteria(**KW))
    assert T.stats.niterations == J.stats.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    _same_health(T.stats.health, J.stats.health)
    assert T.stats.health["naudits"] == T.stats.niterations // 5
    # the ring's gap column: the same audited rows, NaN elsewhere
    tt, jt = T.last_trace, J.last_trace
    assert tt.fields == jt.fields and tt.fields[-1] == "gap"
    gt, gj = tt.records[:, -1], jt.records[:, -1]
    assert np.array_equal(np.isnan(gt), np.isnan(gj))
    assert np.abs(gt[~np.isnan(gt)] - gj[~np.isnan(gj)]).max() <= 1e-10


def test_stacked_audit_matches_reference(sys24):
    csr, b = sys24
    part = partition_rows(csr, 4, seed=2, method="graph", use_metis="never")
    spec = dict(every=3, abft=True)
    J = JaxDist(JaxProblem.build(csr, part, 4, dtype=jnp.float64),
                health=jh.make_spec(**spec))
    T = DistCGSolver(DistributedProblem.build(csr, part, 4), device=CPU,
                     kernels="pallas", comm="dma",
                     health=health.make_spec(**spec))
    J.solve(b, criteria=JaxCrit(**KW))
    T.solve(b, criteria=StoppingCriteria(**KW))
    assert T.stats.niterations == J.stats.niterations
    _same_health(T.stats.health, J.stats.health)
    assert T.stats.health["abft"]["ntrips"] == 0


@pytest.mark.parametrize("window", [1, 2])
def test_stall_detector_matches_reference(sys24, window):
    """CG's residual norm is not monotone: a short window trips, the
    ladder restarts, and the budget runs out the same way."""
    csr, b = sys24
    J, T = _pair(csr, dict(stall_window=window))
    outs = []
    for s, crit, err in ((J, JaxCrit, JaxBreakdown),
                         (T, StoppingCriteria, BreakdownError)):
        try:
            s.solve(b, criteria=crit(**KW))
            outs.append(None)
        except err as e:
            outs.append(str(e))
    st, js = T.stats, J.stats
    assert (st.nbreakdowns, st.nrestarts) == (js.nbreakdowns, js.nrestarts)
    assert st.recovery_log == js.recovery_log
    assert (outs[0] is None) == (outs[1] is None)
    if outs[0] is not None:
        assert outs[1].replace("torch-cg", "jax-cg") == outs[0]


@pytest.mark.parametrize("every", [1, 4, 8])
def test_abft_detects_the_flip_where_the_reference_does(sys24, every):
    csr, b = sys24
    J, T = _pair(csr, dict(every=every, abft=True))
    with jf.injected("sdc:flip@7"):
        xj = np.asarray(J.solve(b, criteria=JaxCrit(**KW)))
    with faults.injected("sdc:flip@7"):
        xt = T.solve(b, criteria=StoppingCriteria(**KW))
    st, js = T.stats, J.stats
    assert st.recovery_log == js.recovery_log
    assert "breakdown detected at iteration 8" in st.recovery_log[0]
    assert st.niterations == js.niterations
    _same_health(st.health, js.health)
    assert st.health["abft"]["ntrips"] == 1
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    assert [e["kind"] for e in st.events if e["kind"].startswith("abft")] \
        == [e["kind"] for e in js.events if e["kind"].startswith("abft")]


def test_clean_abft_solve_never_trips_and_keeps_the_bits(sys24):
    csr, b = sys24
    plain = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                                 device=CPU), device=CPU)
    x0 = plain.solve(b, criteria=StoppingCriteria(**KW))
    _, T = _pair(csr, dict(every=1, abft=True), recovery=False)
    x = T.solve(b, criteria=StoppingCriteria(**KW))
    assert T.stats.health["abft"]["ntrips"] == 0
    assert T.stats.health["abft"]["nchecks"] == T.stats.niterations
    assert T.stats.niterations == plain.stats.niterations
    assert np.array_equal(x, x0)


@pytest.mark.parametrize("action", ["replace", "abort"])
def test_gap_gates_match_reference(sys24, action):
    """A hair-trigger threshold: every audit trips; replace restarts until
    the budget is spent, abort raises at the first trip."""
    csr, b = sys24
    J, T = _pair(csr, dict(every=5, threshold=1e-30, action=action))
    with pytest.raises(JaxBreakdown) as je:
        J.solve(b, criteria=JaxCrit(**KW))
    with pytest.raises(BreakdownError) as te:
        T.solve(b, criteria=StoppingCriteria(**KW))

    def masked(msg):
        # the gap itself is rounding-level: its digits differ
        return re.sub(r"gap \S+ exceeds", "gap G exceeds",
                      msg.replace("torch-cg", "jax-cg"))

    assert masked(str(te.value)) == masked(str(je.value))
    assert T.stats.nrestarts == J.stats.nrestarts
    assert [e["kind"] for e in T.stats.events] == \
        [e["kind"] for e in J.stats.events]


def test_host_audit_matches_reference(sys24):
    csr, b = sys24
    spec = dict(every=3, abft=True, stall_window=50)
    J = JaxHost(csr, health=jh.make_spec(**spec), trace=32)
    T = HostCGSolver(csr, health=health.make_spec(**spec), trace=32)
    xj = J.solve(b, criteria=JaxCrit(**KW))
    xt = T.solve(b, criteria=StoppingCriteria(**KW))
    assert np.array_equal(xt, xj)
    assert T.stats.health == J.stats.health
    assert np.array_equal(T.last_trace.records, J.last_trace.records,
                          equal_nan=True)


# -- the spectrum estimate and the host-side helpers --------------------------

@pytest.mark.parametrize("pipelined", [False, True])
def test_spectrum_estimate_matches_reference(sys24, pipelined):
    csr, b = sys24
    J, T = _pair(csr, dict(every=10), pipelined, trace=512,
                 recovery=False)
    J.solve(b, criteria=JaxCrit(**KW))
    T.solve(b, criteria=StoppingCriteria(**KW))
    ej = jh.convergence_report(J.last_trace, J.stats.niterations, 1e-10)
    et = health.convergence_report(T.last_trace, T.stats.niterations, 1e-10)
    assert et.keys() == ej.keys()
    for k in ("kappa", "lambda_min", "lambda_max", "convergence_factor"):
        assert et[k] == pytest.approx(ej[k], rel=1e-10)
    for k in ("m", "predicted_iterations", "measured_iterations",
              "window_only", "operator"):
        assert et[k] == ej[k]
    # the reference's estimator on the port's ring gives the same answer
    assert jh.spectrum_estimate(T.last_trace)["kappa"] == \
        pytest.approx(ej["kappa"], rel=1e-10)
    rep = health.attach_spectrum(T.stats, T.last_trace, 1e-10)
    assert T.stats.health["spectrum"] is rep


def test_host_helpers_match_reference():
    rng = np.random.default_rng(1)
    a = rng.uniform(0.1, 1.0, 40)
    b = rng.uniform(0.0, 0.9, 40)
    for pipe in (False, True):
        for ws in (0, 3):
            dt, et = health.lanczos_tridiagonal(a, b, pipelined=pipe,
                                                window_start=ws)
            dj, ej = jh.lanczos_tridiagonal(a, b, pipelined=pipe,
                                            window_start=ws)
            assert np.array_equal(dt, dj) and np.array_equal(et, ej)
    for kappa, rtol in ((1e4, 1e-8), (2.0, 1e-3), (0.0, 1e-8),
                        (1e6, 1.5)):
        assert health.predicted_iterations(kappa, rtol) == \
            jh.predicted_iterations(kappa, rtol)
    assert health.abft_default_threshold(torch.float64, 4096) == \
        jh.abft_default_threshold(jnp.float64, 4096)
    assert health.abft_default_threshold(np.float32, 100) == \
        jh.abft_default_threshold(jnp.float32, 100)
    aud = [0.5, 0.75, 3.0, 1.0, 1e-17, 2e-17, 4.0, 0.0]
    spec = dict(every=2, threshold=0.6, action="replace", stall_window=4,
                abft=True)
    assert health.summarize_audit(aud, health.make_spec(**spec)) == \
        jh.summarize_audit(aud, jh.make_spec(**spec))


@pytest.mark.parametrize("kw", [
    dict(every=-1), dict(threshold=-1.0), dict(action="bogus"),
    dict(every=5, action="replace"), dict(abft=True),
    dict(every=2, abft_threshold=1e-3), dict(stall_window=-2)])
def test_spec_refusals_match_reference(kw):
    with pytest.raises(ValueError) as t:
        health.make_spec(**kw)
    with pytest.raises(ValueError) as j:
        jh.make_spec(**kw)
    assert str(t.value) == str(j.value)


def test_disarmed_spec_is_none_and_str_matches():
    assert health.make_spec() is None and jh.make_spec() is None
    kw = dict(every=5, threshold=1e-8, action="replace", stall_window=7,
              abft=True, abft_threshold=1e-9)
    assert str(health.make_spec(**kw)) == str(jh.make_spec(**kw))
    assert health.make_spec(**kw).arms_detect
    assert not health.make_spec(every=5).arms_detect
    assert math.isnan(float(health.audit_init(torch.float64)[0]))


def test_cli_health_section_matches_reference(capsys):
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main
    argv = ["gen:poisson2d:16", "--nparts", "1", "--max-iterations", "500",
            "--residual-rtol", "1e-10", "-q", "--audit-every", "4",
            "--abft", "--stall-window", "100", "--convergence-log",
            os.devnull]
    blocks = []
    for m, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        assert m(argv + extra) == 0
        err = capsys.readouterr().err
        lines = err.splitlines()
        i = lines.index("health:")
        blocks.append([ln for ln in lines[i:] if ln.startswith("  ")
                       and "gap_" not in ln and "rel_" not in ln
                       and "lambda" not in ln and "kappa" not in ln
                       and "factor" not in ln and "bound_ratio" not in ln
                       and "effectiveness" not in ln])
    assert blocks[0] == blocks[1]
    assert any("nchecks" in ln for ln in blocks[0])
    assert any("predicted_iterations" in ln for ln in blocks[0])
