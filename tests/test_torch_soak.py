"""The port's soak driver (acg_tpu_torch.soak) against the JAX package's:
the EWMA drift detector and its vacuous-gate rule on the same latency
sequences, the driver's report over the port's solvers, the
solve:slow fault tripping the detector, and the CLI's --soak and
--fail-on-drift with the reference's exit codes.
"""

import os

import numpy as np
import pytest
import torch

from acg_tpu import faults as jf
from acg_tpu import soak as jsoak
from acg_tpu_torch import faults, soak
from acg_tpu_torch.io.generators import poisson_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"


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


@pytest.mark.parametrize("seq,pct", [
    ([1.0] * 10 + [3.0] * 10, 50.0),
    ([1.0, 1.2, 0.9, 1.1, 1.0, 1.05, 0.95, 1.0], 50.0),
    ([0.5, 5.0, 0.5, 0.5, 0.6, 0.5, 0.5, 0.5, 2.0, 2.0, 2.0, 2.0], 10.0),
    ([1.0, 1.0, 1.0, 1.0, 9.0], 50.0)])
def test_drift_detector_matches_reference(seq, pct):
    t = soak.DriftDetector(len(seq), pct)
    j = jsoak.DriftDetector(len(seq), pct)
    for i, lat in enumerate(seq):
        assert t.update(i, lat) == j.update(i, lat)
    assert t.to_dict() == j.to_dict()


def test_vacuous_gate_and_exit_codes_match_reference():
    for n in range(1, 30):
        assert soak.gate_is_vacuous(n) == jsoak.gate_is_vacuous(n)
    rep = {"drift": {"tripped": True}}
    for r, f in ((rep, 50.0), (rep, None), ({"drift": {"tripped": False}},
                                              50.0), (None, 50.0)):
        assert soak.gate_exit_code(r, f) == jsoak.gate_exit_code(r, f)
    assert soak.DRIFT_EXIT_CODE == jsoak.DRIFT_EXIT_CODE == 7


@pytest.fixture(scope="module")
def solver():
    csr = SymCsrMatrix.from_mtx(poisson_mtx(16, dim=2)).to_csr()
    A = device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    return TorchCGSolver(A, device=CPU), np.ones(csr.shape[0])


def test_slow_fault_trips_the_detector(solver):
    s, b = solver
    crit = StoppingCriteria(maxits=200, residual_rtol=1e-8)
    with faults.injected("solve:slow@10:secs=0.2"):
        x, rep = soak.run_soak(s, b, nsolves=16, criteria=crit,
                               fail_on_drift=50.0)
    assert rep["nsolves"] == 16
    assert rep["drift"]["tripped"] and rep["drift"]["tripped_at_solve"] >= 10
    assert soak.gate_exit_code(rep, 50.0) == 7
    assert s.stats.soak is rep
    assert "drift" in [e["kind"] for e in s.stats.events]
    assert rep["latency"]["max"] >= 0.2
    assert rep["iterations"]["p50"] is not None
    assert np.isfinite(x).all()


def test_soak_refuses_a_vacuous_gate(solver):
    s, b = solver
    with pytest.raises(ValueError, match="vacuous") as t:
        soak.run_soak(s, b, nsolves=3, fail_on_drift=10.0)
    with pytest.raises(ValueError, match="vacuous") as j:
        jsoak.run_soak(s, b, nsolves=3, fail_on_drift=10.0)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("extra,rc", [
    (["--soak", "12", "--fail-on-drift", "50", "--fault-inject",
      "solve:slow@6:secs=0.3"], 7),
    (["--soak", "6", "--fail-on-drift", "100000"], 0)])
def test_cli_soak_gate_exit_codes(extra, rc, capsys):
    from acg_tpu_torch.cli import main
    argv = ["gen:poisson2d:12", "--device", "cpu", "--max-iterations",
            "200", "--residual-rtol", "1e-8", "-q"] + extra
    assert main(argv) == rc
    err = capsys.readouterr().err
    lines = err.splitlines()
    i = lines.index("soak:")
    keys = [ln.split(":")[0].strip() for ln in lines[i + 1:]
            if ln.startswith("  ") and not ln.startswith("   ")]
    assert keys[:5] == ["nsolves", "wall_seconds", "latency", "iterations",
                        "drift"]
    assert os.environ.get(faults.ENV_VAR) is None


@pytest.mark.parametrize("argv,msg", [
    (["--fail-on-drift", "50"], "needs --soak N"),
    (["--soak", "3", "--fail-on-drift", "50"], "vacuous"),
    (["--soak", "5", "--fail-on-drift", "-1"], "must be positive"),
    (["--soak", "5", "--refine"], "--refine"),
    (["--soak", "-1"], "must be >= 0")])
def test_cli_soak_refusals(argv, msg):
    from acg_tpu_torch.cli import main
    with pytest.raises(SystemExit) as e:
        main(["gen:poisson2d:8", "--device", "cpu", "-q"] + argv)
    assert msg in str(e.value)
