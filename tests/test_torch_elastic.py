"""The port's elastic half of the recovery ladder (acg_tpu_torch.supervisor,
the exit-code contract, --supervise/--shrink/--chaos) against the JAX
package's (acg_tpu.supervisor, tests/test_elastic.py).

The pure functions (argv surgery, reason classification, the chaos draw,
the verification oracle) are held to the reference's on the same inputs;
the supervisor loop to the reference's report on the same exit-code
sequence; the CLI modes end to end in subprocesses (``--device cpu``),
each child a solve of the port."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_tpu import supervisor as jsup
from acg_tpu.errors import exit_code_table as jax_exit_code_table
from acg_tpu_torch import faults
from acg_tpu_torch import supervisor as sup
from acg_tpu_torch.errors import (PEER_LOST_CODES, RELAUNCHABLE_CODES,
                                  ExitCode, exit_code_table)
from acg_tpu_torch.io.generators import poisson_mtx
from acg_tpu_torch.matrix import SymCsrMatrix

torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(argv, extra_env=None, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != faults.ENV_VAR}
    env["PYTHONPATH"] = REPO
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", "acg_tpu_torch", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          env=env, timeout=timeout)


# -- the exit-code contract ----------------------------------------------------

def test_exit_code_registry_is_the_single_source():
    """The scattered rc constants resolve to the registry, and the table
    is the reference's row for row."""
    from acg_tpu_torch.checkpoint import CRASH_EXIT_CODE
    from acg_tpu_torch.observatory import SLO_EXIT_CODE
    from acg_tpu_torch.parallel.erragree import PEER_LOST_EXIT
    from acg_tpu_torch.soak import DRIFT_EXIT_CODE

    assert CRASH_EXIT_CODE == int(ExitCode.CRASH_INJECTED) == 94
    assert PEER_LOST_EXIT == int(ExitCode.PEER_LOST) == 97
    assert DRIFT_EXIT_CODE == int(ExitCode.DRIFT) == 7
    assert SLO_EXIT_CODE == int(ExitCode.SLO_BREACH) == 8
    assert int(ExitCode.PEER_DEAD_INJECTED) == 86
    assert int(ExitCode.RELAUNCH_BUDGET) == 95
    assert int(ExitCode.WRONG_ANSWER) == 96
    assert exit_code_table() == jax_exit_code_table()
    from acg_tpu.errors import PEER_LOST_CODES as J_PL
    from acg_tpu.errors import RELAUNCHABLE_CODES as J_RL
    assert RELAUNCHABLE_CODES == J_RL and PEER_LOST_CODES == J_PL


def test_buildinfo_renders_exit_table_and_elastic_rows():
    from acg_tpu_torch.cli import _buildinfo
    out = io.StringIO()
    assert _buildinfo(out) == 0
    text = out.getvalue()
    assert "exit codes:" in text
    assert "\n   94  [faults/checkpoint]" in text
    assert "elastic recovery: --supervise" in text
    assert "chaos campaign: --chaos SEED[:N]" in text


# -- the pure functions against the reference's ------------------------------

ARGV = ["gen:poisson2d:16", "--supervise", "--relaunch-budget", "2",
        "--metrics-file", "m.prom", "--ckpt", "ck", "--ckpt-every", "8",
        "--nparts", "8", "--chaos=3:2", "--shrink", "any"]


@pytest.mark.parametrize("flag,value", [("--nparts", 4), ("--resume", "ck"),
                                        ("--supervise", None)])
def test_supervisor_argv_surgery_matches_the_reference(flag, value):
    assert sup.SUPERVISOR_FLAGS == jsup.SUPERVISOR_FLAGS
    child = sup.strip_flags(ARGV, sup.SUPERVISOR_FLAGS)
    assert child == jsup.strip_flags(ARGV, jsup.SUPERVISOR_FLAGS)
    assert "--supervise" not in child and "m.prom" not in child
    assert sup.flag_value(child, "--nparts") == "8"
    assert sup.set_flag(child, flag, value) == \
        jsup.set_flag(child, flag, value)
    for argv, env in ((["--fault-inject", "spmv:nan@3"],
                       {"ACG_TPU_FAULT_INJECT": "spmv:nan@3"}),
                      (["--fault-inject", "crash:exit@9"], {}),
                      ([], {"ACG_TPU_FAULT_INJECT": "halo:nan@2"})):
        assert sup._strip_fault(argv, env) == jsup._strip_fault(argv, env)


@pytest.mark.parametrize("rc", [0, 1, 3, 7, 8, 86, 94, 95, 96, 97, -9])
def test_supervisor_reason_classification(rc):
    assert sup._reason(rc) == jsup._reason(rc)


class _Args:
    nparts = 8
    abft = True
    audit_every = 5
    multihost = False
    coordinator = None
    soak = 0
    max_iterations = 300
    num_processes = None


@pytest.mark.parametrize("cfg", [
    {}, {"nparts": 0, "abft": False}, {"multihost": True, "soak": 10},
    {"coordinator": "127.0.0.1:1", "num_processes": 4, "audit_every": 7},
    {"max_iterations": 3}])
def test_chaos_schedules_match_the_reference(cfg):
    """The same seed and flags draw the reference's schedules, each
    parseable by the port's fault grammar, sdc flips on audited
    iterations."""
    A = type("A", (_Args,), dict(cfg))
    specs = [sup.chaos_schedule(i, 77, A) for i in range(40)]
    assert specs == [jsup.chaos_schedule(i, 77, A) for i in range(40)]
    for s in specs:
        if s is None:
            continue
        spec = faults.parse_fault_spec(s)
        if spec.site == "sdc":
            assert (spec.iteration + 1) % A.audit_every == 0, s
    assert sup.parse_chaos("2026:3") == jsup.parse_chaos("2026:3") \
        == (2026, 3)
    assert sup.parse_chaos("5") == (5, 20)
    with pytest.raises(SystemExit):
        sup.parse_chaos("5:0")


@pytest.fixture(scope="module")
def system():
    csr = SymCsrMatrix.from_mtx(poisson_mtx(12, dim=2)).to_csr()
    return csr, np.ones(csr.shape[0])


def test_verify_solution_detects_wrong_answer(system, tmp_path):
    import scipy.sparse.linalg as spla

    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx

    csr, b = system
    x = spla.spsolve(csr.tocsc(), b)
    good = str(tmp_path / "good.mtx")
    write_mtx(good, vector_mtx(x), binary=True)
    ok, rel = sup.verify_solution(csr, b, good, 1e-8)
    assert (ok, rel) == jsup.verify_solution(csr, b, good, 1e-8)
    assert ok and rel < 1e-8
    bad = str(tmp_path / "bad.mtx")
    xw = x.copy()
    xw[7] *= -1.0
    write_mtx(bad, vector_mtx(xw), binary=True)
    ok, rel = sup.verify_solution(csr, b, bad, 1e-8)
    assert not ok and rel > 1e-4
    assert sup.verify_solution_dense(csr, b, xw, 1e-8) == \
        jsup.verify_solution_dense(csr, b, xw, 1e-8)
    assert sup.verify_solution_dense(csr, b, x[:-1], 1e-8) == \
        (False, float("inf"))


# -- the supervisor loop against the reference's -------------------------------

@pytest.mark.parametrize("rcs,kw", [
    ([0], {}),
    ([94, 0], {}),
    ([94, 94, 0], {"shrink": "any", "nparts": 8}),
    ([97, 86, 0], {"nparts": 8, "min_parts": 2}),
    ([94, 94, 94, 94], {"budget": 2}),
    ([2], {}),
    ([7], {}),
    ([1, 0], {"shrink": "never", "nparts": 4}),
    ([-9, 0], {"nparts": 2}),
], ids=["clean", "crash", "shrink-any", "peer-lost", "budget", "not-"
        "relaunchable", "drift-gate", "never", "signal"])
def test_supervise_report_matches_the_reference(rcs, kw, tmp_path,
                                                monkeypatch):
    """The same child exit codes give the reference's report (rc,
    attempts, relaunch reasons and parts, degraded) and the same argv of
    every relaunch, less the child module."""
    ck = tmp_path / "ck"
    ck.write_bytes(b"x")
    argv = ["gen:poisson2d:8", "--nparts", str(kw.get("nparts", 0)),
            "--ckpt", str(ck), "--ckpt-every", "4",
            "--fault-inject", "spmv:nan@3"]
    opts = dict(ckpt_path=str(ck), backoff=0.0, env={}, **kw)
    seen = {"port": [], "ref": []}
    seq = {"port": iter(rcs), "ref": iter(rcs)}

    def runner(cmd, env):
        seen["port"].append((cmd[3:], env.get("ACG_TPU_DEGRADED")))
        return next(seq["port"])

    class _Proc:
        def __init__(self, rc):
            self.returncode, self.stdout, self.stderr = rc, "", ""

    def fake_run(cmd, env=None, **_):
        seen["ref"].append((cmd[3:], env.get("ACG_TPU_DEGRADED")))
        return _Proc(next(seq["ref"]))

    monkeypatch.setattr(jsup.subprocess, "run", fake_run)
    got = sup.supervise(argv, runner=runner, **opts)
    want = jsup.supervise(argv, **opts)
    for key in ("rc", "attempts", "relaunches", "degraded", "outcome"):
        assert got[key] == want[key], key
    assert (got["mttr_seconds"] is None) == (want["mttr_seconds"] is None)
    assert seen["port"] == seen["ref"]

    def section(mod, rep):
        return [ln for ln in mod._recovery_section(rep).splitlines()
                if "mttr" not in ln]
    assert section(sup, got) == section(jsup, want)


# -- the CLI modes, end to end -------------------------------------------------

@pytest.mark.parametrize("argv,needle", [
    (["--supervise"], "--ckpt"),
    (["--supervise", "--ckpt", "/tmp/x", "--ckpt-every", "8", "--resume",
      "/tmp/x"], "--resume"),
    (["--chaos", "boom", "--ckpt", "/tmp/x", "--ckpt-every", "8"],
     "SEED[:N]"),
    (["--supervise", "--ckpt", "/tmp/x", "--ckpt-every", "8",
      "--relaunch-budget", "-1"], "--relaunch-budget"),
    (["--supervise", "--ckpt", "/tmp/x", "--ckpt-every", "8",
      "--min-parts", "0"], "--min-parts"),
    (["--chaos", "3:2", "--ckpt", "/tmp/x", "--ckpt-every", "8",
      "--manufactured-solution"], "--manufactured-solution"),
])
def test_supervise_cli_validation(argv, needle):
    """Refused before any child starts, as the reference refuses."""
    from acg_tpu_torch.cli import main
    with pytest.raises(SystemExit) as e:
        main(["gen:poisson2d:8", "--device", "cpu"] + argv)
    assert needle in str(e.value)


def test_supervisor_crash_relaunch_single_device(tmp_path):
    """crash:exit kills the child (rc 94); the supervisor relaunches with
    --resume, the solve converges, the answer is the uninterrupted
    solve's bits, and the supervisor's textfile carries the
    acg_recovery_* families."""
    ck, prom = str(tmp_path / "ck"), str(tmp_path / "sup.prom")
    base = ["gen:poisson2d:16", "--device", "cpu", "--max-iterations",
            "300", "--residual-rtol", "1e-8", "--warmup", "0", "--quiet"]
    r = run_cli(base + ["--ckpt", ck, "--ckpt-every", "8",
                        "--fault-inject", "crash:exit@20", "--supervise",
                        "--relaunch-backoff", "0", "--metrics-file", prom,
                        "-o", str(tmp_path / "x.mtx")])
    assert r.returncode == 0, r.stderr
    assert "relaunch 1/3 with --resume" in r.stderr
    assert "recovery:" in r.stderr
    assert "outcome: converged (rc 0)" in r.stderr
    text = open(prom).read()
    assert 'acg_recovery_relaunches_total{reason="crash"} 1' in text
    assert "acg_recovery_mttr_seconds_count 1" in text
    clean = run_cli(base + ["-o", str(tmp_path / "x0.mtx")])
    assert clean.returncode == 0, clean.stderr
    assert (tmp_path / "x.mtx").read_bytes() == \
        (tmp_path / "x0.mtx").read_bytes()


@pytest.mark.slow
def test_supervisor_budget_exhaustion(tmp_path):
    """A child that cannot converge: no snapshot is ever committed in one
    iteration, so the failure passes through (rc 1), or the budget is
    spent (rc 95)."""
    r = run_cli(["gen:poisson2d:16", "--device", "cpu",
                 "--max-iterations", "1", "--residual-rtol", "1e-12",
                 "--warmup", "0", "--quiet",
                 "--ckpt", str(tmp_path / "ck"), "--ckpt-secs", "30",
                 "--supervise", "--relaunch-budget", "1",
                 "--relaunch-backoff", "0"])
    assert r.returncode in (1, int(ExitCode.RELAUNCH_BUDGET))


def test_supervisor_shrink_elastic_e2e(tmp_path):
    """A crash mid-solve on 8 stacked parts: the supervisor relaunches
    with --resume --resume-repartition on 4 parts, the answer meets the
    original tolerance on the host oracle, and the relaunched child's
    status document says degraded."""
    out, status = str(tmp_path / "x.mtx"), str(tmp_path / "status.json")
    r = run_cli(["gen:poisson2d:20", "--device", "cpu", "--nparts", "8",
                 "--comm", "dma", "--max-iterations", "400",
                 "--residual-rtol", "1e-8", "--warmup", "0", "--quiet",
                 "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "8",
                 "--fault-inject", "crash:exit@20",
                 "--supervise", "--shrink", "any",
                 "--relaunch-backoff", "0",
                 "--status-file", status, "-o", out])
    assert r.returncode == 0, r.stderr
    assert "shrinking 8 -> 4 parts" in r.stderr
    assert "degraded: 8 -> 4 parts (crash)" in r.stderr
    csr = SymCsrMatrix.from_mtx(poisson_mtx(20, dim=2)).to_csr()
    ok, rel = sup.verify_solution(csr, np.ones(csr.shape[0]), out, 1e-8)
    assert ok and rel < 1e-7, rel
    doc = json.load(open(status))
    assert doc["degraded"] == {"from": 8, "to": 4, "reason": "crash"}


def _chaos(tmp_path, spec):
    hist = str(tmp_path / "hist")
    r = run_cli(["gen:poisson2d:16", "--device", "cpu",
                 "--max-iterations", "300", "--residual-rtol", "1e-8",
                 "--warmup", "0", "--quiet",
                 "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "8",
                 "--audit-every", "5", "--abft",
                 "--chaos", spec, "--relaunch-backoff", "0",
                 "--history", hist], timeout=1800)
    assert r.returncode == 0, r.stderr
    assert "wrong-answer: 0" in r.stderr
    rows = []
    for name in os.listdir(hist):
        with open(os.path.join(hist, name)) as f:
            for line in f:
                obj = json.loads(line)
                if obj.get("schema") == "acg-tpu-chaos/1":
                    rows.append(obj)
    return rows


def test_chaos_campaign_small(tmp_path):
    """A seeded 4-schedule campaign (abft and ckpt armed): every run
    converged or agreed-abort, the reference's schedules, one ledger row
    each."""
    rows = _chaos(tmp_path, "2026:4")
    assert len(rows) == 4

    class A(_Args):
        nparts = 0

    want = {jsup.chaos_schedule(i, 2026, A) for i in range(4)}
    assert {r["doc"]["chaos"]["fault"] for r in rows} == want
    assert {r["doc"]["chaos"]["outcome"] for r in rows} <= \
        {"converged", "agreed-abort"}


@pytest.mark.slow
def test_chaos_campaign_acceptance(tmp_path):
    """The reference's 20-schedule acceptance campaign: zero
    wrong-answer-green."""
    rows = _chaos(tmp_path, "1234:20")
    assert len(rows) == 20


@pytest.mark.parametrize("flag", [
    "--grow-after", "--commbench", "--calibration", "--explain", "--plan",
    "--autotune", "--no-probe-cache", "--serve", "--serve-port",
    "--serve-queue-depth", "--serve-coalesce", "--serve-deadline",
    "--serve-faults", "--access-log"])
def test_flags_of_later_tiers_stay_unregistered(flag):
    """The flags of the tiers ported last -- the decision layer's and
    the service's, with the daemon supervisor's --grow-after -- are
    registered with the reference's dest, default, choices, nargs and
    type (the name is kept from when the service's were not yet)."""
    from acg_tpu.cli import make_parser as jax_parser
    from acg_tpu_torch.cli import make_parser
    ref = {o: a for a in jax_parser()._actions for o in a.option_strings}
    port = {o: a for a in make_parser()._actions for o in a.option_strings}
    assert flag in ref and flag in port
    for attr in ("dest", "default", "choices", "nargs", "type"):
        assert getattr(port[flag], attr) == getattr(ref[flag], attr), attr


@pytest.mark.parametrize("flag,dest,value", [
    ("--supervise", "supervise", True), ("--relaunch-budget", "relaunch_budget", 3),
    ("--relaunch-backoff", "relaunch_backoff", 1.0),
    ("--shrink", "shrink", "peer-lost"), ("--min-parts", "min_parts", 1),
    ("--chaos", "chaos", None)])
def test_supervisor_flags_parse_like_the_reference(flag, dest, value):
    """The six flags take the reference's defaults and values."""
    from acg_tpu.cli import make_parser as jax_parser
    from acg_tpu_torch.cli import make_parser
    argv = ["gen:poisson2d:8"]
    t, j = make_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert getattr(t, dest) == getattr(j, dest)
    if flag == "--supervise":
        argv = argv + [flag]
    else:
        argv = argv + [flag, {"--shrink": "any", "--chaos": "7:2"}.get(
            flag, "5")]
    t, j = make_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert getattr(t, dest) == getattr(j, dest)
