"""The port's live observatory (acg_tpu_torch.observatory) against the
JAX package's: the status document and its file and HTTP sinks, the
--slo objectives and the exit-8 gate, and the run-history ledger, whose
index lines (the case key included) are the reference's for the same
document."""

import json
import urllib.request

import pytest
import torch

from acg_tpu import observatory as jax_observatory
from acg_tpu.cli import main as jax_main
from acg_tpu_torch import observatory
from acg_tpu_torch.cli import main as torch_main

torch.set_num_threads(min(2, torch.get_num_threads()))

_RUN = ["gen:poisson2d:12", "--max-iterations", "300", "--residual-rtol",
        "1e-8", "--warmup", "0", "-q"]


@pytest.mark.parametrize("spec", ["iters=50", "latency=0.5,iters=7",
                                  "latency=2", "gap=1e-6", "iters=0",
                                  "bogus=1", "", "latency=x"])
def test_parse_slo_is_the_references(spec):
    try:
        want = str(jax_observatory.parse_slo(spec))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            observatory.parse_slo(spec)
        assert str(got.value) == str(e)
        return
    assert str(observatory.parse_slo(spec)) == want


def test_status_document_and_heartbeat_line():
    """The status recorder's document and the heartbeat line's shape,
    recorded through the same calls on both packages."""
    docs = []
    for obs in (jax_observatory, observatory):
        obs.arm()
        try:
            obs.begin_solve("cg", 100, rtol=1e-8, matrix="m", nparts=4)
            line = obs.heartbeat_line("cg", 10, 0.5)
            obs.heartbeat_line("cg", 20, 0.25)
            obs.note_event("restart", "x")
            obs.end_solve(True, 30, 0.1)
            docs.append((line, obs.status_document()))
        finally:
            obs.shutdown()
    (jl, jd), (tl, td) = docs
    assert tl.split(": ", 1)[1] == jl.split(": ", 1)[1]
    assert tl.startswith("acg-tpu-torch: cg: iteration 10: ")
    assert set(td) == set(jd) and td["schema"] == "acg-tpu-status/1"
    assert set(td["solve"]) == set(jd["solve"])
    assert td["solve"]["iteration"] == 30 and td["events"][0]["kind"] == \
        "restart"


@pytest.mark.parametrize("gate", [False, True])
def test_cli_slo_exit_8(tmp_path, capsys, gate):
    """A breached --slo: exit 8 under --fail-on-slo and 0 without it, as
    the reference exits; the slo: section and its event either way."""
    flags = ["--slo", "iters=3"] + (["--fail-on-slo"] if gate else [])
    st = tmp_path / "s.json"
    rc = torch_main(_RUN + ["--device", "cpu", "--stats-json", str(st)]
                    + flags)
    err = capsys.readouterr().err
    assert jax_main(_RUN + ["--comm", "none"] + flags) == rc
    capsys.readouterr()
    assert rc == (8 if gate else 0)
    assert "SLO breach: iters" in err and "slo:" in err
    doc = json.loads(st.read_text())
    assert doc["stats"]["slo"]["breached"] is True
    assert any(e["kind"] == "slo-breach" for e in doc["stats"]["events"])


def test_cli_status_file_and_port(tmp_path, capsys):
    """--status-file is finalised on exit (phase "exited"); a status
    server answers /status and /metrics."""
    sf = tmp_path / "status.json"
    assert torch_main(_RUN + ["--device", "cpu", "--status-file", str(sf),
                              "--progress", "5"]) == 0
    capsys.readouterr()
    doc = json.loads(sf.read_text())
    assert doc["schema"] == "acg-tpu-status/1" and doc["phase"] == "exited"
    assert doc["solve"]["active"] is False and doc["solves_completed"] == 1
    observatory.arm()
    srv = observatory.serve_status(0)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        status = json.loads(urllib.request.urlopen(base + "/status",
                                                   timeout=30).read())
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=30).read().decode()
    finally:
        srv.shutdown()
        observatory.shutdown()
    assert status["schema"] == "acg-tpu-status/1"
    assert "acg_solves_total" in metrics


_DOCS = [
    {"schema": "acg-tpu-stats/12",
     "manifest": {"matrix": "gen:poisson2d:12", "solver": "acg",
                  "unix_time": 1.7e9, "dtype": "f64", "nparts": 1},
     "stats": {"tsolve": 0.5, "niterations": 40, "converged": True}},
    {"schema": "acg-tpu-stats/12",
     "manifest": {"matrix": "m", "solver": "acg", "precond": "jacobi",
                  "nrhs": 4, "block_cg": True, "operator": "stencil",
                  "calibration": "uncalibrated", "unix_time": 1.7e9},
     "stats": {"tsolve": 1.0, "niterations": 10, "converged": False,
               "soak": {"latency": {"p50": 0.25},
                        "iterations": {"p50": 9}}}},
    {"schema": "acg-tpu-stats/12",
     "manifest": {"metric": "bench_backend_unavailable",
                  "unix_time": 1.7e9 + 60},
     "stats": {"tsolve": 1.0, "niterations": 1}},
]


def test_history_ledger_is_the_references(tmp_path):
    """history_append's ledger: the reference's history_scan reads it,
    each index line equals the reference's for the same document, and
    load_history_baseline picks the same cases."""
    for doc in _DOCS:
        observatory.history_append(tmp_path / "t", doc)
        jax_observatory.history_append(tmp_path / "j", doc)
    got = jax_observatory.history_scan(tmp_path / "t")
    want = jax_observatory.history_scan(tmp_path / "j")
    assert got == want and len(got) == 3
    assert observatory.history_scan(tmp_path / "j") == want
    assert observatory.load_history_baseline(tmp_path / "t") == \
        jax_observatory.load_history_baseline(tmp_path / "j")


@pytest.mark.parametrize("flags,msg", [
    (["--fail-on-slo"], "--fail-on-slo needs --slo"),
    (["--slo", "gap=1e-6"], "--audit-every"),
    (["--telemetry-window", "0"], "--telemetry-window must be positive"),
    (["--progress", "-1"], "--progress must be >= 0"),
    (["--status-port", "70000"], "--status-port must be 0-65535")])
def test_cli_flag_validation(flags, msg):
    with pytest.raises(SystemExit) as e:
        torch_main(["gen:poisson2d:8", "--device", "cpu"] + flags)
    assert msg in str(e.value)


def test_cli_history_refuses_a_file(tmp_path):
    f = tmp_path / "f"
    f.write_text("x")
    with pytest.raises(SystemExit, match="needs a directory"):
        torch_main(["gen:poisson2d:8", "--device", "cpu", "--history",
                    str(f)])
