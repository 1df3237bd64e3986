"""The port's service metrics (acg_tpu_torch.metrics) against the JAX
package's: the same registry, families, help text and buckets, so the
Prometheus exposition is byte-equal after the same recorder calls; the
resource gauges read torch, never jax; and the CLI's --metrics-file and
--metrics-port sinks pass the reference's textfile checker."""

import json
import os
import subprocess
import sys
import urllib.request

import pytest
import torch

from acg_tpu import metrics as jax_metrics
from acg_tpu_torch import metrics
from acg_tpu_torch.cli import main as torch_main

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _registry_state():
    """Each test starts from the port registry disarmed and with no
    collect callback, and leaves it as it found it: an earlier file on the
    same worker may have armed the hooks and registered the resource
    callback, whose RSS reading moves between two expositions."""
    callbacks = list(metrics.REGISTRY._collect_callbacks)
    was = metrics.armed()
    metrics.REGISTRY._collect_callbacks.clear()
    metrics.disarm()
    yield
    metrics.REGISTRY._collect_callbacks[:] = callbacks
    if was:
        metrics.arm()
    else:
        metrics.disarm()

# recorder sequences applied to both packages' process-wide registries in
# a fresh process (the registries live for a process's life); armed
# without the resource-gauge callback, whose RSS reading is the clock's
_SEQUENCES = {
    "solves": """
m.record_solve(0.5, 37, True, solver="cg")
m.record_solve(2.0, 100, False, solver="dist-cg")
m.record_solve(1e-5, 0, True, solver="host-cg")
m.record_phase("ingest", 0.01)
m.record_phase("compile", 1.25)
m.record_phase("solve", 0.5)
""",
    "events-and-slo": """
m.record_event_kind("slo-breach")
m.record_event_kind("restart")
m.record_breakdown(); m.record_restart(); m.record_fallback()
m.record_precond("jacobi", 38)
m.record_slo_target("iters", 100)
m.record_slo_target("latency", 0.25)
m.record_slo("iters", True, 0.5)
m.record_slo("latency", False, 0.0)
""",
    "tracing": """
m.record_trace_span("phase"); m.record_trace_span("event")
m.record_timeline_export()
m.record_trace_analysis({"available": True,
    "op_seconds": {"gemv": 0.2, "dot": 0.01},
    "overlap_efficiency": 0.25, "exposed_collective_seconds": 0.003})
m.record_comm({"halo_bytes_per_iteration": 64,
               "allreduce_bytes_per_iteration": 16}, 10)
""",
}

_CHILD = """
import sys
from acg_tpu import metrics as jm
from acg_tpu_torch import metrics as tm
out = []
for m in (jm, tm):
    m._armed = True
%s
    out.append(m.expose())
assert out[0] == out[1], "exposition differs"
assert "acg_" in out[1]
print("SAME", len(out[1]))
"""


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_exposition_is_byte_equal(name):
    body = "\n".join("    " + line for line in
                     _SEQUENCES[name].strip().splitlines())
    res = subprocess.run([sys.executable, "-c", _CHILD % body], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT,
                                  JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "SAME" in res.stdout


def test_families_are_the_references():
    names = {f.name: (f.kind, f.help, getattr(f, "buckets", None))
             for f in metrics.REGISTRY._families.values()}
    jnames = {f.name: (f.kind, f.help, getattr(f, "buckets", None))
              for f in jax_metrics.REGISTRY._families.values()}
    assert names == jnames


def test_disarmed_hooks_record_nothing():
    before = metrics.expose()
    was = metrics.armed()
    metrics.disarm()
    try:
        metrics.record_phase("solve", 1.0)
        metrics.record_event_kind("x")
        assert metrics.expose() == before
    finally:
        if was:
            metrics.arm()


def test_resource_gauges_read_torch_on_the_cpu():
    """RSS always; no device-memory series without a CUDA card (and no
    jax import to find one)."""
    metrics.update_resource_gauges()
    text = metrics.expose()
    rss = [ln for ln in text.splitlines()
           if ln.startswith("acg_process_resident_bytes ")]
    assert rss and float(rss[0].split()[1]) > 0
    assert not any(ln.startswith("acg_device_memory_bytes{")
                   for ln in text.splitlines())


def test_cli_metrics_file_and_port(tmp_path, capsys):
    """--metrics-file passes the reference's textfile checker, requiring
    a solve; --metrics-port answers /metrics while the process lives."""
    prom = tmp_path / "m.prom"
    assert torch_main(["gen:poisson2d:12", "--device", "cpu", "-q",
                       "--warmup", "0", "--max-iterations", "300",
                       "--residual-rtol", "1e-8", "--metrics-file",
                       str(prom), "--stats-json",
                       str(tmp_path / "s.json")]) == 0
    capsys.readouterr()
    res = subprocess.run([sys.executable, "scripts/check_metrics_textfile.py",
                          str(prom), "--require", "acg_solves_total"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    text = prom.read_text()
    assert 'acg_solves_total{solver="cg",converged="true"}' in text
    doc = json.loads((tmp_path / "s.json").read_text())
    assert "acg_solves_total" in json.dumps(doc["metrics"])
    srv = metrics.serve(0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/metrics",
            timeout=30).read().decode()
    finally:
        srv.shutdown()
    assert "acg_solves_total" in body


def test_failed_validation_never_clobbers_the_textfile(tmp_path):
    prom = tmp_path / "m.prom"
    prom.write_text("# previous scrape\n")
    with pytest.raises(SystemExit):
        torch_main(["gen:poisson2d:8", "--device", "cpu", "--metrics-file",
                    str(prom), "--metrics-port", "70000"])
    assert prom.read_text() == "# previous scrape\n"


_SOAK_DIST = ["gen:poisson2d:16", "--nparts", "4", "--max-iterations", "200",
              "--residual-rtol", "1e-8", "--warmup", "0", "--quiet",
              "--soak", "3"]


def test_cli_soak_dist_solver(tmp_path):
    """The twin of the reference's ``test_cli_soak_dist_solver``: a soak
    over 4 stacked parts folds the comm ledger into the halo and psum
    byte counters, to the reference's values on the same argv (64,512
    and 1,344 bytes: 3 solves of 28 iterations, 768 halo and 16 psum
    bytes an iteration).  Both CLIs run in fresh processes, whose
    registries start empty."""
    def counters(argv, prom):
        res = subprocess.run(
            [sys.executable] + argv + ["--metrics-file", str(prom)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        assert res.returncode == 0, res.stderr
        out = {}
        for ln in prom.read_text().splitlines():
            for name in ("acg_halo_bytes_total", "acg_allreduce_bytes_total"):
                if ln.startswith(name + " "):
                    out[name] = float(ln.split()[-1])
        return out

    port = counters(["-m", "acg_tpu_torch"] + _SOAK_DIST
                    + ["--device", "cpu"], tmp_path / "t.prom")
    ref = counters(["-m", "acg_tpu.cli"] + _SOAK_DIST, tmp_path / "j.prom")
    assert port == ref == {"acg_halo_bytes_total": 64512.0,
                           "acg_allreduce_bytes_total": 1344.0}


def test_rank_mode_comm_counters_sum_to_one_process(tmp_path):
    """Across two gloo processes each rank counts the halo its own parts
    send and rank 0 the psums: the ranks' counters sum to the one-process
    stacked solve's, never twice its traffic."""
    import socket

    argv = ["-m", "acg_tpu_torch", "gen:poisson2d:16", "--device", "cpu",
            "--nparts", "4", "--comm", "dma", "--warmup", "0",
            "--max-iterations", "500", "-q"]
    env = dict(os.environ, PYTHONPATH=ROOT)

    def counters(prom):
        out = {}
        for ln in prom.read_text().splitlines():
            name, _, v = ln.partition(" ")
            if name in ("acg_halo_bytes_total", "acg_allreduce_bytes_total"):
                out[name] = float(v)
        return out

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable] + argv + [
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(i), "--metrics-file",
            str(tmp_path / f"r{i}.prom")],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for i in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    res = subprocess.run([sys.executable] + argv + [
        "--metrics-file", str(tmp_path / "one.prom")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    r0, r1 = (counters(tmp_path / f"r{i}.prom") for i in (0, 1))
    one = counters(tmp_path / "one.prom")
    assert r1["acg_allreduce_bytes_total"] == 0
    assert one["acg_halo_bytes_total"] > 0
    for name in one:
        assert r0[name] + r1[name] == one[name], name
