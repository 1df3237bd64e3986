"""The port's cross-process error agreement (acg_tpu_torch.parallel.
erragree) on 2 gloo processes: the cases of tests/test_erragree.py, a
one-sided ingest error agreed and a dead peer caught by the watchdog
with the reference's exit code (97), and the store-backed agreement,
blob gather and heartbeat themselves."""

import os
import socket
import subprocess
import sys
import time

import pytest

from acg_tpu.errors import ExitCode as JaxExitCode
from acg_tpu.io.generators import poisson_mtx
from acg_tpu.io.mtxfile import write_mtx
from acg_tpu_torch.errors import ExitCode
from acg_tpu_torch.parallel.erragree import PEER_LOST_EXIT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT)


def _cli(matrix, port, pid, timeout_s="20"):
    return subprocess.Popen(
        [sys.executable, "-m", "acg_tpu_torch", str(matrix), "--nparts",
         "4", "--max-iterations", "200", "--residual-rtol", "1e-6",
         "--warmup", "0", "--quiet", "--device", "cpu", "--err-timeout",
         timeout_s, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env())


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ea") / "p12.mtx"
    write_mtx(path, poisson_mtx(12, dim=2))
    return path


def test_exit_codes_are_the_references():
    assert {c.name: int(c) for c in ExitCode} == \
        {c.name: int(c) for c in JaxExitCode}
    assert PEER_LOST_EXIT == 97 == int(ExitCode.PEER_LOST)
    assert int(ExitCode.PEER_DEAD_INJECTED) == 86


def test_one_sided_ingest_error_agreed(matrix_file, tmp_path):
    """Process 1 reads a missing matrix, process 0 is healthy: the ingest
    agreement brings both down nonzero within seconds, process 0 naming
    the peer's failure (tests/test_erragree.py:58)."""
    port = _free_port()
    t0 = time.monotonic()
    procs = [_cli(matrix_file, port, 0),
             _cli(tmp_path / "missing.mtx", port, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert time.monotonic() - t0 < 100
    assert procs[0].returncode != 0 and procs[1].returncode != 0
    assert "missing.mtx" in outs[1][1]
    assert "peer controller failed during ingest" in outs[0][1]


def test_dead_peer_trips_watchdog(matrix_file):
    """Process 1 joins the run, then dies without reaching any
    agreement; process 0's ingest agreement aborts with the peer-lost
    code inside its timeout (tests/test_erragree.py:74)."""
    port = _free_port()
    p0 = _cli(matrix_file, port, 0, timeout_s="8")
    code = ("from acg_tpu_torch.parallel.multihost import initialize; "
            f"initialize('127.0.0.1:{port}', 2, 1, device='cpu'); "
            "import os; os._exit(42)")
    p1 = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                          env=_env())
    t0 = time.monotonic()
    try:
        _, err = p0.communicate(timeout=120)
    finally:
        if p0.poll() is None:
            p0.kill()
    elapsed = time.monotonic() - t0
    p1.wait(timeout=30)
    assert p1.returncode == 42
    assert p0.returncode == PEER_LOST_EXIT, err
    assert elapsed < 90, err
    assert "peer controller died" in err or "timed out" in err


_AGREE = r"""
import sys
from acg_tpu_torch.parallel import erragree, multihost
port, rank = int(sys.argv[1]), int(sys.argv[2])
multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
codes = [erragree.agree_status(c, what=f"s{k}", timeout=30)
         for k, c in enumerate(([0, 3, 0] if rank == 0 else [0, 0, 5]))]
blobs = erragree.allgather_blobs(f"r{rank}", timeout=30)
t = erragree.barrier(timeout=30)
lost = []
hb = erragree.DeadlineHeartbeat(period=0.2, deadline=1.5,
                                on_lost=lambda q, age: lost.append(q))
hb.start()
import time
time.sleep(1.0)
ages = hb.peer_ages()
if rank == 1:
    hb.stop()         # rank 1 stops beating: rank 0 must declare it lost
    erragree.barrier(timeout=30)
else:
    erragree.barrier(timeout=30)
    time.sleep(3.0)
    hb.stop()
print("RESULT", codes, blobs, sorted(ages), lost)
multihost.shutdown()
"""


def test_agreement_blobs_and_heartbeat_on_two_processes():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _AGREE, str(port),
                               str(r)], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se
        res.append(next(ln for ln in so.splitlines()
                        if ln.startswith("RESULT")))
    for r, line in enumerate(res):
        assert "[0, 3, 5]" in line                 # the agreed worst codes
        assert "['r0', 'r1']" in line              # blobs in rank order
        assert f"[{1 - r}]" in line                # the peer it watched
    assert res[0].endswith("[1]")                  # rank 1 declared lost
