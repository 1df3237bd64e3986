"""The rank-mode tier completed: precond, the CA recurrences, recovery,
the audit, checkpoints and the supervisor's fault sites across processes.

Two gloo processes on the CPU (``--device cpu``, jax and acg_tpu blocked
in the children) are held bitwise against the port's one-process stacked
run of the same flags (x and the iterations), and against the
reference's single-controller solve of the same parts on the 8-device
CPU mesh (the same iterations and restarts, x within 1e-10)."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from acg_tpu.io.generators import poisson_mtx
from acg_tpu.io.mtxfile import write_mtx
from acg_tpu_torch import faults
from acg_tpu_torch.io.mtxfile import read_mtx
from tests.test_torch_multihost import _value, run_pair

torch.set_num_threads(min(2, torch.get_num_threads()))

BASE = ["--nparts", "4", "--max-iterations", "2000", "--residual-rtol",
        "1e-10", "--warmup", "0", "-q"]


@pytest.fixture(autouse=True)
def _disarmed():
    prev = os.environ.pop(faults.ENV_VAR, None)
    faults.install(None)
    yield
    faults.install(None)
    if prev is not None:
        os.environ[faults.ENV_VAR] = prev


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("rank") / "poisson2d_n16.mtx"
    write_mtx(path, poisson_mtx(16, dim=2))
    return path


def _x(path):
    return np.asarray(read_mtx(path, binary=True).vals, np.float64)


def _one(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def _resilience(text):
    line = next((ln for ln in text.splitlines()
                 if ln.strip().startswith("resilience:")), None)
    return None if line is None else line.split(":", 1)[1].strip()


CASES = {
    "jacobi": ["--precond", "jacobi"],
    "bjacobi": ["--precond", "bjacobi:4", "--solver", "acg-pipelined"],
    "sstep4": ["--algorithm", "sstep:4"],
    "pl2": ["--algorithm", "pipelined:2"],
    "recover": ["--comm", "dma", "--fault-inject", "spmv:nan@5:part=2",
                "--recover"],
    "halo": ["--fault-inject", "halo:nan@3:part=1", "--recover"],
    "recover-pipelined": ["--comm", "dma", "--solver", "acg-pipelined",
                          "--fault-inject", "dot:neg@5", "--recover"],
    "audit": ["--audit-every", "5", "--abft"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_mode_is_the_stacked_tier(matrix_file, tmp_path, case):
    """Two processes: x and the iterations are the one-process stacked
    run's bits; the reference's mesh solve takes the same iterations and
    restarts, x within 1e-10 relative."""
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main

    argv = [str(matrix_file)] + BASE + CASES[case]
    res = run_pair(argv + ["-o", str(tmp_path / "x2.mtx")], timeout=300)
    assert all(rc == 0 for rc, _, _ in res), res[0][2] + res[1][2]
    rc, err1 = _one(main, argv + ["--device", "cpu", "-o",
                                  str(tmp_path / "x1.mtx")])
    assert rc == 0, err1
    err2 = res[0][2]
    assert _value(err2, "total iterations") == \
        _value(err1, "total iterations")
    assert (tmp_path / "x2.mtx").read_bytes() == \
        (tmp_path / "x1.mtx").read_bytes()
    assert _resilience(err2) == _resilience(err1)
    rc, errj = _one(jax_main, argv + ["-o", str(tmp_path / "xj.mtx")])
    assert rc == 0, errj
    xj, x2 = _x(tmp_path / "xj.mtx"), _x(tmp_path / "x2.mtx")
    if case == "pl2":
        # p(l)'s square-root breakdowns land where the rounding of the
        # psum'd window dots puts them: the stacked tier restarts at
        # other iterations than the reference's mesh (test_torch_
        # recurrence.py's test_dist_pl_converges); both converge
        from acg_tpu_torch.matrix import SymCsrMatrix
        csr = SymCsrMatrix.from_mtx(read_mtx(matrix_file)).to_csr()
        b = np.ones(csr.shape[0])
        for x in (x2, xj):
            assert np.linalg.norm(b - csr @ x) <= 1e-9 * np.linalg.norm(b)
        assert "restarts" in _resilience(err2)
        return
    assert _value(errj, "total iterations") == \
        _value(err2, "total iterations")
    assert _resilience(errj) == _resilience(err2)
    assert np.linalg.norm(x2 - xj) <= 1e-10 * np.linalg.norm(xj)
    if case == "recover":
        assert "1 restarts" in _resilience(err2)


def test_rank_mode_crash_resume_and_repartition(matrix_file, tmp_path):
    """A pair checkpointing every 10 iterations, killed by crash:exit@25
    (both ranks exit 94 after the snapshot at 30); the pair's --resume
    ends bitwise the uninterrupted pair, and one process resumes the
    two-process snapshot onto 3 parts to the original tolerance."""
    from acg_tpu_torch.checkpoint import load_snapshot
    from acg_tpu_torch.cli import main

    argv = [str(matrix_file)] + BASE
    snap = str(tmp_path / "c.ckpt")
    dead = run_pair(argv + ["--ckpt", snap, "--ckpt-every", "10",
                            "--fault-inject", "crash:exit@25"],
                    timeout=300)
    assert [rc for rc, _, _ in dead] == [94, 94], dead[0][2]
    s = load_snapshot(snap)
    assert s.iteration == 30 and s.meta["nparts"] == 4
    assert s.arrays["x"].shape[0] == 4 and "_rowperm" in s.arrays
    back = run_pair(argv + ["--resume", snap, "-o",
                            str(tmp_path / "xr.mtx")], timeout=300)
    assert all(rc == 0 for rc, _, _ in back), back[0][2]
    assert "resumed_from: 30" in back[0][2]
    clean = run_pair(argv + ["-o", str(tmp_path / "x0.mtx")], timeout=300)
    assert all(rc == 0 for rc, _, _ in clean)
    assert (tmp_path / "xr.mtx").read_bytes() == \
        (tmp_path / "x0.mtx").read_bytes()
    rc, err = _one(main, [str(matrix_file), "--device", "cpu", "--nparts",
                          "3", "--max-iterations", "2000",
                          "--residual-rtol", "1e-10", "--warmup", "0",
                          "-q", "--resume", snap, "--resume-repartition",
                          "-o", str(tmp_path / "x3.mtx")])
    assert rc == 0, err
    assert "repartitioned_from" in err
    from acg_tpu_torch.matrix import SymCsrMatrix
    csr = SymCsrMatrix.from_mtx(read_mtx(matrix_file)).to_csr()
    x3 = _x(tmp_path / "x3.mtx")
    b = np.ones(csr.shape[0])
    assert np.linalg.norm(b - csr @ x3) <= 1e-9 * np.linalg.norm(b)


def test_rank_mode_distributed_read_takes_the_hooks(tmp_path):
    """--distributed-read with --ckpt and --recover: each rank reads its
    rows, every rank solves the gathered global b, and the primary
    commits the snapshots."""
    from acg_tpu_torch.tools.mtx2bin import main as mtx2bin
    src = tmp_path / "p.mtx"
    write_mtx(src, poisson_mtx(16, dim=2))
    binf = str(tmp_path / "p.bin.mtx")
    assert mtx2bin(["--expand", str(src), binf]) in (0, None)
    argv = [binf, "--binary", "--max-iterations", "2000",
            "--residual-rtol", "1e-10", "--warmup", "0", "-q",
            "--recover", "--ckpt", str(tmp_path / "d.ckpt"),
            "--ckpt-every", "10"]
    read = run_pair(argv + ["--distributed-read", "-o",
                            str(tmp_path / "xd.bin")], timeout=300)
    assert all(rc == 0 for rc, _, _ in read), read[0][2] + read[1][2]
    assert "snapshots:" in read[0][2]


def test_rank_mode_mesh_refusals(matrix_file):
    """What the reference's mesh refuses stays refused across processes,
    with its message: CA checkpoints, p(l) audits."""
    argv = [str(matrix_file)] + BASE
    res = run_pair(argv + ["--algorithm", "sstep:4", "--ckpt",
                           "/nonexistent/c", "--ckpt-every", "4"],
                   timeout=120)
    assert all(rc != 0 for rc, _, _ in res)
    assert "checkpoints on the single-device tier only" in res[0][2]
    res = run_pair(argv + ["--algorithm", "pipelined:2", "--audit-every",
                           "4"], timeout=120)
    assert all(rc != 0 for rc, _, _ in res)
    assert "has no in-loop audit hook" in res[0][2]


def test_dead_peer_trips_the_watchdog(matrix_file):
    """peer:dead:proc=1: rank 1 dies before its error agreement (exit
    86), rank 0's watchdog tears it down within --err-timeout (exit
    97)."""
    res = run_pair([str(matrix_file)] + BASE + [
        "--fault-inject", "peer:dead:proc=1", "--err-timeout", "5"],
        timeout=120)
    assert [rc for rc, _, _ in res] == [97, 86], res[0][2] + res[1][2]
    assert "dying before checkpoint" in res[1][2]
    assert "timed out" in res[0][2] or "failed" in res[0][2]


SHARDED = {
    "jacobi": ["--precond", "jacobi"],
    "bjacobi": ["--precond", "bjacobi:8"],
    "sstep4": ["--algorithm", "sstep:4"],
    "cheby": ["--precond", "cheby:3"],
    "recover-audit": ["--fault-inject", "spmv:nan@6", "--recover",
                      "--audit-every", "5"],
}


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_rank_sharded_tier_takes_precond_ca_and_hooks(tmp_path, case):
    """The sharded gen-direct tier's rank form (ACG_TPU_GEN_DIRECT_MIN,
    gen:poisson3d:12 on two processes) takes --precond, --algorithm and
    the robustness hooks: the one-process sharded run's iterations and
    restarts, x within 1e-10 (the ranks fold their partial dots, not one
    reduction over N; s-step's Gram products too, so its last block may
    end one iteration apart)."""
    from acg_tpu_torch.cli import main

    env = {"ACG_TPU_GEN_DIRECT_MIN": "100"}
    argv = ["gen:poisson3d:12", "--nparts", "2", "--warmup", "0",
            "--max-iterations", "500", "--residual-rtol", "1e-10", "-q",
            "--kernels", "pallas"] + SHARDED[case]
    res = run_pair(argv + ["-o", str(tmp_path / "two.bin")],
                   env_extra=env, timeout=300)
    assert all(rc == 0 for rc, _, _ in res), res[0][2] + res[1][2]
    os.environ["ACG_TPU_GEN_DIRECT_MIN"] = "100"
    try:
        rc, err = _one(main, argv + ["--device", "cpu", "-o",
                                     str(tmp_path / "one.bin")])
    finally:
        del os.environ["ACG_TPU_GEN_DIRECT_MIN"]
    assert rc == 0, err
    its2 = int(_value(res[0][2], "total iterations"))
    its1 = int(_value(err, "total iterations"))
    assert abs(its2 - its1) <= (1 if case == "sstep4" else 0)
    assert _resilience(res[0][2]) == _resilience(err)
    x2, x1 = _x(tmp_path / "two.bin"), _x(tmp_path / "one.bin")
    assert np.linalg.norm(x2 - x1) <= 1e-9 * np.linalg.norm(x1)
    if case == "recover-audit":
        assert "1 restarts" in _resilience(err)
        assert _value(res[0][2], "naudits") == _value(err, "naudits")
