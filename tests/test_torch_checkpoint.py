"""The port's checkpoint tier (acg_tpu_torch.checkpoint and the chunk
drivers of ChunkedCGSolver/HostCGSolver) against the JAX package's.

A snapshot is the reference's file: the bytes of one written by either
package for the same metadata are equal, and a snapshot written by one
resumes in the other (the same carry names, shapes -- 0-d scalars stay
0-d -- and a solve that finishes within 1e-10 of an uninterrupted one).
On the port a checkpoint-chunked classic solve is bitwise its
uninterrupted solve, and a resumed one bitwise the uninterrupted chunked
solve; crash:exit kills a child process after its snapshot, which
--resume continues; --resume-repartition moves a 4-part snapshot onto 2
parts, one device and the host oracle; the rollback rung restores the
last snapshot before a restart, as the reference's does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu import checkpoint as jck
from acg_tpu import faults as jf
from acg_tpu.errors import AcgError as JaxAcgError
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dm
from acg_tpu.parallel.dist import DistCGSolver as JaxDist
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.resilience import RecoveryPolicy as JaxPolicy
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch import checkpoint as ck
from acg_tpu_torch import faults
from acg_tpu_torch.errors import AcgError
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
KW = dict(maxits=500, residual_rtol=1e-10)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return csr, b


def _dev(csr):
    return device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)


def _rel(x, y):
    return float(np.linalg.norm(np.asarray(x) - np.asarray(y))
                 / np.linalg.norm(np.asarray(y)))


# -- the file ----------------------------------------------------------------

def test_snapshot_bytes_equal_the_references(tmp_path):
    meta = {"tier": "jax-cg", "n": 3, "iteration": 7, "seq": 1,
            "env": {"jax": "x"}}
    arrays = {"x": np.arange(3.0), "r": np.ones(3, np.float32),
              "gamma": np.float64(2.5), "_rowperm": np.arange(3)}
    a, b = tmp_path / "a.ckpt", tmp_path / "b.ckpt"
    na = ck.save_snapshot(a, meta, arrays)
    nb = jck.save_snapshot(b, meta, arrays)
    assert na == nb and a.read_bytes() == b.read_bytes()
    snap = ck.load_snapshot(b)
    assert snap.arrays["gamma"].shape == ()       # 0-d stays 0-d
    assert snap.iteration == 7


def test_env_stamp_names_torch_not_jax(tmp_path):
    p = tmp_path / "e.ckpt"
    ck.save_snapshot(p, {"iteration": 0}, {"x": np.zeros(2)})
    env = ck.load_snapshot(p).meta["env"]
    assert env["torch"] == torch.__version__ and "jax" not in env
    # a reference snapshot's jax stamp is not compared, only warned on
    # keys both sides record
    snap = jck.load_snapshot(p)
    assert ck.check_resume_env(ck.SolverSnapshot(meta={"env": {
        "jax": "0.1"}}, arrays={})) == []
    assert ck.check_resume_env(ck.SolverSnapshot(
        meta={"env": {**env, "torch": "0.0"}}, arrays={})) != []
    assert snap.meta["env"] == env


def test_corrupted_snapshots_refuse_like_the_reference(tmp_path):
    p = tmp_path / "c.ckpt"
    ck.save_snapshot(p, {"iteration": 1}, {"x": np.ones(4)})
    blob = bytearray(p.read_bytes())
    blob[-3] ^= 0xFF
    p.write_bytes(bytes(blob))
    with pytest.raises(AcgError) as t:
        ck.load_snapshot(p)
    with pytest.raises(JaxAcgError) as j:
        jck.load_snapshot(p)
    assert str(t.value) == str(j.value)
    assert "payload checksum" in str(t.value)


@pytest.mark.parametrize("pipelined,precond", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_carry_names_match_the_reference(pipelined, precond):
    assert ck.carry_names(pipelined, precond) == \
        jck.carry_names(pipelined, precond)


# -- chunked and resumed solves -------------------------------------------------

@pytest.mark.parametrize("precond,every", [(None, 7), (None, 1),
                                          ("jacobi", 11), (None, 0.0)])
def test_chunked_solve_is_bitwise_the_uninterrupted_one(sys16, tmp_path,
                                                        precond, every):
    csr, b = sys16
    A = _dev(csr)
    x0 = TorchCGSolver(A, device=CPU, kernels="pallas",
                       precond=precond).solve(b, criteria=StoppingCriteria(
                           **KW))
    cfg = (ck.CheckpointConfig(path=str(tmp_path / "s.ckpt"),
                               secs=1e-4) if every == 0.0 else
           ck.CheckpointConfig(path=str(tmp_path / "s.ckpt"), every=every))
    T = TorchCGSolver(A, device=CPU, kernels="pallas", precond=precond,
                      ckpt=cfg)
    x = T.solve(b, criteria=StoppingCriteria(**KW))
    assert np.array_equal(x, x0)
    assert T.stats.ckpt["snapshots"] >= 1
    assert T.stats.ckpt["iteration"] == T.stats.niterations
    snap = ck.load_snapshot(tmp_path / "s.ckpt")
    names = ck.carry_names(False, precond is not None)
    assert tuple(sorted(snap.arrays)) == tuple(sorted(names))
    assert all(snap.arrays[k].shape == () for k in ck.SCALAR_LEAVES
               if k in snap.arrays)


def test_stacked_chunked_solve_is_bitwise_the_uninterrupted_one(sys16,
                                                                tmp_path):
    csr, b = sys16
    part = partition_rows(csr, 4, seed=1, method="graph", use_metis="never")
    prob = DistributedProblem.build(csr, part, 4)
    x0 = DistCGSolver(prob, device=CPU, comm="dma").solve(
        b, criteria=StoppingCriteria(**KW))
    T = DistCGSolver(prob, device=CPU, comm="dma", ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "d.ckpt"), every=9))
    assert np.array_equal(T.solve(b, criteria=StoppingCriteria(**KW)), x0)
    snap = ck.load_snapshot(tmp_path / "d.ckpt")
    assert snap.meta["nparts"] == 4 and snap.arrays["x"].shape[0] == 4
    assert snap.meta["part_rows"] == prob.part_rows()
    assert np.array_equal(snap.arrays["_rowperm"], prob.row_permutation())


@pytest.mark.parametrize("pipelined", [False, True])
def test_snapshots_resume_across_the_packages(sys16, tmp_path, pipelined):
    csr, b = sys16
    A = _dev(csr)
    x_ref = TorchCGSolver(A, device=CPU, pipelined=pipelined).solve(
        b, criteria=StoppingCriteria(**KW))
    # written by the reference, resumed by the port
    J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64), pipelined=pipelined,
                    ckpt=jck.CheckpointConfig(path=str(tmp_path / "j.ckpt"),
                                              every=20))
    J.solve(b, criteria=JaxCrit(maxits=40, residual_rtol=1e-10),
            raise_on_divergence=False)
    js = ck.load_snapshot(tmp_path / "j.ckpt")
    assert tuple(js.arrays) == ck.carry_names(pipelined, False)
    T = TorchCGSolver(A, device=CPU, pipelined=pipelined,
                      ckpt=ck.CheckpointConfig(resume=js))
    x = T.solve(b, criteria=StoppingCriteria(**KW))
    assert T.stats.ckpt["resumed_from"] == 40
    assert _rel(x, x_ref) <= 1e-10
    # written by the port, resumed by the reference
    T2 = TorchCGSolver(A, device=CPU, pipelined=pipelined,
                       ckpt=ck.CheckpointConfig(
                           path=str(tmp_path / "t.ckpt"), every=20))
    T2.solve(b, criteria=StoppingCriteria(maxits=40, residual_rtol=1e-10),
             raise_on_divergence=False)
    ts = jck.load_snapshot(tmp_path / "t.ckpt")
    assert tuple(ts.arrays) == jck.carry_names(pipelined, False)
    J2 = JaxCGSolver(jax_dm(csr, dtype=jnp.float64), pipelined=pipelined,
                     ckpt=jck.CheckpointConfig(resume=ts))
    xj = np.asarray(J2.solve(b, criteria=JaxCrit(**KW)))
    assert J2.stats.ckpt["resumed_from"] == 40
    assert J2.stats.ckpt["iteration"] == T.stats.ckpt["iteration"]
    assert _rel(xj, x_ref) <= 1e-10


def test_resume_refusals_match_the_reference(sys16, tmp_path):
    csr, b = sys16
    T = TorchCGSolver(_dev(csr), device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "r.ckpt"), every=5))
    T.solve(b, criteria=StoppingCriteria(maxits=10, residual_rtol=1e-10),
            raise_on_divergence=False)
    snap = ck.load_snapshot(tmp_path / "r.ckpt")
    for kw in (dict(tier="dist-cg", pipelined=False, precond=None, n=256,
                    dtype=np.float64, nparts=4),
               dict(tier="jax-cg", pipelined=True, precond=None, n=256,
                    dtype=np.float64),
               dict(tier="jax-cg", pipelined=False, precond=None, n=255,
                    dtype=np.float64),
               dict(tier="jax-cg", pipelined=False, precond=None, n=256,
                    dtype=np.float64, b_crc=1)):
        with pytest.raises(AcgError) as t:
            ck.validate_resume(snap, **kw)
        with pytest.raises(JaxAcgError) as j:
            jck.validate_resume(jck.SolverSnapshot(snap.meta, snap.arrays),
                                **kw)
        assert str(t.value) == str(j.value)
    # resuming the solve with another right-hand side refuses
    T2 = TorchCGSolver(_dev(csr), device=CPU,
                       ckpt=ck.CheckpointConfig(resume=snap))
    with pytest.raises(AcgError, match="right-hand-side checksum"):
        T2.solve(b + 1.0, criteria=StoppingCriteria(**KW))


@pytest.mark.parametrize("target", ["dist2", "single", "host"])
def test_resume_repartition_from_four_parts(sys16, tmp_path, target):
    csr, b = sys16
    x_ref = TorchCGSolver(_dev(csr), device=CPU).solve(
        b, criteria=StoppingCriteria(**KW))
    part4 = partition_rows(csr, 4, seed=1, method="graph", use_metis="never")
    D4 = DistCGSolver(DistributedProblem.build(csr, part4, 4), device=CPU,
                      ckpt=ck.CheckpointConfig(path=str(tmp_path / "4.ckpt"),
                                               every=20))
    D4.solve(b, criteria=StoppingCriteria(maxits=40, residual_rtol=1e-10),
             raise_on_divergence=False)
    snap = ck.load_snapshot(tmp_path / "4.ckpt")
    cfg = ck.CheckpointConfig(resume=snap, repartition=True)
    if target == "dist2":
        part2 = partition_rows(csr, 2, seed=1, method="graph",
                               use_metis="never")
        S = DistCGSolver(DistributedProblem.build(csr, part2, 2),
                         device=CPU, ckpt=cfg)
    elif target == "single":
        S = TorchCGSolver(_dev(csr), device=CPU, ckpt=cfg)
    else:
        S = HostCGSolver(csr, ckpt=cfg)
    x = S.solve(b, criteria=StoppingCriteria(**KW))
    assert S.stats.ckpt["resumed_from"] == 40
    assert _rel(x, x_ref) <= 1e-9
    if target != "host":
        assert S.stats.ckpt["repartitioned_from"] == {"tier": "dist-cg",
                                                      "nparts": 4}
    # the reference repartitions the port's snapshot the same way
    if target == "dist2":
        jS = JaxDist(JaxProblem.build(csr, part2, 2, dtype=jnp.float64),
                     ckpt=jck.CheckpointConfig(resume=jck.load_snapshot(
                         tmp_path / "4.ckpt"), repartition=True))
        xj = np.asarray(jS.solve(b, criteria=JaxCrit(**KW)))
        assert jS.stats.niterations == S.stats.niterations
        assert _rel(xj, x) <= 1e-10
    # without the opt-in the shape mismatch refuses
    with pytest.raises(AcgError, match="snapshot does not match"):
        TorchCGSolver(_dev(csr), device=CPU, ckpt=ck.CheckpointConfig(
            resume=snap)).solve(b, criteria=StoppingCriteria(**KW))


@pytest.mark.parametrize("tier", ["single", "dist", "host"])
def test_rollback_rung_matches_the_reference(sys16, tmp_path, tier):
    """A NaN at iteration 12 under 5-iteration chunks: the ladder rolls
    back to the snapshot at 10 (no restart spent), the fault vanishes,
    and the solve finishes the uninterrupted trajectory."""
    csr, b = sys16
    spec = "spmv:nan@12"
    jp, tp = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    if tier == "single":
        J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64), recovery=JaxPolicy(),
                        ckpt=jck.CheckpointConfig(path=jp, every=5))
        T = TorchCGSolver(_dev(csr), device=CPU, recovery=RecoveryPolicy(),
                          ckpt=ck.CheckpointConfig(path=tp, every=5))
    elif tier == "dist":
        part = partition_rows(csr, 4, seed=1, method="graph",
                              use_metis="never")
        J = JaxDist(JaxProblem.build(csr, part, 4, dtype=jnp.float64),
                    recovery=JaxPolicy(),
                    ckpt=jck.CheckpointConfig(path=jp, every=5))
        T = DistCGSolver(DistributedProblem.build(csr, part, 4), device=CPU,
                         recovery=RecoveryPolicy(),
                         ckpt=ck.CheckpointConfig(path=tp, every=5))
    else:
        from acg_tpu.solvers.host_cg import HostCGSolver as JaxHost
        J = JaxHost(csr, recovery=JaxPolicy(),
                    ckpt=jck.CheckpointConfig(path=jp, every=5))
        T = HostCGSolver(csr, recovery=RecoveryPolicy(),
                         ckpt=ck.CheckpointConfig(path=tp, every=5))
    with jf.injected(spec):
        xj = np.asarray(J.solve(b, criteria=JaxCrit(**KW)))
    with faults.injected(spec):
        xt = T.solve(b, criteria=StoppingCriteria(**KW))
    st, js = T.stats, J.stats
    assert (st.nbreakdowns, st.nrestarts, st.nrollbacks) == \
        (js.nbreakdowns, js.nrestarts, js.nrollbacks)
    assert st.nrollbacks == 1 and st.nrestarts == 0
    assert st.recovery_log == js.recovery_log
    assert st.ckpt == {**js.ckpt, "path": tp}
    assert _rel(xt, xj) <= 1e-10
    assert "1 rollbacks" in st.fwrite()


# -- the CLI -----------------------------------------------------------------

def _cli(argv, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "acg_tpu_torch"] + argv,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_crash_exit_then_resume_in_subprocesses(tmp_path):
    base = ["gen:poisson2d:24", "--device", "cpu", "--max-iterations",
            "500", "--residual-rtol", "1e-10", "-q"]
    env = {k: v for k, v in os.environ.items() if k != faults.ENV_VAR}
    snap = str(tmp_path / "c.ckpt")
    crashed = _cli(base + ["--ckpt", snap, "--ckpt-every", "10",
                           "--fault-inject", "crash:exit@25", "-o",
                           str(tmp_path / "dead.mtx")], env=env)
    assert crashed.returncode == 94, crashed.stderr
    assert "hard exit at 30 iterations" in crashed.stderr
    assert not (tmp_path / "dead.mtx").exists()
    assert ck.load_snapshot(snap).iteration == 30
    resumed = _cli(base + ["--resume", snap, "-o",
                           str(tmp_path / "x1.mtx")], env=env)
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed_from: 30" in resumed.stderr
    clean = _cli(base + ["-o", str(tmp_path / "x0.mtx")], env=env)
    assert clean.returncode == 0
    assert (tmp_path / "x1.mtx").read_bytes() == \
        (tmp_path / "x0.mtx").read_bytes()


def test_cli_ckpt_section_matches_reference(tmp_path, capsys):
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main
    argv = ["gen:poisson2d:16", "--nparts", "1", "--max-iterations", "500",
            "--residual-rtol", "1e-10", "-q", "--ckpt-every", "6"]
    out = []
    for m, extra in ((main, ["--device", "cpu", "--ckpt",
                             str(tmp_path / "t.ckpt")]),
                     (jax_main, ["--ckpt", str(tmp_path / "j.ckpt")])):
        assert m(argv + extra) == 0
        lines = capsys.readouterr().err.splitlines()
        i = lines.index("ckpt:")
        out.append([ln for ln in lines[i + 1:] if ln.startswith("  ")
                    and "path:" not in ln])
    assert out[0] == out[1] and any("snapshots:" in ln for ln in out[0])


@pytest.mark.parametrize("argv,msg", [
    (["--ckpt", "x.ckpt"], "needs a snapshot cadence"),
    (["--ckpt-every", "5"], "need --ckpt FILE"),
    (["--ckpt", "x", "--ckpt-every", "5", "--ckpt-secs", "1"],
     "mutually exclusive"),
    (["--resume-repartition"], "add --resume FILE"),
    (["--ckpt", "x", "--ckpt-every", "5", "--kernels", "fused"],
     "--kernels fused"),
    (["--resume", "/nonexistent.ckpt"], "nonexistent"),
    (["--ckpt", "x", "--ckpt-every", "5", "--algorithm", "sstep:4"],
     "--algorithm sstep:4")])
def test_cli_ckpt_refusals(argv, msg):
    from acg_tpu_torch.cli import main
    with pytest.raises(SystemExit) as e:
        main(["gen:poisson2d:8", "--device", "cpu", "-q"] + argv)
    assert msg in str(e.value)
