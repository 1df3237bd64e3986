"""The port's fault injector (acg_tpu_torch.faults) and the detecting
loops it exercises, against the JAX package's on the same inputs.

Each fault case runs the reference's solver and the port's (on the CPU,
the kernels' plain versions) under the same spec with the same recovery
policy: the same breakdown, restart and iteration counts, the same
recovery log lines, and x within 1e-10 (f64).  Parsing, refusals and the
CLI's stats lines match too.  Every test that arms the injector disarms
it and leaves ``ACG_TPU_FAULT_INJECT`` as it found it: both packages
read that variable in one process.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu import faults as jf
from acg_tpu import health as jh
from acg_tpu.errors import AcgError as JaxAcgError
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
from acg_tpu_torch import faults
from acg_tpu_torch import health
from acg_tpu_torch.errors import AcgError, BreakdownError
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


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both injectors disarmed and the
    shared env var as it was."""
    prev = os.environ.pop(faults.ENV_VAR, None)
    faults.install(None)
    jf.install(None)
    yield
    faults.install(None)
    jf.install(None)
    if prev is None:
        os.environ.pop(faults.ENV_VAR, None)
    else:
        os.environ[faults.ENV_VAR] = prev


@pytest.fixture(scope="module")
def sys16():
    csr = SymCsrMatrix.from_mtx(poisson_mtx(16, dim=2)).to_csr()
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(16, dim=2)).to_csr()
    assert (csr != jcsr).nnz == 0
    b = csr @ np.random.default_rng(3).standard_normal(csr.shape[0])
    return csr, b


def _rel(x, y):
    return float(np.linalg.norm(np.asarray(x) - np.asarray(y))
                 / np.linalg.norm(np.asarray(y)))


# -- the grammar -------------------------------------------------------------

SPECS = ["spmv:nan@7", "spmv:inf@7:part=2", "halo:nan@3", "dot:neg@5",
         "dot:zero@5", "dot:nan@5", "precond:inf@4:seed=9", "sdc:flip@7",
         "crash:exit@20", "solve:slow@10:secs=0.05"]


@pytest.mark.parametrize("text", SPECS)
def test_spec_parsing_matches_reference(text):
    t, j = faults.parse_fault_spec(text), jf.parse_fault_spec(text)
    assert str(t) == str(j) == text
    for f in ("site", "mode", "iteration", "part", "proc", "secs", "seed"):
        assert getattr(t, f) == getattr(j, f)
    assert t.device_site == j.device_site
    assert str(t.shift(3)) == str(j.shift(3))
    assert (t.shift(100) is None) == (j.shift(100) is None)


BAD = ["spmv", "nope:nan@1", "spmv:boom@1", "spmv:nan@x", "spmv:nan",
       "spmv:nan@1:color=2", "solve:slow@3", "crash:exit"]


@pytest.mark.parametrize("text", BAD)
def test_bad_specs_refused_like_reference(text):
    with pytest.raises(ValueError) as t:
        faults.parse_fault_spec(text)
    with pytest.raises(ValueError) as j:
        jf.parse_fault_spec(text)
    if "nope" in text:
        # the port's site list leaves out the supervisor's two sites
        assert "unknown site 'nope'" in str(t.value)
    else:
        assert str(t.value) == str(j.value)


@pytest.mark.parametrize("text", ["peer:dead:proc=1",
                                  "backend:hang:secs=120"])
def test_supervisor_sites_refused_by_name(text):
    jf.parse_fault_spec(text)   # the reference takes them
    with pytest.raises(ValueError, match="multi-process supervisor"):
        faults.parse_fault_spec(text)


def test_env_var_and_suppression():
    os.environ[faults.ENV_VAR] = "spmv:nan@7"
    assert str(faults.active_fault()) == "spmv:nan@7"
    with faults.suppressed():
        assert faults.active_fault() is None
    os.environ[faults.ENV_VAR] = "spmv:oops"
    with pytest.raises(AcgError, match=faults.ENV_VAR):
        faults.active_fault()


def test_device_sites_fire_once_masked_by_live():
    spec = faults.parse_fault_spec("spmv:nan@3:seed=5")
    y = torch.arange(10, dtype=torch.float64)
    assert faults.FaultSpec.apply_spmv(spec, y, 2) is y
    assert torch.isnan(spec.apply_spmv(y, 3)[5])
    frozen = spec.apply_spmv(y, 3, torch.tensor(False))
    assert torch.equal(frozen, y)
    stacked = torch.ones((4, 6), dtype=torch.float64)
    part = faults.parse_fault_spec("halo:inf@1:part=2").apply_halo(
        stacked, 1)
    assert torch.isinf(part[2, 0]) and torch.isfinite(
        part[[0, 1, 3]]).all()
    flip = faults.parse_fault_spec("sdc:flip@0:seed=1").apply_spmv(
        torch.tensor([1.0, 2.0]), 0)
    assert flip.tolist() == [1.0, -2.0]


# -- the single-device solver -------------------------------------------------

CASES = [
    ("spmv:nan@7", False, None, None),
    ("dot:neg@5", True, None, None),
    ("dot:zero@5", False, None, None),
    ("dot:nan@5", True, None, None),
    ("precond:nan@4", False, "jacobi", None),
    ("precond:nan@4", True, "jacobi", None),
    ("spmv:nan@7", True, None, None),
    ("sdc:flip@7", False, None, dict(every=4, abft=True)),
    ("sdc:flip@7", True, None, dict(every=4, abft=True)),
]


@pytest.mark.parametrize("spec,pipelined,precond,hl", CASES)
def test_fault_recovery_matches_reference(sys16, spec, pipelined, precond,
                                          hl):
    csr, b = sys16
    J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64), pipelined=pipelined,
                    precond=precond, recovery=JaxPolicy(),
                    health=jh.make_spec(**hl) if hl else None)
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU),
                      pipelined=pipelined, precond=precond, kernels="pallas",
                      recovery=RecoveryPolicy(), device=CPU,
                      health=health.make_spec(**hl) if hl else None)
    with jf.injected(spec):
        xj = np.asarray(J.solve(b, criteria=JaxCrit(**KW)))
    with faults.injected(spec):
        xt = T.solve(b, criteria=StoppingCriteria(**KW))
    js, ts = J.stats, T.stats
    assert ts.converged and js.converged
    assert (ts.niterations, ts.nbreakdowns, ts.nrestarts) == \
        (js.niterations, js.nbreakdowns, js.nrestarts)
    assert ts.nbreakdowns >= 1
    assert ts.recovery_log == js.recovery_log
    assert _rel(xt, xj) <= 1e-10
    resil = [ln for ln in ts.fwrite().splitlines() if "resilience" in ln
             or "breakdown detected" in ln]
    assert resil == [ln for ln in js.fwrite().splitlines()
                     if "resilience" in ln or "breakdown detected" in ln]
    if hl:
        assert ts.health["abft"]["ntrips"] == js.health["abft"]["ntrips"] \
            == 1
        assert ts.health["abft"]["nchecks"] == js.health["abft"]["nchecks"]


@pytest.mark.parametrize("spec", ["spmv:nan@5", "dot:zero@3"])
def test_fault_without_recovery_raises_like_reference(sys16, spec):
    csr, b = sys16
    J = JaxCGSolver(jax_dm(csr, dtype=jnp.float64))
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU), device=CPU)
    with jf.injected(spec), pytest.raises(JaxBreakdown) as je:
        J.solve(b, criteria=JaxCrit(**KW))
    with faults.injected(spec), pytest.raises(BreakdownError) as te:
        T.solve(b, criteria=StoppingCriteria(**KW))
    assert str(te.value).replace("torch-cg", "jax-cg") == str(je.value)
    assert T.stats.nbreakdowns == J.stats.nbreakdowns == 1
    assert T.stats.nrestarts == 0


@pytest.mark.parametrize("spec,kw", [
    ("halo:nan@3", {}), ("spmv:nan@3:part=1", {}),
    ("precond:nan@3", {}), ("crash:exit@5", {}),
    ("spmv:nan@3", {"kernels": "fused"})])
def test_refusals_match_reference(sys16, spec, kw):
    csr, b = sys16
    dt = jnp.float32 if kw else jnp.float64
    tdt = torch.float32 if kw else torch.float64
    if kw:
        from acg_tpu.ops.spmv import DiaMatrix as JaxDia
        from acg_tpu_torch.io.generators import poisson_dia
        from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
        # a DIA matrix on the fused kernels' route (shifted 128^2)
        planes, offsets, N = poisson_dia(128, 2)
        planes = [np.array(p, copy=True) for p in planes]
        planes[offsets.index(0)] += 2.0
        csr = None
        jA = JaxDia(data=tuple(jnp.asarray(p, dt) for p in planes),
                    offsets=offsets, nrows=N, ncols_padded=N)
        tA = device_matrix_from_arrays(
            "dia", planes, {"offsets": offsets, "nrows": N,
                            "ncols_padded": N}, dtype=tdt, device=CPU)
    else:
        jA = jax_dm(csr, dtype=dt)
        tA = device_matrix_from_csr(csr, dtype=tdt, device=CPU)
    n = tA.nrows
    J = JaxCGSolver(jA, **kw)
    T = TorchCGSolver(tA, device=CPU, **kw)
    with jf.injected(spec), pytest.raises(JaxAcgError) as je:
        J.solve(np.ones(n), criteria=JaxCrit(**KW))
    with faults.injected(spec), pytest.raises(AcgError) as te:
        T.solve(np.ones(n), criteria=StoppingCriteria(**KW))
    assert str(te.value) == str(je.value)


# -- stacked parts -------------------------------------------------------------

@pytest.fixture(scope="module")
def parts16(sys16):
    csr, _ = sys16
    part = partition_rows(csr, 4, seed=1, method="graph", use_metis="never")
    return part


@pytest.mark.parametrize("spec,pipelined,comm,hl", [
    ("halo:nan@3:part=2", False, "xla", None),
    ("halo:nan@3", False, "dma", None),
    ("spmv:nan@3:part=2", True, "xla", None),
    ("dot:neg@4", False, "dma", None),
    ("sdc:flip@7", False, "xla", dict(every=1, abft=True))])
def test_dist_fault_recovery_matches_reference(sys16, parts16, spec,
                                               pipelined, comm, hl):
    csr, b = sys16
    J = JaxDist(JaxProblem.build(csr, parts16, 4, dtype=jnp.float64),
                pipelined=pipelined, recovery=JaxPolicy(),
                health=jh.make_spec(**hl) if hl else None)
    T = DistCGSolver(DistributedProblem.build(csr, parts16, 4),
                     pipelined=pipelined, comm=comm, kernels="pallas",
                     recovery=RecoveryPolicy(), device=CPU,
                     health=health.make_spec(**hl) if hl else None)
    with jf.injected(spec):
        xj = np.asarray(J.solve(b, criteria=JaxCrit(**KW)))
    with faults.injected(spec):
        xt = T.solve(b, criteria=StoppingCriteria(**KW))
    js, ts = J.stats, T.stats
    assert (ts.niterations, ts.nbreakdowns, ts.nrestarts) == \
        (js.niterations, js.nbreakdowns, js.nrestarts)
    assert ts.nbreakdowns == 1 and ts.recovery_log == js.recovery_log
    assert _rel(xt, xj) <= 1e-10


@pytest.mark.parametrize("spec", ["halo:nan@3:part=7", "halo:nan@2"])
def test_dist_refusals_match_reference(sys16, parts16, spec):
    csr, b = sys16
    if spec == "halo:nan@2":
        # one part: no halo to poison
        args = (np.zeros(csr.shape[0], dtype=np.int32), 1)
    else:
        args = (parts16, 4)
    J = JaxDist(JaxProblem.build(csr, *args, dtype=jnp.float64))
    T = DistCGSolver(DistributedProblem.build(csr, *args), device=CPU)
    with jf.injected(spec), pytest.raises(JaxAcgError) as je:
        J.solve(b, criteria=JaxCrit(**KW))
    with faults.injected(spec), pytest.raises(AcgError) as te:
        T.solve(b, criteria=StoppingCriteria(**KW))
    assert str(te.value) == str(je.value)


# -- the host oracle ---------------------------------------------------------

@pytest.mark.parametrize("spec", ["spmv:nan@6", "dot:neg@4", "sdc:flip@7"])
def test_host_cg_fault_matches_reference(sys16, spec):
    csr, b = sys16
    hl = dict(every=2, abft=True) if spec.startswith("sdc") else None
    J = JaxHost(csr, recovery=JaxPolicy(),
                health=jh.make_spec(**hl) if hl else None)
    T = HostCGSolver(csr, recovery=RecoveryPolicy(),
                     health=health.make_spec(**hl) if hl else None)
    with jf.injected(spec):
        xj = J.solve(b, criteria=JaxCrit(**KW))
    with faults.injected(spec):
        xt = T.solve(b, criteria=StoppingCriteria(**KW))
    assert (T.stats.niterations, T.stats.nrestarts) == \
        (J.stats.niterations, J.stats.nrestarts)
    assert T.stats.recovery_log == J.stats.recovery_log
    assert np.array_equal(xt, xj)


# -- the CLI -----------------------------------------------------------------

def _cli_block(main, argv, capsys):
    rc = main(argv)
    err = capsys.readouterr().err
    keep = ("iterations:", "resilience:", "breakdown detected",
            "fallback:", "ntrips:", "nchecks:")
    # the stats block's lines (the stderr event lines name the package)
    return rc, [ln.strip() for ln in err.splitlines()
                if any(k in ln for k in keep)
                and not ln.startswith("acg-tpu")]


@pytest.mark.parametrize("extra", [
    ["--fault-inject", "spmv:nan@7", "--recover"],
    ["--fault-inject", "dot:neg@5", "--solver", "acg-pipelined",
     "--recover"],
    ["--fault-inject", "precond:nan@4", "--precond", "jacobi",
     "--max-restarts", "1"],
    ["--fault-inject", "sdc:flip@7", "--abft", "--audit-every", "4"],
    ["--fault-inject", "halo:nan@3:part=2", "--nparts", "4",
     "--recover"],
    ["--fault-inject", "spmv:nan@3", "--solver", "host", "--recover"]])
def test_cli_fault_inject_matches_reference(extra, capsys):
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main
    argv = ["gen:poisson2d:16", "--max-iterations", "500",
            "--residual-rtol", "1e-10", "-q"] + extra
    if "--nparts" not in extra:
        argv += ["--nparts", "1"]
    rt, lt = _cli_block(main, argv + ["--device", "cpu"], capsys)
    assert os.environ.get(faults.ENV_VAR) is None
    rj, lj = _cli_block(jax_main, argv, capsys)
    assert rt == rj == 0
    assert lt == lj
    assert any("resilience:" in ln for ln in lt)


@pytest.mark.parametrize("argv,msg", [
    (["--fault-inject", "solve:slow@3:secs=1"], "add --soak N"),
    (["--fault-inject", "crash:exit@5"], "arm --ckpt FILE"),
    (["--fault-inject", "spmv:nan@3", "--solver", "petsc"],
     "no injection sites"),
    (["--fault-inject", "peer:dead:proc=1"], "multi-process supervisor"),
    (["--fault-inject", "spmv:nan@3", "--nrhs", "2"], "--nrhs/--block-cg")])
def test_cli_fault_refusals(argv, msg):
    from acg_tpu_torch.cli import main
    with pytest.raises(SystemExit) as e:
        main(["gen:poisson2d:8", "--device", "cpu", "-q"] + argv)
    assert msg in str(e.value)
    assert os.environ.get(faults.ENV_VAR) is None
