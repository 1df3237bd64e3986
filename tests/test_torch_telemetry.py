"""The port's telemetry tier (acg_tpu_torch.telemetry, the trace and
progress hooks of the solvers, the CLI's --convergence-log/--stats-json/
--timeline/--history sinks) against the JAX package's.

Rings: the same iteration numbers as the reference's ring, and values
within 1e-10 relative in f64 -- pointwise for the classic and
preconditioned loops, bitwise for the host oracle (the port's host
solver is the reference's numpy, op for op).  The pipelined
(Ghysels-Vanroose) recurrences amplify the dots' rounding (their sums
run in another order than XLA's) as the residual falls: their first 20
iterations are held pointwise to 1e-10, the residual column everywhere
to 1e-10 of the initial residual norm (the scale the solution tests use,
which reach 1e-10 on x), and the late iterations' alpha, beta and
denominator to 1e-6 relative (measured: up to 4e-8 at 2-norm 3e-8).
The port's documents are read by the reference's readers, and their
keys equal the reference's for the same CLI run but for the manifest's
version and backend fields."""

import contextlib
import io
import json
import math
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from acg_tpu import observatory as jax_observatory
from acg_tpu import telemetry as jax_telemetry
from acg_tpu import tracing as jax_tracing
from acg_tpu.cli import main as jax_main
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dev_matrix
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.solvers.host_cg import HostCGSolver as JaxHostCG
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch import telemetry
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.errors import AcgError, IndefiniteMatrixError
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
from acg_tpu_torch.solvers.host_cg import HostCGSolver

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
RTOL = 1e-10


@pytest.fixture(scope="module")
def csr():
    return JaxSymCsr.from_mtx(jax_poisson_mtx(16, dim=2)).to_csr()


def _b(csr, seed=7):
    return csr @ np.random.default_rng(seed).standard_normal(csr.shape[0])


def _quiet(fn):
    """``fn()`` with stderr captured: (result, stderr text)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res = fn()
    return res, err.getvalue()


def _assert_ring(port, ref, pipelined, r0nrm2=None):
    """The port's trace against the reference's: window, iterations and
    values (see the module docstring for the tolerances)."""
    assert port.niterations == ref.niterations
    assert port.capacity == ref.capacity and port.wrapped == ref.wrapped
    assert np.array_equal(port.iterations, ref.iterations)
    a, c = ref.records, port.records
    assert a.shape == c.shape and np.array_equal(np.isnan(a), np.isnan(c))
    fin = np.isfinite(a)
    err = np.where(fin, np.abs(a - c), 0.0)
    if not pipelined:
        assert np.all(err <= RTOL * np.abs(np.where(fin, a, 0.0)))
        return
    early = ref.iterations < 20
    assert np.all(err[early] <= RTOL * np.abs(np.where(fin, a, 0.0))[early])
    assert np.all(err[:, 0] <= RTOL * r0nrm2)
    assert np.all(err[:, 1:] <= 1e-6 * np.abs(np.where(fin, a, 0.0))[:, 1:])


def _beats(text):
    """(iteration, residual) of every heartbeat line."""
    out = []
    for line in text.splitlines():
        if ": iteration " in line and "residual 2-norm" in line:
            it = int(line.split(": iteration ")[1].split(":")[0])
            res = float(line.split("residual 2-norm ")[1].split(",")[0])
            out.append((it, res))
    return out


_SINGLE = {"classic": {}, "pipelined": {"pipelined": True},
           "precond": {"precond": "jacobi"},
           "precond-pipelined": {"pipelined": True, "precond": "jacobi"}}


@pytest.mark.parametrize("window", [16, 512])
@pytest.mark.parametrize("algo", sorted(_SINGLE))
def test_ring_matches_jax(csr, algo, window):
    """The device ring of each single-device program, wrapped (16 slots)
    and not (512), and the heartbeat's iterations and residuals."""
    kw = _SINGLE[algo]
    b = _b(csr)
    J = JaxCGSolver(jax_dev_matrix(csr, dtype=jnp.float64), kernels="xla",
                    trace=window, progress=10, **kw)
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU),
                      device=CPU, trace=window, progress=10, **kw)
    _, jerr = _quiet(lambda: J.solve(b, criteria=JaxCrit(
        maxits=300, residual_rtol=1e-9)))
    _, terr = _quiet(lambda: T.solve(b, criteria=StoppingCriteria(
        maxits=300, residual_rtol=1e-9)))
    _assert_ring(T.last_trace, J.last_trace, "pipelined" in kw,
                 J.stats.r0nrm2)
    assert T.last_trace.wrapped == (window == 16)
    assert T.stats.trace is T.last_trace
    jb, tb = _beats(jerr), _beats(terr)
    assert [i for i, _ in tb] == [i for i, _ in jb] and tb
    np.testing.assert_allclose([r for _, r in tb], [r for _, r in jb],
                               rtol=1e-8)


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
def test_unbounded_ring_writes_every_step(csr, kernels):
    """No tolerance: every one of the maxits steps is live, the slot is
    the step count (no device counter runs), and the heartbeat reads once
    a chunk."""
    b = _b(csr)
    J = JaxCGSolver(jax_dev_matrix(csr, dtype=jnp.float64), kernels="xla",
                    trace=16, progress=7)
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU),
                      device=CPU, kernels=kernels, trace=16, progress=7)
    _, jerr = _quiet(lambda: J.solve(b, criteria=JaxCrit(maxits=40)))
    _, terr = _quiet(lambda: T.solve(b, criteria=StoppingCriteria(
        maxits=40)))
    _assert_ring(T.last_trace, J.last_trace, False)
    assert [i for i, _ in _beats(terr)] == [7, 14, 21, 28, 35]
    assert [i for i, _ in _beats(terr)] == [i for i, _ in _beats(jerr)]


def test_frozen_steps_leave_the_ring(csr):
    """A solve converging mid-chunk runs frozen steps to the chunk's end:
    the masked writes leave the slots past the last iteration NaN."""
    from acg_tpu_torch.solvers.cg import CHUNK

    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU),
                      device=CPU, trace=512)
    T.solve(_b(csr), criteria=StoppingCriteria(maxits=300,
                                               residual_rtol=1e-9))
    n = T.stats.niterations
    assert n % CHUNK and T.last_trace.niterations == n
    # the ring itself: n rows written, the rest untouched
    program = T._program(StoppingCriteria(maxits=300, residual_rtol=1e-9))
    b, x0 = T.device_args(_b(csr))
    ring = program(b, x0).telem.ring()
    assert np.isfinite(ring[:n]).all() and np.isnan(ring[n:]).all()


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_host_ring_is_the_references(csr, precond):
    """The host oracle records through EagerTraceRecorder: bitwise the
    reference's window, and the same heartbeat."""
    b = _b(csr)
    J = JaxHostCG(csr, trace=16, progress=10, precond=precond)
    T = HostCGSolver(csr, trace=16, progress=10, precond=precond)
    _, jerr = _quiet(lambda: J.solve(b, criteria=JaxCrit(
        maxits=300, residual_rtol=1e-9)))
    _, terr = _quiet(lambda: T.solve(b, criteria=StoppingCriteria(
        maxits=300, residual_rtol=1e-9)))
    assert np.array_equal(T.last_trace.records, J.last_trace.records)
    assert np.array_equal(T.last_trace.iterations, J.last_trace.iterations)
    assert T.last_trace.to_dict() == J.last_trace.to_dict()
    assert _beats(terr) == _beats(jerr)


@pytest.mark.parametrize("case", ["host-indefinite", "host-exact",
                                  "device-breakdown"])
def test_breakdown_partial_window(case):
    """A solve that stops short of maxits leaves a partial window: the
    host oracle's (p, Ap) = 0 raise, its exact-convergence stop, and a
    device loop whose (p, Ap) = 0 turns the scalars NaN."""
    import scipy.sparse as sp

    if case == "host-indefinite":
        A = sp.csr_matrix(np.diag([1.0, 1.0, -1.0, -1.0]))
        b = np.array([1.0, 1.0, 1.0, 1.0])
    else:
        A = sp.identity(6, format="csr")
        b = np.ones(6)
    crit = dict(maxits=10)
    if case.startswith("host"):
        traces = []
        for cls, Crit, err in ((JaxHostCG, JaxCrit, Exception),
                               (HostCGSolver, StoppingCriteria,
                                IndefiniteMatrixError)):
            s = cls(A, trace=8)
            if case == "host-indefinite":
                with pytest.raises(err, match=r"\(p, Ap\) = 0"):
                    s.solve(b, criteria=Crit(**crit))
            else:
                s.solve(b, criteria=Crit(**crit))
            traces.append(s.last_trace)
        jt, tt = traces
        assert tt.to_dict() == jt.to_dict()
        assert tt.niterations < 10
        return
    J = JaxCGSolver(jax_dev_matrix(A, dtype=jnp.float64), kernels="xla",
                    trace=8)
    T = TorchCGSolver(device_matrix_from_csr(A, dtype=torch.float64,
                                             device=CPU), device=CPU,
                      trace=8)
    J.solve(b, criteria=JaxCrit(maxits=10), raise_on_divergence=False)
    T.solve(b, criteria=StoppingCriteria(maxits=10),
            raise_on_divergence=False)
    jt, tt = J.last_trace, T.last_trace
    assert np.array_equal(np.isnan(tt.records), np.isnan(jt.records))
    assert np.isnan(tt.records[-1]).any()


@pytest.mark.parametrize("window", [8, 512])
@pytest.mark.parametrize("pipelined", [False, True])
def test_stacked_ring_matches_jax(csr, pipelined, window):
    """The 4-part stacked tier's ring records the psum'd scalars; its
    heartbeat prints once for all parts, as the reference's leader."""
    b = _b(csr)
    part = partition_rows(csr, 4, seed=0, method="band")
    jprob = JaxProblem.build(csr, part, 4, dtype=jnp.float64)
    J = JaxDistCG(jprob, pipelined=pipelined, trace=window, progress=10)
    T = DistCGSolver(DistributedProblem.build(csr, part, 4),
                     pipelined=pipelined, comm="dma", device=CPU,
                     trace=window, progress=10)
    _, jerr = _quiet(lambda: J.solve(b, criteria=JaxCrit(
        maxits=300, residual_rtol=1e-9)))
    _, terr = _quiet(lambda: T.solve(b, criteria=StoppingCriteria(
        maxits=300, residual_rtol=1e-9)))
    assert T.last_trace.solver == J.last_trace.solver
    _assert_ring(T.last_trace, J.last_trace, pipelined, J.stats.r0nrm2)
    jb, tb = _beats(jerr), _beats(terr)
    assert [i for i, _ in tb] == [i for i, _ in jb] and tb
    assert "dist-cg: iteration 10:" in terr


def test_heartbeat_skips_warmup_solves(csr):
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU),
                      device=CPU, progress=10, trace=16)
    _, err = _quiet(lambda: T.solve(_b(csr), warmup=2,
                                    criteria=StoppingCriteria(
                                        maxits=300, residual_rtol=1e-9)))
    its = [i for i, _ in _beats(err)]
    assert its == sorted(set(its)) and its[0] == 10


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("tier", ["single", "stacked"])
def test_armed_solve_keeps_the_bits(csr, tier, pipelined):
    """The ring and heartbeat only read the loop's scalars: x and the
    iteration count are bitwise the disarmed solve's."""
    b = _b(csr)
    xs = []
    for kw in ({}, {"trace": 16, "progress": 5}):
        if tier == "single":
            s = TorchCGSolver(device_matrix_from_csr(
                csr, dtype=torch.float64, device=CPU), device=CPU,
                pipelined=pipelined, kernels="pallas", **kw)
        else:
            s = DistCGSolver(DistributedProblem.build(
                csr, partition_rows(csr, 4, method="band"), 4), comm="dma",
                device=CPU, pipelined=pipelined, **kw)
        x, _ = _quiet(lambda: s.solve(b, criteria=StoppingCriteria(
            maxits=300, residual_rtol=1e-9)))
        xs.append((x, s.stats.niterations))
    assert np.array_equal(xs[0][0], xs[1][0]) and xs[0][1] == xs[1][1]


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# the operations a disarmed solve dispatches, counted on the tree before
# the observability tier (solves of 64 and 128 iterations of b = ones on
# gen:poisson2d:16, unbounded and at rtol 1e-30): arming nothing must
# add nothing
_DISARMED_OPS = {
    ("classic", 0.0): (2173, 4285), ("classic", 1e-30): (3270, 4872),
    ("pipelined", 0.0): (3608, 7128), ("pipelined", 1e-30): (5028, 9958),
    ("precond", 0.0): (2314, 4554), ("precond", 1e-30): (3475, 5173),
    ("precond-pipelined", 0.0): (3169, 6241),
    ("precond-pipelined", 1e-30): (4780, 9454),
    ("stacked", 0.0): (6219, 12299), ("stacked", 1e-30): (7316, 10902),
    ("stacked-pipelined", 0.0): (6610, 13010),
    ("stacked-pipelined", 1e-30): (8030, 15840)}


@pytest.mark.parametrize("algo,rtol", sorted(_DISARMED_OPS))
def test_disarmed_solves_dispatch_what_they_did(algo, rtol):
    from acg_tpu_torch.cli import synthesize_host_matrix

    full = synthesize_host_matrix("gen:poisson2d:16").to_csr()
    counts = []
    for its in (64, 128):
        if algo.startswith("stacked"):
            s = DistCGSolver(DistributedProblem.build(
                full, partition_rows(full, 4, method="band"), 4),
                comm="dma", device=CPU, pipelined="pipelined" in algo)
        else:
            s = TorchCGSolver(device_matrix_from_csr(
                full, dtype=torch.float64, device=CPU), device=CPU,
                kernels="pallas", **_SINGLE[algo])
        with _CountOps() as c:
            s.solve(np.ones(256), criteria=StoppingCriteria(
                maxits=its, residual_rtol=rtol), raise_on_divergence=False)
        counts.append(c.n)
    assert tuple(counts) == _DISARMED_OPS[(algo, rtol)]


def test_refusals_carry_the_references_messages(csr):
    """fused and replace_every refuse trace/progress at solve time with
    the reference's messages; the CA recurrences and the batched tiers,
    which carry the ring now, refuse a negative size."""
    from acg_tpu.errors import AcgError as JaxAcgError
    from acg_tpu.io.generators import poisson_dia as jax_poisson_dia
    from acg_tpu.ops.spmv import DiaMatrix as JaxDia
    from acg_tpu_torch.ops.spmv import device_matrix_from_arrays

    # a DIA matrix on the fused kernels' route (test_torch_cg's shifted
    # 128^2 Poisson)
    planes, offsets, N = jax_poisson_dia(128, 2, dtype=np.float64)
    planes = [p.copy() for p in planes]
    planes[offsets.index(0)] += 2.0
    jA = JaxDia(data=tuple(jnp.asarray(p, jnp.float32) for p in planes),
                offsets=offsets, nrows=N, ncols_padded=N)
    tA = device_matrix_from_arrays(
        "dia", planes, {"offsets": offsets, "nrows": N, "ncols_padded": N},
        dtype=torch.float32, device=CPU)
    msgs = []
    for make, crit, err in (
            (lambda: JaxCGSolver(jA, kernels="fused", trace=8), JaxCrit,
             JaxAcgError),
            (lambda: TorchCGSolver(tA, device=CPU, kernels="fused",
                                   trace=8), StoppingCriteria, AcgError),
            (lambda: JaxCGSolver(jax_dev_matrix(csr, dtype=jnp.bfloat16),
                                 replace_every=10, progress=5), JaxCrit,
             JaxAcgError),
            (lambda: TorchCGSolver(device_matrix_from_csr(
                csr, dtype=torch.bfloat16, device=CPU), device=CPU,
                replace_every=10, progress=5), StoppingCriteria,
             AcgError)):
        solver = make()
        b = np.ones(N if len(msgs) < 2 else csr.shape[0])
        with pytest.raises(err) as e:
            solver.solve(b, criteria=crit(maxits=20, residual_rtol=1e-6))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "telemetry" in msgs[0]
    assert msgs[2] == msgs[3] and "replace_every" in msgs[2]
    # the CA recurrences and the batched tiers carry the ring now; a
    # negative size still refuses
    with pytest.raises(ValueError, match="trace/progress"):
        TorchCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                             device=CPU), device=CPU,
                      algorithm="sstep:4", trace=-8)
    from acg_tpu_torch.solvers.batched import BatchedCGSolver
    with pytest.raises(ValueError, match="trace/progress"):
        BatchedCGSolver(device_matrix_from_csr(csr, dtype=torch.float64,
                                               device=CPU), device=CPU,
                        trace=-8)


def test_run_manifest_reads_torch():
    man = telemetry.run_manifest(matrix="m")
    assert man["schema"] == jax_telemetry.STATS_SCHEMA == \
        telemetry.STATS_SCHEMA
    assert man["backend"] == {"platform": "cpu", "device_kind": "cpu",
                              "ndevices": 1}
    assert man["torch"] == torch.__version__ and "jax" not in man
    assert man["process_count"] == 1 and man["matrix"] == "m"


def test_host_documents_match_the_reference():
    """aggregate_ranks, format_rank_report and the trace classes are the
    reference's, value for value."""
    payloads = [{"process": 0, "tsolve": 1.0, "niterations": 10,
                 "parts": [{"part": 0, "rows": 100, "nnz": 500,
                            "halo_send_bytes": 80}]},
                {"process": 1, "tsolve": 2.0, "niterations": 10,
                 "parts": [{"part": 1, "rows": 300, "nnz": 1500,
                            "halo_send_bytes": 80}]}]
    agg = telemetry.aggregate_ranks(payloads)
    assert agg == jax_telemetry.aggregate_ranks(payloads)
    assert telemetry.format_rank_report(agg) == \
        jax_telemetry.format_rank_report(agg)
    buf = np.arange(40, dtype=np.float64).reshape(10, 4) - 3.0
    for n in (0, 4, 10, 23):
        t = telemetry.ConvergenceTrace.from_ring(buf, n).to_dict()
        assert t == jax_telemetry.ConvergenceTrace.from_ring(buf,
                                                             n).to_dict()
    rec, jrec = telemetry.EagerTraceRecorder(3), \
        jax_telemetry.EagerTraceRecorder(3)
    for i in range(5):
        rec.record(i, -i, math.nan, 2.0 * i)
        jrec.record(i, -i, math.nan, 2.0 * i)
    assert rec.finish().to_dict() == jrec.finish().to_dict()


def _keys(d, prefix=""):
    """Every key path of a nested dict (lists of dicts by their first
    element)."""
    out = set()
    for k, v in d.items():
        path = f"{prefix}/{k}"
        out.add(path)
        if isinstance(v, dict):
            out |= _keys(v, path)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out |= _keys(v[0], path + "[]")
    return out


# the manifest's version and backend fields: each package reports its own
_OWN_FIELDS = {"/manifest/jax", "/manifest/jaxlib", "/manifest/acg_tpu",
               "/manifest/torch", "/manifest/cuda",
               "/manifest/acg_tpu_torch"}
_COMMON = ["gen:poisson2d:16", "--max-iterations", "300",
           "--residual-rtol", "1e-8", "--warmup", "1", "-q"]


@pytest.mark.parametrize("tier", ["single", "stacked", "host"])
def test_cli_documents_match_the_references(tier, tmp_path, capsys):
    """--stats-json, --convergence-log, --timeline and --history of one
    CLI run of each package: the reference's readers take the port's
    files, and the keys are the same."""
    extra = {"single": ["--comm", "none"], "stacked": ["--nparts", "4"],
             "host": ["--solver", "host", "--comm", "none"]}[tier]
    docs = {}
    for name, main, dev in (("jax", jax_main, []),
                            ("torch", torch_main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        assert main(_COMMON + extra + dev + [
            "--stats-json", str(d / "st.json"),
            "--convergence-log", str(d / "c.jsonl"),
            "--timeline", str(d / "tl.json"),
            "--history", str(d / "hist")]) == 0
        docs[name] = d
        err = capsys.readouterr().err
        assert "total solver time" in err
    td, jd = docs["torch"], docs["jax"]
    tdoc = json.loads((td / "st.json").read_text())
    jdoc = json.loads((jd / "st.json").read_text())
    assert (_keys(tdoc) ^ _keys(jdoc)) <= _OWN_FIELDS
    assert tdoc["stats"]["niterations"] == jdoc["stats"]["niterations"]
    assert tdoc["manifest"]["backend"]["platform"] == "cpu"
    meta, recs = jax_telemetry.read_convergence_log(td / "c.jsonl")
    jmeta, jrecs = jax_telemetry.read_convergence_log(jd / "c.jsonl")
    assert set(meta) == set(jmeta) and meta["schema"] == jmeta["schema"]
    assert [r["it"] for r in recs] == [r["it"] for r in jrecs]
    assert tdoc["stats"]["trace"]["records"] == recs
    assert recs[-1]["rnrm2"] == tdoc["stats"]["rnrm2"]
    tl = jax_tracing.read_timeline(td / "tl.json")
    assert tl["metadata"]["schema"] == "acg-tpu-timeline/1"
    pids = {e["pid"] for e in tl["traceEvents"]}
    assert len(pids) == (4 if tier == "stacked" else 1)
    res = subprocess.run([sys.executable, "scripts/check_timeline.py",
                          str(td / "tl.json")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    hist = jax_observatory.history_scan(td / "hist")
    jhist = jax_observatory.history_scan(jd / "hist")
    assert len(hist) == 1 and set(hist[0]) == set(jhist[0])
    assert hist[0]["case"] == jhist[0]["case"]
    assert hist[0]["iterations"] == jhist[0]["iterations"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["acg_tpu"] = None
from acg_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def test_two_gloo_processes_aggregate_ranks(tmp_path):
    """Two processes: the stats document's ranks block holds both, process
    0 alone writes the clock-aligned timeline, and each heartbeat sample
    is printed once."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    st, tl = tmp_path / "st.json", tmp_path / "tl.json"
    argv = ["gen:poisson2d:16", "--nparts", "4", "--comm", "dma",
            "--max-iterations", "300", "--residual-rtol", "1e-8",
            "--warmup", "0", "-q", "--device", "cpu", "--progress", "10",
            "--stats-json", str(st), "--timeline", str(tl),
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, *argv,
                               "--process-id", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    err0, err1 = outs[0][1], outs[1][1]
    doc = json.loads(st.read_text())
    per = doc["ranks"]["per_rank"]
    assert [p["process"] for p in per] == [0, 1]
    assert doc["ranks"]["aggregate"]["processes"] == 2
    assert doc["ranks"]["aggregate"]["parts"]["count"] == 4
    assert "cross-rank: 2 processes" in err0
    tdoc = jax_tracing.read_timeline(tl)
    assert tdoc["metadata"]["nranks"] == 2
    assert tdoc["metadata"]["clock"]["aligned"] is True
    assert len({e["pid"] for e in tdoc["traceEvents"]}) == 4
    assert "timeline:" in err0 and "timeline:" not in err1
    its = [i for i, _ in _beats(err0)]
    assert its and its == sorted(set(its)) and not _beats(err1)
