"""The port's performance observability (acg_tpu_torch.perfmodel)
against the JAX package's: the analytic counters (equal to the
reference's for the same sizes and dtypes), the counted dispatches and
footprint that stand in for the reference's compiler analysis, the
static communication ledgers (key for key the reference's), the case
keying of the regression gate, scripts/torch_bench_diff.py, and the
CLI's --explain tier."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_tpu import perfmodel as jax_perfmodel
from acg_tpu_torch import perfmodel
from acg_tpu_torch.cli import main as torch_main

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(ROOT, "scripts", "torch_bench_diff.py")


@pytest.fixture(scope="module")
def csr():
    from acg_tpu_torch.io.generators import poisson2d_coo
    from acg_tpu_torch.matrix import SymCsrMatrix
    r, c, v, N = poisson2d_coo(24)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def _single(csr, pipelined=False, dtype=torch.float32):
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers.cg import TorchCGSolver
    A = device_matrix_from_csr(csr, dtype=dtype, device="cpu")
    return TorchCGSolver(A, pipelined=pipelined, kernels="xla",
                         device="cpu")


# -- the analytic and counted costs --------------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
def test_analytic_counters_are_the_references(csr, pipelined):
    """The analytic flops and bytes of an iteration equal the
    reference's for the same (nnz, n, dtypes), and the counted
    dispatches of the loop are positive, with no hand kernel under
    kernels='xla'."""
    import jax.numpy as jnp

    from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dev
    from acg_tpu.ops.spmv import matrix_index_bytes as jax_idx
    from acg_tpu.solvers.stats import cg_flops_per_iteration

    s = _single(csr, pipelined)
    flops, byts, tables, nnz, mat_b, idx_b = perfmodel._analytic_costs(
        s, csr)
    ref_idx = jax_idx(jax_dev(csr, dtype=jnp.float32))
    assert idx_b == ref_idx and tables is None
    assert flops == cg_flops_per_iteration(csr.nnz, csr.shape[0],
                                           pipelined)
    assert byts == jax_perfmodel.analytic_bytes_per_iteration(
        csr.nnz, csr.shape[0], ref_idx, 4, 4, pipelined)
    assert perfmodel.analytic_bytes_per_iteration(5, 7, 4.0, 8, 2, True) \
        == jax_perfmodel.analytic_bytes_per_iteration(5, 7, 4.0, 8, 2, True)
    counted = perfmodel.count_dispatches(s, np.ones(csr.shape[0]))
    assert counted["source"] == "counted"
    assert counted["ops_per_iteration"] > 0
    assert counted["kernel_launches_per_iteration"] == {}
    assert counted["dispatches_per_iteration"] == \
        counted["ops_per_iteration"]
    # the counting solves leave the statistics as they were
    assert s.stats.nsolves == 0


def test_analyze_solver_memory(csr):
    s = _single(csr)
    an = perfmodel.analyze_solver(s, np.ones(csr.shape[0], np.float32))
    assert an["available"], an
    mem = an["memory"]
    assert mem["source"] == "counted"
    # the resident tensors hold the DIA planes (5 x N f32)
    assert mem["argument_bytes"] >= 5 * csr.shape[0] * 4
    assert mem["total_hbm_bytes"] >= mem["argument_bytes"]


def test_attach_and_stats_twin(csr):
    s = _single(csr)
    an = perfmodel.analyze_solver(s, np.ones(csr.shape[0], np.float32))
    perfmodel.attach(s.stats, an, ledger={"halo_bytes_per_iteration": 0},
                     per_iteration={"flops": 1.0})
    d = s.stats.to_dict()
    assert d["costmodel"]["per_iteration"]["flops"] == 1.0
    assert d["costmodel"]["comm"]["halo_bytes_per_iteration"] == 0
    assert d["memory"]["source"] == "counted"
    txt = s.stats.fwrite()
    assert "costmodel:" in txt and "memory:" in txt


def test_analyze_unavailable_degrades():
    """A solver whose counting solve fails reports why."""
    class Broken:
        device = torch.device("cpu")
        stats = None

        def solve(self, *a, **kw):
            raise RuntimeError("no backend here")

    an = perfmodel.analyze_solver(Broken(), np.ones(4))
    assert an["available"] is False
    assert "no backend here" in an["why"]


def test_triad_probe_bytes_are_the_kernels_it_dispatches():
    """Each triad step the probe credits with TRIAD_PASSES passes is one
    dispatched operation that reads two n-vectors and writes one, so the
    bandwidth it reports is the bytes its kernels move."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n, k = 1000, 5
    seen = []

    class Bytes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = kwargs.get("out")
            ins = [a for a in list(args) + [v for key, v in kwargs.items()
                                            if key != "out"]
                   if isinstance(a, torch.Tensor)]
            seen.append((func, sum(t.nbytes for t in ins),
                         out.nbytes if out is not None else 0))
            return func(*args, **kwargs)

    c = torch.full((n,), 0.5)
    a = torch.ones(n)
    out = torch.empty_like(a)
    with Bytes():
        last = perfmodel.triad_chain(a, c, out, k)
    ops = [s for s in seen if not getattr(s[0], "is_view", False)]
    assert len(ops) == k
    assert all(r + w == perfmodel.TRIAD_PASSES * n * 4 and w == n * 4
               for _f, r, w in ops)
    want = torch.ones(n, dtype=torch.float64)
    for _ in range(k):
        want = 0.5 + 1.0000001 * want
    assert torch.allclose(last.double(), want, rtol=1e-6)


# -- communication ledgers -----------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"pipelined": True, "precise_dots": True}, {"comm": "dma"},
    {"precond": "cheby:2"}, {"precond": "jacobi", "pipelined": True},
    {"algorithm": "sstep:4"}, {"algorithm": "pipelined:2"},
    {"kernels": "fused"}], ids=lambda kw: ",".join(
        f"{k}={v}" for k, v in kw.items()) or "classic")
def test_comm_ledger_dist_is_the_references(csr, kw):
    """The stacked tier's ledger equals the reference's, key for key, on
    the same 4-part band partition."""
    import jax.numpy as jnp

    from acg_tpu.io.generators import poisson2d_coo as jax_coo
    from acg_tpu.matrix import SymCsrMatrix as JaxSym
    from acg_tpu.parallel.dist import DistCGSolver as JaxDist
    from acg_tpu.parallel.dist import DistributedProblem as JaxProb
    from acg_tpu.partition import partition_rows as jax_part
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    part = partition_rows(csr, 4, seed=0, method="band")
    s = DistCGSolver(DistributedProblem.build(csr, part, 4), device="cpu",
                     **kw)
    r, c, v, N = jax_coo(24)
    jcsr = JaxSym.from_coo(N, r, c, v).to_csr()
    jprob = JaxProb.build(jcsr, jax_part(jcsr, 4, seed=0, method="band"),
                          4, dtype=jnp.float64)
    led = perfmodel.comm_ledger(s)
    assert led == jax_perfmodel.comm_ledger(JaxDist(jprob, **kw))
    expect = sum(int(x.halo.total_send) for x in s.problem.subs) * 8
    if not kw:
        assert led["halo_bytes_per_iteration"] == expect
        assert led["allreduce_per_iteration"] == 2
        assert all(nb["hops"] == 1 for nb in led["neighbors"])


@pytest.mark.parametrize("kw", [{}, {"pipelined": True},
                                {"algorithm": "sstep:2"},
                                {"precond": "cheby:3"}],
                         ids=["classic", "pipelined", "sstep", "cheby"])
def test_comm_ledger_sharded_roll(kw):
    """The sharded tier's derived halo: offsets +-1, +-8 move 18
    boundary elements a part, one collective-permute an offset, as in
    the reference's ledger of the same tier."""
    from acg_tpu.parallel.sharded_dia import \
        build_sharded_poisson_solver as jax_build
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver

    s = build_sharded_poisson_solver(8, 2, nparts=4, device="cpu", **kw)
    led = perfmodel.comm_ledger(s)
    assert led == jax_perfmodel.comm_ledger(jax_build(8, 2, nparts=4, **kw))
    if not kw:
        assert led["halo_bytes_per_shard"] == 18 * 4
        assert led["halo_bytes_per_iteration"] == 18 * 4 * 4
        assert led["transport"].startswith("xla-roll")
        assert led["halo_exchanges_per_iteration"] == 4


def test_comm_ledger_absent_on_single_device(csr):
    assert perfmodel.comm_ledger(_single(csr)) is None


# -- the case keying of the regression gate ------------------------------

def _stats_doc(metric, niter, tsolve, **manifest):
    return {"schema": "acg-tpu-stats/2",
            "manifest": {"metric": metric, **manifest},
            "stats": {"niterations": niter, "tsolve": tsolve}}


def _both(path):
    got = perfmodel.load_cases(path)
    assert got == jax_perfmodel.load_cases(path)
    return got


def test_load_cases_stats_jsonl(tmp_path):
    p = tmp_path / "stats.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps(_stats_doc("m1", 1000, 1.0)) + "\n")
        f.write(json.dumps(_stats_doc("m1", 1000, 2.0)) + "\n")
        f.write(json.dumps(_stats_doc("m2", 500, 1.0, precond="jacobi",
                                      nrhs=4, operator="stencil")) + "\n")
        f.write("# a comment line\n")
    assert _both(p) == {"m1": 1000.0,
                        "m2|precond=jacobi|nrhs=4|operator=stencil": 500.0}


def test_load_cases_single_document(tmp_path):
    p = tmp_path / "stats.json"
    p.write_text(json.dumps({
        "schema": "acg-tpu-stats/2",
        "manifest": {"solver": "acg", "matrix": "gen:poisson2d:24"},
        "stats": {"niterations": 30, "tsolve": 0.5}}, indent=2))
    assert _both(p) == {"acg:gen:poisson2d:24": 60.0}


def test_load_cases_bench_rows(tmp_path):
    p = tmp_path / "rows.json"
    p.write_text('{"metric": "m1", "value": 123.0, "unit": "iters/s"}\n'
                 '# setup: commentary\n'
                 '{"metric": "m2", "value": 7.5}\n')
    assert _both(p) == {"m1": 123.0, "m2": 7.5}
    w = tmp_path / "wrapped.json"
    w.write_text(json.dumps({"n": 4, "rc": 0,
                             "parsed": {"metric": "m1", "value": 99.0}}))
    assert _both(w) == {"m1": 99.0}


def test_compare_cases_regression_and_tolerance():
    old = {"a": 100.0, "b": 100.0, "gone": 5.0}
    new = {"a": 95.0, "b": 80.0, "fresh": 1.0}
    got = perfmodel.compare_cases(old, new, 10.0)
    assert got == jax_perfmodel.compare_cases(old, new, 10.0)
    lines, nreg, ncmp = got
    assert (ncmp, nreg) == (2, 1)
    joined = "\n".join(lines)
    assert "REGRESSION" in joined
    assert "baseline-only" in joined and "new case" in joined


def test_check_regression_exit_codes(tmp_path, capsys):
    base = tmp_path / "base.jsonl"
    base.write_text(json.dumps(_stats_doc("cg_case", 1000, 1.0)) + "\n")
    for rows, want in (([{"metric": "cg_case", "value": 500.0}], 1),
                       ([{"metric": "cg_case", "value": 1500.0}], 0),
                       ([{"metric": "other_case", "value": 500.0}], 2)):
        assert perfmodel.check_regression(rows, base, 10.0) == want
        assert jax_perfmodel.check_regression(rows, base, 10.0) == want
    assert perfmodel.check_regression([], tmp_path / "nope", 10.0) == 2


def test_load_baseline_cases_from_history(tmp_path, capsys):
    """A ``--history`` directory as the baseline: the best usable case
    values, and the refusal (None) for an all-unavailable ledger, as the
    reference decides them."""
    from acg_tpu_torch import observatory

    good, bad = tmp_path / "good", tmp_path / "bad"
    observatory.history_append(good, _stats_doc("m", 100, 1.0))
    observatory.history_append(good, _stats_doc("m", 100, 0.5))
    observatory.history_append(bad, _stats_doc(
        perfmodel.UNAVAILABLE_METRIC, 1, 1.0))
    for d, want in ((good, {"m": 200.0}), (bad, None)):
        assert perfmodel.load_baseline_cases(str(d)) == want
        assert jax_perfmodel.load_baseline_cases(str(d)) == want
    assert "re-baseline" in capsys.readouterr().err


# -- scripts/torch_bench_diff.py -----------------------------------------

def test_bench_diff_help_without_torch():
    """--help answers without importing torch or the JAX package."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{_SCRIPT!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_path({_SCRIPT!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('torch', 'jax', 'acg_tpu', 'acg_tpu_torch')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "fail-on-regress" in r.stdout


def test_bench_diff_cli(tmp_path):
    old, new, other = (tmp_path / f"{n}.json"
                       for n in ("old", "new", "other"))
    old.write_text('{"metric": "m1", "value": 100.0}\n'
                   '{"metric": "m2", "value": 50.0}\n')
    new.write_text('{"metric": "m1", "value": 120.0}\n'
                   '{"metric": "m2", "value": 30.0}\n')
    other.write_text('{"metric": "zz", "value": 1.0}\n')
    for a, b, want in ((old, new, 1), (old, old, 0), (old, other, 2)):
        r = subprocess.run([sys.executable, _SCRIPT, str(a), str(b),
                            "--fail-on-regress", "10"],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == want, r.stdout + r.stderr
        if want == 1:
            assert "REGRESSION" in r.stdout


# -- the --explain CLI tier ----------------------------------------------

def test_cli_explain_end_to_end(tmp_path):
    """--explain prints, for the classic and pipelined single-device
    tiers and the stacked multi-part tier: the counted dispatches and
    footprint, the analytic bytes and flops, the comm ledger (multi-
    part), the dispatch term, predicted against measured and a bound;
    the stats twin carries them, marked uncalibrated."""
    sj = tmp_path / "explain.jsonl"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = torch_main(["gen:poisson2d:16", "--device", "cpu", "--explain",
                         "--no-probe-cache",
                         "--nparts", "4", "--dtype", "f32",
                         "--max-iterations", "20", "--warmup", "0",
                         "--stats-json", str(sj), "-q"])
    err = err.getvalue()
    assert rc == 0, err
    for tier in ("== explain: cg ", "== explain: cg-pipelined",
                 "== explain: dist-cg (nparts=4"):
        assert tier in err, err
    for text in ("costmodel:", "memory (device footprint, counted)",
                 "comm ledger: halo", "counted: ", "dispatch: ",
                 "comm uncalibrated at", "predicted", "measured",
                 "verdict: ", "-bound", "== explain: convergence"):
        assert text in err, text
    assert "compiler" not in err
    docs = [json.loads(line) for line in sj.read_text().splitlines()
            if line.strip()]
    assert len(docs) == 3
    assert all("costmodel" in d["stats"] for d in docs)
    assert all(d["manifest"]["explain"]["uncalibrated"] for d in docs)
    assert all(d["manifest"]["calibration"] == "uncalibrated" for d in docs)
    dist = [d for d in docs if "dist-cg" in d["manifest"]["metric"]]
    assert "comm" in dist[0]["stats"]["costmodel"]
    assert dist[0]["manifest"]["explain"]["dispatches_per_iteration"] > 0
