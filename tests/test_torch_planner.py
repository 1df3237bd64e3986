"""The port's decision observatory (acg_tpu_torch.planner) against the
JAX package's: the ranked plan (the reference's labels, order and
prices for the same injected inputs; documents both validators accept),
the typed refusal matrix, the iteration model, pricing within a band of
the measured best on 8 stacked parts, the --autotune plan-vs-actual
round trip through scripts/torch_history_report.py, self-correction,
and old-document tolerance."""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from acg_tpu import planner as jax_planner
from acg_tpu_torch import commbench as cb
from acg_tpu_torch import planner
from acg_tpu_torch.cli import main as torch_main

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPORT = os.path.join(ROOT, "scripts", "torch_history_report.py")


def _report(argv):
    return subprocess.run([sys.executable, _REPORT, *argv],
                          capture_output=True, text=True, timeout=300)


def _cli(argv):
    """``(rc, stderr)`` of one in-process port CLI run."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            rc = torch_main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            err.write(str(e.code))
    return rc, err.getvalue()


def _csr(side=24):
    from acg_tpu_torch.io.generators import poisson2d_coo
    from acg_tpu_torch.matrix import SymCsrMatrix
    r, c, v, n = poisson2d_coo(side)
    return SymCsrMatrix.from_coo(n, r, c, v).to_csr()


def _cal(**over):
    doc = {"schema": cb.COMMBENCH_SCHEMA, "backend": "cpu", "nparts": 8,
           "collectives": {
               "all_reduce": {"alpha_s": 1e-5, "beta_s_per_byte": 1e-10,
                              "npoints": 1, "r2": None,
                              "points": [{"bytes": 8, "seconds": 1e-5}]},
               "all_to_all": {"alpha_s": 2e-5, "beta_s_per_byte": 1e-9,
                              "npoints": 1, "r2": None,
                              "points": [{"bytes": 1024,
                                          "seconds": 2.1e-5}]}}}
    doc.update(over)
    doc["calibration_id"] = cb.calibration_id(doc)
    return doc


def _plan_kwargs(**over):
    kw = dict(matrix_id="gen:poisson2d:24", nparts=8,
              dtype_name="float64", rtol=1e-6, maxits=400,
              mat_itemsize=8, vec_itemsize=8, kappa=950.0,
              kappa_source="lanczos-oracle", bw_gbs=40.0,
              dispatch_s=5e-5)
    kw.update(over)
    return kw


# -- determinism and parity ----------------------------------------------

@pytest.mark.parametrize("over", [
    {}, {"precond": "cheby:4"}, {"precond": "jacobi", "nparts": 1},
    {"operator_armed": True}, {"cal": "dma"}],
    ids=["plain", "cheby", "jacobi-1part", "operator", "dma-fit"])
def test_plan_is_the_references(over):
    """With the same injected calibration, kappa, bandwidth and
    dispatch, the port's document is the reference's: the same ranked
    labels, order and prices, the same pruned cells, the same plan id;
    both validators accept it.  On one part in f64 the port also prunes
    the fused cells (``fused_cg_route`` refuses f64): the rest of the
    ranking is the reference's, row for row."""
    csr = _csr()
    cal = _cal()
    if over.pop("cal", None) == "dma":
        cal = _cal(collectives={**cal["collectives"], "dma": {
            "alpha_s": 3e-5, "beta_s_per_byte": 5e-10, "npoints": 1,
            "r2": None, "points": [{"bytes": 64, "seconds": 3e-5}]}})
    kw = _plan_kwargs(**over)
    doc = planner.build_plan(csr, cal=cal, **kw)
    ref = jax_planner.build_plan(csr, cal=cal, **kw)
    assert planner.validate_plan(doc) == []
    assert jax_planner.validate_plan(doc) == []
    if kw["nparts"] < 2:
        keep = [r for r in ref["ranked"] if r["kernels"] != "fused"]
        assert doc["ranked"] == keep
        assert {p["reason"] for p in doc["pruned"]} - \
            {p["reason"] for p in ref["pruned"]} == {"fused-f64"}
        return
    assert json.dumps(doc, sort_keys=True) == json.dumps(ref,
                                                         sort_keys=True)


def test_plan_determinism_and_id_integrity():
    csr = _csr()
    cal = _cal()
    idisp = {"classic": 1e-4}
    a = planner.build_plan(csr, cal=cal, **_plan_kwargs(
        launch_s=4e-6, iter_dispatch_s=idisp))
    b = planner.build_plan(csr, cal=cal, **_plan_kwargs(
        launch_s=4e-6, iter_dispatch_s=idisp))
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert planner.validate_plan(a) == [] == jax_planner.validate_plan(a)
    assert a["calibration"] == cal["calibration_id"]
    assert a["plan_id"].startswith("plan-cpu-8p-")
    preds = [r["predicted_s_per_solve"] for r in a["ranked"]]
    assert preds == sorted(preds) and all(p > 0 for p in preds)
    # the per-iteration dispatch is priced into every cell
    plain = planner.build_plan(csr, cal=cal, **_plan_kwargs())
    for r, p in zip(sorted(a["ranked"], key=lambda r: r["label"]),
                    sorted(plain["ranked"], key=lambda r: r["label"])):
        assert r["predicted_s_per_solve"] == pytest.approx(
            p["predicted_s_per_solve"] + r["predicted_iterations"] * 1e-4)
    tampered = json.loads(json.dumps(a))
    tampered["ranked"][0]["predicted_s_per_solve"] *= 0.5
    assert any("plan_id" in p for p in planner.validate_plan(tampered))


def test_calibrated_alpha_of_the_counted_launches_keeps_the_price():
    """The comm term bills a reduction round's and a halo exchange's
    dispatches once: a calibration whose alphas are exactly those
    counted launches at the launch latency, and whose 1/beta is the
    probed bandwidth, prices every candidate as the uncalibrated plan
    does (the dispatch term holds the iteration's other launches)."""
    csr = _csr()
    launch, bw = 4e-6, 40.0
    rounds = {"reduction": 6.0, "xla": 4.0, "dma": 7.0}

    def fit(k):
        return {"alpha_s": k * launch, "beta_s_per_byte": 1.0 / (bw * 1e9),
                "npoints": 2, "r2": 1.0,
                "points": [{"bytes": 8, "seconds": k * launch}]}

    cal = _cal(collectives={"all_reduce": fit(6), "all_to_all": fit(4),
                            "dma": fit(7)})
    kw = _plan_kwargs(bw_gbs=bw, launch_s=launch, comm_launches=rounds,
                      iter_dispatch_s={"classic/xla": 1e-4,
                                       "classic/dma": 1.2e-4,
                                       "sstep:4/xla": 2e-4})
    unc = {r["label"]: r for r in planner.build_plan(csr, **kw)["ranked"]}
    got = {r["label"]: r for r in
           planner.build_plan(csr, cal=cal, **kw)["ranked"]}
    common = set(unc) & set(got)
    assert any(lab.startswith("sstep:4/") for lab in common)
    for lab in common:
        assert got[lab]["calibrated"] and not unc[lab]["calibrated"]
        assert got[lab]["predicted_s_per_solve"] == pytest.approx(
            unc[lab]["predicted_s_per_solve"], rel=1e-12), lab


class _Probe:
    """A candidate's solver whose solve raises ``exc`` (None: returns)."""

    def __init__(self, exc=None):
        import types
        self.exc = exc
        self.device = torch.device("cuda")
        self.stats = types.SimpleNamespace(nbreakdowns=0, niterations=1)

    def solve(self, *a, **kw):
        if self.exc is not None:
            raise self.exc


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_probe_kernel_error_raises_on_cuda(monkeypatch, device):
    """A ValueError from a probe's SOLVE is a kernel wrapper refusing to
    launch: on a CUDA device it raises out of --autotune's probes and out
    of the dispatch count, where the CPU disqualifies the candidate.  A
    ValueError from the construction is the tier's refusal, and a typed
    solver outcome disqualifies, on either device."""
    import types

    from acg_tpu_torch import perfmodel
    from acg_tpu_torch.errors import BreakdownError

    rows = [dict(planner.enumerate_candidates(1)[0][0], label=f"c{i}")
            for i in range(3)]
    kernel = ValueError("dia_spmv: no kernel for 3 planes")

    def build(cand, *a, **kw):
        if cand.get("label") == "c0":
            raise ValueError("the tier refuses this candidate")
        return _Probe(BreakdownError("(p, Ap) <= 0")
                      if cand.get("label") == "c1" else kernel)

    monkeypatch.setattr(planner, "_operand", lambda *a, **kw: None)
    monkeypatch.setattr(planner, "_build_candidate", build)
    args = types.SimpleNamespace(residual_rtol=1e-6)
    err = io.StringIO()
    pick = (lambda: planner.autotune_select(
        args, {"ranked": rows}, None, None, 1, np.ones(4), None, None,
        device, err, top=3))
    if device == "cuda":
        with pytest.raises(ValueError, match="no kernel"):
            pick()
    else:
        assert pick() is None
    txt = err.getvalue()
    assert "probe c0 refused" in txt and "probe c1 BreakdownError" in txt

    def count(s, b):
        raise kernel

    monkeypatch.setattr(planner, "_build_candidate",
                        lambda *a, **kw: _Probe())
    monkeypatch.setattr(perfmodel, "count_dispatches", count)
    by_rec = (lambda: planner.dispatch_by_recurrence(
        types.SimpleNamespace(), _csr(8), None, device, 1e-6, 1e-6))
    if device == "cuda":
        with pytest.raises(ValueError, match="no kernel"):
            by_rec()
    else:
        assert by_rec() == ({}, None)


def test_plan_render_and_write(tmp_path):
    doc = planner.build_plan(_csr(), cal=_cal(), **_plan_kwargs())
    txt = planner.render_plan(doc)
    assert doc["plan_id"] in txt and doc["calibration"] in txt
    assert "UNCALIBRATED" not in txt
    dest = tmp_path / "plan.json"
    planner.write_plan(doc, dest)
    assert json.loads(dest.read_text())["plan_id"] == doc["plan_id"]


# -- the refusal matrix --------------------------------------------------

_KNOWN = {"ca-precond", "ca-fused", "fused-precond", "fused-f64",
          "dma-single-part", "dma-unbenchmarked", "assembled-bypassed"}


def test_refusal_matrix_uncalibrated_and_pruned_reasons():
    """No calibration: marked uncalibrated, comm priced from the
    device's figures (alpha the launches of a round at the launch
    latency, one without a count; 1/beta the probed bandwidth); pruned
    cells carry typed reasons and never appear in the ranking."""
    csr = _csr()
    doc = planner.build_plan(csr, cal=None, **_plan_kwargs(launch_s=3e-6))
    assert doc["uncalibrated"] is True
    assert doc["calibration"] == cb.UNCALIBRATED
    assert "UNCALIBRATED" in planner.render_plan(doc)
    assert not any(r["calibrated"] for r in doc["ranked"])
    reasons = {p["reason"] for p in doc["pruned"]}
    assert {"ca-fused", "dma-unbenchmarked"} <= reasons <= _KNOWN
    pruned = {planner.candidate_label(p) for p in doc["pruned"]}
    assert not pruned & {r["label"] for r in doc["ranked"]}
    row = next(r for r in doc["ranked"]
               if r["label"] == "classic/auto/xla/none/assembled")
    # classic: 2 single-scalar reductions, each alpha + 8 B at 40 GB/s
    assert row["s_per_iteration"]["allreduce"] == pytest.approx(
        2 * (3e-6 + 8 / 40e9))
    counted = planner.build_plan(csr, cal=None, **_plan_kwargs(
        launch_s=3e-6, comm_launches={"reduction": 6.0, "xla": 4.0}))
    row = next(r for r in counted["ranked"]
               if r["label"] == "classic/auto/xla/none/assembled")
    assert row["s_per_iteration"]["allreduce"] == pytest.approx(
        2 * (6 * 3e-6 + 8 / 40e9))


def test_refusal_matrix_precond_operator_and_fused_cells():
    csr = _csr()
    doc = planner.build_plan(csr, cal=_cal(), precond="cheby:4",
                             **_plan_kwargs())
    reasons = {p["reason"] for p in doc["pruned"]}
    assert {"ca-precond", "fused-precond"} <= reasons
    assert any(r["precond"].startswith("cheby") for r in doc["ranked"])
    doc2 = planner.build_plan(csr, cal=_cal(), operator_armed=True,
                              **_plan_kwargs())
    assert "assembled-bypassed" in {p["reason"] for p in doc2["pruned"]}
    assert all(r["matrix_free"] for r in doc2["ranked"])
    # one part: no dma, and the single-device fused kernels follow
    # fused_cg_route (f32/mixed/bf16; f64 refused)
    doc3 = planner.build_plan(csr, cal=_cal(), **_plan_kwargs(nparts=1))
    r3 = {p["reason"] for p in doc3["pruned"]}
    assert {"dma-single-part", "fused-f64"} <= r3
    doc4 = planner.build_plan(csr, cal=_cal(),
                              **_plan_kwargs(nparts=1, dtype_name="f32"))
    assert "fused-f64" not in {p["reason"] for p in doc4["pruned"]}
    assert any(r["kernels"] == "fused" for r in doc4["ranked"])


def test_iteration_model_tracks_recurrence():
    csr = _csr()
    doc = planner.build_plan(csr, cal=_cal(), precond="cheby:4",
                             **_plan_kwargs())
    by = {r["label"]: r for r in doc["ranked"]}
    classic = by["classic/auto/xla/none/assembled"]
    assert by["sstep:4/auto/xla/none/assembled"]["predicted_iterations"] \
        > classic["predicted_iterations"]
    assert by["classic/auto/xla/cheby:4/assembled"][
        "predicted_iterations"] < classic["predicted_iterations"]
    for cand in ({"algorithm": "pipelined:3", "precond": "none"},
                 {"algorithm": "sstep:8", "precond": "none"},
                 {"algorithm": "classic", "precond": "bjacobi:8"}):
        assert planner._iterations_for(cand, 950.0, 1e-6, 400) == \
            jax_planner._iterations_for(cand, 950.0, 1e-6, 400)


# -- pricing within band (the acceptance) --------------------------------

def test_top_plan_within_band_of_measured_best():
    """On 8 stacked parts with a live calibration of their collectives,
    the planner's preferred cell among classic, sstep:4 and pipelined is
    within 2x of the measured best of the three.  The planner is fed
    what the CLI feeds it (``plan_for_args``): the calibration, kappa,
    the launch latency and each recurrence's counted dispatches.
    The calibration takes the min of its repeats, and the three solvers
    are timed in turns, the min of three rounds each, so load on the
    host skews them alike."""
    side, nparts, rtol, maxits = 48, 8, 1e-6, 400
    csr = _csr(side)
    # one intra-op thread: a loaded host's oversubscribed thread pools
    # would slow the s-step Gram products far more than the rest
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _within_band(csr, side, nparts, rtol, maxits)
    finally:
        torch.set_num_threads(threads)


def _within_band(csr, side, nparts, rtol, maxits):
    from acg_tpu_torch import perfmodel
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.partition import partition_rows
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    colls = cb.bench_collectives(nparts, cb.CPU_SWEEP, reps=4)
    cal = {"schema": cb.COMMBENCH_SCHEMA, "backend": "cpu",
           "nparts": nparts, "collectives": colls}
    cal["calibration_id"] = cb.calibration_id(cal)
    part = partition_rows(csr, nparts, seed=0, method="band")
    prob = DistributedProblem.build(csr, part, nparts)
    b = np.ones(prob.n)
    crit = StoppingCriteria(maxits=maxits, residual_rtol=rtol)
    solvers = {"classic": DistCGSolver(prob, device="cpu"),
               "pipelined": DistCGSolver(prob, pipelined=True,
                                         device="cpu"),
               "sstep:4": DistCGSolver(prob, algorithm="sstep:4",
                                       device="cpu")}
    for s in solvers.values():
        s.solve(b, criteria=crit, raise_on_divergence=False, warmup=1)
    measured = dict.fromkeys(solvers, math.inf)
    for _ in range(3):
        for name, s in solvers.items():
            t0 = time.perf_counter()
            s.solve(b, criteria=crit, raise_on_divergence=False)
            measured[name] = min(measured[name], time.perf_counter() - t0)
    kappa, src = planner.kappa_estimate(csr, rtol, maxits)
    launch_s = perfmodel.launch_latency_seconds("cpu")
    iter_disp, rounds = planner.dispatch_by_recurrence(
        prob, csr, None, "cpu", launch_s,
        perfmodel.flag_read_seconds("cpu"), comms=("xla",))
    doc = planner.build_plan(
        csr, matrix_id=f"gen:poisson2d:{side}", nparts=nparts,
        dtype_name="float64", rtol=rtol, maxits=maxits, mat_itemsize=8,
        vec_itemsize=8, cal=cal, kappa=kappa, kappa_source=src,
        kernels=("auto",), comms=("xla",), launch_s=launch_s,
        iter_dispatch_s=iter_disp, comm_launches=rounds)
    wanted = {f"{name}/auto/xla/none/assembled": name for name in measured}
    top = [wanted[r["label"]] for r in doc["ranked"]
           if r["label"] in wanted][0]
    assert measured[top] <= 2.0 * min(measured.values()), (measured, top)


# -- plan-vs-actual through the ledger -----------------------------------

@pytest.fixture(scope="module")
def planned_run(tmp_path_factory):
    """One --commbench and one --autotune solve with a --history ledger,
    shared by the round-trip tests."""
    root = tmp_path_factory.mktemp("plan")
    cal = root / "cal.json"
    rc, err = _cli(["gen:poisson2d:16", "--device", "cpu", "--commbench",
                    str(cal), "--nparts", "8", "--dtype", "f32",
                    "--max-iterations", "20", "--warmup", "0", "-q"])
    assert rc == 0, err
    hist, plan, sj = root / "hist", root / "plan.json", root / "stats.json"
    rc, err = _cli(["gen:poisson2d:32", "--device", "cpu", "--autotune",
                    "--no-probe-cache",
                    "--calibration", str(cal), "--history", str(hist),
                    "--plan", str(plan), "--stats-json", str(sj),
                    "--nparts", "8", "--residual-rtol", "1e-6",
                    "--max-iterations", "300", "--warmup", "0", "-q"])
    assert rc == 0, err
    assert "autotune: dispatching" in err and "fallback" not in err
    return {"cal": cal, "hist": hist, "plan": plan, "stats": sj}


def test_autotune_records_plan_vs_actual(planned_run):
    doc = json.loads(planned_run["plan"].read_text())
    assert planner.validate_plan(doc) == []
    assert jax_planner.validate_plan(doc) == []
    cal_id = json.loads(planned_run["cal"].read_text())["calibration_id"]
    assert doc["calibration"] == cal_id
    assert doc["iter_dispatch_s"]["classic/xla"] > 0
    assert doc["comm_launches"]["reduction"] > 0
    for row in doc["ranked"]:
        assert row["label"] == jax_planner.candidate_label(row)
    plan = json.loads(planned_run["stats"].read_text())["stats"]["plan"]
    assert plan["plan_id"] == doc["plan_id"]
    assert plan["source"] == "planned" and plan["calibration"] == cal_id
    assert plan["measured_s_per_solve"] > 0
    assert plan["misprediction_ratio"] > 0
    from acg_tpu_torch.observatory import history_scan
    rows = [e["doc"]["stats"]["plan"] for e in history_scan(
        planned_run["hist"]) if (e.get("doc") or {}).get("stats", {})
        .get("plan")]
    assert rows and rows[-1]["plan_id"] == doc["plan_id"]


def test_history_report_plan_column_and_gate(planned_run):
    r = _report([str(planned_run["hist"])])
    assert r.returncode == 0, r.stderr
    assert "plan x" in r.stdout
    r = _report([str(planned_run["hist"]), "--fail-on-misprediction",
                 "1e-9"])
    assert r.returncode == 7 and "MISPREDICTION" in r.stdout
    r = _report([str(planned_run["hist"]), "--fail-on-misprediction",
                 "1e9"])
    assert r.returncode == 0


def test_second_planned_run_self_corrects(planned_run):
    plan2 = planned_run["hist"].parent / "plan2.json"
    rc, err = _cli(["gen:poisson2d:32", "--device", "cpu", "--autotune",
                    "--no-probe-cache",
                    "--calibration", str(planned_run["cal"]), "--history",
                    str(planned_run["hist"]), "--plan", str(plan2),
                    "--nparts", "8", "--residual-rtol", "1e-6",
                    "--max-iterations", "300", "--warmup", "0", "-q"])
    assert rc == 0, err
    doc = json.loads(plan2.read_text())
    assert doc["correction"]["nsamples"] >= 1
    assert doc["correction"]["scale"] != 1.0
    assert "correction" in planner.render_plan(doc)


def test_explain_plan_prints_table_without_solving(tmp_path, capsys):
    out = tmp_path / "plan.json"
    rc, err = _cli(["gen:poisson2d:16", "--device", "cpu", "--explain",
                    "--no-probe-cache",
                    "--plan", str(out), "--nparts", "8",
                    "--max-iterations", "50", "-q"])
    assert rc == 0, err
    assert "== plan: gen:poisson2d:16 on 8 part(s)" in err
    doc = json.loads(out.read_text())
    assert planner.validate_plan(doc) == [] == jax_planner.validate_plan(doc)
    assert doc["uncalibrated"] is True
    assert "total solver time" not in err
    assert "converged" not in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    (["--autotune", "--explain"], "--explain --plan"),
    (["--autotune", "--kernels", "fused"], "--autotune does not support"),
    (["--autotune", "--algorithm", "sstep:4"], "--autotune does not"),
    (["--plan", "p.json"], "--plan needs --explain"),
])
def test_autotune_refusal_matrix(argv, msg):
    rc, err = _cli(["gen:poisson2d:16", "--device", "cpu"] + argv)
    assert rc != 0 and msg in err, err


def test_explain_calibration_mismatch_warns_structured(tmp_path):
    """A calibration taken on other parts (or another backend or device)
    warns and leaves the structured calibration-mismatch event; a
    matching one does not."""
    cal = _cal(nparts=4, backend="cuda", device="NVIDIA H100 80GB HBM3")
    p = tmp_path / "cal.json"
    p.write_text(json.dumps(cal))
    sj = tmp_path / "explain.jsonl"
    rc, err = _cli(["gen:poisson2d:16", "--device", "cpu", "--explain",
                    "--no-probe-cache",
                    "--calibration", str(p), "--nparts", "8", "--dtype",
                    "f32", "--max-iterations", "20", "--warmup", "0",
                    "--stats-json", str(sj), "-q"])
    assert rc == 0, err
    assert "WARNING" in err and "4 parts" in err
    assert "backend cuda vs this run's cpu" in err
    assert "device NVIDIA H100 80GB HBM3 vs this run's cpu" in err
    docs = [json.loads(ln) for ln in sj.read_text().splitlines()
            if ln.strip()]
    kinds = [e.get("kind") for d in docs
             for e in d["stats"].get("events", [])]
    assert "calibration-mismatch" in kinds, kinds
    p8 = tmp_path / "cal8.json"
    p8.write_text(json.dumps(_cal(nparts=8)))
    rc, err = _cli(["gen:poisson2d:16", "--device", "cpu", "--explain",
                    "--no-probe-cache",
                    "--calibration", str(p8), "--nparts", "8", "--dtype",
                    "f32", "--max-iterations", "20", "--warmup", "0",
                    "-q"])
    assert rc == 0, err
    assert "calibration-mismatch" not in err and "WARNING" not in err


# -- old-document tolerance ----------------------------------------------

def test_old_ledger_docs_render_without_plan_column(tmp_path):
    d = tmp_path / "hist"
    d.mkdir()
    row = {"ledger": "acg-tpu-history/1", "unix_time": 1e9,
           "case": "legacy", "latency_s": 0.1, "iterations": 9,
           "doc": {"schema": "acg-tpu-stats/11",
                   "manifest": {"metric": "legacy"},
                   "stats": {"tsolve": 0.1, "niterations": 9}}}
    (d / "2001-09-09.jsonl").write_text(json.dumps(row) + "\n")
    r = _report([str(d), "--fail-on-misprediction", "1e-9"])
    assert r.returncode == 0, r.stderr + r.stdout
    assert "plan -" in r.stdout


def test_old_stats_doc_loads_additively():
    from acg_tpu_torch import observatory
    from acg_tpu_torch.solvers.stats import SolverStats
    doc = {"schema": "acg-tpu-stats/11",
           "manifest": {"metric": "m", "matrix": "m", "solver": "acg"},
           "stats": {"tsolve": 0.5, "niterations": 7, "converged": True}}
    assert observatory._index_of(doc)["iterations"] == 7
    st = SolverStats()
    assert st.to_dict()["plan"] == {}
    assert "plan:" not in st.fwrite()
    st.plan = {"plan_id": "plan-cpu-1p-x"}
    assert "plan:" in st.fwrite()
