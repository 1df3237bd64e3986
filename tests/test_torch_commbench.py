"""The port's communication observatory (acg_tpu_torch.commbench)
against the JAX package's: the alpha-beta fit, the collective sweeps on
stacked parts, K6's per-edge rows (its plain version on the CPU), the
measured segment decomposition, the document (which the reference's
validator accepts and whose id the reference's hash reproduces), the
calibrated comm pricing, and the CLI's --commbench / --calibration
path.  The reference's runs go over the 8-device CPU mesh of the test
configuration."""

import contextlib
import gzip
import io
import json
import math

import numpy as np
import pytest
import torch

from acg_tpu import commbench as jax_cb
from acg_tpu_torch import commbench as cb
from acg_tpu_torch.cli import main as torch_main

torch.set_num_threads(min(2, torch.get_num_threads()))


def _csr(side=16):
    from acg_tpu_torch.io.generators import poisson2d_coo
    from acg_tpu_torch.matrix import SymCsrMatrix
    r, c, v, n = poisson2d_coo(side)
    return SymCsrMatrix.from_coo(n, r, c, v).to_csr()


def _dist_solver(side=16, nparts=8, pipelined=False, comm="xla",
                 kernels="auto"):
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    csr = _csr(side)
    part = partition_rows(csr, nparts, seed=42, method="band")
    prob = DistributedProblem.build(csr, part, nparts)
    return DistCGSolver(prob, pipelined=pipelined, comm=comm,
                        kernels=kernels, device="cpu"), csr


def _jax_dist_solver(side=16, nparts=8, comm="xla"):
    import jax.numpy as jnp

    from acg_tpu.io.generators import poisson2d_coo
    from acg_tpu.matrix import SymCsrMatrix
    from acg_tpu.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu.partition import partition_rows

    r, c, v, n = poisson2d_coo(side)
    csr = SymCsrMatrix.from_coo(n, r, c, v).to_csr()
    part = partition_rows(csr, nparts, seed=42, method="band")
    return DistCGSolver(DistributedProblem.build(csr, part, nparts,
                                                 dtype=jnp.float64),
                        comm=comm)


# -- the alpha-beta fit --------------------------------------------------

def test_fit_recovers_known_alpha_beta():
    """Synthetic timings (2 % noise) recover alpha and beta, with the
    reference's fit on the same points."""
    alpha, beta = 5e-5, 2e-9
    rng = np.random.default_rng(7)
    pts = [(b, (alpha + beta * b) * (1.0 + 0.02 * rng.standard_normal()))
           for b in (64, 1024, 16384, 262144, 4194304)]
    fit = cb.fit_alpha_beta(pts)
    assert fit == jax_cb.fit_alpha_beta(pts)
    assert fit["npoints"] == 5 and fit["r2"] > 0.99
    assert abs(fit["alpha_s"] - alpha) / alpha < 0.25
    assert abs(fit["beta_s_per_byte"] - beta) / beta < 0.25
    assert cb.predict_seconds(fit, 0) == pytest.approx(fit["alpha_s"])


def test_fit_clamps_nonnegative_and_degrades():
    for pts in ([(64, 3e-5), (65536, 1e-5)], [], [(64, -1.0)],
                [(1024, 1e-6)], [(0, 2e-6), (0, 1e-6)]):
        assert cb.fit_alpha_beta(pts) == jax_cb.fit_alpha_beta(pts), pts
    fit = cb.fit_alpha_beta([(64, 3e-5), (65536, 1e-5)])
    assert fit["beta_s_per_byte"] == 0.0
    assert fit["alpha_s"] == pytest.approx(2e-5)
    assert cb.fit_alpha_beta([]) is None
    one = cb.fit_alpha_beta([(1024, 1e-6)])
    assert one["alpha_s"] == 0.0
    assert one["beta_s_per_byte"] == pytest.approx(1e-6 / 1024)
    assert cb.predict_seconds(None, 10) is None


# -- the collective kinds on stacked parts -------------------------------

def test_collective_sweep_on_8_stacked_parts():
    """Each plain kind sweeps and fits nonnegative; a part's payload is
    the reference's for the same requested size, and a chain keeps the
    all-ones payload (the sum rescaled by 1/P, the transpose, the
    roll)."""
    from acg_tpu.parallel.mesh import solve_mesh

    colls = cb.bench_collectives(8, (256, 8192), reps=6, repeats=2)
    mesh = solve_mesh(8)
    for kind in ("all_reduce", "all_to_all", "collective_permute"):
        entry = colls[kind]
        assert entry["alpha_s"] >= 0.0 and entry["beta_s_per_byte"] >= 0.0
        assert len(entry["points"]) == 2
        for p, nb in zip(entry["points"], (256, 8192)):
            assert p["seconds"] > 0
            assert p["bytes"] == jax_cb._collective_program(mesh, kind, nb,
                                                            1)[1]
    assert colls["all_to_all"]["points"][1]["bytes"] == 8192
    for kind, shape in (("all_reduce", (4, 16)), ("all_to_all", (4, 4, 4)),
                        ("collective_permute", (4, 16))):
        run, _ = cb._collective_program(4, kind, 64, 3, "cpu")
        assert torch.equal(run(), torch.ones(shape)), kind


def test_dma_per_edge_rows_and_dense_sweep():
    """Per-edge rows by ring distance on 8 stacked parts (K6's plain
    version here): one row a distance 1..4, the antipodal distance one
    peer a part, the count gates the reference's."""
    rows = cb.bench_dma_edges(8, 2048, reps=6, repeats=2)
    assert [r["distance"] for r in rows] == [1, 2, 3, 4]
    for r in rows:
        assert r["put_wait_seconds"] > 0 and r["window_bytes"] == 2048
    assert rows[-1]["peers_per_shard"] == 1
    assert all(r["peers_per_shard"] == 2 for r in rows[:-1])
    for d in (None, 1, 2, 3, 4):
        assert np.array_equal(cb._dma_counts(8, 5, d),
                              jax_cb._dma_counts(8, 5, d))
    dense = cb.bench_dma(8, (512, 4096), reps=6, repeats=2)
    assert dense["alpha_s"] >= 0 and len(dense["points"]) == 2
    assert dense["route"] == "plain"
    # a gated exchange writes only the distance-d windows
    run, _, _ = cb._dma_program(4, 3, 1, "cpu", distance=2)
    out = run()
    assert torch.equal(out[0, 2], torch.ones(3))
    assert torch.equal(out[0, 1], torch.zeros(3))


# -- segment decomposition ----------------------------------------------

def test_segment_decomposition_sums_to_measured_band():
    """The SpMV/halo/reduction split approximates the measured s/iter of
    the same stacked solve within the reference's band (0.15-3.5).  The
    probes and the solve are timed in turns, three rounds, each the min
    of its repeats, so load on the host skews both alike."""
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    solver, _csr = _dist_solver()
    b = np.ones(solver.problem.n)
    K = 25
    explained = measured = math.inf
    for _ in range(3):
        segs = cb.segment_decomposition(solver, b, reps=12, repeats=3)
        assert segs["available"], segs
        explained = min(explained, segs["explained_s_per_iteration"])
        for _ in range(3):
            solver.stats.tsolve = 0.0
            solver.solve(b, criteria=StoppingCriteria(maxits=K), warmup=1,
                         host_result=False, raise_on_divergence=False)
            measured = min(measured, solver.stats.tsolve / K)
    assert set(segs["segments"]) == {"spmv", "halo", "reduction"}
    for seg in segs["segments"].values():
        assert seg["s_per_iteration"] > 0
    assert segs["segments"]["reduction"]["calls_per_iteration"] == 2.0
    assert segs["segments"]["spmv"]["calls_per_iteration"] == 1.0
    ratio = explained / measured
    assert 0.15 <= ratio <= 3.5, (segs, measured)


def test_pipelined_reduction_probe_is_fused():
    solver, _ = _dist_solver(pipelined=True)
    segs = cb.segment_decomposition(solver, np.ones(solver.problem.n),
                                    reps=6, repeats=2)
    assert segs["available"], segs
    assert segs["segments"]["reduction"]["calls_per_iteration"] == 1.0


@pytest.mark.parametrize("comm", ["xla", "dma"])
def test_probes_leave_solve_loops_unchanged(comm):
    """A solve after the probes (and the collective sweeps) dispatches
    the same operations and kernels and returns the same bits as before
    them, on stacked parts and on one device."""
    from acg_tpu_torch import perfmodel
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers.cg import TorchCGSolver

    solver, csr = _dist_solver(comm=comm, kernels="pallas")
    s1 = TorchCGSolver(device_matrix_from_csr(csr, device="cpu"),
                       kernels="pallas", device="cpu")
    b = np.ones(csr.shape[0])
    before = [(s.solve(b, raise_on_divergence=False),
               perfmodel.count_dispatches(s, b)) for s in (solver, s1)]
    for s in (solver, s1):
        assert cb.segment_decomposition(s, b, reps=4,
                                        repeats=1)["available"]
    cb.bench_collectives(8, (256,), reps=2, repeats=1)
    cb.bench_dma_edges(8, 256, reps=2, repeats=1)
    after = [(s.solve(b, raise_on_divergence=False),
              perfmodel.count_dispatches(s, b)) for s in (solver, s1)]
    for (x0, c0), (x1, c1) in zip(before, after):
        assert np.array_equal(x0, x1)
        assert c0 == c1


# -- document validation and calibrated pricing -------------------------

def _minimal_doc(**over):
    doc = {"schema": cb.COMMBENCH_SCHEMA, "nparts": 8,
           "collectives": {
               "all_reduce": {"alpha_s": 1e-5, "beta_s_per_byte": 0.0,
                              "npoints": 1, "r2": None,
                              "points": [{"bytes": 8, "seconds": 1e-5}]},
               "all_to_all": {"alpha_s": 2e-5, "beta_s_per_byte": 1e-9,
                              "npoints": 1, "r2": None,
                              "points": [{"bytes": 1024,
                                          "seconds": 2.1e-5}]}}}
    doc.update(over)
    doc["calibration_id"] = cb.calibration_id(doc)
    return doc


def test_validator_roundtrip_and_tamper_detection(tmp_path):
    """The port's validator finds the reference's problems in the same
    documents, and the id is the reference's hash."""
    doc = _minimal_doc()
    assert doc["calibration_id"] == jax_cb.calibration_id(doc)
    assert cb.validate_commbench(doc) == []
    p = tmp_path / "cal.json"
    p.write_text(json.dumps(doc))
    assert cb.load_calibration(p)["calibration_id"] == doc["calibration_id"]
    mangled = _minimal_doc()
    mangled["collectives"]["all_reduce"]["points"] = [
        {"bytes": "oops", "seconds": 1}]
    mangled["calibration_id"] = cb.calibration_id(mangled)
    cases = [dict(doc, nparts=4), {"schema": "nope"}, mangled,
             _minimal_doc(edges=[{"distance": "x"}]), "not a doc"]
    for bad_alpha in ("abc", None, True):
        m2 = _minimal_doc()
        m2["collectives"]["all_reduce"]["alpha_s"] = bad_alpha
        m2["calibration_id"] = cb.calibration_id(m2)
        cases.append(m2)
    for d in cases:
        got = cb.validate_commbench(d)
        assert got and got == jax_cb.validate_commbench(d), d
    (tmp_path / "garbage.json").write_text("{torn")
    with pytest.raises(ValueError):
        cb.load_calibration(tmp_path / "garbage.json")


def test_calibrated_comm_pricing_math():
    cal = _minimal_doc()
    led = {"transport": "xla", "nparts": 8,
           "allreduce_per_iteration": 2, "allreduce_scalars": 1,
           "allreduce_bytes_per_iteration": 16,
           "halo_bytes_per_iteration": 800,
           "halo_exchanges_per_iteration": 1,
           "halo_plane_bytes_per_exchange": 1000}
    with_dma = _minimal_doc(collectives={
        **cal["collectives"],
        "dma": {"alpha_s": 4e-5, "beta_s_per_byte": 2e-9, "npoints": 1,
                "r2": None, "points": [{"bytes": 512, "seconds": 4.1e-5}]}})
    led_dma = dict(led, transport="dma")
    for c, lg in ((cal, led), (cal, led_dma), (with_dma, led_dma),
                  (cal, {"error": "x"})):
        assert cb.comm_seconds(c, lg) == jax_cb.comm_seconds(c, lg)
    cs = cb.comm_seconds(cal, led)
    assert cs["allreduce_s"] == pytest.approx(2 * 1e-5)
    assert cs["halo_s"] == pytest.approx(2e-5 + 1e-9 * 1000)
    assert cs["halo_kind"] == "all_to_all"
    assert cb.comm_seconds(cal, led_dma)["halo_kind"] == "all_to_all"
    assert cb.comm_seconds(with_dma, led_dma)["halo_kind"] == "dma"
    assert cb.comm_seconds(cal, {"error": "x"}) is None


@pytest.mark.parametrize("comm", ["xla", "dma"])
def test_ledger_carries_plane_bytes_and_ring_distances(comm):
    """The stacked tier's ledger declares the padded plane the transport
    moves ((P-1) windows under dma, P under xla) and the ring distances,
    as the reference's ledger of the same partition does."""
    solver, _ = _dist_solver(comm=comm)
    led = solver.comm_profile()
    ref = _jax_dist_solver(comm=comm).comm_profile()
    maxcnt = solver.problem.halo.maxcnt
    assert led["halo_plane_bytes_per_exchange"] == \
        (7 if comm == "dma" else 8) * maxcnt * 8
    assert led["ring_distances"] == [1]
    for k in ("halo_plane_bytes_per_exchange", "ring_distances",
              "halo_bytes_per_iteration"):
        assert led[k] == ref[k], k
    assert cb.halo_exchange_seconds(_minimal_doc(), led) == \
        jax_cb.halo_exchange_seconds(_minimal_doc(), ref)


def test_bench_diff_keys_calibrations_apart(tmp_path):
    from acg_tpu import perfmodel as jax_perfmodel
    from acg_tpu_torch import perfmodel

    def doc(cal, val):
        return {"schema": "acg-tpu-stats/12",
                "manifest": {"metric": "m1", "calibration": cal},
                "stats": {"tsolve": 1.0, "niterations": val}}

    paths = []
    for name, cal, val in (("a", "cb-cpu-8p-aaaa", 100),
                           ("b", "cb-cpu-8p-bbbb", 50),
                           ("u", "uncalibrated", 75)):
        p = tmp_path / f"{name}.jsonl"
        p.write_text(json.dumps(doc(cal, val)) + "\n")
        paths.append(p)
    ca, cbb, cu = (perfmodel.load_cases(p) for p in paths)
    assert [ca, cbb, cu] == [jax_perfmodel.load_cases(p) for p in paths]
    assert list(ca) == ["m1|cal=cb-cpu-8p-aaaa"]
    assert list(cu) == ["m1"]
    lines, nreg, ncmp = perfmodel.compare_cases(ca, cbb, 10.0)
    assert ncmp == 0 and nreg == 0
    key, _ = perfmodel._row_case({"metric": "m1", "value": 1.0,
                                  "calibration": "cb-x-2p-cc"})
    assert key == "m1|cal=cb-x-2p-cc"


def test_triad_probe_cache_sidecar(tmp_path, monkeypatch):
    """The sidecar's port keys (``torch:<device>:n<elems>``, never the
    reference's), the hit, --no-probe-cache and refresh."""
    from acg_tpu_torch import perfmodel

    calls = {"n": 0}

    def fake_probe(nelems, **kw):
        calls["n"] += 1
        return 123.0 + calls["n"]

    monkeypatch.setattr(perfmodel, "triad_probe_gbs", fake_probe)
    path = tmp_path / "probe.json"
    # a reference entry under the reference's key prices nothing here
    path.write_text(json.dumps({"cpu:cpu:n999": {"gbs": 7.0}}))
    monkeypatch.setenv("ACG_TPU_PROBE_CACHE", str(path))
    assert perfmodel.cached_triad_probe_gbs(999) == 124.0
    assert perfmodel.cached_triad_probe_gbs(999) == 124.0
    assert calls["n"] == 1
    cache = json.loads(path.read_text())
    assert cache["cpu:cpu:n999"] == {"gbs": 7.0}
    assert cache["torch:cpu:n999"]["gbs"] == 124.0
    perfmodel.cached_triad_probe_gbs(1000)
    assert calls["n"] == 2
    assert perfmodel.cached_triad_probe_gbs(999, use_cache=False) == 126.0
    assert json.loads(path.read_text())["torch:cpu:n999"]["gbs"] == 124.0
    assert perfmodel.cached_triad_probe_gbs(999, refresh=True) == 127.0
    assert json.loads(path.read_text())["torch:cpu:n999"]["gbs"] == 127.0


def test_trace_analysis_breaks_collectives_out_by_kind(tmp_path):
    """The per-kind collective seconds a calibrated verdict is confronted
    with: the port's analysis of a capture equals the reference's."""
    from acg_tpu import tracing as jax_tracing
    from acg_tpu_torch import tracing

    us = 1e6
    events = [
        {"ph": "X", "pid": 1, "tid": 1, "name": "solve",
         "ts": 0.0, "dur": 10.0 * us},
        {"ph": "X", "pid": 1, "tid": 3, "name": "all-reduce.1",
         "ts": 1.0 * us, "dur": 2.0 * us},
        {"ph": "X", "pid": 1, "tid": 3, "name": "all-to-all.4",
         "ts": 4.0 * us, "dur": 1.0 * us},
        {"ph": "X", "pid": 1, "tid": 3, "name": "collective-permute.2",
         "ts": 6.0 * us, "dur": 0.5 * us},
    ]
    d = tmp_path / "plugins" / "profile" / "r"
    d.mkdir(parents=True)
    with gzip.open(d / "vm.trace.json.gz", "wt") as f:
        json.dump({"displayTimeUnit": "ns", "metadata": {},
                   "traceEvents": events}, f)
    an = tracing.analyze_trace(tmp_path)
    ref = jax_tracing.analyze_trace(tmp_path)
    assert an["available"]
    kinds = an["collective_kind_seconds"]
    assert kinds == ref["collective_kind_seconds"]
    assert kinds["all_reduce"] == pytest.approx(2.0)
    assert kinds["all_to_all"] == pytest.approx(1.0)
    assert kinds["collective_permute"] == pytest.approx(0.5)
    assert sum(kinds.values()) == pytest.approx(an["collective_seconds"])


# -- CLI: --commbench / --calibration ------------------------------------

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


@pytest.fixture(scope="module")
def commbench_doc(tmp_path_factory):
    """One --commbench run shared by the CLI tests."""
    out = tmp_path_factory.mktemp("cb") / "cal.json"
    rc, err = _cli(["gen:poisson2d:16", "--device", "cpu", "--commbench",
                    str(out), "--nparts", "8", "--dtype", "f32",
                    "--max-iterations", "20", "--warmup", "0", "-q"])
    assert rc == 0, err
    assert "calibration id: cb-cpu-8p-" in err
    return out


def test_cli_commbench_document_validates(commbench_doc):
    """Both validators accept the document, both hashes give its id; the
    four kinds are fitted and the segments measured."""
    doc = json.loads(commbench_doc.read_text())
    assert cb.validate_commbench(doc) == []
    assert jax_cb.validate_commbench(doc) == []
    assert jax_cb.calibration_id(doc) == doc["calibration_id"]
    for kind in cb.KINDS:
        assert "alpha_s" in doc["collectives"][kind], kind
    assert [e["distance"] for e in doc["edges"]] == [1, 2, 3, 4]
    assert doc["segments"]["available"] is True
    assert doc["case"]["measured_s_per_iteration"] > 0
    assert doc["backend"] == "cpu" and doc["device"] == "cpu"
    assert doc["transport_layout"] == cb.TRANSPORT_LAYOUT


def test_cli_calibrated_explain_beats_uncalibrated(commbench_doc, tmp_path):
    """``--explain --calibration`` on the 8 stacked parts: the dist
    tier's predicted/measured ratio is closer to 1 than the uncalibrated
    one, with the id printed and in the manifest."""
    sj = tmp_path / "explain.jsonl"
    rc, err = _cli(["gen:poisson2d:16", "--device", "cpu", "--explain",
                    "--no-probe-cache",
                    "--calibration", str(commbench_doc), "--nparts", "8",
                    "--dtype", "f32", "--max-iterations", "20",
                    "--warmup", "0", "--stats-json", str(sj), "-q"])
    assert rc == 0, err
    cal_id = json.loads(commbench_doc.read_text())["calibration_id"]
    assert "== explain: calibration ==" in err and cal_id in err
    docs = [json.loads(ln) for ln in sj.read_text().splitlines()
            if ln.strip()]
    dist = [d for d in docs if "dist-cg" in d["manifest"]["metric"]]
    row = dist[0]["manifest"]["explain"]
    meas = row["measured_s_per_iter"]
    ratio = row["predicted_s_per_iter"] / meas
    ratio_uncal = row["uncalibrated_predicted_s_per_iter"] / meas
    assert abs(math.log(ratio)) < abs(math.log(ratio_uncal)), row
    assert row["calibration"] == cal_id
    assert dist[0]["manifest"]["calibration"] == cal_id
    assert row["segments"]["available"] is True
    assert dist[0]["stats"]["costmodel"]["calibration"] == cal_id


def test_cli_solve_records_calibration_provenance(commbench_doc, tmp_path):
    """A normal solve under --calibration stamps the id on the manifest
    and the convergence-log meta line; without one both say
    uncalibrated."""
    cal_id = json.loads(commbench_doc.read_text())["calibration_id"]
    for cal, want in ((["--calibration", str(commbench_doc)], cal_id),
                      ([], "uncalibrated")):
        sj, cl = tmp_path / f"s{len(cal)}.json", tmp_path / f"c{len(cal)}"
        rc, err = _cli(["gen:poisson2d:16", "--device", "cpu",
                        "--max-iterations", "100", "--residual-rtol",
                        "1e-8", "--warmup", "0", "-q", "--stats-json",
                        str(sj), "--convergence-log", str(cl)] + cal)
        assert rc == 0, err
        assert json.loads(sj.read_text())["manifest"]["calibration"] == want
        meta = json.loads(cl.read_text().splitlines()[0])
        assert meta["meta"] is True and meta["calibration"] == want


@pytest.mark.parametrize("argv,msg", [
    (["--commbench", "--calibration", "x.json"], "two calibration sources"),
    (["--explain", "--calibration", "MISSING"], "--calibration"),
    (["--explain", "--calibration", "BAD"],
     "not a valid acg-tpu-commbench/1"),
    (["--commbench", "--fault-inject", "spmv:nan@3"], "PRISTINE"),
    (["--commbench", "--soak", "3"], "measurement pass"),
    (["--commbench", "c.json", "--stats-json", "s.jsonl"], "--stats-json"),
    (["--commbench", "--multihost"], "single-controller"),
])
def test_cli_commbench_and_calibration_refusals(tmp_path, monkeypatch,
                                                argv, msg):
    """The reference's refusals, before any device work."""
    monkeypatch.delenv("ACG_TPU_FAULT_INJECT", raising=False)
    (tmp_path / "BAD").write_text('{"schema": "nope"}')
    monkeypatch.chdir(tmp_path)
    rc, err = _cli(["gen:poisson2d:8", "--device", "cpu"] + argv)
    assert rc != 0 and msg in err, err
    assert not (tmp_path / "c.json").exists()
