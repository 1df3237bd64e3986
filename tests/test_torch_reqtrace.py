"""The port's request observatory (acg_tpu_torch.reqtrace) against the JAX
package's (acg_tpu.reqtrace, tests/test_reqtrace.py): request identity
resolution, per-stage accounting, the access ledger, and its validators.

Each test runs the same calls through both modules and holds the port's
results to the reference's: the same trace-ids, request ids, outcomes,
stage sums, lanes and ring contents, ledger rows with the same keys that
the reference's ``scripts/check_access_log.py`` and
``scripts/access_report.py`` read as they read the reference's.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from acg_tpu import reqtrace as jrt
from acg_tpu_torch import reqtrace as trt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
BOTH = pytest.mark.parametrize("rt", [trt, jrt], ids=["port", "jax"])


def test_constants_are_the_references():
    for name in ("ACCESS_SCHEMA", "REQUESTS_SCHEMA", "STAGES", "OUTCOMES"):
        assert getattr(trt, name) == getattr(jrt, name), name


# -- identity resolution --------------------------------------------------

def test_parse_traceparent():
    assert trt.parse_traceparent(TRACEPARENT) == TRACE_ID
    for v in (TRACEPARENT, "  " + TRACEPARENT.upper() + " ", None, "",
              "not-a-traceparent", TRACE_ID,
              "00-" + "g" * 32 + "-00f067aa0ba902b7-01",
              "00-" + "a" * 31 + "-00f067aa0ba902b7-01", 17):
        assert trt.parse_traceparent(v) == jrt.parse_traceparent(v), v


def test_request_id_resolution_order():
    docs = [{"request_id": "client-7", "traceparent": TRACEPARENT},
            {"traceparent": TRACEPARENT}]
    docs += [{"request_id": bad, "traceparent": TRACEPARENT}
             for bad in ("", "has space", "x" * 129, 42, ["list"])]
    for doc in docs:
        assert trt.request_id_from_doc(doc) == jrt.request_id_from_doc(doc)
    assert trt.request_id_from_doc(docs[0]) == "client-7"
    assert trt.request_id_from_doc(docs[1]) == TRACE_ID
    # nothing usable: generated, of the reference's form
    for doc in ({}, None, {"request_id": "bad id", "traceparent": "junk"}):
        rid, jrid = trt.request_id_from_doc(doc), jrt.request_id_from_doc(doc)
        assert rid.startswith("req-") and len(rid) == len(jrid) == 4 + 16
    assert trt.generate_request_id() != trt.generate_request_id()


def test_outcome_mapping():
    bodies = [{"ok": True}, None, {}, {"ok": False,
                                       "error": {"type": "not-converged"}}]
    bodies += [{"ok": False, "error": {"type": kind}}
               for kind in ("shed-queue-full", "shed-slo-burn",
                            "shed-shutdown", "deadline-expired",
                            "invalid-request", "faults-disabled",
                            "NotConvergedError", "BreakdownError")]
    for body in bodies:
        assert trt.outcome_of(body) == jrt.outcome_of(body), body
        assert trt.outcome_of(body) in trt.OUTCOMES


# -- per-request records --------------------------------------------------

def _record_story(rt):
    rec = rt.RequestRecord("r-1", matrix="gen:poisson2d:12")
    rec.stage("queue-wait", 0.25)
    rec.stage("queue-wait", 0.25)
    rec.stage("solve", 0.5, batch="batch-1")
    rec.note("coalesced", 3)
    stages = rec.stages()
    d = rec.doc()
    rec.stage("demux", -1.0)
    demux = rec.stages()["demux"]
    log = rt.RequestLog()
    rec2 = log.begin("r-2")
    rec2.stage("admit", 0.01)
    row = log.complete(rec2, "ok")
    rec2.stage("solve", 99.0)
    rec2.note("cache", {"operator": "hit"})
    sealed = rec2.doc()
    return (stages, (d["inflight"], d["request_id"], d["coalesced"],
                     sorted(d)), demux, row["outcome"],
            sorted(sealed["stages"]), "cache" in sealed, sorted(row))


def test_record_accumulates_and_freezes():
    got, want = _record_story(trt), _record_story(jrt)
    assert got == want
    stages, doc, demux, outcome, sealed, cached, _ = got
    assert stages == {"queue-wait": 0.5, "solve": 0.5}
    assert doc[:3] == (True, "r-1", 3) and demux == 0.0
    assert outcome == "ok" and sealed == ["admit"] and not cached


def _lane_story(rt):
    log = rt.RequestLog(ring=4)
    a, b, c = log.begin("a"), log.begin("b"), log.begin("c")
    lanes = [a.lane, b.lane, c.lane]
    log.complete(b, "ok")
    lanes.append(log.begin("d").lane)
    first = log.complete(a, "deadline-expired") is not None
    second = log.complete(a, "ok")
    return lanes, first, second, a.outcome, log.summary()["outcomes"]


def test_log_lane_assignment_and_idempotent_complete():
    got = _lane_story(trt)
    assert got == _lane_story(jrt)
    assert got[0] == [0, 1, 2, 1] and got[1] and got[2] is None
    assert got[3] == "deadline-expired"


@BOTH
def test_log_ring_bound_and_monotone_t_done(rt):
    log = rt.RequestLog(ring=3)
    rows = [log.complete(log.begin(f"r-{i}"), "ok") for i in range(8)]
    snap = log.snapshot()
    assert snap["schema"] == jrt.REQUESTS_SCHEMA
    assert [d["request_id"] for d in snap["completed"]] == \
        ["r-5", "r-6", "r-7"]
    assert snap["outcomes"] == {"ok": 8}
    dones = [r["t_done"] for r in rows]
    assert all(b > a for a, b in zip(dones, dones[1:]))
    assert all(r["t_arrival"] <= r["t_done"] for r in rows)
    s = log.summary()
    assert (s["completed"], s["inflight"], s["ring"]) == (8, 0, 3)
    assert sorted(s) == sorted(jrt.RequestLog().summary())


def _write_ledger(rt, path):
    log = rt.RequestLog(path, ring=8)
    members = [f"m-{i}" for i in range(3)]
    batch = {"id": "batch-1", "width": 3, "members": members,
             "solve_seconds": 0.3, "rhs_solve_seconds": 0.1}
    for rid in members:
        rec = log.begin(rid, matrix="gen:poisson2d:12")
        rec.arrival -= 0.5  # backdate: wall must cover the stages
        rec.stage("admit", 0.001)
        rec.stage("queue-wait", 0.02)
        rec.stage("solve", 0.1, batch="batch-1")
        rec.note("batch", batch)
        rec.note("cache", {"operator": "hit", "program": "hit"})
        log.complete(rec, "ok")
    shed = log.begin("shed-1")
    shed.stage("admit", 0.0005)
    log.complete(shed, "shed-queue-full")
    log.close()
    with open(path) as f:
        return [json.loads(line) for line in f]


def _checker(*argv):
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, cwd=ROOT)


def test_ledger_rows_pass_the_validator(tmp_path):
    """Rows the port writes -- a batched row with per-RHS attribution
    and a shed row -- carry the reference's keys and stages and pass the
    reference's checker and reporter; a stage-sum forgery is caught."""
    path = str(tmp_path / "access.jsonl")
    rows = _write_ledger(trt, path)
    jrows = _write_ledger(jrt, str(tmp_path / "jaccess.jsonl"))
    assert len(rows) == len(jrows) == 4
    volatile = ("t_done", "t_arrival", "wall_seconds")
    for r, j in zip(rows, jrows):
        assert sorted(r) == sorted(j)
        assert {k: v for k, v in r.items() if k not in volatile} == \
            {k: v for k, v in j.items() if k not in volatile}
    assert set(rows[0]["stages"]) <= set(trt.STAGES)
    res = _checker("scripts/check_access_log.py", path, "--min-rows", "4",
                   "--require-outcome", "ok", "--require-outcome",
                   "shed-queue-full")
    assert res.returncode == 0, res.stderr
    rep = _checker("scripts/access_report.py", path)
    assert rep.returncode == 0, rep.stderr
    assert "p99" in rep.stdout and "queue-wait" in rep.stdout
    assert "tail decomposition" in rep.stdout
    forged = dict(rows[0])
    forged["stages"] = {"solve": forged["wall_seconds"] + 1.0}
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps(forged) + "\n")
    res = _checker("scripts/check_access_log.py", bad)
    assert res.returncode == 1 and "exceeds wall" in res.stderr


def test_concurrent_completions_never_tear(tmp_path):
    """Many threads completing against one port log: every ledger line
    parses (one os.write a row), t_done stays strictly monotone, and
    snapshot() under fire never tears."""
    path = str(tmp_path / "access.jsonl")
    log = trt.RequestLog(path, ring=16)
    nthreads, per = 8, 25
    stop = threading.Event()
    torn = []

    def _writer(k):
        for i in range(per):
            rec = log.begin(f"w{k}-{i}")
            rec.stage("admit", 0.0001)
            rec.stage("solve", 0.0002)
            log.complete(rec, "ok")

    def _reader():
        while not stop.is_set():
            snap = log.snapshot()
            torn.extend(d for d in snap["completed"] + snap["inflight"]
                        if not d.get("request_id"))

    threads = [threading.Thread(target=_writer, args=(k,))
               for k in range(nthreads)]
    rt = threading.Thread(target=_reader)
    rt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    stop.set()
    rt.join(timeout=60.0)
    log.close()
    assert torn == []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == nthreads * per
    dones = [r["t_done"] for r in rows]
    assert all(b > a for a, b in zip(dones, dones[1:]))
    assert log.summary()["outcomes"] == {"ok": nthreads * per}
    res = _checker("scripts/check_access_log.py", path, "--min-rows",
                   str(nthreads * per))
    assert res.returncode == 0, res.stderr
