"""The port's solver service (acg_tpu_torch.serve, ``--serve``) against the
JAX package's (acg_tpu.serve, tests/test_serve.py): admission control,
request isolation, caches, coalescing, the self-healing loop and the
request observatory, each twin driving both daemons on the CPU with the
same requests.

What is held, and how:
  * the refusal matrix, request validation and the coalesce and program
    keys: the same kinds, statuses and keys as the reference;
  * every green answer: the reference's iterations, x within 1e-10
    relative, the true residual of the same ``b`` (both packages draw it
    from ``np.random.default_rng(b_seed)``);
  * coalescing: each member of a batch bitwise its single answer, with
    the same iterations (the batch takes each column's dots as the
    single-RHS program does);
  * the load-sensitive twins of the queue-full 429 and the expired 504
    hold the worker on an event, not a sleep, so a loaded host cannot
    move them;
  * a state sidecar written by either package warm-restores the other's
    daemon;
  * the access log armed or off: the same bits and kernel launches.
"""

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from acg_tpu import metrics as jmetrics
from acg_tpu import observatory as jobservatory
from acg_tpu import serve as jserve
from acg_tpu import supervisor as jsup
from acg_tpu.cli import synthesize_host_matrix
from acg_tpu_torch import metrics, observatory, serve
from acg_tpu_torch import supervisor as sup
from acg_tpu_torch.errors import AcgError

torch.set_num_threads(min(2, torch.get_num_threads()))

MATRIX = "gen:poisson2d:12"
_CSR = synthesize_host_matrix(MATRIX).to_csr()
N = int(_CSR.shape[0])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"

# (serve module, metrics module, observatory module) of each package
PORT = (serve, metrics, observatory)
JAX = (jserve, jmetrics, jobservatory)


def _registry_state(m):
    """Everything the daemons record into ``m``'s process-wide registry:
    each series' values, the arming and the collect callbacks."""
    reg = m.REGISTRY
    with reg._lock:
        series = {name: {k: (list(c._values) if isinstance(c._values, list)
                             else c._values, c._sum, c._count)
                         for k, c in fam._children.items()}
                  for name, fam in reg._families.items()}
    return (series, m.armed(), list(reg._collect_callbacks),
            m._serve_queue_high_water)


def _restore_registry(m, state) -> None:
    series, armed, callbacks, high_water = state
    reg = m.REGISTRY
    with reg._lock:
        for name, fam in reg._families.items():
            saved = series.get(name, {})
            for k in list(fam._children):
                if k not in saved:
                    del fam._children[k]
                    continue
                c = fam._children[k]
                vals, c._sum, c._count = saved[k]
                c._values = list(vals) if isinstance(vals, list) else vals
        reg._collect_callbacks[:] = callbacks
    m._serve_queue_high_water = high_water
    if armed:
        m.arm()
    else:
        m.disarm()


@pytest.fixture(autouse=True)
def _registries_restored():
    """The daemons record into both packages' process-wide registries
    and observatories, which tests of other files on the same worker read
    (the reference's test_observatory.py holds absolute SLO counts): each
    test here leaves them as it found them."""
    states = [(m, _registry_state(m)) for m in (metrics, jmetrics)]
    observed = [(o, o.armed()) for o in (observatory, jobservatory)]
    yield
    for m, state in states:
        _restore_registry(m, state)
    for o, armed in observed:
        o._clear_slo()
        if not armed:
            o.shutdown()


def _counter(m, name: str) -> float:
    """Sum every sample of a counter family in ``m``'s exposition --
    tests assert deltas, the registries are process-wide."""
    total = 0.0
    for line in m.expose().splitlines():
        if line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if head == name or head.startswith(name + "{"):
            total += float(val)
    return total


@contextlib.contextmanager
def _daemon(pkg=PORT, **kw):
    srv, _, obs = pkg
    kw.setdefault("port", 0)
    kw.setdefault("default_timeout", 60.0)
    if srv is serve:
        kw.setdefault("device", "cpu")
    d = srv.ServeDaemon(srv.ServeConfig(**kw))
    d.start()
    try:
        yield d
    finally:
        d.stop()
        obs._clear_slo()


def _doc(**kw):
    doc = {"matrix": MATRIX, "rtol": 1e-8, "maxits": 300}
    doc.update(kw)
    return doc


def _b(seed):
    return np.random.default_rng(seed).standard_normal(N)


def _true_rel(x, b) -> float:
    r = b - _CSR @ np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _rel(x, y) -> float:
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _same_answer(body, jbody):
    """The port's green answer against the reference's for one b."""
    assert body["ok"] and jbody["ok"]
    assert body["iterations"] == jbody["iterations"]
    assert body["converged"] == jbody["converged"]
    assert _rel(body["x"], jbody["x"]) <= 1e-10


@contextlib.contextmanager
def _held_worker(d):
    """Hold ``d``'s worker inside the lead request of a batch (a request
    with ``fault="slow:0"``) until the block exits: ``entered`` is set
    once the worker holds it."""
    gate, entered = threading.Event(), threading.Event()

    def hold(req):
        entered.set()
        gate.wait(60.0)

    d._serve_fault = hold
    try:
        yield entered
    finally:
        gate.set()


# -- validation & refusal matrix ------------------------------------------

def _serve_args(**kw):
    ns = argparse.Namespace(
        A=MATRIX, soak=0, resume=None, b=None, x0=None, output=None,
        explain=False, bench=False, nrhs=0, block_cg=False,
        fault_inject=None, manufactured_solution=False,
        distributed_read=False, output_comm_matrix=False,
        profile_ops=None, ckpt=None, serve_port=0,
        serve_queue_depth=16, serve_coalesce=8, serve_deadline=60.0,
        nparts=0, comm="xla", dtype="f64", serve_faults=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_serve_validate_refusal_matrix():
    serve._serve_validate(_serve_args())
    for kw, frag in [
            ({"soak": 5}, "--soak"),
            ({"resume": "snap"}, "--resume"),
            ({"b": "b.npy"}, "b/x0"),
            ({"output": "x.npy"}, "-o/--output"),
            ({"explain": True}, "--explain"),
            ({"bench": True}, "--bench"),
            ({"nrhs": 4}, "--nrhs"),
            ({"block_cg": True}, "--nrhs"),
            ({"fault_inject": "spmv:nan@3"}, "--fault-inject"),
            ({"manufactured_solution": True}, "--manufactured"),
            ({"plan": "p.json"}, "--plan"),
            ({"A": "matrix.mtx"}, "gen:")]:
        with pytest.raises(SystemExit, match=frag) as t:
            serve._serve_validate(_serve_args(**kw))
        with pytest.raises(SystemExit) as j:
            jserve._serve_validate(_serve_args(**kw))
        assert str(t.value).split(": ", 1)[1] == \
            str(j.value).split(": ", 1)[1]


def test_config_from_args_state_suffix():
    for kw in ({"ckpt": "/tmp/ck"}, {}, {"ckpt": "/tmp/ck.serve.json"},
               {"nparts": 4, "comm": "dma", "dtype": "f32",
                "serve_faults": True}):
        cfg = serve.config_from_args(_serve_args(**kw))
        jcfg = jserve.config_from_args(_serve_args(**kw))
        assert {k: v for k, v in vars(cfg).items() if k != "device"} == \
            vars(jcfg)
    cfg = serve.config_from_args(_serve_args(ckpt="/tmp/ck"))
    assert cfg.state_path == "/tmp/ck.serve.json"
    assert cfg.preload == MATRIX
    assert serve.config_from_args(_serve_args(device="cpu")).device == "cpu"


def test_request_validation_refusals():
    for doc, kind, status in [
            ({}, "invalid-request", 400),
            ({"matrix": "file.mtx"}, "invalid-request", 400),
            ({"matrix": MATRIX, "dtype": "f16"}, "invalid-request", 400),
            ({"matrix": MATRIX, "algorithm": "sstep:zz"},
             "invalid-request", 400),
            ({"matrix": MATRIX, "maxits": 0}, "invalid-request", 400),
            ({"matrix": MATRIX, "timeout": -1}, "invalid-request", 400),
            ({"matrix": MATRIX, "rtol": "soon"}, "invalid-request", 400),
            ({"matrix": MATRIX, "b": ["x", "y"]}, "invalid-request", 400),
            ({"matrix": MATRIX, "fault": "crash"}, "faults-disabled",
             403)]:
        with pytest.raises(serve.RequestRefused) as t:
            serve._Request(doc, serve.ServeConfig())
        with pytest.raises(jserve.RequestRefused) as j:
            jserve._Request(doc, jserve.ServeConfig())
        assert (t.value.kind, t.value.status) == (kind, status)
        assert (j.value.kind, j.value.status) == (kind, status)
        assert str(t.value) == str(j.value)
    armed = serve.ServeConfig(allow_faults=True)
    assert serve._Request({"matrix": MATRIX, "fault": "crash"},
                          armed).fault == "crash"


def test_coalesce_key_compatibility():
    docs = [_doc(b_seed=1), _doc(b_seed=2), _doc(coalesce=False),
            _doc(fault="slow:0.1"), _doc(precond="jacobi"),
            _doc(algorithm="pipelined:2"), _doc(rtol=1e-6),
            _doc(algorithm="classic"), _doc(dtype="f32")]
    cfg = serve.ServeConfig(allow_faults=True, nparts=4)
    jcfg = jserve.ServeConfig(allow_faults=True, nparts=4)
    keys = []
    for doc in docs:
        r, j = serve._Request(doc, cfg), jserve._Request(doc, jcfg)
        assert r.coalesce_key(cfg) == j.coalesce_key(jcfg)
        assert r.operator_key(cfg) == j.operator_key(jcfg)
        for nrhs in (1, 3):
            assert r.program_key(cfg, nrhs) == j.program_key(jcfg, nrhs)
        keys.append(r.coalesce_key(cfg))
    assert keys[0] is not None and keys[0] == keys[1] == keys[7]
    assert keys[2:6] == [None] * 4 and keys[6] != keys[0]


# -- caches: steady state is zero ingest, zero compile --------------------

def test_repeat_request_zero_ingest_zero_compile():
    with _daemon() as d, _daemon(JAX) as jd:
        c0 = _counter(metrics, "acg_compiles_total")
        s1, b1 = d.submit(_doc(b_seed=7))
        assert s1 == 200 and b1["ok"] and b1["converged"]
        assert b1["cache"] == {"operator": "miss", "program": "miss"}
        c1 = _counter(metrics, "acg_compiles_total")
        assert c1 > c0
        hits0 = _counter(metrics, "acg_serve_cache_hits_total")
        s2, b2 = d.submit(_doc(b_seed=8))
        assert s2 == 200 and b2["ok"]
        assert b2["cache"] == {"operator": "hit", "program": "hit"}
        # the acceptance assertion: the repeat pays no warm-up
        assert _counter(metrics, "acg_compiles_total") == c1
        assert _counter(metrics, "acg_serve_cache_hits_total") >= hits0 + 2
        assert _true_rel(b2["x"], _b(8)) <= 1e-8
        for seed, body in ((7, b1), (8, b2)):
            js, jb = jd.submit(_doc(b_seed=seed))
            assert js == 200
            _same_answer(body, jb)
        assert b2["cache"] == jb["cache"]
        assert d.requests_served == 2
        doc, jdoc = d.status_doc(), jd.status_doc()
        assert set(doc) == set(jdoc) and doc["schema"] == serve.SCHEMA
        assert doc["serving"]
        assert doc["operator_cache"] == jdoc["operator_cache"]
        assert doc["program_cache"] == jdoc["program_cache"] == \
            {"entries": 1}


def test_program_cache_keyed_by_shape():
    bodies = []
    for pkg in (PORT, JAX):
        with _daemon(pkg) as d:
            d.submit(_doc(b_seed=1))
            s, body = d.submit(_doc(b_seed=1, algorithm="pipelined:2",
                                    coalesce=False))
            assert s == 200
            assert body["cache"] == {"operator": "hit", "program": "miss"}
            assert len(d.programs) == 2
            bodies.append(body)
    _same_answer(*bodies)


# -- coalescing: bitwise equal to single service --------------------------

def _coalesced(d, seeds):
    """Serve each seed singly, then the three queued behind a held
    worker so the drain merges them: (singles, coalesced answers)."""
    singles = {}
    for s in seeds:
        st, body = d.submit(_doc(b_seed=s, coalesce=False))
        assert st == 200 and body["coalesced"] == 1
        singles[s] = body
    results = {}
    with _held_worker(d) as entered:
        lead = threading.Thread(
            target=lambda: d.submit(_doc(fault="slow:0", b_seed=99)))
        lead.start()
        assert entered.wait(60.0)
        threads = [threading.Thread(
            target=lambda s=s: results.__setitem__(s, d.submit(
                _doc(b_seed=s)))) for s in seeds]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60.0
        while len(d.queue) < len(seeds) and time.monotonic() < deadline:
            time.sleep(0.01)
    for t in [lead] + threads:
        t.join(timeout=120.0)
    return singles, results


def test_coalesced_batch_bitwise_equals_single():
    seeds = [11, 22, 33]
    with _daemon(allow_faults=True, coalesce=4) as d:
        coal0 = _counter(metrics, "acg_serve_coalesced_total")
        singles, results = _coalesced(d, seeds)
        assert _counter(metrics, "acg_serve_coalesced_total") == \
            coal0 + len(seeds)
    with _daemon(JAX, allow_faults=True, coalesce=4) as jd:
        jsingles, jresults = _coalesced(jd, seeds)
    for s in seeds:
        st, body = results[s]
        assert st == 200 and body["ok"]
        assert body["coalesced"] == len(seeds)
        # the bitwise pin: same bits, same per-RHS iteration count
        assert body["x"] == singles[s]["x"]
        assert body["iterations"] == singles[s]["iterations"]
        assert jresults[s][1]["coalesced"] == len(seeds)
        _same_answer(body, jresults[s][1])
        _same_answer(singles[s], jsingles[s])


# -- admission control: queue, deadline, SLO ladder -----------------------

def _queue_full(pkg):
    with _daemon(pkg, allow_faults=True, queue_depth=1) as d:
        m = pkg[1]
        d.submit(_doc(b_seed=1))  # warm the caches
        shed0 = _counter(m, "acg_serve_shed_total")
        with _held_worker(d) as entered:
            lead = threading.Thread(
                target=lambda: d.submit(_doc(fault="slow:0", b_seed=2)))
            lead.start()
            assert entered.wait(60.0)  # the worker holds the lead
            filler = threading.Thread(
                target=lambda: d.submit(_doc(b_seed=3)))
            filler.start()
            deadline = time.monotonic() + 60.0
            while len(d.queue) < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            out = d.submit(_doc(b_seed=4))
        lead.join(timeout=60.0)
        filler.join(timeout=60.0)
        assert _counter(m, "acg_serve_shed_total") > shed0
    return out


def test_queue_full_sheds_typed_429():
    (status, body), (jstatus, jbody) = _queue_full(PORT), _queue_full(JAX)
    assert status == jstatus == 429
    assert body["error"]["type"] == jbody["error"]["type"] == \
        "shed-queue-full"
    assert body["error"]["retryable"] and jbody["error"]["retryable"]
    assert body["error"]["message"] == jbody["error"]["message"]


def _expired(pkg):
    with _daemon(pkg, allow_faults=True, queue_depth=4) as d:
        d.submit(_doc(b_seed=1))  # warm the caches
        out = {}
        with _held_worker(d) as entered:
            lead = threading.Thread(
                target=lambda: d.submit(_doc(fault="slow:0", b_seed=2)))
            lead.start()
            assert entered.wait(60.0)
            late = threading.Thread(target=lambda: out.setdefault(
                "r", d.submit(_doc(b_seed=3, timeout=0.2))))
            late.start()
            # held past its 0.2 s budget, whatever the host's load
            deadline = time.monotonic() + 60.0
            while (not len(d.queue) or not d.queue._dq[0].expired()) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        late.join(timeout=60.0)
        lead.join(timeout=60.0)
    return out["r"]


def test_expired_request_answers_typed_504():
    (status, body), (jstatus, jbody) = _expired(PORT), _expired(JAX)
    assert status == jstatus == 504
    assert body["error"]["type"] == jbody["error"]["type"] == \
        "deadline-expired"
    assert body["error"]["retryable"] and jbody["error"]["retryable"]


def _slo_ladder(pkg):
    obs = pkg[2]
    out = []
    with _daemon(pkg, degrade_burn=0.4, shed_burn=0.75) as d:
        d.submit(_doc(b_seed=1))
        obs.install_slo(obs.parse_slo("iters=1"))
        obs.slo_observe(iterations=100)  # breach
        obs.slo_observe(iterations=1)    # ok -> burn 0.5
        deg0 = _counter(pkg[1], "acg_serve_degraded_total")
        out.append(d.submit(_doc(b_seed=2, algorithm="pipelined:2",
                                 coalesce=False)))
        assert _counter(pkg[1], "acg_serve_degraded_total") == deg0 + 1
        obs.slo_observe(iterations=100)
        obs.slo_observe(iterations=100)
        out.append(d.submit(_doc(b_seed=3)))
    return out


def test_slo_burn_degrades_then_sheds():
    (s1, b1), (s2, b2) = _slo_ladder(PORT)
    (j1, jb1), (j2, jb2) = _slo_ladder(JAX)
    assert s1 == j1 == 200 and b1["degraded"] is jb1["degraded"] is True
    _same_answer(b1, jb1)
    assert _true_rel(b1["x"], _b(2)) <= 1e-8  # degraded, not wrong
    assert s2 == j2 == 503
    assert b2["error"]["type"] == jb2["error"]["type"] == "shed-slo-burn"
    assert b2["error"]["retryable"]


def test_stopped_daemon_sheds_typed():
    answers = []
    for srv, _, obs in (PORT, JAX):
        cfg = srv.ServeConfig(port=0, **({"device": "cpu"}
                                         if srv is serve else {}))
        d = srv.ServeDaemon(cfg)
        d.start()
        d.stop()
        answers.append(d.submit(_doc(b_seed=1)))
        obs._clear_slo()
    (status, body), (jstatus, jbody) = answers
    assert status == jstatus == 503
    assert body["error"] == jbody["error"]
    assert body["error"]["type"] == "shed-shutdown"


# -- request isolation ----------------------------------------------------

def test_fault_request_is_isolated_and_retried():
    bodies = []
    for pkg in (PORT, JAX):
        with _daemon(pkg, allow_faults=True, retries=1,
                     retry_backoff=0.01) as d:
            inval0 = _counter(pkg[1], "acg_serve_cache_invalidations_total")
            status, body = d.submit(_doc(b_seed=5, fault="dot:nan@2",
                                         coalesce=False))
            assert status == 200 and body["ok"]
            assert _true_rel(body["x"], _b(5)) <= 1e-8
            status, body2 = d.submit(_doc(b_seed=6))
            assert status == 200 and body2["ok"]
            assert _counter(pkg[1], "acg_serve_cache_invalidations_total") \
                >= inval0
            bodies.append((body, body2))
    _same_answer(bodies[0][1], bodies[1][1])


def test_unconverged_request_answers_typed_500():
    out = []
    for pkg in (PORT, JAX):
        with _daemon(pkg) as d:
            status, body = d.submit(_doc(b_seed=1, maxits=2))
            status2, body2 = d.submit(_doc(b_seed=1))
            out.append((status, body, status2, body2))
    (s, b, s2, b2), (js, jb, js2, jb2) = out
    assert s == js == 500 and not b["ok"]
    assert b["error"]["type"] == jb["error"]["type"] == "NotConvergedError"
    assert b["error"]["retryable"] and jb["error"]["retryable"]
    assert s2 == js2 == 200
    _same_answer(b2, jb2)


# -- self-healing: state sidecar + warm restore ---------------------------

def test_state_sidecar_and_warm_restore(tmp_path):
    for pkg in (PORT, JAX):
        state = str(tmp_path / f"serve-{pkg[0].__name__}.json")
        with _daemon(pkg, state_path=state) as d:
            st, _ = d.submit(_doc(b_seed=1))
            assert st == 200
        with open(state) as f:
            doc = json.load(f)
        assert doc["schema"] == serve.STATE_SCHEMA == jserve.STATE_SCHEMA
        assert doc["requests_served"] == 1
        assert doc["operators"] == [[MATRIX, "f64", 0]]
        warm0 = _counter(pkg[1], "acg_serve_warm_restores_total")
        with _daemon(pkg, state_path=state) as d2:
            assert d2.warm_restored == 1
            assert _counter(pkg[1], "acg_serve_warm_restores_total") == \
                warm0 + 1
            st, body = d2.submit(_doc(b_seed=2))
            assert st == 200
            assert body["cache"] == {"operator": "hit", "program": "miss"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_sidecar_restores_across_packages(tmp_path, writer):
    """A sidecar written by one package's daemon warm-restores the
    other's: the same schema, the same operator keys."""
    state = str(tmp_path / "serve.json")
    first, second = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    with _daemon(first, state_path=state) as d:
        st, body = d.submit(_doc(b_seed=3))
        assert st == 200
    with _daemon(second, state_path=state) as d2:
        assert d2.warm_restored == 1
        assert d2.operators.keys() == [(MATRIX, "f64", 0)]
        st, body2 = d2.submit(_doc(b_seed=3))
        assert st == 200 and body2["cache"]["operator"] == "hit"
    _same_answer(body, body2)


def test_unreadable_state_is_cold_start(tmp_path):
    for pkg in (PORT, JAX):
        state = str(tmp_path / f"serve-{pkg[0].__name__}.json")
        with open(state, "w") as f:
            f.write("{not json")
        with _daemon(pkg, state_path=state) as d:
            assert d.warm_restored == 0
            st, body = d.submit(_doc(b_seed=1))
            assert st == 200 and body["cache"]["operator"] == "miss"


def test_evicted_operator_releases_its_programs():
    """An operator-cache eviction drops the operator's device buffers and
    every program built on them (the reference's invalidation)."""
    with _daemon(operator_cache_size=1) as d:
        d.submit(_doc(b_seed=1))
        entry = d.operators.peek((MATRIX, "f64", 0))
        assert "A" in entry and len(d.programs) == 1
        s, body = d.submit(_doc(b_seed=1, matrix="gen:poisson2d:8"))
        assert s == 200 and body["cache"]["operator"] == "miss"
        assert entry == {}  # nothing of the evicted entry stays
        assert d.operators.keys() == [("gen:poisson2d:8", "f64", 0)]
        assert [k[0] for k in d.programs.keys()] == ["gen:poisson2d:8"]


def test_daemon_resolves_its_device_before_binding():
    """No card and no request for the CPU: the daemon refuses to be
    built, before any port is bound; asked for the CPU, it runs there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(AcgError, match="no CUDA device"):
        serve.ServeDaemon(serve.ServeConfig(port=0))
    d = serve.ServeDaemon(serve.ServeConfig(port=0, device="cpu"))
    assert d.device.type == "cpu" and d.port is None
    # a CPU daemon has no CUDA context to lose: an error is answered typed
    assert not d._context_lost(RuntimeError("CUDA error: launch failure"))


# -- the HTTP surface -----------------------------------------------------

def test_http_endpoints_end_to_end():
    import urllib.error
    import urllib.request

    with _daemon() as d:
        base = f"http://127.0.0.1:{d.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30.0) as resp:
                return resp.status, resp.read().decode()

        status, body = get("/healthz")
        assert status == 200 and json.loads(body)["ok"]
        status, body = get("/status")
        assert status == 200 and json.loads(body)["schema"] == serve.SCHEMA
        status, body = get("/metrics")
        assert status == 200 and "acg_serve_requests_total" in body
        status, body = get("/requests")
        reqdoc = json.loads(body)
        assert status == 200 and reqdoc["schema"] == "acg-serve-requests/1"
        assert reqdoc["inflight"] == [] and reqdoc["completed"] == []
        req = urllib.request.Request(
            base + "/solve",
            data=json.dumps(_doc(b_seed=9, return_x=False)).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120.0) as resp:
            out = json.loads(resp.read().decode())
        assert out["ok"] and out["converged"] and "x" not in out
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                base + "/solve", data=b"{not json"), timeout=30.0)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/nope")
        assert ei.value.code == 404
    with _daemon(JAX) as jd:
        jout = jd.submit(_doc(b_seed=9, return_x=False))[1]
    assert out["iterations"] == jout["iterations"]
    assert set(out) == set(jout)


# -- grow-on-recovery (the supervisor's other ratchet half) ---------------

def _regrow_story(mod, tmp_path):
    from acg_tpu.observatory import DEGRADED_ENV as jenv
    from acg_tpu_torch.observatory import DEGRADED_ENV as tenv
    assert jenv == tenv
    s = mod.DaemonSupervisor(
        [MATRIX, "--serve", "--nparts", "8"],
        state_path=str(tmp_path / "s.json"), nparts=8, grow_after=3,
        backoff=0.0)
    launches = []
    s._launch = lambda: launches.append(list(s.argv))
    s._relaunch(parts=4, reason="crash-injected", grow=False)
    after_shrink = (s.cur_parts, dict(s.report["degraded"]),
                    s.env[tenv])
    s._relaunch(parts=8, reason="regrow", grow=True)
    return (launches, after_shrink, s.cur_parts, s.report["regrows"],
            s.report["degraded"], tenv in s.env,
            len(s.report["relaunches"]))


def test_supervisor_regrow_relaunch_argv_surgery(tmp_path):
    metrics.arm()
    jmetrics.arm()
    re0 = _counter(metrics, "acg_recovery_regrows_total")
    got = _regrow_story(sup, tmp_path)
    assert got == _regrow_story(jsup, tmp_path)
    launches, shrink, parts, regrows, degraded, env_set, nrel = got
    assert shrink == (4, {"from": 8, "to": 4, "reason": "crash-injected"},
                      "8:4:crash-injected")
    assert launches[0][launches[0].index("--nparts") + 1] == "4"
    assert parts == 8 and regrows == 1 and degraded is None
    assert not env_set and nrel == 1
    assert "--resume-repartition" in launches[1]
    assert launches[1][launches[1].index("--nparts") + 1] == "8"
    assert _counter(metrics, "acg_recovery_regrows_total") == re0 + 1


def test_serve_chaos_schedule_deterministic_and_crashful():
    for seed in (1234, 99, 7):
        for nparts in (0, 4):
            a = [serve.serve_chaos_schedule(i, seed, nparts)
                 for i in range(40)]
            assert a == [jserve.serve_chaos_schedule(i, seed, nparts)
                         for i in range(40)]
            assert a[1] == {"fault": "crash"}
            for sched in a:
                f = sched.get("fault")
                assert f is None or f == "crash" or f.startswith(
                    ("slow:", "spmv:", "dot:", "halo:"))
            if nparts == 0:
                assert all(not (s.get("fault") or "").startswith("halo:")
                           for s in a)


# -- the CLI daemon, its supervisor and the live campaign (subprocess) ---

def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("ACG_TPU_FAULT_INJECT", serve.FAULTS_ENV)}
    env["PYTHONPATH"] = REPO
    return env


def _wait_port(proc, timeout=120.0) -> int:
    """The port a --serve child printed ("listening on port P")."""
    t0 = time.monotonic()
    lines = []
    while time.monotonic() - t0 < timeout:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        if "listening on port" in line:
            return int(line.split("listening on port ")[1].split()[0])
    raise AssertionError("the daemon never listened:\n" + "".join(lines))


def test_cli_daemon_serves_and_exits_on_sigterm(tmp_path):
    """``--serve --device cpu -vv``: requests through HTTP, an access log
    the reference's checker accepts, a service timeline, and SIGTERM ends
    it with rc 0, its "served" line and the process's launch line."""
    ledger, tl = str(tmp_path / "a.jsonl"), str(tmp_path / "tl.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "acg_tpu_torch", MATRIX, "--device", "cpu",
         "--serve", "--serve-port", "0", "--access-log", ledger,
         "--timeline", tl, "-vv"], cwd=REPO, env=_env(),
        stderr=subprocess.PIPE, text=True)
    try:
        port = _wait_port(proc)
        base = f"http://127.0.0.1:{port}"
        for seed in (1, 2):
            s, body = serve._http_json("POST", base + "/solve",
                                       _doc(b_seed=seed), timeout=120.0)
            assert s == 200 and body["ok"]
            assert _true_rel(body["x"], _b(seed)) <= 1e-8
        assert body["cache"] == {"operator": "hit", "program": "hit"}
        s, body = serve._http_json("POST", base + "/solve",
                                   _doc(b_seed=1, maxits=2), timeout=120.0)
        assert s == 500 and body["error"]["type"] == "NotConvergedError"
        proc.send_signal(signal.SIGTERM)
        err = proc.communicate(timeout=120.0)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "served 2 request(s), 1 failed -- bye" in err
    assert "kernel launches: {" in err
    res = subprocess.run(
        [sys.executable, "scripts/check_access_log.py", ledger,
         "--min-rows", "3", "--require-outcome", "ok",
         "--require-outcome", "request-failed"], cwd=REPO,
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    res = subprocess.run([sys.executable, "scripts/check_timeline.py", tl],
                         cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    with open(tl) as f:
        names = {e.get("args", {}).get("name") for e in
                 json.load(f)["traceEvents"] if e.get("ph") == "M"}
    assert "serve worker" in names and "request lane 0" in names


def test_supervised_daemon_shrinks_warm_restores_and_regrows(tmp_path):
    """``--serve --supervise --nparts 4 --shrink any --grow-after 2``: a
    crash request kills the daemon, the relaunch runs on 2 parts and
    warm-restores its operator, and after 2 requests served by the
    relaunched daemon it regrows to 4; every answer verifies on the
    host."""
    ck = str(tmp_path / "ck")
    proc = subprocess.Popen(
        [sys.executable, "-m", "acg_tpu_torch", MATRIX, "--device", "cpu",
         "--serve", "--serve-port", "0", "--supervise", "--nparts", "4",
         "--shrink", "any", "--grow-after", "2", "--serve-faults",
         "--relaunch-backoff", "0", "--ckpt", ck], cwd=REPO, env=_env(),
        stderr=subprocess.PIPE, text=True)
    try:
        port = _wait_port(proc)
        base = f"http://127.0.0.1:{port}"
        assert serve._wait_serving(base, 60.0)

        def nparts():
            return serve._http_json("GET", base + "/status")[1]["nparts"]

        assert nparts() == 4
        # a request before the crash: the relaunched daemon still regrows
        # after its own 2 (the sidecar's count is the writer's, by pid)
        s, body = serve._http_json("POST", base + "/solve", _doc(b_seed=2),
                                   timeout=120.0)
        assert s == 200 and _true_rel(body["x"], _b(2)) <= 1e-8
        with pytest.raises(OSError):
            serve._http_json("POST", base + "/solve",
                             _doc(fault="crash"), timeout=60.0)
        # the relaunch binds a new port: read it from the child's stderr
        port = _wait_port(proc)
        base = f"http://127.0.0.1:{port}"
        assert serve._wait_serving(base, 120.0)
        st = serve._http_json("GET", base + "/status")[1]
        assert st["nparts"] == 2 and st["warm_restored"] >= 1
        for seed in (3, 4):
            s, body = serve._http_json("POST", base + "/solve",
                                       _doc(b_seed=seed), timeout=120.0)
            assert s == 200 and _true_rel(body["x"], _b(seed)) <= 1e-8
        port = _wait_port(proc)   # the regrow relaunch
        base = f"http://127.0.0.1:{port}"
        assert serve._wait_serving(base, 120.0)
        assert nparts() == 4
        s, body = serve._http_json("POST", base + "/solve",
                                   _doc(b_seed=5), timeout=120.0)
        assert s == 200 and _true_rel(body["x"], _b(5)) <= 1e-8
        proc.send_signal(signal.SIGTERM)
        err = proc.communicate(timeout=120.0)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "relaunches: 1" in err and "regrows: 1" in err


@pytest.mark.slow
def test_crash_relaunch_warm_cache_live(tmp_path):
    """The live campaign (schedule 1 is a forced crash): the supervisor
    relaunches the daemon, the relaunch warm-restores, every response
    verifies; the reference's schedules."""
    r = subprocess.run(
        [sys.executable, "-m", "acg_tpu_torch", MATRIX, "--device", "cpu",
         "--serve", "--serve-faults", "--chaos", "77:2", "--ckpt",
         str(tmp_path / "ck"), "--relaunch-backoff", "0",
         "--max-iterations", "400", "--residual-rtol", "1e-8", "--quiet",
         "--history", str(tmp_path / "history")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warm-restored" in r.stderr
    rows = [e["doc"] for e in observatory.history_scan(tmp_path / "history")
            if e["doc"].get("schema") == "acg-tpu-chaos-serve/1"]
    assert len(rows) == 2
    assert [row["chaos"]["fault"] for row in rows] == \
        [jserve.serve_chaos_schedule(i, 77, 0).get("fault")
         for i in range(2)]
    verdicts = {row["chaos"]["verdict"] for row in rows}
    assert "crash-relaunched" in verdicts
    assert not verdicts & {"WRONG-ANSWER", "HANG"}


# -- decision observatory (--serve --autotune) ----------------------------

def _serve_cal(cb, **over):
    doc = {"schema": cb.COMMBENCH_SCHEMA, "backend": "cpu", "nparts": 8,
           "collectives": {
               "all_reduce": {"alpha_s": 1e-5, "beta_s_per_byte": 1e-10,
                              "npoints": 3, "r2": None},
               "all_to_all": {"alpha_s": 2e-5, "beta_s_per_byte": 1e-9,
                              "npoints": 3, "r2": None}}}
    doc.update(over)
    doc["calibration_id"] = cb.calibration_id(doc)
    return doc


def test_serve_autotune_plans_and_stamps_provenance(tmp_path, monkeypatch):
    """--serve --autotune: the daemon plans on an operator-cache miss,
    stamps each response with the plan id and provenance, shows the
    cached decisions under /status plans:, and replans when the
    calibration id changes -- the reference's sources, request by
    request."""
    from acg_tpu import commbench as jcb
    from acg_tpu_torch import commbench as cb

    monkeypatch.setenv("ACG_TPU_PROBE_CACHE", str(tmp_path / "probe.json"))
    cal = _serve_cal(cb)
    assert cal["calibration_id"] == _serve_cal(jcb)["calibration_id"]
    with _daemon(autotune=True, calibration=cal) as d:
        s1, b1 = d.submit(_doc(b_seed=1))
        assert s1 == 200 and b1["ok"]
        assert b1["plan"]["source"] == "planned", b1["plan"]
        assert str(b1["plan"]["id"]).startswith("plan-"), b1["plan"]
        plans = d.status_doc()["plans"]
        assert plans["autotune"] is True
        assert plans["calibration"] == cal["calibration_id"]
        assert plans["decisions"][0]["plan_id"] == b1["plan"]["id"]
        assert plans["last_misprediction_ratio"] > 0
        s2, b2 = d.submit(_doc(b_seed=2, algorithm="classic"))
        assert s2 == 200 and b2["plan"]["source"] == "flag-forced"
        cal2 = _serve_cal(cb, nparts=8, backend="cpu", note="recalibrated")
        assert cal2["calibration_id"] != cal["calibration_id"]
        d.set_calibration(cal2)
        s3, b3 = d.submit(_doc(b_seed=3))
        assert s3 == 200 and b3["plan"]["source"] == "planned"
        doc2 = d.status_doc()
        assert doc2["plans"]["calibration"] == cal2["calibration_id"]
        assert all(dec["calibration"] == cal2["calibration_id"]
                   for dec in doc2["plans"]["decisions"])
        assert set(doc2["plans"]) == {"autotune", "calibration",
                                      "decisions",
                                      "last_misprediction_ratio"}
    _, jb = None, None
    with _daemon(JAX, autotune=True, calibration=_serve_cal(jcb)) as jd:
        _, jb = jd.submit(_doc(b_seed=1))
    assert jb["plan"]["source"] == b1["plan"]["source"]
    assert b1["converged"] and jb["converged"]


def test_serve_without_autotune_has_no_plan_section():
    for pkg in (PORT, JAX):
        with _daemon(pkg) as d:
            s, b = d.submit(_doc(b_seed=4))
            assert s == 200 and b["ok"]
            assert b["plan"] == {"id": None, "source": "flag-forced"}
            assert d.status_doc()["plans"]["autotune"] is False
            assert d.status_doc()["plans"]["decisions"] == []


# -- the request observatory ----------------------------------------------

def _identity_story(pkg, ledger):
    with _daemon(pkg, access_log=ledger) as d:
        out = [d.submit(_doc(b_seed=1, request_id="client-1")),
               d.submit(_doc(b_seed=2, traceparent=TRACEPARENT)),
               d.submit(_doc(b_seed=3)),
               d.submit(_doc(maxits=0, request_id="bad-1"))]
        return out, d.status_doc()["requests"], pkg[1].expose()


def test_request_identity_echo_and_access_ledger(tmp_path):
    ledger = str(tmp_path / "access.jsonl")
    out, reqs, expo = _identity_story(PORT, ledger)
    jout, jreqs, _ = _identity_story(JAX, str(tmp_path / "j.jsonl"))
    (s1, b1), (s2, b2), (s3, b3), (s4, b4) = out
    assert b1["request_id"] == "client-1"
    assert b2["request_id"] == "4bf92f3577b34da6a3ce929d0e0e4736"
    assert b3["request_id"].startswith("req-")
    assert s4 == 400 and b4["request_id"] == "bad-1"
    assert b4["error"]["type"] == "invalid-request"
    for (s, b), (js, jb) in zip(out, jout):
        assert s == js and set(b) == set(jb)
        if s == 200:
            _same_answer(b, jb)
        else:
            assert b["error"] == jb["error"]
    assert set(b1) == {"ok", "schema", "id", "request_id", "converged",
                       "iterations", "latency_seconds", "cache",
                       "coalesced", "degraded", "plan", "x"}
    assert 'acg_serve_stage_seconds_bucket{stage="solve"' in expo
    assert "acg_serve_inflight" in expo
    assert reqs["completed"] == jreqs["completed"] == 4
    assert reqs["outcomes"] == jreqs["outcomes"] == \
        {"ok": 3, "invalid-request": 1}
    assert reqs["access_log"] == ledger
    with open(ledger) as f:
        rows = [json.loads(line) for line in f]
    assert [r["request_id"] for r in rows] == \
        ["client-1", "4bf92f3577b34da6a3ce929d0e0e4736", b3["request_id"],
         "bad-1"]
    for r in rows[:3]:
        assert r["outcome"] == "ok"
        assert sum(r["stages"].values()) <= r["wall_seconds"] + 5e-3
        for stage in ("admit", "queue-wait", "cache", "solve", "demux",
                      "respond"):
            assert stage in r["stages"], (r["request_id"], stage)
    assert rows[3]["outcome"] == "invalid-request"
    # the miss bills its warm-up to compile; a hit ran none (where the
    # reference bills the first request's again)
    assert rows[0]["stages"]["compile"] > 0
    assert "compile" not in rows[1]["stages"]
    res = subprocess.run(
        [sys.executable, "scripts/check_access_log.py", ledger,
         "--min-rows", "4", "--require-outcome", "ok",
         "--require-outcome", "invalid-request"],
        capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr


def test_concurrent_coalesced_requests_trace_one_solve(tmp_path):
    """Parallel requests coalescing into one batch: /requests never tears
    under fire, each member lands its own ledger row, the rows share one
    batch block whose per-RHS attribution sums back to the batch solve
    time, and the armed timeline carries one worker solve-batch span
    linked to every member id."""
    from acg_tpu_torch import tracing

    ledger = str(tmp_path / "access.jsonl")
    seeds = [11, 22, 33]
    ids = {s: f"member-{s}" for s in seeds}
    results = {}
    try:
        tracing.arm()
        with _daemon(allow_faults=True, coalesce=4, access_log=ledger) as d:
            d.submit(_doc(b_seed=1))
            with _held_worker(d) as entered:
                threads = [threading.Thread(target=lambda: d.submit(
                    _doc(fault="slow:0", b_seed=99,
                         request_id="slow-lead")))]
                threads[0].start()
                assert entered.wait(60.0)
                for s in seeds:
                    t = threading.Thread(
                        target=lambda s=s: results.__setitem__(s, d.submit(
                            _doc(b_seed=s, request_id=ids[s]))))
                    threads.append(t)
                    t.start()
                deadline = time.monotonic() + 60.0
                while len(d.queue) < len(seeds) \
                        and time.monotonic() < deadline:
                    snap = d.reqlog.snapshot()
                    assert snap["schema"] == "acg-serve-requests/1"
                    for doc in snap["inflight"] + snap["completed"]:
                        assert doc["request_id"]
                        assert isinstance(doc["stages"], dict)
                    time.sleep(0.01)
            for t in threads:
                t.join(timeout=120.0)
            for s in seeds:
                st, body = results[s]
                assert st == 200 and body["coalesced"] == len(seeds)
                assert body["request_id"] == ids[s]
        spans = tracing.local_payload()["spans"]
    finally:
        tracing.disarm()
    with open(ledger) as f:
        rows = {r["request_id"]: r for r in map(json.loads, f)
                if r["request_id"] in ids.values()}
    assert set(rows) == set(ids.values())
    assert len({r["batch"]["id"] for r in rows.values()}) == 1
    blk = next(iter(rows.values()))["batch"]
    assert blk["width"] == len(seeds)
    assert sorted(blk["members"]) == sorted(ids.values())
    assert abs(blk["rhs_solve_seconds"] * blk["width"]
               - blk["solve_seconds"]) <= 1e-3
    for r in rows.values():
        assert r["batch"] == blk
        assert r["stages"]["queue-wait"] > 0
        assert abs(r["stages"]["solve"] - blk["rhs_solve_seconds"]) <= 1e-3
    worker = [s for s in spans if s["cat"] == "worker"
              and s["name"].startswith("solve-batch")
              and set((s.get("args") or {}).get("requests", []))
              >= set(ids.values())]
    assert len(worker) == 1
    for rid in ids.values():
        mine = [s for s in spans if s["cat"] == "request"
                and (s.get("args") or {}).get("request") == rid]
        assert {s["name"] for s in mine} >= {"queue-wait", "solve", "demux"}


@pytest.mark.parametrize("nparts", [0, 4])
def test_access_log_leaves_bits_and_launches_unchanged(tmp_path, nparts):
    """The twin of the reference's byte-identity pin for the request
    layer: the same requests with --access-log armed and off give the
    same bits and the same kernel launches."""
    from acg_tpu_torch.ops import kernels as K

    runs = []
    for ledger in (None, str(tmp_path / "a.jsonl")):
        with _daemon(nparts=nparts, access_log=ledger) as d:
            K.reset_launches()
            bodies = [d.submit(_doc(b_seed=s, maxits=400))[1]
                      for s in (1, 2)]
            runs.append(([b["x"] for b in bodies],
                         [b["iterations"] for b in bodies],
                         dict(K.launches)))
    assert runs[0] == runs[1]
