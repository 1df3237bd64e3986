"""Long-lived solver service (``--serve``): the counterpart of
``acg_tpu/serve.py``.

Every other tier is a batch program: each CLI invocation pays ingest,
partition and the first solve's warm-up before the first timed
iteration.  This module keeps one process on the card for its lifetime:

* **daemon**: one process owns the device and answers ``POST /solve``
  over a stdlib HTTP endpoint on localhost (ThreadingHTTPServer, zero
  dependencies).  ``GET /status`` serves the observatory status document
  and ``GET /metrics`` the Prometheus exposition on the same port.  The
  device is resolved once, when the daemon is built: the CUDA card
  unless the caller asks for the CPU, and with no card the daemon
  raises before it binds a port.  The worker thread runs on that device.

* **caches**: an *operator cache* (generator spec x dtype x parts ->
  the matrix on the device, or the stacked
  :class:`~acg_tpu_torch.parallel.dist.DistributedProblem`) and a
  *program cache* (a constructed solver, keyed by the recurrence x
  precond x nrhs product).  A cache-miss solve runs with ``warmup=1``
  so its warm-up is absorbed and counted (``acg_compiles_total``); a
  cache-hit solve runs ``warmup=0``, so a repeated request pays no
  ingest and moves no compile counter.  Evicting an operator drops it
  and every program built on it, so their device buffers go with it.

* **admission control**: a bounded queue sheds with a typed 429; the
  SLO error-budget burn drives degrade-before-refuse (past
  ``degrade_burn`` requests are served on the classic unpreconditioned
  profile and marked ``degraded``; past ``shed_burn`` they are refused);
  an expired request is answered with a typed 504, never a hang.

* **request isolation**: a breakdown rides the solver's own
  :class:`~acg_tpu_torch.solvers.resilience.RecoveryDriver` ladder
  first; what escapes is answered with a typed error, retried within a
  bounded budget on a freshly built program on the same device, and the
  possibly poisoned program-cache entry is invalidated.  Nothing is
  retried on a kernel's plain version or on the CPU.  A CUDA error that
  leaves the card's context unusable ends the daemon with
  :data:`~acg_tpu_torch.errors.ExitCode.BACKEND_UNAVAILABLE`, which the
  supervisor relaunches: the daemon never answers on a dead context.

* **coalescing**: compatible queued requests (same operator, classic
  recurrence, unpreconditioned, same tolerances) merge into one
  batched solve and demux per request, bitwise equal to serving each
  singly: the single-RHS program is plain PyTorch (``kernels="xla"``)
  and the batch takes each column's dots as that program does
  (``column_dots="single"``).

* **self-healing**: the daemon persists its operator-cache key set (a
  small JSON sidecar beside ``--ckpt``) after every request; the
  supervisor (:mod:`acg_tpu_torch.supervisor`) relaunches a crashed
  daemon, which warm-restores the operator cache from that state before
  accepting traffic.  ``--chaos SEED[:N] --serve`` runs the campaign
  against the live daemon, every green answer verified on the host
  (exit 96 on any wrong-answer-green).

Each request's ``b`` is ``np.random.default_rng(b_seed)``'s normals, as
the reference draws them, so both packages solve the same system.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from acg_tpu_torch import reqtrace
from acg_tpu_torch.errors import (AcgError, BreakdownError, ExitCode,
                                  NotConvergedError)

SCHEMA = "acg-serve/1"
STATE_SCHEMA = "acg-serve-state/1"
# per-request fault specs are only honoured when the daemon was armed
# for them (the chaos campaign's hook) -- a production daemon must not
# be crashable by a request body
FAULTS_ENV = "ACG_TPU_SERVE_FAULTS"
# how long the coalescer waits for compatible followers after the
# first request of a batch is popped
COALESCE_WINDOW_SECS = 0.05


# -- configuration ---------------------------------------------------------

class ServeConfig:
    """Daemon knobs (CLI ``--serve-*`` flags; all defaulted so tests
    can construct one directly).  ``device`` is where the daemon solves:
    the CUDA card unless the caller asks for ``"cpu"``."""

    def __init__(self, *, port: int = 0, queue_depth: int = 16,
                 coalesce: int = 8, default_timeout: float = 60.0,
                 degrade_burn: float = 0.5, shed_burn: float = 0.9,
                 operator_cache_size: int = 4,
                 program_cache_size: int = 16, retries: int = 1,
                 retry_backoff: float = 0.05,
                 state_path: str | None = None,
                 preload: str | None = None, nparts: int = 0,
                 comm: str = "xla", dtype: str = "f64",
                 allow_faults: bool = False, autotune: bool = False,
                 calibration: dict | None = None,
                 access_log: str | None = None,
                 request_ring: int = 64, device: str | None = None):
        self.port = int(port)
        self.queue_depth = int(queue_depth)
        self.coalesce = int(coalesce)
        self.default_timeout = float(default_timeout)
        self.degrade_burn = float(degrade_burn)
        self.shed_burn = float(shed_burn)
        self.operator_cache_size = int(operator_cache_size)
        self.program_cache_size = int(program_cache_size)
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        self.state_path = state_path
        self.preload = preload
        self.nparts = int(nparts)
        self.comm = comm
        self.dtype = dtype
        self.allow_faults = bool(allow_faults) \
            or os.environ.get(FAULTS_ENV) == "1"
        # decision observatory (--serve --autotune): plan on operator-
        # cache miss against this calibration, replan when it changes
        self.autotune = bool(autotune)
        self.calibration = calibration
        # request observatory (--access-log): the append-only
        # acg-tpu-access/1 ledger path, and the size of the completed-
        # request ring GET /requests serves
        self.access_log = access_log
        self.request_ring = int(request_ring)
        self.device = device


class RequestRefused(Exception):
    """A typed admission/validation refusal: ``kind`` is the machine-
    readable error type, ``status`` the HTTP code it rides."""

    def __init__(self, kind: str, message: str, status: int = 400):
        super().__init__(message)
        self.kind = kind
        self.status = int(status)


class _Request:
    _next_id = [0]
    _id_lock = threading.Lock()
    # request observatory: the stable client-facing identity and the
    # RequestRecord tracking it -- attached by submit() right after
    # construction (class defaults keep direct constructions safe)
    request_id: str | None = None
    trace: "reqtrace.RequestRecord | None" = None

    def __init__(self, doc: dict, cfg: ServeConfig):
        with self._id_lock:
            self._next_id[0] += 1
            self.id = self._next_id[0]
        self.matrix = doc.get("matrix") or cfg.preload
        if not self.matrix:
            raise RequestRefused(
                "invalid-request", "no 'matrix' in the request and the "
                "daemon was started without a preload operator")
        if not str(self.matrix).startswith("gen:"):
            raise RequestRefused(
                "invalid-request",
                f"the service ingests generator specs (gen:...); got "
                f"{self.matrix!r}")
        self.dtype = str(doc.get("dtype", cfg.dtype))
        if self.dtype not in ("f32", "f64"):
            raise RequestRefused("invalid-request",
                                 f"dtype must be f32|f64, got "
                                 f"{self.dtype!r}")
        self.algorithm = doc.get("algorithm")
        if self.algorithm is not None:
            from acg_tpu_torch.recurrence import parse_algorithm
            try:
                parse_algorithm(str(self.algorithm))
            except ValueError as e:
                raise RequestRefused("invalid-request", str(e))
        self.precond = doc.get("precond")
        try:
            self.rtol = float(doc.get("rtol", 1e-8))
            self.atol = float(doc.get("atol", 0.0))
            self.maxits = int(doc.get("maxits", 500))
            self.timeout = float(doc.get("timeout",
                                         cfg.default_timeout))
        except (TypeError, ValueError) as e:
            raise RequestRefused("invalid-request",
                                 f"bad numeric field: {e}")
        if self.maxits < 1 or self.timeout <= 0:
            raise RequestRefused("invalid-request",
                                 "maxits must be >= 1 and timeout > 0")
        self.b = doc.get("b")
        self.b_seed = doc.get("b_seed")
        if self.b is not None:
            try:
                self.b = np.asarray(self.b, dtype=np.float64).reshape(-1)
            except (TypeError, ValueError) as e:
                raise RequestRefused("invalid-request", f"bad 'b': {e}")
        self.coalesce = bool(doc.get("coalesce", True))
        self.fault = doc.get("fault")
        if self.fault is not None and not cfg.allow_faults:
            raise RequestRefused(
                "faults-disabled",
                "per-request fault injection is only honoured when the "
                "daemon was started with --serve-faults (the chaos "
                "campaign's hook)", status=403)
        self.want_x = bool(doc.get("return_x", True))
        self.enqueued = time.monotonic()
        self.deadline = self.enqueued + self.timeout
        self.event = threading.Event()
        self.status: int | None = None
        self.response: dict | None = None

    def expired(self) -> bool:
        return time.monotonic() > self.deadline

    def operator_key(self, cfg: ServeConfig) -> tuple:
        return (str(self.matrix), self.dtype, int(cfg.nparts))

    def program_key(self, cfg: ServeConfig, nrhs: int) -> tuple:
        return self.operator_key(cfg) + (
            str(self.algorithm or "classic"),
            str(self.precond or "none"), int(nrhs))

    def coalesce_key(self, cfg: ServeConfig):
        """Requests sharing this key may merge into one batched solve
        and stay BITWISE equal to single service: the batched-classic
        recurrence, its dots taken per column as the single-RHS
        program takes them, is column-wise identical only to the
        classic, unpreconditioned single-RHS program
        (tests/test_torch_serve.py), and the shared scalar tolerances
        must match."""
        if (not self.coalesce or self.fault is not None
                or self.precond is not None
                or self.algorithm not in (None, "classic")):
            return None
        return (str(self.matrix), self.dtype, self.rtol, self.atol,
                self.maxits)

    def finish(self, status: int, body: dict) -> None:
        self.status = int(status)
        self.response = body
        # the respond stage starts here: the submit waiter measures
        # its wakeup against this stamp
        self._finished_at = time.monotonic()
        self.event.set()


def _error_body(kind: str, message: str, req: "_Request | None" = None,
                retryable: bool = False,
                request_id: str | None = None) -> dict:
    body = {"schema": SCHEMA, "ok": False,
            "error": {"type": kind, "message": message,
                      "retryable": bool(retryable)}}
    if req is not None:
        body["id"] = req.id
    rid = (getattr(req, "request_id", None) if req is not None
           else None) or request_id
    if rid:
        body["request_id"] = rid
    return body


# -- bounded request queue -------------------------------------------------

class _Queue:
    """Bounded FIFO with coalesce-aware draining (a plain queue.Queue
    cannot pull compatible followers without popping strangers)."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()

    def __len__(self):
        with self._cv:
            return len(self._dq)

    def put(self, req: _Request) -> bool:
        from acg_tpu_torch import metrics
        with self._cv:
            if len(self._dq) >= self.depth:
                return False
            self._dq.append(req)
            metrics.record_serve_queue_depth(len(self._dq))
            self._cv.notify()
            return True

    def pop(self, timeout: float):
        from acg_tpu_torch import metrics
        with self._cv:
            if not self._dq:
                self._cv.wait(timeout)
            if not self._dq:
                return None
            req = self._dq.popleft()
            metrics.record_serve_queue_depth(len(self._dq))
            return req

    def drain_compatible(self, key, limit: int) -> list:
        """Remove (in order) up to ``limit`` queued requests whose
        coalesce key equals ``key``."""
        from acg_tpu_torch import metrics
        out = []
        if key is None or limit <= 0:
            return out
        with self._cv:
            keep = collections.deque()
            for r in self._dq:
                if len(out) < limit and r._ckey == key:
                    out.append(r)
                else:
                    keep.append(r)
            self._dq = keep
            metrics.record_serve_queue_depth(len(self._dq))
        return out

    def drain_all(self) -> list:
        with self._cv:
            out = list(self._dq)
            self._dq.clear()
        return out


# -- LRU caches ------------------------------------------------------------

class _LruCache:
    def __init__(self, name: str, size: int):
        self.name = name
        self.size = max(int(size), 1)
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        from acg_tpu_torch import metrics
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                metrics.record_serve_cache("hit", self.name)
                return self._d[key]
        metrics.record_serve_cache("miss", self.name)
        return None

    def put(self, key, value) -> list:
        """Insert; returns the evicted ``(key, value)`` pairs."""
        from acg_tpu_torch import metrics
        evicted = []
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.size:
                evicted.append(self._d.popitem(last=False))
                metrics.record_serve_cache("evict", self.name)
        return evicted

    def peek(self, key):
        """Side-effect-free read: no LRU bump, no hit/miss counting
        (the /status path must observe the cache, not perturb it)."""
        with self._lock:
            return self._d.get(key)

    def invalidate(self, key) -> bool:
        from acg_tpu_torch import metrics
        with self._lock:
            hit = self._d.pop(key, None) is not None
        if hit:
            metrics.record_serve_cache("invalidate", self.name)
        return hit

    def invalidate_where(self, pred) -> int:
        from acg_tpu_torch import metrics
        n = 0
        with self._lock:
            for k in [k for k in self._d if pred(k)]:
                del self._d[k]
                n += 1
        for _ in range(n):
            metrics.record_serve_cache("invalidate", self.name)
        return n

    def keys(self) -> list:
        with self._lock:
            return list(self._d.keys())

    def __len__(self):
        with self._lock:
            return len(self._d)


# -- the daemon ------------------------------------------------------------

class ServeDaemon:
    """The long-lived solver service.  Construct, :meth:`start` (binds
    the port, launches the worker), submit requests over HTTP or
    in-process via :meth:`submit`, :meth:`stop` to wind down."""

    def __init__(self, config: ServeConfig):
        from acg_tpu_torch._device import resolve_device
        self.cfg = config
        # the one device of the daemon's life, resolved before anything
        # binds a port: no card and no request for the CPU raises here
        self.device = resolve_device(config.device)
        self.queue = _Queue(config.queue_depth)
        self.operators = _LruCache("operator",
                                   config.operator_cache_size)
        self.programs = _LruCache("program", config.program_cache_size)
        self.requests_served = 0
        self.requests_failed = 0
        self.warm_restored = 0
        self.started_at = time.time()
        self.accepting = False
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        self._server = None
        self.port: int | None = None
        self._state_lock = threading.Lock()
        # decision observatory: the last planned solve's predicted /
        # measured ratio (surfaced in /status)
        self.last_misprediction: float | None = None
        # request observatory: per-request records, the completed ring
        # (GET /requests) and the acg-tpu-access/1 ledger
        self.reqlog = reqtrace.RequestLog(config.access_log,
                                          ring=config.request_ring)
        # batch ids link coalesced members to their shared solve span
        # (single worker thread owns the counter)
        self._batch_seq = 0

    # -- state persistence (the self-healing warm restore) ----------------

    def _save_state(self) -> None:
        path = self.cfg.state_path
        if not path:
            return
        doc = {"schema": STATE_SCHEMA,
               "operators": [list(k) for k in self.operators.keys()],
               "requests_served": int(self.requests_served),
               "port": self.port, "pid": os.getpid(),
               "unix_time": time.time()}
        tmp = (f"{path}.tmp.{os.getpid()}"
               f".{threading.get_ident()}")
        try:
            # serialized: the worker (batch end) and the main thread
            # (start/stop) both persist -- concurrent writers would
            # steal each other's tmp file out from under os.replace
            with self._state_lock:
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                    f.write("\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: serve: state write failed: "
                             f"{e}\n")

    def _warm_restore(self) -> None:
        """Re-ingest the operator-cache keys the previous incarnation
        served -- the relaunch pays the ingest ONCE at boot instead of
        on the first unlucky request after every crash."""
        from acg_tpu_torch import metrics, observatory
        path = self.cfg.state_path
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            keys = [tuple(k) for k in doc.get("operators", [])]
        except (OSError, ValueError, TypeError) as e:
            sys.stderr.write(f"acg-tpu-torch: serve: unreadable state "
                             f"{path}: {e} (cold start)\n")
            return
        n = 0
        for key in keys:
            try:
                matrix, dtype = str(key[0]), str(key[1])
                self._ingest_operator((matrix, dtype,
                                       int(self.cfg.nparts)))
                n += 1
            except Exception as e:  # noqa: BLE001 -- a stale key must
                sys.stderr.write(   # not kill the restore
                    f"acg-tpu-torch: serve: warm restore of {key} failed: "
                    f"{e}\n")
        if n:
            self.warm_restored = n
            metrics.record_serve_warm_restore(n)
            observatory.note_event(
                "serve-warm-restore",
                f"re-ingested {n} operator(s) from {path}")
            sys.stderr.write(f"acg-tpu-torch: serve: warm-restored {n} "
                             f"operator(s) from {path}\n")

    # -- operator / program construction -----------------------------------

    @staticmethod
    def _torch_dtype(dtype: str):
        return torch.float64 if dtype == "f64" else torch.float32

    def _ingest_operator(self, key: tuple) -> tuple:
        """Build (and cache) the ingested operator for ``key`` =
        (matrix, dtype, nparts); returns ``(entry, was_hit)``.
        Counts hit/miss on the operator cache."""
        entry = self.operators.get(key)
        if entry is not None:
            return entry, True
        matrix, dtype, nparts = key
        from acg_tpu_torch.cli import synthesize_host_matrix
        t0 = time.perf_counter()
        sym = synthesize_host_matrix(matrix)
        csr = sym.to_csr()
        dt = self._torch_dtype(dtype)
        entry = {"csr": csr, "dtype": dtype, "n": int(csr.shape[0])}
        if int(nparts) > 1:
            # the stacked parts live on the host until a solver takes
            # them to the daemon's device
            from acg_tpu_torch.parallel.dist import DistributedProblem
            from acg_tpu_torch.partition import partition_rows
            part = partition_rows(csr, int(nparts), seed=0,
                                  method="band")
            entry["prob"] = DistributedProblem.build(
                csr, part, int(nparts), dtype=dt)
        else:
            from acg_tpu_torch.ops.spmv import device_matrix_from_csr
            entry["A"] = device_matrix_from_csr(csr, dtype=dt,
                                                device=self.device)
        entry["ingest_seconds"] = time.perf_counter() - t0
        if self.cfg.autotune:
            # decision observatory: plan on operator-cache miss -- the
            # decision is cached alongside the operator (and the
            # programs it selects), replanned when the
            # calibration id changes (_solve_batch)
            entry["plan"] = self._plan_operator(key, entry)
        evicted = self.operators.put(key, entry)
        for (ekey, val) in evicted:
            # dependent programs hold the evicted operator's device
            # buffers alive -- drop them with it, and the entry's own
            self.programs.invalidate_where(lambda k: k[:3] == ekey)
            val.clear()
        if evicted and self.device.type == "cuda":
            torch.cuda.empty_cache()
        return entry, False

    def _calibration_id(self) -> str:
        from acg_tpu_torch.commbench import UNCALIBRATED, calibration_id
        cal = self.cfg.calibration
        if not isinstance(cal, dict):
            return UNCALIBRATED
        return cal.get("calibration_id") or calibration_id(cal)

    def set_calibration(self, cal: dict | None) -> None:
        """Swap the live calibration document.  Cached decisions keep
        their recorded calibration id, so the next planned request for
        each operator notices the mismatch and replans."""
        self.cfg.calibration = cal

    def _plan_operator(self, key: tuple, entry: dict) -> dict | None:
        """One planning pass for a freshly ingested operator: rank the
        candidate space the daemon can actually dispatch (its fixed
        kernels/transport; the recurrence is the free axis) and return
        the decision.  Planning failing is never fatal -- the request
        falls back to the flag-selected program."""
        from acg_tpu_torch import observatory, planner
        matrix, dtype, nparts = key
        try:
            itemsize = 8 if dtype == "f64" else 4
            kappa, src = planner.kappa_estimate(entry["csr"], 1e-8, 500)
            k = planner._probe_constants(self.device)
            doc = planner.build_plan(
                entry["csr"], matrix_id=str(matrix),
                nparts=max(int(nparts), 1), dtype_name=str(dtype),
                rtol=1e-8, maxits=500, mat_itemsize=itemsize,
                vec_itemsize=itemsize, cal=self.cfg.calibration,
                kappa=kappa, kappa_source=src, bw_gbs=k["bw_gbs"],
                dispatch_s=k["flag_s"], backend=self.device.type,
                kernels=("auto",), comms=(self.cfg.comm,))
            if not doc["ranked"]:
                return None
            top = doc["ranked"][0]
            decision = {
                "plan_id": doc["plan_id"],
                "calibration": doc["calibration"],
                "selected": top["label"],
                "algorithm": top["algorithm"],
                "predicted_s_per_solve": top["predicted_s_per_solve"],
                "predicted_iterations": top["predicted_iterations"],
            }
            observatory.note_event(
                "serve-planned",
                f"operator {matrix}: {top['label']} (plan "
                f"{doc['plan_id']}, calibration {doc['calibration']})")
            return decision
        except Exception as e:  # noqa: BLE001 -- planning is advisory
            sys.stderr.write(f"acg-tpu-torch: serve: planning {matrix} "
                             f"failed: {type(e).__name__}: {e}\n")
            return None

    def _build_solver(self, req: _Request, op: dict, nrhs: int):
        from acg_tpu_torch.solvers.resilience import RecoveryPolicy
        pol = RecoveryPolicy(max_restarts=2,
                             backoff=self.cfg.retry_backoff)
        algorithm = req.algorithm
        dev = self.device
        if "prob" in op:
            if nrhs > 1:
                from acg_tpu_torch.parallel.dist_batched import \
                    BatchedDistCGSolver
                return BatchedDistCGSolver(op["prob"], device=dev)
            # kernels "auto": batched K1, K6 under dma, the per-part dot,
            # K5 for a pipelined request
            from acg_tpu_torch.parallel.dist import DistCGSolver
            return DistCGSolver(op["prob"], comm=self.cfg.comm,
                                precond=req.precond, recovery=pol,
                                algorithm=algorithm, device=dev)
        if nrhs > 1:
            from acg_tpu_torch.solvers.batched import BatchedCGSolver
            return BatchedCGSolver(op["A"], mode="batched", device=dev,
                                   column_dots="single")
        from acg_tpu_torch.solvers.cg import TorchCGSolver
        # kernels="xla" keeps the single-RHS program column-identical
        # to the batched tier's (the coalescing bitwise guarantee)
        return TorchCGSolver(op["A"], kernels="xla",
                             precond=req.precond, recovery=pol,
                             host_matrix=op["csr"],
                             algorithm=algorithm, device=dev)

    def _program_for(self, req: _Request, op: dict, nrhs: int):
        """(solver, was_hit) for this request shape."""
        key = req.program_key(self.cfg, nrhs)
        solver = self.programs.get(key)
        if solver is not None:
            return solver, True
        solver = self._build_solver(req, op, nrhs)
        self.programs.put(key, solver)
        return solver, False

    # -- admission ---------------------------------------------------------

    def _burn(self) -> float:
        from acg_tpu_torch import observatory
        rep = observatory.slo_report()
        burns = list((rep.get("burn") or {}).values())
        return max(burns) if burns else 0.0

    def admit(self, req: _Request) -> None:
        """Admission control; raises :class:`RequestRefused` with the
        typed shed reason instead of queueing."""
        from acg_tpu_torch import metrics
        if not self.accepting:
            metrics.record_serve_shed("shutdown")
            raise RequestRefused(
                "shed-shutdown", "the service is shutting down",
                status=503)
        burn = self._burn()
        req._admit_burn = burn
        if burn >= self.cfg.shed_burn:
            metrics.record_serve_shed("slo-burn")
            raise RequestRefused(
                "shed-slo-burn",
                f"SLO error-budget burn {burn:.2f} is past the shed "
                f"threshold {self.cfg.shed_burn:.2f}; retry later",
                status=503)
        req._ckey = req.coalesce_key(self.cfg)
        if not self.queue.put(req):
            metrics.record_serve_shed("queue-full")
            raise RequestRefused(
                "shed-queue-full",
                f"request queue is full (depth "
                f"{self.cfg.queue_depth}); retry later", status=429)

    def submit(self, doc: dict) -> tuple:
        """The in-process request path (the HTTP handler's core, also
        the test hook): validate, admit, wait for the worker, return
        ``(http_status, response_dict)`` -- ALWAYS within the
        request's deadline plus a small grace.  Every path through
        here -- green, shed, invalid, expired -- opens and seals one
        request-observatory record, so the access ledger carries
        exactly one row per request."""
        from acg_tpu_torch import metrics
        rid = reqtrace.request_id_from_doc(doc)
        rec = self.reqlog.begin(
            rid, matrix=((doc.get("matrix") if isinstance(doc, dict)
                          else None) or self.cfg.preload))
        t_admit0 = time.monotonic()
        try:
            req = _Request(doc, self.cfg)
        except RequestRefused as e:
            metrics.record_serve_request("invalid")
            rec.stage("admit", time.monotonic() - t_admit0,
                      decision=e.kind)
            self.reqlog.complete(rec, "invalid-request")
            return e.status, _error_body(e.kind, str(e),
                                         request_id=rid)
        req.request_id = rid
        req.trace = rec
        rec.id = req.id
        rec.matrix = str(req.matrix)
        try:
            self.admit(req)
        except RequestRefused as e:
            metrics.record_serve_request("shed")
            rec.stage("admit", time.monotonic() - t_admit0,
                      burn=getattr(req, "_admit_burn", None),
                      decision=e.kind)
            self.reqlog.complete(
                rec, e.kind if e.kind.startswith("shed-")
                else "request-failed")
            return e.status, _error_body(e.kind, str(e), req,
                                         retryable=True)
        rec.stage("admit", time.monotonic() - t_admit0,
                  burn=getattr(req, "_admit_burn", None),
                  decision="admitted")
        if not req.event.wait(req.timeout + 1.0):
            metrics.record_serve_shed("deadline")
            metrics.record_serve_request("expired")
            self.reqlog.complete(rec, "deadline-expired")
            return 504, _error_body(
                "deadline-expired",
                f"request {req.id} was not answered within its "
                f"{req.timeout:g}s deadline", req, retryable=True)
        t_fin = getattr(req, "_finished_at", None)
        if t_fin is not None:
            rec.stage("respond", time.monotonic() - t_fin)
        self.reqlog.complete(rec, reqtrace.outcome_of(req.response))
        return req.status, req.response

    # -- the worker --------------------------------------------------------

    def _degraded(self, req: _Request) -> bool:
        """The degrade rung of the shed ladder: past ``degrade_burn``
        the request is served on the cheap profile (classic
        recurrence, no preconditioner) instead of refused."""
        if self._burn() < self.cfg.degrade_burn:
            return False
        return (req.algorithm not in (None, "classic")
                or req.precond is not None)

    def _request_b(self, req: _Request, n: int) -> np.ndarray:
        if req.b is not None:
            if req.b.size != n:
                raise RequestRefused(
                    "invalid-request",
                    f"'b' has {req.b.size} entries; {req.matrix} has "
                    f"{n} rows")
            return req.b
        if req.b_seed is not None:
            return np.random.default_rng(
                int(req.b_seed)).standard_normal(n)
        return np.ones(n)

    def _serve_fault(self, req: _Request) -> None:
        """Host-level fault sites for the chaos campaign: ``crash``
        kills the daemon mid-request (the supervisor's relaunch
        trigger); ``slow:S`` dilates service (the SLO-burn trigger).
        Device-site specs are injected around the solve instead."""
        f = str(req.fault or "")
        if f.startswith("crash"):
            sys.stderr.write(f"acg-tpu-torch: serve: request {req.id} "
                             f"injected crash -- daemon exiting\n")
            sys.stderr.flush()
            os._exit(int(ExitCode.CRASH_INJECTED))
        if f.startswith("slow:"):
            time.sleep(float(f.split(":", 1)[1]))

    def _solve_batch(self, batch: list) -> None:
        """Serve one coalesced batch (len >= 1) end to end: cache
        lookups, the solve, demux, per-request responses.  All
        failure paths answer every member with a TYPED error."""
        from acg_tpu_torch import faults, metrics, observatory, tracing
        from acg_tpu_torch.solvers import StoppingCriteria
        lead = batch[0]
        nrhs = len(batch)
        degraded = False
        self._batch_seq += 1
        bid = self._batch_seq
        member_ids = [getattr(r, "request_id", None) for r in batch]
        try:
            if lead.fault:
                self._serve_fault(lead)
            degraded = self._degraded(lead)
            if degraded:
                lead.algorithm = None
                lead.precond = None
                metrics.record_serve_degraded()
                observatory.note_event(
                    "serve-degraded",
                    f"request {lead.id} [{lead.request_id}] "
                    f"downgraded to the classic "
                    f"unpreconditioned profile (SLO burn "
                    f"{self._burn():.2f})")
            t_cache0 = time.perf_counter()
            op, op_hit = self._ingest_operator(
                lead.operator_key(self.cfg))
            ingest_dt = time.perf_counter() - t_cache0
            # decision observatory: resolve this batch's program
            # provenance.  degraded beats everything (the shed ladder
            # already stripped algorithm/precond); an explicit request
            # field is flag-forced; otherwise the cached plan decides
            # -- replanned first when the calibration id changed
            decision = op.get("plan") if self.cfg.autotune else None
            if self.cfg.autotune and decision is not None:
                cal_now = self._calibration_id()
                if decision.get("calibration") != cal_now:
                    observatory.note_event(
                        "serve-replanned",
                        f"operator {lead.matrix}: calibration "
                        f"{decision.get('calibration')} -> {cal_now}")
                    decision = self._plan_operator(
                        lead.operator_key(self.cfg), op)
                    op["plan"] = decision
            if degraded:
                plan_source = "fallback"
            elif lead.algorithm is not None or lead.precond is not None:
                plan_source = "flag-forced"
            elif decision is not None:
                plan_source = "planned"
                # the planned recurrence only applies to single-RHS
                # service: coalesced batches ride the batched-classic
                # program (the bitwise coalescing contract)
                if nrhs == 1 \
                        and decision.get("algorithm") != "classic":
                    lead.algorithm = decision["algorithm"]
            else:
                plan_source = "flag-forced"
            plan_body = {"id": (decision or {}).get("plan_id"),
                         "source": plan_source}
            n = op["n"]
            cols = [self._request_b(r, n) for r in batch]
            b = cols[0] if nrhs == 1 else np.stack(cols, axis=1)
            crit = StoppingCriteria(maxits=lead.maxits,
                                    residual_rtol=lead.rtol,
                                    residual_atol=lead.atol)
            t0 = time.perf_counter()
            x, solver, prog_hit, prog_dt, ninval = \
                self._solve_with_retries(lead, op, nrhs, b, crit)
            latency = time.perf_counter() - t0
            st = solver.stats
            observatory.slo_observe(st, latency=latency,
                                    iterations=int(st.niterations))
            if nrhs > 1:
                metrics.record_serve_coalesced(nrhs)
            if plan_source == "planned" and latency > 0 \
                    and decision.get("predicted_s_per_solve"):
                ratio = float(decision["predicted_s_per_solve"]) \
                    / latency
                self.last_misprediction = ratio
                metrics.record_plan_misprediction(ratio)
            # tail-latency attribution: the program build (billed to
            # the cache stage with the operator ingest) and the compile
            # a cache-miss solve absorbed in warmup are carved out of
            # the measured latency; what remains is PURE solve, split
            # per RHS so member attributions sum to the batch solve
            # time -- and stage sums never exceed the request wall
            # (a program-cache hit ran no warm-up: the compile its
            # solver's stats accumulated is its first request's, which
            # the reference bills again to every hit)
            compile_s = 0.0 if prog_hit else min(max(float(
                (st.timings or {}).get("compile", 0.0) or 0.0), 0.0),
                latency)
            solve_s = max(latency - compile_s
                          - min(max(prog_dt, 0.0), latency), 0.0)
            rhs_share = solve_s / nrhs
            # ONE batch-scoped solve span linked to every member id --
            # the coalesced batch's row on the service timeline
            t_wall = time.time()
            tracing.record_span(
                f"solve-batch-{bid}", t_wall - latency, t_wall,
                cat="worker", batch=bid, nrhs=nrhs,
                requests=[m for m in member_ids if m])
            prog_state = ("invalidated" if ninval
                          else ("hit" if prog_hit else "miss"))
            cache_body = {"operator": "hit" if op_hit else "miss",
                          "program": "hit" if prog_hit else "miss"}
            batch_block = {"id": bid, "width": nrhs,
                           "members": [m for m in member_ids if m],
                           "solve_seconds": round(solve_s, 6),
                           "rhs_solve_seconds": round(rhs_share, 6)}
            X = np.asarray(x)
            for j, r in enumerate(batch):
                t_demux0 = time.perf_counter()
                xj = X[:, j] if nrhs > 1 else X
                iters = (int(st.batch["iterations"][j])
                         if nrhs > 1 and st.batch else
                         int(st.niterations))
                body = {"schema": SCHEMA, "ok": True, "id": r.id,
                        "request_id": r.request_id,
                        "converged": bool(st.converged),
                        "iterations": iters,
                        "latency_seconds": round(latency, 6),
                        "coalesced": nrhs, "degraded": degraded,
                        "plan": dict(plan_body),
                        "cache": dict(cache_body)}
                if r.want_x:
                    body["x"] = xj.tolist()
                rec = getattr(r, "trace", None)
                if rec is not None:
                    rec.stage("cache", ingest_dt + prog_dt,
                              operator=cache_body["operator"],
                              program=prog_state)
                    if compile_s > 0:
                        rec.stage("compile", compile_s)
                    rec.stage("solve", rhs_share, batch=bid)
                    rec.note("cache", {"operator":
                                       cache_body["operator"],
                                       "program": prog_state})
                    rec.note("coalesced", nrhs)
                    rec.note("degraded", bool(degraded))
                    rec.note("plan", dict(plan_body))
                    rec.note("batch", dict(batch_block))
                    rec.stage("demux",
                              time.perf_counter() - t_demux0)
                r.finish(200, body)
                metrics.record_plan_decision(plan_source)
                metrics.record_serve_request("ok")
                self.requests_served += 1
            self._save_state()
        except RequestRefused as e:
            for r in batch:
                r.finish(e.status, _error_body(e.kind, str(e), r))
                metrics.record_serve_request("invalid")
        except Exception as e:  # noqa: BLE001 -- the isolation
            # boundary: ANY request failure becomes a typed answer
            kind = type(e).__name__
            observatory.note_event(
                "request-failed",
                f"request {lead.id} [{lead.request_id}] "
                f"({lead.matrix}): {kind}: {e}")
            sys.stderr.write(f"acg-tpu-torch: serve: request {lead.id} "
                             f"[{lead.request_id}] failed: "
                             f"{kind}: {e}\n")
            for r in batch:
                r.finish(500, _error_body(
                    kind, str(e), r,
                    retryable=isinstance(e, (BreakdownError,
                                             NotConvergedError))))
                metrics.record_serve_request("error")
                self.requests_failed += 1
            if self._context_lost(e):
                # the card's context is gone: answering on it would be
                # answering wrong; end with a relaunchable code, after a
                # moment for the handler threads to send the typed answers
                sys.stderr.write(
                    f"acg-tpu-torch: serve: the CUDA context is unusable "
                    f"after {kind}; exiting "
                    f"{int(ExitCode.BACKEND_UNAVAILABLE)} for the "
                    f"supervisor to relaunch\n")
                sys.stderr.flush()
                time.sleep(0.2)
                os._exit(int(ExitCode.BACKEND_UNAVAILABLE))
        finally:
            _ = faults  # keep the import local-and-single

    def _context_lost(self, e: BaseException) -> bool:
        """Whether ``e`` left the daemon's CUDA context unusable: a CUDA
        error (a sticky one -- an illegal address, a launch failure --
        poisons every later call), confirmed by a probe that touches the
        card.  A CPU daemon, or an error outside the runtime, never
        does."""
        if self.device.type != "cuda":
            return False
        cuda_err = (isinstance(e, getattr(torch, "AcceleratorError", ()))
                    or (isinstance(e, RuntimeError)
                        and "CUDA error" in str(e)))
        if not cuda_err:
            return False
        try:
            probe = torch.ones(1, device=self.device) + 1
            torch.cuda.synchronize(self.device)
            return float(probe.item()) != 2.0
        except Exception:  # noqa: BLE001 -- any failure: the context died
            return True

    def _solve_with_retries(self, lead: _Request, op: dict, nrhs: int,
                            b, crit):
        """The bounded per-request retry loop around the solve.  A
        breakdown that escapes the solver's own recovery ladder
        invalidates the (possibly poisoned) program-cache entry,
        backs off, and retries with a freshly built program; the
        LAST failure propagates to the typed-error boundary.
        Returns ``(x, solver, prog_hit, program_lookup_seconds,
        ninvalidated)`` -- the lookup time feeds the cache stage, the
        invalidation count the ledger's program provenance."""
        from acg_tpu_torch import faults, observatory
        attempt = 0
        prog_dt = 0.0
        ninval = 0
        while True:
            op_entry = op
            t_p0 = time.perf_counter()
            solver, prog_hit = self._program_for(lead, op_entry, nrhs)
            prog_dt += time.perf_counter() - t_p0
            # a cache-miss solve absorbs (and counts) its warm-up as
            # the compile phase; a cache-hit solve must NOT pay or
            # count one
            warmup = 0 if prog_hit else 1
            try:
                f = lead.fault
                if f and not (f.startswith("crash")
                              or f.startswith("slow:")):
                    with faults.injected(str(f)):
                        x = solver.solve(b, criteria=crit,
                                         warmup=warmup)
                else:
                    x = solver.solve(b, criteria=crit, warmup=warmup)
                return x, solver, prog_hit, prog_dt, ninval
            except NotConvergedError:
                # ran to maxits healthy -- a retry re-runs the same
                # trajectory; answer typed instead
                raise
            except (BreakdownError, FloatingPointError,
                    AcgError) as e:
                self.programs.invalidate(
                    lead.program_key(self.cfg, nrhs))
                ninval += 1
                # a poisoned request traces END TO END: the
                # invalidation event and the retry line both carry
                # the stable request identity
                observatory.note_event(
                    "serve-program-invalidated",
                    f"request {lead.id} [{lead.request_id}]: program "
                    f"cache entry for {lead.matrix} invalidated "
                    f"after {type(e).__name__}")
                if attempt >= self.cfg.retries:
                    raise
                attempt += 1
                sys.stderr.write(
                    f"acg-tpu-torch: serve: request {lead.id} "
                    f"[{lead.request_id}] retry "
                    f"{attempt}/{self.cfg.retries} after "
                    f"{type(e).__name__}\n")
                time.sleep(self.cfg.retry_backoff * (2 ** (attempt - 1)))
                # the fault modelled a transient -- drop it on retry
                lead.fault = None

    def _worker_loop(self) -> None:
        from acg_tpu_torch import metrics
        if self.device.type == "cuda":
            # a new thread's current device is the default one, not
            # necessarily the daemon's
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            req = self.queue.pop(timeout=0.1)
            if req is None:
                continue
            t_pop = time.monotonic()
            rec = getattr(req, "trace", None)
            if req.expired():
                metrics.record_serve_shed("deadline")
                metrics.record_serve_request("expired")
                if rec is not None:
                    rec.stage("queue-wait", t_pop - req.enqueued)
                req.finish(504, _error_body(
                    "deadline-expired",
                    f"request {req.id} expired in queue", req,
                    retryable=True))
                continue
            batch = [req]
            key = getattr(req, "_ckey", None)
            if key is not None and self.cfg.coalesce > 1:
                deadline = time.monotonic() + COALESCE_WINDOW_SECS
                while (len(batch) < self.cfg.coalesce
                       and time.monotonic() < deadline):
                    more = self.queue.drain_compatible(
                        key, self.cfg.coalesce - len(batch))
                    if more:
                        batch.extend(more)
                    else:
                        time.sleep(0.005)
            # per-request attribution: the lead paid queue-wait until
            # its pop and the coalesce window after it; a follower's
            # whole wait (including the window that scooped it up) is
            # queue residency
            t_batch = time.monotonic()
            if rec is not None:
                rec.stage("queue-wait", t_pop - req.enqueued)
                rec.stage("coalesce", t_batch - t_pop,
                          followers=len(batch) - 1)
            for r in batch[1:]:
                fr = getattr(r, "trace", None)
                if fr is not None:
                    fr.stage("queue-wait", t_batch - r.enqueued)
            self._solve_batch(batch)
        # shutdown: answer the stragglers, never strand a waiter
        for r in self.queue.drain_all():
            from acg_tpu_torch import metrics
            metrics.record_serve_shed("shutdown")
            metrics.record_serve_request("shed")
            r.finish(503, _error_body(
                "shed-shutdown", "the service is shutting down", r,
                retryable=True))

    # -- status ------------------------------------------------------------

    def status_doc(self) -> dict:
        from acg_tpu_torch import observatory
        doc = {"schema": SCHEMA, "serving": self.accepting,
               "pid": os.getpid(), "port": self.port,
               "uptime_seconds": round(time.time() - self.started_at,
                                       3),
               "queue_depth": len(self.queue),
               "queue_limit": self.cfg.queue_depth,
               "requests_served": self.requests_served,
               "requests_failed": self.requests_failed,
               "warm_restored": self.warm_restored,
               "operator_cache": {"entries": len(self.operators),
                                  "keys": [list(k) for k in
                                           self.operators.keys()]},
               "program_cache": {"entries": len(self.programs)},
               "slo_burn": round(self._burn(), 4),
               "nparts": self.cfg.nparts}
        # request observatory: in-flight / completed tallies and the
        # outcome histogram (GET /requests serves the documents)
        doc["requests"] = self.reqlog.summary()
        # decision observatory: what the daemon would dispatch and how
        # honest the last planned prediction was
        cached = []
        for key in self.operators.keys():
            entry = self.operators.peek(key)
            dec = (entry or {}).get("plan")
            if dec:
                cached.append({"matrix": key[0],
                               "plan_id": dec.get("plan_id"),
                               "selected": dec.get("selected"),
                               "calibration": dec.get("calibration")})
        doc["plans"] = {
            "autotune": bool(self.cfg.autotune),
            "calibration": self._calibration_id(),
            "decisions": cached,
            "last_misprediction_ratio": self.last_misprediction,
        }
        doc["status"] = observatory.status_document()
        return doc

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> int:
        """Arm the planes, warm-restore, bind the port, go.  Returns
        the bound port (``cfg.port == 0`` lets the OS pick -- the
        test hook, the ``--metrics-port`` design)."""
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        from acg_tpu_torch import metrics, observatory
        metrics.arm()
        observatory.arm()
        self._warm_restore()
        if self.cfg.preload:
            self._ingest_operator((str(self.cfg.preload),
                                   self.cfg.dtype,
                                   int(self.cfg.nparts)))
        self.accepting = True
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="acg-serve-worker",
                                        daemon=True)
        self._worker.start()
        daemon = self

        class _Handler(BaseHTTPRequestHandler):
            def _reply(self, status: int, body: dict,
                       ctype: str = "application/json") -> None:
                data = (json.dumps(body) + "\n").encode()
                self.send_response(int(status))
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 -- stdlib handler contract
                path = self.path.split("?")[0]
                if path in ("/status", "/"):
                    self._reply(200, daemon.status_doc())
                elif path == "/requests":
                    self._reply(200, daemon.reqlog.snapshot())
                elif path == "/healthz":
                    self._reply(200 if daemon.accepting else 503,
                                {"ok": daemon.accepting})
                elif path == "/metrics":
                    body = metrics.expose().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802 -- stdlib handler contract
                path = self.path.split("?")[0]
                if path == "/shutdown":
                    self._reply(200, {"ok": True,
                                      "detail": "shutting down"})
                    threading.Thread(target=daemon.stop,
                                     daemon=True).start()
                    return
                if path != "/solve":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length",
                                                  0))
                    doc = json.loads(
                        self.rfile.read(length).decode() or "{}")
                    if not isinstance(doc, dict):
                        raise ValueError("request body must be a "
                                         "JSON object")
                except (ValueError, UnicodeDecodeError) as e:
                    metrics.record_serve_request("invalid")
                    self._reply(400, _error_body("invalid-request",
                                                 f"bad JSON: {e}"))
                    return
                status, body = daemon.submit(doc)
                self._reply(status, body)

            def log_message(self, *a):  # clients must not spam stderr
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", self.cfg.port),
                                           _Handler)
        self.port = int(self._server.server_address[1])
        threading.Thread(target=self._server.serve_forever,
                         name="acg-serve-http", daemon=True).start()
        self._save_state()
        observatory.note_event("serve-start",
                               f"solver service on port {self.port} "
                               f"(pid {os.getpid()})")
        sys.stderr.write(f"acg-tpu-torch: serve: listening on port "
                         f"{self.port} (pid {os.getpid()})\n")
        return self.port

    def stop(self) -> None:
        self.accepting = False
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=10.0)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        self._save_state()
        self.reqlog.close()


# -- CLI entry -------------------------------------------------------------

def _serve_validate(args) -> None:
    """The could-never-fire discipline for ``--serve``: refuse every
    one-shot flag the daemon could never honour, BEFORE binding a
    port."""
    unsupported = [flag for flag, on in [
        ("--soak (the daemon IS the service loop)",
         bool(getattr(args, "soak", 0))),
        ("--resume (the daemon warm-restores from its own serve "
         "state)", args.resume is not None),
        ("b/x0 input files (each request carries its own b)",
         bool(args.b or args.x0)),
        ("-o/--output (solutions ride the HTTP responses)",
         getattr(args, "output", None) is not None),
        ("--explain", bool(getattr(args, "explain", False))),
        ("--bench", bool(getattr(args, "bench", False))),
        ("--nrhs/--block-cg (the coalescer owns batching)",
         int(getattr(args, "nrhs", 0) or 0) >= 2
         or bool(getattr(args, "block_cg", False))),
        ("--fault-inject (requests carry their own fault field "
         "under --serve-faults)",
         getattr(args, "fault_inject", None) is not None),
        ("--manufactured-solution",
         bool(getattr(args, "manufactured_solution", False))),
        ("--distributed-read",
         bool(getattr(args, "distributed_read", False))),
        ("--output-comm-matrix",
         bool(getattr(args, "output_comm_matrix", False))),
        ("--profile-ops",
         getattr(args, "profile_ops", None) is not None),
        ("--plan (the daemon plans per operator; GET /status shows "
         "the cached decisions)",
         getattr(args, "plan", None) is not None),
    ] if on]
    if unsupported:
        raise SystemExit(f"acg-tpu-torch: --serve does not support: "
                         f"{', '.join(unsupported)}")
    if not str(args.A).startswith("gen:"):
        raise SystemExit(
            "acg-tpu-torch: --serve preloads a generator operator "
            "(gen:...); file matrices are not served yet")


def config_from_args(args) -> ServeConfig:
    state = args.ckpt
    if state is not None and not state.endswith(".serve.json"):
        state = state + ".serve.json"
    # --serve dispatches before _main's calibration load; mirror it
    cal = getattr(args, "_calibration", None)
    if cal is None and getattr(args, "calibration", None):
        from acg_tpu_torch.commbench import load_calibration
        try:
            cal = load_calibration(args.calibration)
        except (OSError, ValueError) as e:
            raise SystemExit(f"acg-tpu-torch: --calibration "
                             f"{args.calibration}: {e}")
    return ServeConfig(
        port=int(getattr(args, "serve_port", 0) or 0),
        queue_depth=int(getattr(args, "serve_queue_depth", 16)),
        coalesce=int(getattr(args, "serve_coalesce", 8)),
        default_timeout=float(getattr(args, "serve_deadline", 60.0)),
        state_path=state, preload=str(args.A),
        nparts=int(args.nparts or 0),
        comm="dma" if getattr(args, "comm", "xla") in ("dma",
                                                       "nvshmem")
        else "xla",
        dtype="f64" if args.dtype == "f64" else "f32",
        allow_faults=bool(getattr(args, "serve_faults", False)),
        autotune=bool(getattr(args, "autotune", False)),
        calibration=cal,
        access_log=getattr(args, "access_log", None),
        device=getattr(args, "device", None))


def run_serve(args, argv: list) -> int:
    """The ``--serve`` CLI mode: plain daemon, supervised daemon
    (``--supervise``), or the live chaos campaign (``--chaos``)."""
    _serve_validate(args)
    if args.chaos is not None:
        return run_chaos_serve(args, argv)
    if args.supervise:
        from acg_tpu_torch.supervisor import run_supervised_serve
        return run_supervised_serve(args, argv)
    from acg_tpu_torch import metrics, observatory
    if args.slo:
        observatory.install_slo(observatory.parse_slo(args.slo))
    # --serve --timeline FILE = the SERVICE timeline: the daemon owns
    # the span recorder for its lifetime (serve dispatches before
    # _main's per-solve arm/export), one worker row plus one lane per
    # in-flight request window, exported at shutdown
    timeline = getattr(args, "timeline", None)
    if timeline:
        from acg_tpu_torch import tracing
        tracing.arm()
    # the device is resolved here, before the port is bound
    daemon = ServeDaemon(config_from_args(args))
    daemon.start()
    if args.metrics_port:
        metrics.serve(args.metrics_port)
    if args.status_port:
        observatory.serve_status(args.status_port)
    if args.metrics_file:
        metrics.install_flush_handlers(args.metrics_file)
    import signal

    def _term(signum, frame):
        sys.stderr.write("acg-tpu-torch: serve: signal "
                         f"{signum} -- shutting down\n")
        threading.Thread(target=daemon.stop, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
        signal.signal(signal.SIGINT, _term)
    except ValueError:
        pass  # not the main thread (in-process callers)
    try:
        while daemon._server is not None and not daemon._stop.is_set():
            time.sleep(0.2)
    except KeyboardInterrupt:
        daemon.stop()
    sys.stderr.write(f"acg-tpu-torch: serve: served "
                     f"{daemon.requests_served} request(s), "
                     f"{daemon.requests_failed} failed -- bye\n")
    if getattr(args, "verbose", 0) >= 2:
        # the process's kernel launches, as a CLI run prints them
        from acg_tpu_torch.cli import _report_run
        _report_run(args)
    if timeline:
        from acg_tpu_torch import tracing
        try:
            summary = tracing.export_chrome_trace(
                timeline, [tracing.local_payload()],
                nparts=max(int(args.nparts or 0), 1))
            sys.stderr.write(
                f"acg-tpu-torch: --timeline {timeline}: service timeline, "
                f"{summary['nspans']} span(s)\n")
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: --timeline {timeline}: "
                             f"{e}\n")
        finally:
            tracing.disarm()
    if args.metrics_file:
        try:
            metrics.write_textfile(args.metrics_file)
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: --metrics-file "
                             f"{args.metrics_file}: {e}\n")
    return 0


# -- the live chaos campaign ----------------------------------------------

def _http_json(method: str, url: str, doc=None, timeout: float = 30.0):
    """(status, parsed-body) with stdlib urllib; connection-level
    failures surface as OSError to the caller."""
    import urllib.error
    import urllib.request
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except ValueError:
            return e.code, {"ok": False,
                            "error": {"type": "http",
                                      "message": str(e)}}


def serve_chaos_schedule(index: int, seed: int, nparts: int) -> dict:
    """Schedule ``index``'s request mutation -- deterministic in
    (seed, index) like :func:`acg_tpu_torch.supervisor.chaos_schedule`, over
    the sites a LIVE daemon can exercise.  Schedule 1 is ALWAYS a
    crash-mid-request: every campaign of >= 2 schedules exercises the
    kill-and-relaunch path regardless of seed (the acceptance's
    non-negotiable case), the rest of the menu stays seeded."""
    rng = np.random.default_rng([int(seed), int(index), 77])
    menu = ["none", "none", "crash", "slow", "spmv:nan", "dot:nan"]
    if int(nparts) > 1:
        menu.append("halo:nan")
    pick = "crash" if int(index) == 1 \
        else menu[int(rng.integers(len(menu)))]
    if pick == "none":
        return {}
    if pick == "crash":
        return {"fault": "crash"}
    if pick == "slow":
        return {"fault": f"slow:{0.05 + 0.1 * float(rng.random()):.3f}"}
    k = 2 + int(6 * float(rng.random()) ** 2)
    if pick == "dot:nan":
        return {"fault": f"dot:nan@{k}"}
    return {"fault": f"{pick}@{k}:seed={int(rng.integers(1 << 16))}"}


def run_chaos_serve(args, argv: list) -> int:
    """``--serve --chaos SEED[:N]``: the campaign against the LIVE
    daemon.  A supervised daemon is launched as a child; every
    schedule fires one request (possibly fault-carrying) at it, every
    green response is verified against the host oracle
    independently, and every verdict lands in the ledger.  Exit 96 on
    any wrong-answer-green; the daemon must still be serving at the
    end."""
    from acg_tpu_torch import metrics, observatory
    from acg_tpu_torch.supervisor import (SUPERVISOR_FLAGS, parse_chaos,
                                    set_flag, strip_flags, supervise_daemon,
                                    verify_solution_dense)
    seed, nsched = parse_chaos(args.chaos)
    if args.ckpt is None:
        raise SystemExit(
            "acg-tpu-torch: --serve --chaos relaunches the daemon from its "
            "persisted serve state; arm --ckpt FILE")
    from acg_tpu_torch.cli import synthesize_host_matrix
    csr = synthesize_host_matrix(args.A).to_csr()
    metrics.arm()
    child_argv = strip_flags(argv, SUPERVISOR_FLAGS)
    port = int(getattr(args, "serve_port", 0) or 0)
    if port == 0:
        # the campaign needs a STABLE address across daemon relaunches
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        child_argv = set_flag(child_argv, "--serve-port", port)
    env = dict(os.environ)
    env[FAULTS_ENV] = "1"
    env.pop("ACG_TPU_FAULT_INJECT", None)
    sup = supervise_daemon(
        child_argv, state_path=args.ckpt + ".serve.json",
        budget=max(args.relaunch_budget, nsched), backoff=0.1,
        env=env, label="chaos-serve")
    base = f"http://127.0.0.1:{port}"
    try:
        if not _wait_serving(base, 120.0):
            sup.stop()
            raise SystemExit("acg-tpu-torch: --serve --chaos: the daemon "
                             "never came up")
        tally = {"verified": 0, "typed-error": 0, "crash-relaunched": 0,
                 "WRONG-ANSWER": 0, "HANG": 0}
        sys.stderr.write(f"acg-tpu-torch: chaos-serve: {nsched} schedules "
                         f"from seed {seed} against {base}\n")
        for i in range(nsched):
            sched = serve_chaos_schedule(i, seed, int(args.nparts or 0))
            rng = np.random.default_rng([seed, i, 3])
            doc = {"matrix": args.A, "b_seed": int(rng.integers(1 << 30)),
                   "rtol": float(args.residual_rtol or 1e-8),
                   "maxits": int(args.max_iterations),
                   "timeout": 120.0,
                   "request_id": f"chaos-{seed}-{i}", **sched}
            verdict, rel, rid = _chaos_request(base, doc, csr,
                                               verify_solution_dense)
            if verdict == "crash-relaunched":
                if not _wait_serving(base, 120.0):
                    verdict = "HANG"
            tally[verdict] = tally.get(verdict, 0) + 1
            sys.stderr.write(
                f"acg-tpu-torch: chaos-serve[{i}]: "
                f"fault={sched.get('fault') or 'none'} -> {verdict}"
                f"{f' (rel {rel:.3e})' if rel is not None else ''}\n")
            if args.history:
                try:
                    observatory.history_append(args.history, {
                        "schema": "acg-tpu-chaos-serve/1",
                        "chaos": {"schedule": i, "seed": seed,
                                  "fault": sched.get("fault"),
                                  "verdict": verdict,
                                  "request_id": rid,
                                  "true_rel_residual": rel},
                        "manifest": {"matrix": str(args.A),
                                     "nparts": int(args.nparts or 0),
                                     "unix_time": time.time()}})
                except OSError as e:
                    sys.stderr.write(f"acg-tpu-torch: --history: {e}\n")
        # the daemon must END the campaign serving a correct answer
        doc = {"matrix": args.A, "b_seed": 12345,
               "rtol": float(args.residual_rtol or 1e-8),
               "maxits": int(args.max_iterations), "timeout": 120.0,
               "request_id": f"chaos-{seed}-final"}
        final, frel, _frid = _chaos_request(base, doc, csr,
                                            verify_solution_dense)
        sys.stderr.write(
            "chaos-serve:\n"
            f"  schedules: {nsched} (seed {seed})\n"
            + "".join(f"  {k}: {v}\n" for k, v in sorted(tally.items())
                      if v)
            + f"  final probe: {final}\n")
        _http_json("POST", f"{base}/shutdown", timeout=10.0)
    finally:
        sup.stop()
    if args.metrics_file:
        try:
            metrics.write_textfile(args.metrics_file)
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: --metrics-file: {e}\n")
    if tally["WRONG-ANSWER"] or final == "WRONG-ANSWER":
        return int(ExitCode.WRONG_ANSWER)
    if tally["HANG"] or final not in ("verified",):
        return int(ExitCode.FAILURE)
    return 0


def _wait_serving(base: str, timeout: float) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            status, doc = _http_json("GET", f"{base}/healthz",
                                     timeout=5.0)
            if status == 200 and doc.get("ok"):
                return True
        except (OSError, ValueError):
            pass
        time.sleep(0.25)
    return False


def _chaos_request(base: str, doc: dict, csr, verify) -> tuple:
    """Fire one campaign request; classify the outcome as ``(verdict,
    rel_residual, request_id)`` -- the echoed request identity lands in
    the verification ledger rows, so a campaign verdict joins against
    the daemon's own access ledger and structured events.  Green
    responses are verified INDEPENDENTLY against the host oracle --
    a green-but-wrong x is the campaign's one unforgivable verdict."""
    b = np.random.default_rng(int(doc["b_seed"])).standard_normal(
        csr.shape[0])
    try:
        status, body = _http_json("POST", f"{base}/solve", doc,
                                  timeout=float(doc["timeout"]) + 30.0)
    except OSError:
        # connection died under us -- the crash-mid-request class
        # (the sent id still identifies the request in daemon logs)
        return "crash-relaunched", None, doc.get("request_id")
    rid = (body.get("request_id") if isinstance(body, dict)
           else None) or doc.get("request_id")
    if status == 200 and body.get("ok"):
        x = np.asarray(body.get("x", []), dtype=np.float64)
        ok, rel = verify(csr, b, x, doc["rtol"])
        return ("verified" if ok else "WRONG-ANSWER"), rel, rid
    if isinstance(body, dict) and body.get("error", {}).get("type"):
        return "typed-error", None, rid
    return "HANG", None, rid
