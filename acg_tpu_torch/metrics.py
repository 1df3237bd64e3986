"""Process-lifetime service metrics: registry, Prometheus exposition,
and the instrumentation hooks the solver layers feed.

The counterpart of ``acg_tpu/metrics.py``: the same registry, every
family of the reference with its name, help text and buckets, so the
exposition text is byte-identical for the same recorder calls.  The
families of tiers the port does not have yet (checkpoints, recovery,
the solver service, ABFT, commbench, the planner) are registered and
recorded by nothing.  Three metric kinds, Prometheus-shaped (text
exposition format 0.0.4): counters, gauges, and histograms with fixed
exponential buckets whose :meth:`Histogram.quantile` interpolates as
``histogram_quantile`` does.

One process-wide :data:`REGISTRY`, thread-safe.  The layer is DISARMED
by default and every hook is a cheap early-return; all recording is
host-side bookkeeping and never touches the device.
:func:`update_resource_gauges` reads the process RSS and, on a CUDA
card, ``torch.cuda.memory_stats()``.

Sinks: :func:`write_textfile` (an atomic-rename Prometheus textfile,
flushed by the CLI on exit and on SIGTERM), :func:`serve` (a stdlib
``/metrics`` endpoint on a daemon thread) and :func:`snapshot_dict`
(the JSON twin in ``--stats-json`` documents).
"""

from __future__ import annotations

import atexit
import math
import os
import signal
import sys
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "arm", "disarm", "armed", "exponential_buckets",
    "write_textfile", "install_flush_handlers", "serve",
    "snapshot_dict", "expose",
]


def exponential_buckets(start: float, factor: float,
                        count: int) -> tuple[float, ...]:
    """``count`` bucket upper bounds ``start * factor**i`` -- the fixed
    exponential ladder every histogram here uses (a latency that can
    span 1e5x needs log-spaced resolution, not linear)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("exponential_buckets needs start > 0, "
                         "factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# solve latency: 100 us .. ~1.7 h in x2 steps -- wide enough for a tiny
# CPU debug solve and a pod-filling 512^3 one in the same ladder
SOLVE_SECONDS_BUCKETS = exponential_buckets(1e-4, 2.0, 26)
# iterations-to-converge: 1 .. ~8.4M
ITERATION_BUCKETS = exponential_buckets(1.0, 2.0, 24)
# pipeline phases: 10 us .. ~10 min
PHASE_SECONDS_BUCKETS = exponential_buckets(1e-5, 2.0, 26)

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integers without a trailing
    ``.0``, ``+Inf``/``-Inf``/``NaN`` spelled the exposition-format way."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.12g}"


def _label_str(names, values) -> str:
    if not names:
        return ""
    esc = [str(v).replace("\\", r"\\").replace('"', r'\"')
           .replace("\n", r"\n") for v in values]
    return "{" + ",".join(f'{n}="{e}"' for n, e in zip(names, esc)) + "}"


class _Child:
    """One labelled time series of a metric family."""

    __slots__ = ("_family", "_values", "_sum", "_count", "labelvalues")

    def __init__(self, family, labelvalues):
        self._family = family
        self.labelvalues = labelvalues
        nb = len(family.buckets) if family.kind == "histogram" else 0
        self._values = [0.0] * nb if nb else 0.0
        self._sum = 0.0
        self._count = 0

    # counter/gauge -----------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if self._family.kind == "histogram":
            raise ValueError(f"{self._family.name}: histograms "
                             f"observe(), they do not inc()")
        if self._family.kind == "counter" and amount < 0:
            raise ValueError(f"{self._family.name}: counters are "
                             f"monotone (inc by {amount})")
        with self._family._lock:
            self._values += float(amount)

    def dec(self, amount: float = 1.0) -> None:
        if self._family.kind != "gauge":
            raise ValueError(f"{self._family.name}: only gauges dec")
        with self._family._lock:
            self._values -= float(amount)

    def set(self, value: float) -> None:
        if self._family.kind != "gauge":
            raise ValueError(f"{self._family.name}: only gauges set")
        with self._family._lock:
            self._values = float(value)

    @property
    def value(self) -> float:
        return self._values if not isinstance(self._values, list) \
            else float(self._count)

    # histogram ---------------------------------------------------------
    def observe(self, value: float) -> None:
        if self._family.kind != "histogram":
            raise ValueError(f"{self._family.name}: only histograms "
                             f"observe")
        value = float(value)
        with self._family._lock:
            for i, ub in enumerate(self._family.buckets):
                if value <= ub:
                    self._values[i] += 1
                    break
            self._sum += value
            self._count += 1

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """``(upper_bound, cumulative_count)`` pairs ending with
        ``(+Inf, count)`` -- the exposition's ``_bucket`` series."""
        with self._family._lock:
            out, acc = [], 0
            for ub, c in zip(self._family.buckets, self._values):
                acc += int(c)
                out.append((ub, acc))
            out.append((math.inf, self._count))
            return out

    def quantile(self, q: float) -> float:
        """Histogram-interpolated quantile (the ``histogram_quantile``
        estimator: linear within the landing bucket, lower edge 0 for
        the first).  Returns NaN on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        cum = self.cumulative_buckets()
        total = cum[-1][1]
        if total == 0:
            return math.nan
        rank = q * total
        prev_ub, prev_c = 0.0, 0
        for ub, c in cum:
            if c >= rank:
                if math.isinf(ub):
                    # landed past the ladder: the last finite edge is
                    # the honest answer (no width to interpolate in)
                    return prev_ub if prev_ub else math.nan
                if c == prev_c:
                    return ub
                return prev_ub + (ub - prev_ub) * (rank - prev_c) / (
                    c - prev_c)
            prev_ub, prev_c = ub, c
        return prev_ub


class _Family:
    """One named metric family; unlabelled families proxy straight to
    their single child, so ``REGISTRY.counter("x", "...").inc()`` works
    without a ``.labels()`` hop."""

    def __init__(self, name: str, help: str, kind: str, registry,
                 labelnames=(), buckets=()):
        bad = set(name) - _NAME_OK
        if bad or not name or name[0].isdigit():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = registry._lock
        self._children: dict[tuple, _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self, ())

    def labels(self, *values, **kwargs) -> _Child:
        if kwargs:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            try:
                values = tuple(kwargs[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"{self.name}: missing label {e}")
            if len(kwargs) != len(self.labelnames):
                extra = set(kwargs) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown labels {extra}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                # label dedup: one child per distinct value tuple, ever
                child = self._children[values] = _Child(self, values)
            return child

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled "
                             f"{self.labelnames}; use .labels()")
        return self._children[()]

    # unlabelled proxies
    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    @property
    def value(self) -> float:
        return self._only().value

    def quantile(self, q: float) -> float:
        """Quantile over ALL children merged (the soak driver's view:
        one latency distribution regardless of solver labels)."""
        with self._lock:
            kids = list(self._children.values())
        if len(kids) == 1:
            return kids[0].quantile(q)
        merged = _Child(self, ())
        for k in kids:
            with self._lock:
                merged._values = [a + b for a, b in
                                  zip(merged._values, k._values)]
                merged._sum += k._sum
                merged._count += k._count
        return merged.quantile(q)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(k._count for k in self._children.values())


# aliases so isinstance-ish naming reads naturally in callers/tests
Counter = Gauge = Histogram = _Family


class Registry:
    """Thread-safe metric registry with Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}
        self._collect_callbacks: list = []

    def _register(self, name, help, kind, labelnames, buckets=()):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (fam.kind != kind
                        or fam.labelnames != tuple(labelnames)
                        or (kind == "histogram" and fam.buckets !=
                            tuple(sorted(float(b) for b in buckets)))):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(labelnames)} (was {fam.kind}"
                        f"{fam.labelnames}; histograms must also keep "
                        f"their bucket ladder)")
                return fam
            fam = _Family(name, help, kind, self, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()) -> _Family:
        return self._register(name, help, "counter", labelnames)

    def gauge(self, name, help="", labelnames=()) -> _Family:
        return self._register(name, help, "gauge", labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=SOLVE_SECONDS_BUCKETS) -> _Family:
        if not buckets:
            raise ValueError(f"{name}: histogram needs buckets")
        return self._register(name, help, "histogram", labelnames,
                              buckets)

    def on_collect(self, fn) -> None:
        """Register a pre-exposition callback (resource gauges refresh
        at scrape/flush time, the Prometheus collector convention)."""
        with self._lock:
            if fn not in self._collect_callbacks:
                self._collect_callbacks.append(fn)

    def expose(self) -> str:
        """The Prometheus text exposition (format 0.0.4): families in
        name order, children in label order -- deterministic, so a
        golden test can pin it."""
        for fn in list(self._collect_callbacks):
            try:
                fn()
            except Exception:  # noqa: BLE001 -- a failed resource
                pass           # refresh must never sink a scrape
        out = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                out.append(f"# HELP {name} {fam.help}")
                out.append(f"# TYPE {name} {fam.kind}")
                for lv in sorted(fam._children):
                    child = fam._children[lv]
                    if fam.kind == "histogram":
                        for ub, c in child.cumulative_buckets():
                            ls = _label_str(fam.labelnames + ("le",),
                                            lv + (_fmt(ub),))
                            out.append(f"{name}_bucket{ls} {c}")
                        ls = _label_str(fam.labelnames, lv)
                        out.append(f"{name}_sum{ls} "
                                   f"{_fmt(child._sum)}")
                        out.append(f"{name}_count{ls} {child._count}")
                    else:
                        ls = _label_str(fam.labelnames, lv)
                        out.append(f"{name}{ls} "
                                   f"{_fmt(child._values)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able registry snapshot (the ``metrics`` key of an
        ``acg-tpu-stats/3`` document)."""
        for fn in list(self._collect_callbacks):
            try:
                fn()
            except Exception:  # noqa: BLE001
                pass
        doc: dict = {}
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                entry: dict = {"type": fam.kind, "help": fam.help,
                               "samples": []}
                for lv in sorted(fam._children):
                    child = fam._children[lv]
                    labels = dict(zip(fam.labelnames, lv))
                    if fam.kind == "histogram":
                        entry["samples"].append({
                            "labels": labels,
                            "buckets": [[(None if math.isinf(ub)
                                          else ub), c]
                                        for ub, c in
                                        child.cumulative_buckets()],
                            "sum": child._sum,
                            "count": child._count,
                        })
                    else:
                        entry["samples"].append(
                            {"labels": labels, "value": child._values})
                doc[name] = entry
        return doc

    def reset(self) -> None:
        """Drop every family (tests only -- a service registry is
        append-only for life)."""
        with self._lock:
            self._families.clear()
            self._collect_callbacks.clear()


REGISTRY = Registry()

# -- the instrument set the solver layers feed ---------------------------

SOLVES = REGISTRY.counter(
    "acg_solves_total", "Completed solve() calls by solver and outcome.",
    labelnames=("solver", "converged"))
ITERATIONS = REGISTRY.counter(
    "acg_iterations_total", "CG iterations executed across all solves.")
SOLVE_SECONDS = REGISTRY.histogram(
    "acg_solve_seconds", "Wall-clock seconds per solve.",
    buckets=SOLVE_SECONDS_BUCKETS)
SOLVE_ITERATIONS = REGISTRY.histogram(
    "acg_solve_iterations", "Iterations-to-converge per solve.",
    buckets=ITERATION_BUCKETS)
PHASE_SECONDS = REGISTRY.histogram(
    "acg_phase_seconds", "Pipeline-phase seconds "
    "(ingest/partition/transfer/compile/solve/writeback).",
    labelnames=("phase",), buckets=PHASE_SECONDS_BUCKETS)
COMPILES = REGISTRY.counter(
    "acg_compiles_total", "Compile phases observed (warmup-absorbed "
    "program compiles in the CLI and bench paths).")
BREAKDOWNS = REGISTRY.counter(
    "acg_breakdowns_total", "Breakdowns detected by the solve loops.")
RESTARTS = REGISTRY.counter(
    "acg_restarts_total", "Recovery restarts granted by the policy.")
FALLBACKS = REGISTRY.counter(
    "acg_fallbacks_total", "Transport/solver fallbacks taken.")
EVENTS = REGISTRY.counter(
    "acg_events_total", "Structured telemetry events by kind.",
    labelnames=("kind",))
HALO_BYTES = REGISTRY.counter(
    "acg_halo_bytes_total", "Halo-exchange payload bytes moved "
    "(static comm-ledger estimate x iterations).")
ALLREDUCE_BYTES = REGISTRY.counter(
    "acg_allreduce_bytes_total", "Allreduce/psum payload bytes moved "
    "(static comm-ledger estimate x iterations).")
RSS_BYTES = REGISTRY.gauge(
    "acg_process_resident_bytes", "Resident set size of this process.")
DEVICE_MEMORY = REGISTRY.gauge(
    "acg_device_memory_bytes", "Per-device memory where the backend "
    "reports it (jax memory_stats).", labelnames=("device", "kind"))
DRIFT_RATIO = REGISTRY.gauge(
    "acg_soak_latency_drift_ratio", "Soak driver: EWMA solve latency "
    "over the baseline window's (1.0 = no drift).")
PRECOND_APPLIES = REGISTRY.counter(
    "acg_precond_applies_total", "Preconditioner applies (analytic: "
    "one per iteration + setup; cheby bills its per-apply SpMVs).",
    labelnames=("kind",))
HEALTH_GAP = REGISTRY.gauge(
    "acg_health_residual_gap", "Latest in-loop true-residual audit "
    "gap ||r_true - r_rec||/||b|| (acg_tpu.health, --audit-every).")
HEALTH_KAPPA = REGISTRY.gauge(
    "acg_health_kappa_estimate", "Condition-number estimate of the "
    "(preconditioned) operator from the Lanczos tridiagonal of the "
    "last traced solve.")
HEALTH_AUDITS = REGISTRY.counter(
    "acg_health_audits_total", "In-loop true-residual audits "
    "performed across all solves.")
HEALTH_GAP_TRIPS = REGISTRY.counter(
    "acg_health_gap_trips_total", "Audit gaps past --gap-threshold "
    "(each one emitted an accuracy_degraded event).")
# survivability tier (acg_tpu.checkpoint): solver-state snapshots,
# resumes, and the recovery ladder's rollback rung
CKPT_SNAPSHOTS = REGISTRY.counter(
    "acg_ckpt_snapshots_total", "Solver-state snapshots committed "
    "(atomic-rename writes; --ckpt).")
CKPT_BYTES = REGISTRY.counter(
    "acg_ckpt_bytes_total", "Bytes written by committed snapshots.")
CKPT_WRITE_SECONDS = REGISTRY.histogram(
    "acg_ckpt_write_seconds", "Snapshot serialisation + atomic-rename "
    "seconds (billed to the 'ckpt' phase, excluded from solve "
    "latency).", buckets=PHASE_SECONDS_BUCKETS)
CKPT_RESUMES = REGISTRY.counter(
    "acg_ckpt_resumes_total", "Solves reconstructed from an on-disk "
    "snapshot (--resume).")
CKPT_ROLLBACKS = REGISTRY.counter(
    "acg_ckpt_rollbacks_total", "Breakdowns answered by rolling the "
    "loop carry back to the last snapshot (the recovery ladder's "
    "first rung).")
CKPT_REPARTITIONS = REGISTRY.counter(
    "acg_ckpt_repartition_resumes_total", "Shape-portable resumes: "
    "snapshots reassembled through the row-permutation sidecar onto "
    "a different partition or tier (--resume-repartition).")
# elastic-recovery tier (acg_tpu.supervisor, --supervise): child
# relaunches and time-to-recovery
RECOVERY_RELAUNCHES = REGISTRY.counter(
    "acg_recovery_relaunches_total", "Supervisor child relaunches by "
    "failure reason (crash/peer-lost/failure/backend).",
    labelnames=("reason",))
RECOVERY_MTTR = REGISTRY.histogram(
    "acg_recovery_mttr_seconds", "Seconds from the first failing "
    "child exit to the eventual converged run (--supervise; observed "
    "once per recovered incident).", buckets=SOLVE_SECONDS_BUCKETS)
RECOVERY_REGROWS = REGISTRY.counter(
    "acg_recovery_regrows_total", "Grow-on-recovery relaunches: a "
    "shrunken child healthy long enough was relaunched back toward "
    "the original mesh width (--grow-after).")
# solver-service tier (acg_tpu.serve, --serve): request accounting,
# the operator/program caches, and the admission-control ladder
SERVE_REQUESTS = REGISTRY.counter(
    "acg_serve_requests_total", "Requests answered by the solver "
    "service, by outcome (ok/error/shed/expired/invalid).",
    labelnames=("outcome",))
SERVE_CACHE_HITS = REGISTRY.counter(
    "acg_serve_cache_hits_total", "Serve cache hits (operator = "
    "ingested matrix + device planes; program = constructed solver "
    "whose jitted programs are compile-warm).", labelnames=("cache",))
SERVE_CACHE_MISSES = REGISTRY.counter(
    "acg_serve_cache_misses_total", "Serve cache misses (each one "
    "paid an ingest or a program construction + compile).",
    labelnames=("cache",))
SERVE_CACHE_EVICTIONS = REGISTRY.counter(
    "acg_serve_cache_evictions_total", "Serve cache LRU evictions.",
    labelnames=("cache",))
SERVE_CACHE_INVALIDATIONS = REGISTRY.counter(
    "acg_serve_cache_invalidations_total", "Serve cache entries "
    "dropped because a request poisoned them (request isolation).",
    labelnames=("cache",))
SERVE_SHED = REGISTRY.counter(
    "acg_serve_shed_total", "Requests refused by admission control, "
    "by reason (queue-full/slo-burn/deadline/shutdown).",
    labelnames=("reason",))
SERVE_COALESCED = REGISTRY.counter(
    "acg_serve_coalesced_total", "Requests served through a coalesced "
    "multi-RHS batched solve instead of singly.")
SERVE_DEGRADED = REGISTRY.counter(
    "acg_serve_degraded_total", "Requests served in degraded mode "
    "(the SLO-burn ladder downgraded the solve configuration).")
SERVE_WARM_RESTORES = REGISTRY.counter(
    "acg_serve_warm_restores_total", "Operator-cache entries "
    "re-ingested at daemon start from the persisted serve state "
    "(self-healing warm restore).")
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "acg_serve_queue_depth", "Requests currently queued in the "
    "solver service.")
SERVE_QUEUE_HIGH_WATER = REGISTRY.gauge(
    "acg_serve_queue_depth_high_water", "High-water mark of the serve "
    "request queue (worst backlog observed this process).")
SERVE_INFLIGHT = REGISTRY.gauge(
    "acg_serve_inflight", "Requests currently in flight in the solver "
    "service (admitted, not yet answered).")
SERVE_STAGE_SECONDS = REGISTRY.histogram(
    "acg_serve_stage_seconds", "Per-request stage seconds in the "
    "solver service (admit/queue-wait/coalesce/cache/compile/solve/"
    "demux/respond) -- the request observatory's tail-latency "
    "attribution.", labelnames=("stage",),
    buckets=PHASE_SECONDS_BUCKETS)
# ABFT checksum-protected SpMV (acg_tpu.health, --abft)
ABFT_CHECKS = REGISTRY.counter(
    "acg_abft_checks_total", "In-loop Huang-Abraham checksum "
    "verifications of the SpMV.")
ABFT_TRIPS = REGISTRY.counter(
    "acg_abft_trips_total", "Checksum mismatches past the ABFT "
    "threshold (silent SpMV corruption detected on device).")
ABFT_MISMATCH = REGISTRY.gauge(
    "acg_abft_mismatch_last", "Latest relative checksum mismatch "
    "|sum(Ax) - (c, x)| / scale.")
# timeline-tracing tier (acg_tpu.tracing): span-timeline recording and
# profiler-capture analysis
TRACE_SPANS = REGISTRY.counter(
    "acg_trace_spans_total", "Timeline spans/instants recorded by the "
    "span recorder (--timeline), by category.",
    labelnames=("cat",))
TRACE_EXPORTS = REGISTRY.counter(
    "acg_trace_exports_total", "Chrome trace-event timeline files "
    "written (--timeline).")
TRACE_OP_SECONDS = REGISTRY.gauge(
    "acg_trace_op_seconds", "Measured per-op-class device seconds "
    "from the last analyzed --trace capture.", labelnames=("op",))
TRACE_OVERLAP = REGISTRY.gauge(
    "acg_trace_overlap_efficiency", "Fraction of collective device "
    "time hidden under compute in the last analyzed capture (1.0 = "
    "fully overlapped; absent collectives leave the gauge untouched).")
TRACE_EXPOSED_SECONDS = REGISTRY.gauge(
    "acg_trace_exposed_collective_seconds", "Collective device time "
    "NOT overlapped by compute in the last analyzed capture.")
# communication observatory (acg_tpu.commbench, --commbench): fitted
# alpha-beta per collective kind and the measured segment split
COMMBENCH_RUNS = REGISTRY.counter(
    "acg_commbench_runs_total", "Completed --commbench microbenchmark "
    "suites (collective sweeps + segment decomposition).")
COMMBENCH_ALPHA = REGISTRY.gauge(
    "acg_commbench_alpha_seconds", "Fitted per-collective latency "
    "alpha from the last commbench run (t = alpha + beta * bytes).",
    labelnames=("kind",))
COMMBENCH_BETA = REGISTRY.gauge(
    "acg_commbench_beta_seconds_per_byte", "Fitted per-collective "
    "inverse bandwidth beta from the last commbench run.",
    labelnames=("kind",))
COMMBENCH_SEGMENT = REGISTRY.gauge(
    "acg_commbench_segment_seconds", "Measured per-iteration segment "
    "seconds (spmv / halo / reduction) from the last commbench "
    "segment decomposition.", labelnames=("segment",))
# live-observatory tier (acg_tpu.observatory, --slo): declared
# service-level objectives and their error-budget burn
SLO_TARGET = REGISTRY.gauge(
    "acg_slo_target", "Declared per-solve service-level objective "
    "targets (--slo latency=S,iters=N,gap=G).",
    labelnames=("objective",))
SLO_BREACHES = REGISTRY.counter(
    "acg_slo_breaches_total", "Completed solves that breached a "
    "declared objective (each breach also emits an slo-breach event).",
    labelnames=("objective",))
SLO_BURN = REGISTRY.gauge(
    "acg_slo_burn_ratio", "Fraction of observed solves breaching each "
    "declared objective (cumulative error-budget burn; 0 = none, "
    "1 = every solve).", labelnames=("objective",))
# decision observatory (acg_tpu.planner, --autotune): how programs
# were chosen and how honest the cost model's predictions are
PLAN_DECISIONS = REGISTRY.counter(
    "acg_plan_decisions_total", "Program-selection decisions by "
    "provenance: planned (cost-model chose), flag-forced (caller "
    "overrode), fallback (degraded/probe-failed path).",
    labelnames=("source",))
PLAN_MISPREDICTION = REGISTRY.gauge(
    "acg_plan_misprediction_ratio", "Predicted / measured "
    "seconds-per-solve of the last planned solve (1.0 = the cost "
    "model was exactly right; drives self-correction).")

_armed = False


def arm() -> None:
    """Arm the process-wide hooks.  All recording is host-side
    bookkeeping, so arming cannot perturb the compiled programs; the
    hooks stay cheap early-returns until this is called."""
    global _armed
    _armed = True
    REGISTRY.on_collect(update_resource_gauges)


def disarm() -> None:
    global _armed
    _armed = False


def armed() -> bool:
    return _armed


def record_solve(seconds: float, iterations: int, converged: bool,
                 solver: str = "cg") -> None:
    """One completed solve (called from the solvers' solve() tails).
    Also closes out the live-observatory status document's in-flight
    solve (its own arm gate; no-op disarmed)."""
    from acg_tpu_torch import observatory
    observatory.end_solve(bool(converged), int(iterations),
                          float(seconds))
    if not _armed:
        return
    SOLVES.labels(solver=solver,
                  converged="true" if converged else "false").inc()
    ITERATIONS.inc(max(int(iterations), 0))
    SOLVE_SECONDS.observe(max(float(seconds), 0.0))
    SOLVE_ITERATIONS.observe(max(int(iterations), 0))


def record_phase(name: str, seconds: float) -> None:
    """One pipeline-phase timing (fed from telemetry's phase timer and
    the solvers' add_timing); a compile phase also counts a compile."""
    if not _armed:
        return
    PHASE_SECONDS.labels(phase=str(name)).observe(max(float(seconds),
                                                      0.0))
    if name == "compile":
        COMPILES.inc()


def record_event_kind(kind: str) -> None:
    if not _armed:
        return
    EVENTS.labels(kind=str(kind)).inc()


def record_breakdown() -> None:
    if _armed:
        BREAKDOWNS.inc()


def record_restart() -> None:
    if _armed:
        RESTARTS.inc()


def record_fallback() -> None:
    if _armed:
        FALLBACKS.inc()


def record_precond(kind: str, applies: int) -> None:
    """One solve's preconditioner applies (the PCG tier's solve()
    tails, acg_tpu.precond)."""
    if _armed:
        PRECOND_APPLIES.labels(kind=str(kind)).inc(max(int(applies), 0))


def record_health_audit(gap, naudits: int) -> None:
    """One solve's audit summary (the numerical-health tier's solve()
    tails): the latest finite gap lands on the gauge, the audit count
    on the counter."""
    if not _armed:
        return
    if gap is not None and math.isfinite(float(gap)):
        HEALTH_GAP.set(float(gap))
    HEALTH_AUDITS.inc(max(int(naudits), 0))


def record_rollback() -> None:
    if _armed:
        CKPT_ROLLBACKS.inc()


def record_snapshot(nbytes: int, seconds: float) -> None:
    """One committed solver-state snapshot (the chunk drivers' write
    tails, acg_tpu.checkpoint)."""
    if not _armed:
        return
    CKPT_SNAPSHOTS.inc()
    CKPT_BYTES.inc(max(int(nbytes), 0))
    CKPT_WRITE_SECONDS.observe(max(float(seconds), 0.0))


def record_resume() -> None:
    if _armed:
        CKPT_RESUMES.inc()


def record_repartition() -> None:
    if _armed:
        CKPT_REPARTITIONS.inc()


def record_relaunch(reason: str) -> None:
    """One supervisor child relaunch (--supervise), by failure
    reason."""
    if _armed:
        RECOVERY_RELAUNCHES.labels(reason=str(reason)).inc()


def record_recovery_mttr(seconds: float) -> None:
    """One recovered incident's mean-time-to-recovery observation:
    first failing child exit -> eventual converged run."""
    if _armed:
        RECOVERY_MTTR.observe(max(float(seconds), 0.0))


def record_regrow() -> None:
    """One grow-on-recovery relaunch (--supervise --grow-after): a
    shrunken-but-healthy child relaunched toward the original width."""
    if _armed:
        RECOVERY_REGROWS.inc()


def record_serve_request(outcome: str) -> None:
    if _armed:
        SERVE_REQUESTS.labels(outcome=str(outcome)).inc()


def record_serve_cache(event: str, cache: str) -> None:
    """One serve-cache event: ``event`` in hit/miss/evict/invalidate,
    ``cache`` in operator/program."""
    if not _armed:
        return
    fam = {"hit": SERVE_CACHE_HITS, "miss": SERVE_CACHE_MISSES,
           "evict": SERVE_CACHE_EVICTIONS,
           "invalidate": SERVE_CACHE_INVALIDATIONS}[event]
    fam.labels(cache=str(cache)).inc()


def record_serve_shed(reason: str) -> None:
    if _armed:
        SERVE_SHED.labels(reason=str(reason)).inc()


def record_serve_coalesced(nrequests: int) -> None:
    if _armed:
        SERVE_COALESCED.inc(max(int(nrequests), 0))


def record_serve_degraded() -> None:
    if _armed:
        SERVE_DEGRADED.inc()


def record_serve_warm_restore(nentries: int) -> None:
    if _armed:
        SERVE_WARM_RESTORES.inc(max(int(nentries), 0))


_serve_queue_high_water = 0


def record_serve_queue_depth(depth: int) -> None:
    global _serve_queue_high_water
    if _armed:
        d = max(int(depth), 0)
        SERVE_QUEUE_DEPTH.set(d)
        if d > _serve_queue_high_water:
            _serve_queue_high_water = d
            SERVE_QUEUE_HIGH_WATER.set(d)


def record_serve_inflight(n: int) -> None:
    if _armed:
        SERVE_INFLIGHT.set(max(int(n), 0))


def record_serve_stage(stage: str, seconds: float) -> None:
    """One per-request stage observation (acg_tpu.reqtrace)."""
    if _armed:
        SERVE_STAGE_SECONDS.labels(stage=str(stage)).observe(
            max(float(seconds), 0.0))


def record_abft(nchecks: int, rel_last, ntrips: int) -> None:
    """One solve attempt's ABFT summary (fed from health.note_audit)."""
    if not _armed:
        return
    ABFT_CHECKS.inc(max(int(nchecks), 0))
    ABFT_TRIPS.inc(max(int(ntrips), 0))
    if rel_last is not None and math.isfinite(float(rel_last)):
        ABFT_MISMATCH.set(float(rel_last))


def record_health_kappa(kappa: float) -> None:
    if _armed and kappa and math.isfinite(float(kappa)):
        HEALTH_KAPPA.set(float(kappa))


def record_gap_trip() -> None:
    if _armed:
        HEALTH_GAP_TRIPS.inc()


def record_trace_span(cat: str) -> None:
    """One recorded timeline span/instant (acg_tpu.tracing)."""
    if _armed:
        TRACE_SPANS.labels(cat=str(cat)).inc()


def record_timeline_export() -> None:
    if _armed:
        TRACE_EXPORTS.inc()


def record_trace_analysis(analysis: dict) -> None:
    """One --trace capture analysis: per-op-class measured seconds on
    the gauges, overlap efficiency where collectives were measured."""
    if not _armed or not analysis.get("available"):
        return
    for cls, secs in analysis.get("op_seconds", {}).items():
        TRACE_OP_SECONDS.labels(op=str(cls)).set(float(secs))
    eff = analysis.get("overlap_efficiency")
    if eff is not None and math.isfinite(float(eff)):
        TRACE_OVERLAP.set(float(eff))
        TRACE_EXPOSED_SECONDS.set(
            float(analysis.get("exposed_collective_seconds", 0.0)))


def record_slo_target(objective: str, target: float) -> None:
    """One declared objective's target gauge (observatory.install_slo:
    a scrape shows what the run promised before the first solve)."""
    if _armed:
        SLO_TARGET.labels(objective=str(objective)).set(float(target))


def record_slo(objective: str, breached: bool, burn: float) -> None:
    """One judged objective after a completed solve: the breach counter
    and the cumulative burn-fraction gauge (observatory.slo_observe)."""
    if not _armed:
        return
    if breached:
        SLO_BREACHES.labels(objective=str(objective)).inc()
    SLO_BURN.labels(objective=str(objective)).set(float(burn))


def record_comm(ledger: dict, iterations: int) -> None:
    """Fold one solve's communication volume out of the perfmodel
    tier's static ledger: per-iteration halo/psum bytes x the solve's
    iteration count."""
    if not _armed or not ledger:
        return
    its = max(int(iterations), 0)
    HALO_BYTES.inc(int(ledger.get("halo_bytes_per_iteration", 0)) * its)
    ALLREDUCE_BYTES.inc(
        int(ledger.get("allreduce_bytes_per_iteration", 0)) * its)


def observe_solver_comm(solver, iterations: int) -> None:
    """``record_comm`` from a solver's own ``comm_profile()`` hook
    (PR 3); solvers without one are a no-op."""
    if not _armed:
        return
    prof = getattr(solver, "comm_profile", None)
    if prof is None:
        return
    try:
        record_comm(prof(), iterations)
    except Exception:  # noqa: BLE001 -- metrics must never sink a solve
        pass


def record_commbench(doc: dict) -> None:
    """Fold one commbench document into the registry: alpha/beta per
    fitted collective kind plus the measured segment split (no-op
    disarmed, like every recorder here)."""
    if not _armed or not isinstance(doc, dict):
        return
    COMMBENCH_RUNS.inc()
    for kind, fit in (doc.get("collectives") or {}).items():
        if isinstance(fit, dict) and "alpha_s" in fit:
            COMMBENCH_ALPHA.labels(str(kind)).set(float(fit["alpha_s"]))
            COMMBENCH_BETA.labels(str(kind)).set(
                float(fit.get("beta_s_per_byte", 0.0)))
    segs = (doc.get("segments") or {})
    for name, seg in (segs.get("segments") or {}).items():
        try:
            COMMBENCH_SEGMENT.labels(str(name)).set(
                float(seg["s_per_iteration"]))
        except (KeyError, TypeError, ValueError):
            continue


def record_plan_decision(source: str) -> None:
    """One program-selection decision: ``planned`` | ``flag-forced`` |
    ``fallback`` (no-op disarmed)."""
    if not _armed:
        return
    PLAN_DECISIONS.labels(str(source)).inc()


def record_plan_misprediction(ratio: float) -> None:
    """Predicted/measured seconds-per-solve of one planned solve."""
    if not _armed:
        return
    try:
        r = float(ratio)
    except (TypeError, ValueError):
        return
    if r > 0 and math.isfinite(r):
        PLAN_MISPREDICTION.set(r)


def update_resource_gauges() -> None:
    """Refresh RSS and, on a CUDA card, the per-device memory gauges
    (``bytes_in_use``/``peak_bytes_in_use`` from the caching
    allocator's ``allocated_bytes.all``, ``bytes_limit`` the card's
    total); registered as a collect callback so every scrape/flush sees
    fresh values.  The CPU reports none."""
    try:
        with open("/proc/self/statm") as f:
            RSS_BYTES.set(int(f.read().split()[1])
                          * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue   # a device this process never allocated on
        _, total = torch.cuda.mem_get_info(d)
        for kind, value in (
                ("bytes_in_use", stats.get("allocated_bytes.all.current")),
                ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak")),
                ("bytes_limit", total)):
            if value is not None:
                DEVICE_MEMORY.labels(device=str(d), kind=kind).set(value)


# -- sinks ----------------------------------------------------------------

def expose() -> str:
    return REGISTRY.expose()


def snapshot_dict() -> dict:
    return REGISTRY.snapshot()


def write_textfile(path, registry: Registry | None = None) -> None:
    """Atomic textfile flush (write sibling temp + rename): a scraper
    of ``--metrics-file`` output never reads a torn write -- the
    node-exporter textfile-collector contract."""
    reg = registry or REGISTRY
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(reg.expose())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


_flush_path: str | None = None
_flush_installed = False


def _flush_now() -> None:
    if _flush_path is None:
        return
    try:
        write_textfile(_flush_path)
    except OSError as e:
        sys.stderr.write(f"acg-tpu-torch: --metrics-file {_flush_path}: "
                         f"{e}\n")


def install_flush_handlers(path) -> None:
    """Arrange for ``--metrics-file`` to be written on normal exit AND
    on SIGTERM (a soak run killed by an orchestrator must still leave
    its final scrape behind).  The SIGTERM handler chains to whatever
    was installed before it, preserving the prior exit semantics."""
    global _flush_path, _flush_installed
    _flush_path = os.fspath(path)
    if _flush_installed:
        return
    _flush_installed = True
    atexit.register(_flush_now)
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            _flush_now()
            if prev == signal.SIG_IGN:
                return  # the run was ignoring SIGTERM; keep it alive
            if callable(prev) and prev != signal.SIG_DFL:
                prev(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        # not the main thread: atexit still covers the normal path
        pass


def serve(port: int, registry: Registry | None = None):
    """Serve ``GET /metrics`` on a daemon thread (``--metrics-port``):
    stdlib only, bound on all interfaces like every Prometheus
    exporter.  Returns the live server (``.server_address[1]`` is the
    real port -- pass 0 to let the OS pick, the test hook)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or REGISTRY

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 -- stdlib handler contract
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = reg.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes must not spam stderr
            pass

    server = ThreadingHTTPServer(("", int(port)), _Handler)
    t = threading.Thread(target=server.serve_forever,
                         name="acg-metrics", daemon=True)
    t.start()
    return server
