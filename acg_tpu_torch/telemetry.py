"""Solve telemetry: convergence traces, the structured stats document,
phase timing and cross-rank aggregation.

The counterpart of ``acg_tpu/telemetry.py``, with the reference's
schema strings (``acg-tpu-stats/12``, ``acg-tpu-convergence/1``), so the
reference's readers accept the port's documents:

1. **Phase timing**: :class:`PhaseTimer` and :func:`add_timing` feed the
   stats block's ``timings:`` section, the metrics registry's phase
   histogram and the ``--timeline`` spans; :func:`annotate` brackets a
   phase in a ``torch.profiler.record_function("acg:<name>")`` while a
   profiler runs, so ``--trace`` captures carry the phase windows.
2. **In-loop convergence telemetry** (``--convergence-log``): the eager
   loops of :mod:`acg_tpu_torch.solvers.cg` write each iteration's
   ``(||r||^2, alpha, beta, pAp)`` into a ``(capacity, 4)`` device ring
   (:class:`LoopTelemetry`).  The slot is the DEVICE iteration count
   modulo the capacity and the write is masked by the loop's ``live``
   flag, so the frozen steps that run past convergence (the loops read
   their flag once per chunk) leave the ring as it was.  It is fetched
   once, with the result.
3. **Progress heartbeat** (``--progress K``): the iterations that are
   multiples of K record ``(k, ||r||^2)`` into a small device list, and
   the lines print when the loop next reads its convergence flag -- no
   extra device sync per K iterations.
4. **Structured stats sink** (``--stats-json``): :func:`stats_document`,
   the manifest of :func:`run_manifest` (torch, CUDA and the card where
   the reference reports jax), and the cross-rank aggregation gathered
   over :func:`acg_tpu_torch.parallel.erragree.allgather_blobs`.

Everything here is off by default; a disarmed loop builds and writes no
ring and launches nothing more than before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from acg_tpu_torch.solvers.stats import PHASE_ORDER

# the reference's schema strings: the port's documents are read by the
# reference's readers (acg_tpu/telemetry.py:58-118 for what each
# version added)
STATS_SCHEMA = "acg-tpu-stats/12"
CONVERGENCE_SCHEMA = "acg-tpu-convergence/1"
# default ring capacity (--telemetry-window)
DEFAULT_WINDOW = 512
TRACE_FIELDS = ("rnrm2", "alpha", "beta", "pAp")
# the optional 5th ring column: the numerical-health tier's
# true-residual audit gap (NaN on unaudited iterations)
AUDIT_FIELD = "gap"
# a rank whose solve time exceeds this multiple of the median gets the
# straggler callout in the cross-rank report
STRAGGLER_RATIO = 1.2


# -- device-side ring buffer and heartbeat --------------------------------

def ring_init(capacity: int, dtype, device,
              audit: bool = False) -> torch.Tensor:
    """The ring: ``(capacity, 4)`` slots of ``(rnrm2sqr, alpha, beta,
    pAp)`` (``(capacity, 5)`` with the health tier's ``gap`` column when
    ``audit``), NaN-initialised so unwritten slots are detectable
    host-side."""
    width = len(TRACE_FIELDS) + (1 if audit else 0)
    return torch.full((max(int(capacity), 1), width),
                      math.nan, dtype=dtype, device=device)


def ring_record(buf: torch.Tensor, k, rnrm2sqr, alpha, beta, pAp,
                live=None, gap=None) -> None:
    """Write iteration ``k``'s scalars into slot ``k % capacity``, in
    place.  ``k`` is the device iteration count (a one-element tensor)
    or, for a loop with no ``live`` flag, the host step count; ``live``
    (a one-element bool) masks the write, so a frozen step past
    convergence writes the slot's old row back.  ``gap`` fills an
    audited ring's fifth column."""
    vals = (rnrm2sqr, alpha, beta, pAp)
    if buf.shape[1] > len(TRACE_FIELDS):
        vals = vals + (math.nan if gap is None else gap,)
    row = torch.stack([torch.as_tensor(v, device=buf.device).reshape(())
                       .to(buf.dtype) for v in vals])
    if live is None:
        buf[int(k) % buf.shape[0]] = row
        return
    slot = torch.remainder(k, buf.shape[0]).reshape(1)
    old = buf.index_select(0, slot)
    buf.index_copy_(0, slot, torch.where(live, row, old))


class LoopTelemetry:
    """The in-loop telemetry of one program run: the device ring
    (``trace`` slots; 0 = none) and the ``--progress`` heartbeat (every
    ``progress`` iterations; 0 = none), fed by :meth:`step` once per loop
    step and drained by :meth:`flush` where the loop reads its flag.

    A live step's device iteration count equals the host step count (the
    count advances on every live step and the loop freezes for good once
    converged), so the heartbeat's candidate steps are known on the host:
    only those record a ``(k + 1, ||r||^2)`` row, masked by ``live``.
    ``leader`` false (a multi-process rank other than the first) records
    no heartbeat, so a run prints each line once."""

    def __init__(self, trace: int, progress: int, dtype, device,
                 what: str = "cg", leader: bool = True,
                 audit: bool = False):
        self.buf = (ring_init(trace, dtype, device, audit) if trace
                    else None)
        self.progress = int(progress) if leader else 0
        self.what = what
        self._steps = 0
        self._beats: list = []

    def step(self, k, live, rnrm2sqr, alpha, beta, pAp,
             gap=None) -> None:
        """One loop step: ``k`` the device iteration count before the
        step (ignored when ``live`` is None: an unbounded loop's steps
        are all live), the step's scalars as the ring records them
        (``gap``: the audit column of an audited ring)."""
        i = self._steps
        self._steps += 1
        if self.buf is not None:
            ring_record(self.buf, i if live is None else k, rnrm2sqr,
                        alpha, beta, pAp, live=live, gap=gap)
        if self.progress and (i + 1) % self.progress == 0:
            g = torch.as_tensor(rnrm2sqr).reshape(())
            if live is None:
                self._beats.append(torch.stack(
                    [torch.full_like(g, i + 1), g]))
            else:
                row = torch.stack([(k + 1).to(g.dtype), g])
                self._beats.append(torch.where(
                    live, row, torch.full_like(row, math.nan)))

    def beat(self, k_next, rnrm2sqr, mask) -> None:
        """A heartbeat row of a loop whose device count is not its host
        step count (the communication-avoiding recurrences): ``(k_next,
        ||r||^2)`` where the one-element bool ``mask`` holds -- the loop
        computes it from its device count -- NaN otherwise."""
        if not self.progress:
            return
        g = torch.as_tensor(rnrm2sqr).reshape(())
        row = torch.stack([torch.as_tensor(k_next).reshape(()).to(g.dtype),
                           g])
        self._beats.append(torch.where(mask, row,
                                       torch.full_like(row, math.nan)))

    def flush(self) -> None:
        """Print the heartbeat lines recorded since the last flush (one
        small device-to-host copy; nothing when none was recorded)."""
        if not self._beats:
            return
        rows = torch.stack(self._beats).to(torch.float64).cpu().tolist()
        self._beats = []
        from acg_tpu_torch import observatory
        for it, g in rows:
            if math.isfinite(it):
                sys.stderr.write(observatory.heartbeat_line(
                    self.what, int(it), math.sqrt(max(g, 0.0))) + "\n")
        sys.stderr.flush()

    def ring(self) -> np.ndarray | None:
        """The ring on the host (the one fetch of a traced solve)."""
        if self.buf is None:
            return None
        return self.buf.to(torch.float64).cpu().numpy()


class BatchedLoopTelemetry:
    """The in-loop telemetry of a batched run (``acg_tpu/solvers/
    batched.py:252-253``, ``acg_tpu/parallel/dist_batched.py:610``): a
    ``(capacity, nrhs)`` device ring of each loop iteration's per-RHS
    ``||r_j||^2``, written in the slot of the loop's device iteration
    count and masked by its any-column-live flag, so the frozen steps
    past the last column's convergence leave it as it was; and a
    heartbeat of the worst column at the iterations on the period,
    printed where the loop reads its flag.  The reference refuses
    ``--progress`` on this tier; the port prints the worst column."""

    def __init__(self, trace: int, progress: int, nrhs: int, dtype,
                 device, what: str = "cg-batched", leader: bool = True):
        self.buf = (torch.full((max(int(trace), 1), max(int(nrhs), 1)),
                               math.nan, dtype=dtype, device=device)
                    if trace else None)
        self.progress = int(progress) if leader else 0
        self.what = what
        self._steps = 0
        self._beats: list = []

    def step(self, k, live, rnrm2sqr_cols) -> None:
        """One loop step: ``k`` the device iteration count before the
        step (the host step count when ``live`` is None), the columns'
        ``||r||^2`` after it."""
        i = self._steps
        self._steps += 1
        cols = rnrm2sqr_cols.reshape(-1)
        if self.buf is not None:
            cols_b = cols.to(self.buf.dtype).reshape(1, -1)
            if live is None:
                self.buf[i % self.buf.shape[0]] = cols_b[0]
            else:
                slot = torch.remainder(k, self.buf.shape[0]).reshape(1)
                old = self.buf.index_select(0, slot)
                self.buf.index_copy_(0, slot, torch.where(live, cols_b,
                                                          old))
        if self.progress:
            kk = (torch.full((), i, device=cols.device) if live is None
                  else k)
            worst = torch.max(cols)
            row = torch.stack([(kk + 1).to(worst.dtype), worst])
            on = (kk + 1) % self.progress == 0
            if live is not None:
                on = on & live
            self._beats.append(torch.where(on, row,
                                           torch.full_like(row, math.nan)))

    flush = LoopTelemetry.flush

    def ring(self) -> np.ndarray | None:
        if self.buf is None:
            return None
        return self.buf.to(torch.float64).cpu().numpy()


# -- host-side trace representation -------------------------------------

@dataclasses.dataclass
class ConvergenceTrace:
    """The host view of one solve attempt's in-loop telemetry.

    ``records`` is ``(m, 4)`` float64 ``(rnrm2, alpha, beta, pAp)`` --
    note rnrm2 is the NORM (the square root is applied here, once,
    instead of per-iteration on device) -- and ``iterations`` the
    0-based iteration index of each row, contiguous and ascending.
    ``wrapped`` marks a ring that overwrote its oldest rows: only the
    trailing ``capacity`` iterations survive (truncation, marked in the
    JSONL meta record).  ``fields`` names the record columns -- rings
    carrying the numerical-health audit column append ``"gap"``
    (relative true-residual gap on audited iterations, NaN elsewhere),
    and the JSONL meta line carries the same list so mixed
    audited/unaudited windows round-trip without misaligned fields."""

    capacity: int
    niterations: int
    records: np.ndarray
    iterations: np.ndarray
    wrapped: bool
    solver: str = "cg"
    fields: tuple = TRACE_FIELDS
    # extra meta-line keys (additive; e.g. the active commbench
    # calibration id the CLI stamps on the JSONL meta record)
    meta_extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_ring(cls, buf, niterations: int, solver: str = "cg",
                  already_norm: bool = False,
                  offset: int = 0) -> "ConvergenceTrace":
        """Un-rotate a fetched ring buffer: slot ``k % capacity`` holds
        iteration ``k``, so the surviving window is iterations
        ``[max(0, n - capacity), n)``.  The column names come from the
        ring's width (4 = the classic tuple, 5 = + the audit column).
        ``offset`` (the checkpoint chunk drivers) renumbers the window
        to TRAJECTORY iterations: the ring held chunk-local indices,
        and iterations before the chunk are marked truncated exactly
        like a wrapped ring's."""
        buf = np.asarray(buf, dtype=np.float64)
        cap = int(buf.shape[0])
        fields = tuple(TRACE_FIELDS) + (
            (AUDIT_FIELD,) if buf.shape[1] > len(TRACE_FIELDS) else ())
        n = int(niterations)
        off = int(offset)
        m = min(n, cap)
        its = np.arange(n - m, n, dtype=np.int64)
        rows = buf[its % cap] if m else buf[:0]
        rows = np.array(rows, copy=True)
        if m and not already_norm:
            # stored squared (saves the per-iteration device sqrt);
            # NaN/Inf propagate through sqrt unchanged, and a poisoned
            # negative "norm" must stay visibly wrong, not become NaN
            g = rows[:, 0]
            rows[:, 0] = np.where(g >= 0, np.sqrt(np.abs(g)), g)
        return cls(capacity=cap, niterations=n + off, records=rows,
                   iterations=its + off, wrapped=n > cap or off > 0,
                   solver=solver, fields=fields)

    @property
    def first_iteration(self) -> int:
        return int(self.iterations[0]) if self.iterations.size else 0

    def to_dict(self) -> dict:
        """JSON-able form (the ``trace`` key of
        :meth:`SolverStats.to_dict`); record dicts are identical to the
        JSONL data lines, so the two sinks round-trip."""
        return {
            "schema": CONVERGENCE_SCHEMA,
            "solver": self.solver,
            "capacity": self.capacity,
            "niterations": self.niterations,
            "first_iteration": self.first_iteration,
            "wrapped": self.wrapped,
            "fields": list(self.fields),
            **dict(self.meta_extra),
            "records": [self.record_dict(i)
                        for i in range(self.iterations.size)],
        }

    def record_dict(self, i: int) -> dict:
        rec = {"it": int(self.iterations[i])}
        for j, f in enumerate(self.fields):
            rec[f] = _json_float(self.records[i, j])
        return rec

    def write_jsonl(self, f) -> None:
        """One meta line (wrap/truncation marked), then one record per
        surviving iteration."""
        own = isinstance(f, (str, bytes)) or hasattr(f, "__fspath__")
        out = open(f, "w") if own else f
        try:
            meta = self.to_dict()
            records = meta.pop("records")
            meta = {"meta": True, **meta}
            if self.wrapped:
                meta["truncated_before"] = self.first_iteration
            out.write(json.dumps(meta) + "\n")
            for rec in records:
                out.write(json.dumps(rec) + "\n")
        finally:
            if own:
                out.close()

    def tail_summary(self, n: int = 5) -> str:
        """The trailing residual window as one human line -- what the
        recovery driver logs next to a breakdown/restart event.  When
        the audit column is present each audited entry carries its gap
        inline, and the line says so -- a reader of a mixed window must
        never mistake audit gaps for residuals."""
        m = min(int(n), self.iterations.size)
        if not m:
            return "trailing residual window: (empty)"
        audited = AUDIT_FIELD in self.fields
        gi = self.fields.index(AUDIT_FIELD) if audited else None
        parts = []
        for i in range(m):
            row = self.records[-m + i]
            s = f"it {int(self.iterations[-m + i])}: {row[0]:.3e}"
            if audited and math.isfinite(row[gi]):
                s += f" (gap {row[gi]:.3e})"
            parts.append(s)
        line = "trailing residual window: " + ", ".join(parts)
        if audited:
            line += " [audit gap column present]"
        return line


@dataclasses.dataclass
class BatchedConvergenceTrace:
    """Host view of a batched solve's per-RHS residual ring.

    ``records`` is ``(m, nrhs)`` float64 of per-RHS residual NORMS
    (sqrt applied here, once); ``iterations`` the 0-based iteration of
    each row.  The JSONL form declares ``nrhs`` in its meta line and
    each data record carries the full residual column plus the
    worst-RHS value, so :mod:`scripts/plot_convergence` can render the
    residual fan and ascii consumers can fall back to the worst RHS."""

    capacity: int
    niterations: int
    nrhs: int
    records: np.ndarray
    iterations: np.ndarray
    wrapped: bool
    solver: str = "cg-batched"
    # extra meta-line keys (the ConvergenceTrace convention)
    meta_extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_ring(cls, buf, niterations: int,
                  solver: str = "cg-batched",
                  offset: int = 0) -> "BatchedConvergenceTrace":
        buf = np.asarray(buf, dtype=np.float64)
        cap, nrhs = int(buf.shape[0]), int(buf.shape[1])
        n = int(niterations)
        off = int(offset)
        m = min(n, cap)
        its = np.arange(n - m, n, dtype=np.int64)
        rows = np.array(buf[its % cap] if m else buf[:0], copy=True)
        if m:
            rows = np.where(rows >= 0, np.sqrt(np.abs(rows)), rows)
        return cls(capacity=cap, niterations=n + off, nrhs=nrhs,
                   records=rows, iterations=its + off,
                   wrapped=n > cap or off > 0, solver=solver)

    @property
    def first_iteration(self) -> int:
        return int(self.iterations[0]) if self.iterations.size else 0

    def worst_per_iteration(self) -> np.ndarray:
        """(m,) worst-RHS residual per recorded iteration -- what the
        ascii sparkline and the status-trail consumers fall back to."""
        if not self.records.size:
            return self.records.reshape(0)
        return np.nanmax(self.records, axis=1)

    def to_dict(self) -> dict:
        return {
            "schema": CONVERGENCE_SCHEMA,
            "solver": self.solver,
            "capacity": self.capacity,
            "niterations": self.niterations,
            "first_iteration": self.first_iteration,
            "wrapped": self.wrapped,
            "nrhs": self.nrhs,
            "fields": ["rnrm2"],
            **dict(self.meta_extra),
            "records": [self.record_dict(i)
                        for i in range(self.iterations.size)],
        }

    def record_dict(self, i: int) -> dict:
        cols = [_json_float(v) for v in self.records[i]]
        finite = [v for v in self.records[i] if math.isfinite(v)]
        return {"it": int(self.iterations[i]), "rnrm2": cols,
                "worst": _json_float(max(finite) if finite
                                     else float("nan"))}

    def write_jsonl(self, f) -> None:
        own = isinstance(f, (str, bytes)) or hasattr(f, "__fspath__")
        out = open(f, "w") if own else f
        try:
            meta = self.to_dict()
            records = meta.pop("records")
            meta = {"meta": True, **meta}
            if self.wrapped:
                meta["truncated_before"] = self.first_iteration
            out.write(json.dumps(meta) + "\n")
            for rec in records:
                out.write(json.dumps(rec) + "\n")
        finally:
            if own:
                out.close()

    def tail_summary(self, n: int = 5) -> str:
        worst = self.worst_per_iteration()
        m = min(int(n), self.iterations.size)
        if not m:
            return "trailing residual window: (empty)"
        parts = [f"it {int(self.iterations[-m + i])}: "
                 f"{worst[-m + i]:.3e} (worst of {self.nrhs})"
                 for i in range(m)]
        return "trailing residual window: " + ", ".join(parts)


class EagerTraceRecorder:
    """The eager twin of the device ring for the host solver: same
    capacity/wrap semantics, recorded per iteration in plain Python.
    ``audit=True`` mirrors the health tier's 5-column ring (gap column,
    NaN on unaudited iterations)."""

    def __init__(self, capacity: int, solver: str = "host-cg",
                 audit: bool = False):
        self.capacity = max(int(capacity), 1)
        self.solver = solver
        self.audit = bool(audit)
        self._rows: list = [None] * self.capacity
        self._n = 0

    def record(self, rnrm2: float, alpha: float, beta: float,
               pAp: float, gap: float = math.nan) -> None:
        row = (float(rnrm2), float(alpha), float(beta), float(pAp))
        if self.audit:
            row = row + (float(gap),)
        self._rows[self._n % self.capacity] = row
        self._n += 1

    def finish(self) -> ConvergenceTrace:
        n, cap = self._n, self.capacity
        width = len(TRACE_FIELDS) + (1 if self.audit else 0)
        fields = tuple(TRACE_FIELDS) + ((AUDIT_FIELD,) if self.audit
                                        else ())
        m = min(n, cap)
        its = np.arange(n - m, n, dtype=np.int64)
        rows = np.asarray([self._rows[k % cap] for k in its],
                          dtype=np.float64).reshape(m, width)
        return ConvergenceTrace(capacity=cap, niterations=n, records=rows,
                                iterations=its, wrapped=n > cap,
                                solver=self.solver, fields=fields)


def read_convergence_log(path) -> tuple[dict, list[dict]]:
    """Parse a ``--convergence-log`` JSONL file back into
    ``(meta, records)`` -- the inverse of :meth:`write_jsonl`, shared by
    the tests and ``scripts/plot_convergence.py``.

    A TRUNCATED TRAILING line (a SIGTERM/OOM-kill landing mid-write --
    exactly the runs whose telemetry matters most) yields the parseable
    prefix with ``meta["truncated"] = True`` instead of raising; a
    malformed line with valid JSON after it is still an error (that is
    corruption, not truncation)."""
    meta: dict = {}
    records: list[dict] = []
    with open(path) as f:
        lines = f.read().split("\n")
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            if any(later.strip() for later in lines[i + 1:]):
                raise
            meta["truncated"] = True
            break
        if obj.get("meta"):
            meta = obj
        else:
            records.append(obj)
    return meta, records


def _json_float(v) -> float | str:
    """JSON has no NaN/Inf literal; poisoned telemetry values must
    survive the round trip as strings, not crash the writer."""
    v = float(v)
    if math.isfinite(v):
        return v
    return repr(v)


# -- phase timing + trace annotations -----------------------------------

class PhaseTimer:
    """Wall-clock seconds per pipeline phase (ingest -> partition ->
    transfer -> compile -> solve -> writeback), accumulated across
    retries; each phase also lands on the metrics registry's phase
    histogram and as a ``--timeline`` span ending now."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)
        from acg_tpu_torch import metrics, tracing
        metrics.record_phase(name, seconds)
        tracing.record_phase_span(name, seconds)

    def merge_into(self, timings: dict) -> dict:
        """Fold these phases into a stats ``timings`` dict, re-ordered
        so the canonical pipeline order survives whichever side recorded
        first.  CONSUMES the timer's phases, so repeated folds
        accumulate instead of double-counting."""
        merged = dict(timings)
        for k, v in self.phases.items():
            merged[k] = merged.get(k, 0.0) + v
        self.phases.clear()
        ordered = {k: merged[k] for k in PHASE_ORDER if k in merged}
        ordered.update({k: v for k, v in merged.items()
                        if k not in ordered})
        timings.clear()
        timings.update(ordered)
        return timings


@contextlib.contextmanager
def annotate(name: str):
    """A ``torch.profiler.record_function("acg:<name>")`` bracket while a
    profiler runs (nothing otherwise: no op is recorded outside a
    capture).  Also feeds the status document's current phase."""
    from acg_tpu_torch import observatory
    observatory.note_phase(name)
    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(f"acg:{name}"):
        yield


def add_timing(stats, name: str, seconds: float) -> None:
    """Accumulate one phase's seconds onto ``stats.timings``."""
    stats.timings[name] = stats.timings.get(name, 0.0) + float(seconds)
    from acg_tpu_torch import metrics, tracing
    metrics.record_phase(name, seconds)
    tracing.record_phase_span(name, seconds)


def record_event(stats, kind: str, detail: str) -> None:
    """Append one timestamped event for the structured sink; it also
    bumps ``acg_events_total``, lands as an instant on the timeline and
    on the status document (each a no-op disarmed)."""
    stats.events.append({"t": time.time(), "kind": kind,
                         "detail": str(detail)})
    from acg_tpu_torch import metrics, observatory, tracing
    metrics.record_event_kind(kind)
    tracing.record_instant(kind, detail=str(detail))
    observatory.note_event(kind, str(detail))


# -- structured stats sink ----------------------------------------------

def run_manifest(**extra) -> dict:
    """The run manifest of a ``--stats-json`` document: backend, device
    and process layout, torch and CUDA versions, plus caller-supplied
    keys (matrix id, solver/kernel/comm choices, partition sizes)."""
    from acg_tpu_torch.parallel import multihost

    man: dict = {"schema": STATS_SCHEMA,
                 "unix_time": time.time()}
    man["torch"] = torch.__version__
    man["cuda"] = torch.version.cuda
    man["process_index"] = multihost.process_index()
    man["process_count"] = multihost.process_count()
    try:
        if torch.cuda.is_available():
            man["backend"] = {
                "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(
                    torch.cuda.current_device()),
                "ndevices": torch.cuda.device_count()}
        else:
            man["backend"] = {"platform": "cpu", "device_kind": "cpu",
                              "ndevices": 1}
    except RuntimeError as e:   # a driver that cannot be queried
        man["backend"] = f"unavailable ({type(e).__name__})"
    from acg_tpu_torch import __version__
    man["acg_tpu_torch"] = __version__
    man.update({k: v for k, v in extra.items() if v is not None})
    return man


def stats_document(stats, manifest: dict | None = None,
                   ranks: dict | None = None) -> dict:
    """The full ``--stats-json`` document: schema + manifest + the
    machine-readable twin of ``fwrite`` (+ the cross-rank aggregation
    when gathered, + the metrics registry snapshot when armed)."""
    doc = {"schema": STATS_SCHEMA,
           "manifest": manifest or run_manifest(),
           "stats": stats.to_dict()}
    if ranks is not None:
        doc["ranks"] = ranks
    from acg_tpu_torch import metrics
    if metrics.armed():
        doc["metrics"] = metrics.snapshot_dict()
    return doc


def write_stats_json(path, stats, manifest: dict | None = None,
                     ranks: dict | None = None,
                     append: bool = False) -> dict:
    """Write (or with ``append``, JSONL-append) the structured stats
    document.  Returns the document."""
    doc = stats_document(stats, manifest=manifest, ranks=ranks)
    own = isinstance(path, (str, bytes)) or hasattr(path, "__fspath__")
    f = open(path, "a" if append else "w") if own else path
    try:
        json.dump(doc, f, indent=None if append else 2, sort_keys=False,
                  default=str)
        f.write("\n")
    finally:
        if own:
            f.close()
    return doc


# -- cross-rank aggregation ---------------------------------------------

def rank_payload(solver) -> dict:
    """This process's contribution to the cross-rank report: solve
    time, iteration count, and per-OWNED-part rows, nnz and halo send
    bytes where a partitioned problem exists."""
    from acg_tpu_torch.parallel import multihost

    st = solver.stats
    payload = {"process": int(multihost.process_index()),
               "tsolve": float(st.tsolve),
               "niterations": int(st.niterations)}
    prob = getattr(solver, "problem", None)
    if prob is not None:
        dbl = torch.empty((), dtype=prob.vdtype).element_size()
        parts = []
        owned = (range(prob.nparts) if prob.owned_parts is None
                 else prob.owned_parts)
        for p in owned:
            s = prob.subs[p]
            if s is None or getattr(s, "A_local", None) is None:
                continue
            halo = getattr(s, "halo", None)
            parts.append({
                "part": int(p),
                "rows": int(s.nowned),
                "nnz": int(s.A_local.nnz
                           + (s.A_ghost.nnz if s.A_ghost is not None
                              else 0)),
                "halo_send_bytes": int(halo.total_send * dbl
                                       if halo is not None else 0),
            })
        payload["parts"] = parts
    return payload


def gather_rank_stats(payload: dict, timeout: float = 120.0
                      ) -> list[dict] | None:
    """Allgather each process's payload dict over the store
    (:func:`~acg_tpu_torch.parallel.erragree.allgather_blobs`).  Every
    process must call this at the same point.  Returns one dict per
    process, or None when the gather failed (warned, not raised: a
    failed gather must not take down a solve that succeeded)."""
    from acg_tpu_torch.parallel import multihost

    if multihost.process_count() == 1:
        return [payload]
    from acg_tpu_torch.parallel.erragree import allgather_blobs

    try:
        blobs = allgather_blobs(json.dumps(payload, default=str),
                                tag="telemetry", timeout=timeout)
    except Exception as e:  # noqa: BLE001 -- aggregation is best-effort
        sys.stderr.write(f"acg-tpu-torch: cross-rank stats gather failed "
                         f"({type(e).__name__}); skipping aggregation\n")
        return None
    return [json.loads(b) for b in blobs]


def aggregate_ranks(payloads: list[dict]) -> dict:
    """min/median/max solve time, per-part rows/nnz/halo-bytes imbalance
    (max over mean), and the straggler callout -- the evidence the
    communication-reduced-variant literature asks for, per pod."""
    ts = sorted((float(p.get("tsolve", 0.0)), int(p.get("process", i)))
                for i, p in enumerate(payloads))
    times = [t for t, _ in ts]
    med = float(np.median(times)) if times else 0.0
    agg: dict = {
        "processes": len(payloads),
        "solve_time": {"min": times[0] if times else 0.0,
                       "median": med,
                       "max": times[-1] if times else 0.0},
    }
    parts = [pt for p in payloads for pt in p.get("parts", [])]
    if parts:
        imb = {}
        for key in ("rows", "nnz", "halo_send_bytes"):
            vals = np.asarray([pt.get(key, 0) for pt in parts],
                              dtype=np.float64)
            mean = float(vals.mean()) if vals.size else 0.0
            imb[key] = {"max": float(vals.max(initial=0.0)),
                        "mean": mean,
                        "imbalance": (float(vals.max(initial=0.0) / mean)
                                      if mean > 0 else 1.0)}
        agg["parts"] = {"count": len(parts), "imbalance": imb}
    straggler = None
    if times and med > 0 and times[-1] > STRAGGLER_RATIO * med:
        straggler = {"process": ts[-1][1], "tsolve": times[-1],
                     "ratio_to_median": times[-1] / med}
    agg["straggler"] = straggler
    return agg


def format_rank_report(agg: dict) -> str:
    """One stderr line from the primary summarising the aggregation."""
    st = agg["solve_time"]
    line = (f"cross-rank: {agg['processes']} processes, solve time "
            f"min/median/max {st['min']:.6f}/{st['median']:.6f}/"
            f"{st['max']:.6f} s")
    parts = agg.get("parts")
    if parts:
        imb = parts["imbalance"]
        line += (f"; imbalance (max/mean) rows {imb['rows']['imbalance']:.2f}"
                 f" nnz {imb['nnz']['imbalance']:.2f}"
                 f" halo-bytes {imb['halo_send_bytes']['imbalance']:.2f}")
    s = agg.get("straggler")
    if s:
        line += (f"; straggler: process {s['process']} "
                 f"({s['ratio_to_median']:.2f}x median)")
    return line
