"""Request-scoped observability for the solver service: the request
observatory (the counterpart of ``acg_tpu/reqtrace.py``).

Every earlier observability tier (telemetry rings, ``--timeline`` spans,
the status document, SLO burn) is solve-scoped: one CLI invocation, one
attribution.  The ``--serve`` daemon answers requests, and a request's
latency is paid across stages no solve-scoped plane sees -- admission,
queue wait, the coalesce window, cache lookups, an absorbed warm-up,
its share of a batched solve, demux, and the handoff back to the
waiting client.  This module is the per-request ledger of exactly that:

* **identity** -- every request resolves to a stable ``request_id``
  (client-supplied ``request_id`` field, the trace-id of a W3C
  ``traceparent``, or generated), echoed in the response body, every
  structured event on the failure path, and the chaos campaign's
  verification rows.

* **stages** -- :class:`RequestRecord` accumulates per-stage seconds
  (:data:`STAGES`), feeds the ``acg_serve_stage_seconds{stage}``
  histogram, and drops ``cat="request"`` spans on the
  :mod:`acg_tpu_torch.tracing` recorder so ``--serve --timeline``
  renders the service timeline: the worker's batch row plus one lane
  per in-flight request window.

* **ledger** -- :class:`RequestLog` appends one ``acg-tpu-access/1``
  JSONL row per completed request (``--access-log FILE``; a single
  ``os.write`` on an ``O_APPEND`` fd, so concurrent completions never
  interleave bytes), keeps the last-K completed documents for ``GET
  /requests``, and tracks in-flight lanes + outcome tallies for the
  ``requests:`` status block.

Host-side stdlib bookkeeping only: nothing here touches the solver's
tensors or kernels, so the daemon launches the same kernels and returns
the same bits with the observatory armed or not (pinned in
tests/test_torch_serve.py).
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import threading
import time

ACCESS_SCHEMA = "acg-tpu-access/1"
REQUESTS_SCHEMA = "acg-serve-requests/1"

# the per-request stage vocabulary, in service order: admission checks,
# queue residency, the coalesce window, operator/program cache lookups,
# the absorbed compile, this request's share of the (possibly batched)
# solve, per-request demux, and the worker->submitter handoff
STAGES = ("admit", "queue-wait", "coalesce", "cache", "compile",
          "solve", "demux", "respond")

# terminal outcomes (the ledger's enum; shed-* is a closed family)
OUTCOMES = ("ok", "shed-queue-full", "shed-slo-burn", "shed-shutdown",
            "deadline-expired", "request-failed", "invalid-request")

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}$")
# client-supplied ids: printable ASCII, no whitespace, bounded -- an id
# rides log lines, JSONL rows and trace args verbatim
_ID_RE = re.compile(r"^[\x21-\x7e]{1,128}$")


def parse_traceparent(value) -> str | None:
    """The 32-hex trace-id out of a W3C ``traceparent`` value
    (``00-<trace-id>-<parent-id>-<flags>``), or ``None``."""
    m = _TRACEPARENT_RE.match(str(value or "").strip().lower())
    return m.group(1) if m else None


def generate_request_id() -> str:
    return "req-" + os.urandom(8).hex()


def request_id_from_doc(doc) -> str:
    """Resolve one POST /solve body's request identity: a well-formed
    client ``request_id`` wins, else the trace-id of a ``traceparent``,
    else a generated ``req-...``.  A malformed client id is IGNORED,
    not refused -- identity must never cost a request its answer."""
    if isinstance(doc, dict):
        rid = doc.get("request_id")
        if isinstance(rid, str) and _ID_RE.match(rid):
            return rid
        tid = parse_traceparent(doc.get("traceparent"))
        if tid:
            return tid
    return generate_request_id()


def outcome_of(body) -> str:
    """Map a serve response body to its ledger outcome: green is
    ``ok``, admission/deadline refusals keep their typed kind, request
    validation collapses to ``invalid-request``, and every other typed
    error -- breakdown, non-convergence, the isolation boundary -- is
    ``request-failed``."""
    if isinstance(body, dict):
        if body.get("ok"):
            return "ok"
        kind = str((body.get("error") or {}).get("type") or "")
        if kind.startswith("shed-") or kind == "deadline-expired":
            return kind
        if kind in ("invalid-request", "faults-disabled"):
            return "invalid-request"
    return "request-failed"


class RequestRecord:
    """One request's observability state: per-stage seconds, the
    provenance notes (cache/coalesce/degrade/plan/batch), and the
    timeline lane it occupies while in flight.  The submitter thread
    and the worker both mutate it; every mutation and snapshot rides
    the record lock, and a completed record is frozen (the submit
    waiter and the worker can race at the deadline boundary)."""

    def __init__(self, request_id: str, matrix=None):
        self.request_id = str(request_id)
        self.id: int | None = None
        self.matrix = matrix
        self.arrival = time.monotonic()
        self.lane: int | None = None
        self.outcome: str | None = None
        self._lock = threading.Lock()
        self._stages: collections.OrderedDict = collections.OrderedDict()
        self._notes: dict = {}
        self._row: dict | None = None
        self._done = False

    def stage(self, name: str, seconds: float, t1: float | None = None,
              **attrs) -> None:
        """Account ``seconds`` to stage ``name`` (accumulating), feed
        the ``acg_serve_stage_seconds`` histogram, and drop a
        ``cat="request"`` span on this request's timeline lane.  ``t1``
        is the stage's wall-clock end (``time.time()``); defaults to
        now -- the span recorder wants epoch endpoints, the ledger only
        the duration."""
        from acg_tpu_torch import metrics, tracing
        sec = max(float(seconds), 0.0)
        with self._lock:
            if self._done:
                return
            self._stages[name] = self._stages.get(name, 0.0) + sec
        metrics.record_serve_stage(name, sec)
        end = float(t1) if t1 is not None else time.time()
        tracing.record_span(str(name), end - sec, end, cat="request",
                            lane=self.lane, request=self.request_id,
                            **attrs)

    def note(self, key: str, value) -> None:
        """Attach provenance (cache verdicts, batch membership, plan
        source, ...) that rides the ledger row and /requests doc."""
        with self._lock:
            if not self._done:
                self._notes[key] = value

    def stages(self) -> dict:
        with self._lock:
            return dict(self._stages)

    def doc(self) -> dict:
        """The /requests document: the sealed ledger row for a
        completed request, a live snapshot (so-far stages + lane) for
        an in-flight one."""
        with self._lock:
            if self._row is not None:
                return dict(self._row)
            d = {"request_id": self.request_id, "id": self.id,
                 "matrix": self.matrix, "inflight": True,
                 "lane": self.lane,
                 "wall_seconds_so_far":
                     round(max(time.monotonic() - self.arrival, 0.0), 6),
                 "stages": {k: round(v, 6)
                            for k, v in self._stages.items()}}
            for key in ("cache", "coalesced", "degraded", "plan",
                        "batch"):
                if key in self._notes:
                    d[key] = self._notes[key]
            return d


class RequestLog:
    """The daemon's request registry + access ledger: assigns timeline
    lanes to in-flight requests, keeps a bounded ring of completed
    request documents (``GET /requests``), tallies outcomes, and
    appends one atomic ``acg-tpu-access/1`` JSONL row per completed
    request."""

    def __init__(self, path: str | None = None, ring: int = 64):
        self.path = path
        self._lock = threading.Lock()
        self._inflight: dict[int, RequestRecord] = {}
        self._completed: collections.deque = collections.deque(
            maxlen=max(int(ring), 1))
        self._outcomes: collections.Counter = collections.Counter()
        self._last_done = 0.0
        self._fd: int | None = None
        if path:
            self._fd = os.open(path, os.O_APPEND | os.O_CREAT
                               | os.O_WRONLY, 0o644)

    def begin(self, request_id: str, matrix=None) -> RequestRecord:
        """Open a record: assign the lowest free timeline lane and
        register it in flight."""
        from acg_tpu_torch import metrics
        rec = RequestRecord(request_id, matrix=matrix)
        with self._lock:
            lanes = {r.lane for r in self._inflight.values()}
            lane = 0
            while lane in lanes:
                lane += 1
            rec.lane = lane
            self._inflight[id(rec)] = rec
            n = len(self._inflight)
        metrics.record_serve_inflight(n)
        return rec

    def complete(self, rec: RequestRecord, outcome: str) -> dict | None:
        """Seal ``rec``: freeze its stages, free the lane, move it to
        the completed ring, tally the outcome, and append the ledger
        row in ONE ``os.write`` (atomic for an O_APPEND fd -- rows from
        racing completions never interleave).  Ledger ``t_done`` stamps
        are strictly increasing in file order; ``t_arrival`` is derived
        as ``t_done - wall`` so every row is self-consistent.
        Idempotent: the first completion wins; returns the row (or
        ``None`` on the losing side of the race)."""
        from acg_tpu_torch import metrics
        with rec._lock:
            if rec._done:
                return None
            rec._done = True
            rec.outcome = str(outcome)
            stages = {k: round(float(v), 6)
                      for k, v in rec._stages.items()}
            notes = dict(rec._notes)
        wall = max(time.monotonic() - rec.arrival, 0.0)
        row = {"schema": ACCESS_SCHEMA, "request_id": rec.request_id,
               "id": rec.id, "matrix": rec.matrix,
               "outcome": rec.outcome,
               "wall_seconds": round(wall, 6), "stages": stages}
        for key in ("cache", "coalesced", "degraded", "plan", "batch"):
            if key in notes:
                row[key] = notes[key]
        with self._lock:
            t_done = time.time()
            if t_done <= self._last_done:
                t_done = self._last_done + 1e-6
            self._last_done = t_done
            row["t_done"] = round(t_done, 6)
            row["t_arrival"] = round(t_done - wall, 6)
            with rec._lock:
                rec._row = row
            self._inflight.pop(id(rec), None)
            self._completed.append(rec)
            self._outcomes[rec.outcome] += 1
            n = len(self._inflight)
            if self._fd is not None:
                try:
                    os.write(self._fd,
                             (json.dumps(row) + "\n").encode())
                except OSError as e:
                    sys.stderr.write(f"acg-tpu-torch: --access-log "
                                     f"{self.path}: {e}\n")
        metrics.record_serve_inflight(n)
        return row

    def snapshot(self) -> dict:
        """The ``GET /requests`` document: last-K completed rows plus
        the current in-flight snapshots.  Membership is captured under
        the registry lock, each document under its record lock -- a
        reader under load sees a consistent (never torn) view."""
        with self._lock:
            inflight = list(self._inflight.values())
            completed = list(self._completed)
            outcomes = dict(self._outcomes)
        return {"schema": REQUESTS_SCHEMA,
                "inflight": [r.doc() for r in inflight],
                "completed": [r.doc() for r in completed],
                "outcomes": outcomes}

    def summary(self) -> dict:
        """The status document's ``requests:`` block."""
        with self._lock:
            return {"inflight": len(self._inflight),
                    "completed": sum(self._outcomes.values()),
                    "ring": int(self._completed.maxlen or 0),
                    "outcomes": dict(self._outcomes),
                    "access_log": self.path}

    def close(self) -> None:
        with self._lock:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
