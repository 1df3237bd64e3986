"""Timeline tracing: the cross-rank span timeline, profiler-capture
analysis, measured overlap and straggler attribution.

The counterpart of ``acg_tpu/tracing.py``, on ``torch.profiler``:

1. **Cross-rank span timeline** (``--timeline FILE``): a host-side span
   recorder fed by the phase timer and the telemetry events, gathered
   across processes over the store
   (:func:`~acg_tpu_torch.parallel.erragree.allgather_blobs`) with a
   barrier-timestamp clock alignment (each rank's ``time.time()`` right
   after one barrier), and exported as Chrome trace-event JSON with the
   reference's schema (``acg-tpu-timeline/1``) -- one pid per part.
2. **Profiler captures** (``--trace DIR``): :func:`profiler_trace` runs
   ``torch.profiler.profile`` (CPU activity, plus CUDA activity on the
   card) around the solve and writes ``<process>.trace.json.gz`` under
   DIR.  :func:`analyze_trace` parses it into per-op-class device
   seconds inside the ``acg:solve`` windows, an overlap-efficiency
   score and a per-rank straggler split.  The port's own CUDA kernels
   are classified by name (K1/K7 ``gemv``, the per-part dot ``dot``, K6
   ``halo`` of kind ``dma``, K3/K4/K5 ``fusion``), as are cuBLAS and
   ATen reductions (``dot``) and NCCL collectives; host collectives
   that leave no device event (gloo) are bracketed as ``psum`` /
   ``halo_exchange`` spans while a capture runs (:func:`host_span`).
   Host operator events (``cpu_op``, the CUDA runtime calls) and the
   device twin of each annotation are never counted, so no op is
   counted twice.
3. **Surfaces**: the ``tracing:`` stats section, ``acg_trace_*``
   metric families, and the reference's ``scripts/trace_report.py`` /
   ``scripts/check_timeline.py`` readers.

Everything is off by default; the recorder is host-side bookkeeping.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import math
import os
import re
import shutil
import sys
import threading
import time

import torch

TIMELINE_SCHEMA = "acg-tpu-timeline/1"

# a rank (or device line) whose per-phase seconds exceed this multiple
# of the median gets the straggler callout -- THE ratio the cross-rank
# stats aggregation uses, imported so the two callouts can never
# disagree on who is a straggler
from acg_tpu_torch.telemetry import STRAGGLER_RATIO  # noqa: E402

# span categories -> Chrome trace tid (one named row per category, so
# chunk spans never pretend to nest inside the solve phase bracket and
# instants get their own track)
_TID_PHASES, _TID_CHUNKS, _TID_EVENTS = 1, 2, 3
# the solver service's request observatory: the worker's batch spans
# ride one row, and each in-flight request window rides its own lane
# (tid = _TID_REQUEST_BASE + lane, lane assigned by reqtrace)
_TID_WORKER = 4
_TID_REQUEST_BASE = 10
_CAT_TIDS = {"phase": _TID_PHASES, "chunk": _TID_CHUNKS,
             "ckpt": _TID_CHUNKS, "event": _TID_EVENTS,
             "worker": _TID_WORKER, "request": _TID_REQUEST_BASE}

# -- the span recorder ---------------------------------------------------

_lock = threading.Lock()
_armed = False
_spans: list[dict] = []
_instants: list[dict] = []


def arm() -> None:
    """Arm the process-wide span recorder (``--timeline``).  Host-side
    bookkeeping only; the hooks in telemetry/checkpoint stay cheap
    early-returns until this is called."""
    global _armed
    _armed = True


def disarm() -> None:
    """Disarm AND clear -- in-process callers (tests, library use) must
    not leak one invocation's spans into the next."""
    global _armed
    _armed = False
    with _lock:
        _spans.clear()
        _instants.clear()


def armed() -> bool:
    return _armed


def record_span(name: str, t0: float, t1: float, cat: str = "phase",
                part: int | None = None, **attrs) -> None:
    """One completed span in unix-epoch seconds (``time.time()`` -- the
    only clock that can be aligned ACROSS controllers; perf_counter
    epochs differ per process)."""
    if not _armed:
        return
    span = {"name": str(name), "t0": float(t0), "t1": float(max(t1, t0)),
            "cat": str(cat)}
    if part is not None:
        span["part"] = int(part)
    if attrs:
        span["args"] = {k: v for k, v in attrs.items() if v is not None}
    with _lock:
        _spans.append(span)
    from acg_tpu_torch import metrics
    metrics.record_trace_span(cat)


def record_phase_span(name: str, seconds: float) -> None:
    """The phase-timer hook: phases report ``(name, seconds)`` at phase
    END, so the span is ``[now - seconds, now]`` on the wall clock."""
    if not _armed:
        return
    t1 = time.time()
    record_span(name, t1 - max(float(seconds), 0.0), t1, cat="phase")


def record_instant(name: str, detail: str | None = None,
                   part: int | None = None) -> None:
    """One instant event (the telemetry tier's structured events --
    breakdown/restart/rollback/resume/drift/... -- as timeline pins)."""
    if not _armed:
        return
    inst = {"name": str(name), "t": time.time()}
    if detail:
        inst["detail"] = str(detail)
    if part is not None:
        inst["part"] = int(part)
    with _lock:
        _instants.append(inst)
    from acg_tpu_torch import metrics
    metrics.record_trace_span("event")


def nspans() -> int:
    with _lock:
        return len(_spans) + len(_instants)


# -- profiler captures ------------------------------------------------------

# True while profiler_trace runs: the host-collective spans record only
# then (outside a capture they cost nothing)
_capturing = False


def capturing() -> bool:
    return _capturing


def host_span(name: str, host_only: bool):
    """A ``record_function(name)`` bracket around a host collective while
    a capture runs -- ``"psum"`` (class allreduce) or
    ``"halo_exchange"`` (class halo).  ``host_only``: the collective
    leaves no device event (gloo, or a CPU tensor); a collective that
    has one (an NCCL kernel, K6) gets no span, or it would count
    twice."""
    if not (_capturing and host_only):
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiler_trace(trace_dir):
    """``torch.profiler.profile`` around a block, written as
    ``<process>.trace.json.gz`` under ``trace_dir`` (CPU activity, plus
    CUDA activity when a card is present).  ``None`` is a no-op; a
    failed start warns and runs the body unprofiled, and a failed export
    warns (the analysis then reports the capture missing) -- a solve
    never dies for its observability."""
    global _capturing
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from acg_tpu_torch.parallel import multihost

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 -- profile-or-not, never sink
        prof = None
        sys.stderr.write(f"acg-tpu-torch: --trace {trace_dir}: profiler "
                         f"start failed ({type(e).__name__}: {e}); "
                         f"continuing without a capture\n")
    _capturing = prof is not None
    try:
        yield
    finally:
        _capturing = False
        if prof is not None:
            try:
                if torch.cuda.is_available() \
                        and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                _export(prof, trace_dir, multihost.process_index())
            except Exception as e:  # noqa: BLE001
                sys.stderr.write(f"acg-tpu-torch: --trace {trace_dir}: "
                                 f"profiler stop failed "
                                 f"({type(e).__name__}: {e})\n")


def _export(prof, trace_dir, process: int) -> str:
    """The capture as ``<trace_dir>/<process>.trace.json.gz`` (the name
    :func:`find_capture` looks for, its first dot-field the rank)."""
    d = os.fspath(trace_dir)
    os.makedirs(d, exist_ok=True)
    raw = os.path.join(d, f"{process}.trace.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb",
                                           compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)
    return raw + ".gz"


# -- cross-rank gather + clock alignment ---------------------------------

def local_payload(parts=None) -> dict:
    """This controller's timeline contribution: its recorded spans and
    instants plus the part ids it owns (``parts=None`` = unpartitioned:
    the spans land on one pid)."""
    from acg_tpu_torch.parallel import multihost

    with _lock:
        spans = [dict(s) for s in _spans]
        instants = [dict(i) for i in _instants]
    return {"process": int(multihost.process_index()),
            "parts": ([int(p) for p in parts] if parts is not None
                      else None),
            "spans": spans, "instants": instants}


def align_payloads(payloads: list[dict]) -> dict:
    """Barrier-timestamp clock alignment, in place.

    Every payload carries ``t_barrier`` -- ``time.time()`` taken
    immediately after ALL ranks exited the same allgather barrier, so
    the true event is simultaneous up to barrier-exit jitter and any
    difference is clock skew.  Shifting rank r by
    ``max(t_barrier) - t_barrier[r]`` (always >= 0) lands every rank on
    the slowest clock: after alignment the barrier stamps are EQUAL, so
    no span can precede a peer's view of the same wall instant -- no
    negative inter-rank skew survives."""
    stamps = [p.get("t_barrier") for p in payloads]
    known = [s for s in stamps if s is not None]
    info = {"ranks": len(payloads), "aligned": len(known) > 1,
            "max_skew_s": (max(known) - min(known)) if known else 0.0}
    if len(known) < 2:
        return info
    ref = max(known)
    for p in payloads:
        tb = p.get("t_barrier")
        if tb is None:
            continue
        off = ref - tb
        p["clock_offset_s"] = off
        if off == 0.0:
            continue
        for s in p.get("spans", []):
            s["t0"] += off
            s["t1"] += off
        for i in p.get("instants", []):
            i["t"] += off
        p["t_barrier"] = ref
    return info


def gather_timeline(parts=None, timeout: float = 120.0,
                    collective: bool = True
                    ) -> tuple[list[dict], dict]:
    """``(payloads, clock_info)`` -- every controller's spans, clock
    aligned.  COLLECTIVE (every controller must call it at the same
    point); error paths pass ``collective=False`` and get the local
    payload alone (a one-sided failure must not enter a gather its
    peers may never reach -- the erragree rationale).  Never raises
    and never returns None: a failed gather degrades to this
    controller's local payload."""
    from acg_tpu_torch.parallel import multihost

    payload = local_payload(parts=parts)
    n = multihost.process_count()
    if n == 1 or not collective:
        payload["t_barrier"] = time.time()
        return [payload], {"ranks": 1, "aligned": False,
                           "max_skew_s": 0.0}
    from acg_tpu_torch.parallel.erragree import allgather_blobs, barrier

    try:
        # round 1 is pure barrier: after it returns, all ranks are
        # within barrier-exit jitter of the same instant -- the stamp
        # taken THERE is the clock-alignment reference
        payload["t_barrier"] = barrier(tag="timeline-sync",
                                       timeout=timeout)
        blobs = allgather_blobs(json.dumps(payload), tag="timeline",
                                timeout=timeout)
    except Exception as e:  # noqa: BLE001 -- the timeline is
        # best-effort: a failed gather must not take down a solve that
        # succeeded (gather_rank_stats discipline)
        sys.stderr.write(f"acg-tpu-torch: timeline gather failed "
                         f"({type(e).__name__}); writing this "
                         f"controller's spans only\n")
        return [payload], {"ranks": 1, "aligned": False,
                           "max_skew_s": 0.0}
    payloads = [json.loads(b) for b in blobs]
    info = align_payloads(payloads)
    return payloads, info


# -- Chrome trace-event export -------------------------------------------

def export_chrome_trace(path, payloads: list[dict], nparts: int = 1,
                        clock: dict | None = None) -> dict:
    """Write the gathered spans as Chrome trace-event JSON (Perfetto /
    chrome://tracing loadable): one pid per PART (pid = part + 1; rank
    named in the process metadata), spans as complete ``X`` events on
    per-category rows, telemetry events as instants.  A controller-wide
    span (no ``part``) describes every part that controller owns -- the
    SPMD program runs them in lockstep -- so it is replicated onto each
    owned pid, exactly how an nsys timeline shows one row per GPU for a
    fully bulk-synchronous phase.  Returns the summary dict that lands
    in the ``tracing:`` stats section."""
    events: list[dict] = []
    all_t: list[float] = []
    for p in payloads:
        for s in p.get("spans", []):
            all_t.append(s["t0"])
        for i in p.get("instants", []):
            all_t.append(i["t"])
    origin = min(all_t) if all_t else 0.0

    pids_seen: set[int] = set()
    # service-timeline tracks discovered from the spans themselves
    # (the worker row and one lane per concurrent request window) --
    # named AFTER the walk, once we know which exist
    extra_tracks: set[tuple[int, int, str]] = set()
    nspans_out = 0
    for p in payloads:
        rank = int(p.get("process", 0))
        parts = p.get("parts")
        if parts is None:
            parts = [rank]
        parts = [int(q) for q in parts] or [rank]
        for part in parts:
            pid = part + 1
            if pid in pids_seen:
                continue
            pids_seen.add(pid)
            events.append({"ph": "M", "pid": pid, "name": "process_name",
                           "args": {"name": f"part {part} "
                                            f"(rank {rank})"}})
            events.append({"ph": "M", "pid": pid,
                           "name": "process_sort_index",
                           "args": {"sort_index": pid}})
            for tid, tname in ((_TID_PHASES, "phases"),
                               (_TID_CHUNKS, "chunks"),
                               (_TID_EVENTS, "events")):
                events.append({"ph": "M", "pid": pid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": tname}})
        for s in p.get("spans", []):
            targets = ([int(s["part"]) + 1] if s.get("part") is not None
                       else [q + 1 for q in parts])
            cat = s.get("cat", "phase")
            tid = (_TID_CHUNKS if s["name"] == "ckpt"
                   else _CAT_TIDS.get(cat, _TID_PHASES))
            if cat == "request":
                lane = (s.get("args") or {}).get("lane")
                tid = _TID_REQUEST_BASE + (int(lane) if isinstance(
                    lane, (int, float)) else 0)
            for pid in targets:
                if cat == "worker":
                    extra_tracks.add((pid, tid, "serve worker"))
                elif cat == "request":
                    extra_tracks.add(
                        (pid, tid,
                         f"request lane {tid - _TID_REQUEST_BASE}"))
                ev = {"ph": "X", "pid": pid, "tid": tid,
                      "name": s["name"], "cat": cat,
                      "ts": (s["t0"] - origin) * 1e6,
                      "dur": max((s["t1"] - s["t0"]) * 1e6, 0.001)}
                if s.get("args"):
                    ev["args"] = s["args"]
                events.append(ev)
                nspans_out += 1
        for i in p.get("instants", []):
            targets = ([int(i["part"]) + 1] if i.get("part") is not None
                       else [q + 1 for q in parts])
            for pid in targets:
                ev = {"ph": "i", "pid": pid, "tid": _TID_EVENTS,
                      "name": i["name"], "s": "p",
                      "ts": (i["t"] - origin) * 1e6}
                if i.get("detail"):
                    ev["args"] = {"detail": i["detail"]}
                events.append(ev)
    for pid, tid, tname in sorted(extra_tracks):
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": tname}})
    # monotone ts per (pid, tid) track by construction of the writer,
    # not by luck of recording order (check_timeline.py validates it)
    events.sort(key=lambda e: (e.get("ph") != "M", e["pid"],
                               e.get("tid", 0), e.get("ts", 0.0)))
    doc = {
        "displayTimeUnit": "ms",
        "metadata": {
            "schema": TIMELINE_SCHEMA,
            "origin_unix_s": origin,
            "nparts": int(nparts),
            "nranks": len(payloads),
            "clock": clock or {"ranks": len(payloads),
                               "aligned": False, "max_skew_s": 0.0},
        },
        "traceEvents": events,
    }
    own = isinstance(path, (str, bytes)) or hasattr(path, "__fspath__")
    f = open(path, "w") if own else path
    try:
        json.dump(doc, f)
        f.write("\n")
    finally:
        if own:
            f.close()
    summary = {"file": os.fspath(path) if own else "<stream>",
               "schema": TIMELINE_SCHEMA,
               "nspans": nspans_out, "nparts": len(pids_seen),
               "nranks": len(payloads),
               "clock_max_skew_s": float((clock or {}).get("max_skew_s",
                                                           0.0))}
    from acg_tpu_torch import metrics
    metrics.record_timeline_export()
    return summary


def read_timeline(path) -> dict:
    """Parse a ``--timeline`` file back; raises ValueError when it is
    not an acg-tpu timeline (the content-sniffing classifiers in
    plot_convergence/trace_report dispatch on this)."""
    with open(path) as f:
        doc = json.load(f)
    if (not isinstance(doc, dict)
            or not isinstance(doc.get("traceEvents"), list)):
        raise ValueError("not a Chrome trace-event document")
    return doc


# -- profiler-trace analysis ---------------------------------------------

# HLO op INSTANCES only (full match, optional "%"/-start/-done/".N"
# decorations): substring search would misfile XLA compile-pass events
# like "batch-dot-simplification" or "all-reduce-folder" -- a capture
# contains the compiler's own timeline too, and pass time is not op
# time.  First match wins: the collective classes outrank "dot" (an
# all-reduce is not a dot product).
_HLO_PATTERNS: tuple[tuple[str, re.Pattern], ...] = (
    ("allreduce", re.compile(
        r"%?(all[-_.]?reduce|reduce[-_.]?scatter)"
        r"([-_.](start|done))?[.\d]*$", re.I)),
    ("halo", re.compile(
        r"%?(all[-_.]?to[-_.]?all|collective[-_.]?permute)"
        r"([-_.](start|done))?[.\d]*$", re.I)),
    ("dot", re.compile(r"%?(dot|gemm|convolution)[.\d]*$", re.I)),
    # bare "fusion" is ALSO an XLA pass name -- only the numbered HLO
    # instances ("fusion.3", "loop_fusion.12") count as device op time
    ("fusion", re.compile(r"%?(loop_|input_|output_)?fusion\.\d+$",
                          re.I)),
    ("copy", re.compile(r"%?(copy|transpose|bitcast)"
                        r"([-_.](start|done))?[.\d]*$", re.I)),
)
# keyword classes safe as substrings anywhere: first the port's own
# CUDA kernels and the library kernels of its plain ops, as CUPTI names
# them (demangled: "void (anonymous namespace)::part_dot_kernel<double,
# double>(...)"), ahead of the reference's keywords -- cuBLAS's dot
# kernels carry "cublasGemvTensorStridedBatched" template arguments,
# which the gemv keyword would claim
_KEYWORD_PATTERNS: tuple[tuple[str, re.Pattern], ...] = (
    ("allreduce", re.compile(r"nccl\w*(AllReduce|AllGather|ReduceScatter)",
                             re.I)),
    ("halo", re.compile(r"halo_put|nccl\w*SendRecv", re.I)),
    ("fusion", re.compile(r"cg_phase_[ab]_kernel|pipelined_update_kernel",
                          re.I)),
    ("dot", re.compile(r"part_dot_kernel|(?<!\w)dot_kernel|"
                       r"reduce_1Block_kernel|at::native::reduce_kernel")),
    ("gemv", re.compile(r"spmv|matvec|gemv", re.I)),
    ("allreduce", re.compile(r"\bpsum\b", re.I)),
    ("halo", re.compile(r"ppermute|halo_exchange", re.I)),
)
# collective KIND sub-classification (the commbench observatory's
# per-kind confrontation: acg_tpu.commbench fits one alpha-beta model
# per kind, so the capture must report measured seconds per kind too,
# not one pooled "collective" figure).  First match wins; the fallback
# maps the coarse class (allreduce -> all_reduce, halo -> all_to_all)
_COLLECTIVE_KIND_PATTERNS: tuple[tuple[str, re.Pattern], ...] = (
    # "dma" must match halo_exchange_dma / pallas put kernels and the
    # port's K6 (halo_put_kernel, halo_put_peer_kernel) but NOT the
    # plain halo_exchange all_to_all transport's span
    ("dma", re.compile(r"dma|pallas|halo_put", re.I)),
    ("all_to_all", re.compile(r"all[-_.]?to[-_.]?all", re.I)),
    ("collective_permute", re.compile(
        r"collective[-_.]?permute|ppermute", re.I)),
    ("all_reduce", re.compile(
        r"all[-_.]?reduce|reduce[-_.]?scatter|psum", re.I)),
)


def _collective_kind(name: str, cls: str) -> str:
    for kind, pat in _COLLECTIVE_KIND_PATTERNS:
        if pat.search(name):
            return kind
    return "all_reduce" if cls == "allreduce" else "all_to_all"


# torch.profiler event categories that hold op time: the device's own
# events, and the host annotations (the phases, and host_span's
# collectives).  Host operator and runtime events ("cpu_op",
# "cuda_runtime", ...) would count a device op twice, and each
# annotation's device twin ("gpu_user_annotation") would count a phase
# twice.  Events without a category (other producers) all count
_OP_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset",
                      "user_annotation"))


def _counted(e: dict) -> bool:
    cat = e.get("cat")
    return cat is None or cat in _OP_CATS


# torch.profiler writes one event a block, "  {" to "  }" at two spaces
# (nested objects sit deeper), its category in the block's first lines
_BLOCK_SEP = "\n  },\n  {"
_BLOCK_CAT = re.compile(r'"cat": "([^"]*)"')


def _op_events(path) -> list[dict]:
    """The complete events of one capture file that can hold op or phase
    time (:func:`_counted`).  A card's capture is mostly host operator,
    runtime and flow events (~1.8M for two flagship solves): in
    torch.profiler's layout only the counted blocks are parsed; any
    other layout is parsed whole."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    events = _counted_blocks(text)
    if events is None:
        events = [e for e in json.loads(text).get("traceEvents", [])
                  if e.get("ph") == "X" and _counted(e)]
    return events


def _counted_blocks(text: str) -> list[dict] | None:
    """The counted complete events of a capture in torch.profiler's
    layout, or None when ``text`` is not in it (or a counted block does
    not parse alone)."""
    start = text.find('"traceEvents": [')
    end = text.rfind("\n  }")
    if start < 0 or end < start:
        return None
    body = text[start:end]
    blocks = body.split(_BLOCK_SEP)
    if len(blocks) < 2:
        return None
    # the first block holds the list's opening: keep from its event on
    first = blocks[0].find("\n  {")
    if first < 0:
        return None
    blocks[0] = blocks[0][first + 4:]
    out = []
    for blk in blocks:
        m = _BLOCK_CAT.search(blk, 0, 200)
        if m is None or m.group(1) not in _OP_CATS or '"ph": "X"' not in \
                blk[:200]:
            continue
        try:
            e = json.loads("{" + blk + "}")
        except ValueError:
            return None
        if e.get("ph") == "X":
            out.append(e)
    return out


_PJIT_RE = re.compile(r"^(?:PjitFunction|jit_?)\(?([^)]*)\)?$")
_PHASES = ("ingest", "partition", "transfer", "compile", "solve",
           "ckpt", "writeback")


def _classify_op(name: str) -> str | None:
    m = _PJIT_RE.match(name)
    if m:
        inner = m.group(1)
        for cls, pat in _HLO_PATTERNS + _KEYWORD_PATTERNS:
            if pat.search(inner):
                return cls
        # a compiled-program dispatch (the whole fused solve on CPU
        # captures, where XLA emits no per-HLO-op device events)
        return "program"
    for cls, pat in _HLO_PATTERNS:
        if pat.fullmatch(name):
            return cls
    for cls, pat in _KEYWORD_PATTERNS:
        if pat.search(name):
            return cls
    return None


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur0, cur1 = intervals[0]
    for a, b in intervals[1:]:
        if a > cur1:
            total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    return total + (cur1 - cur0)


def _subtract_seconds(base: list[tuple[float, float]],
                      cover: list[tuple[float, float]]) -> float:
    """Seconds of ``union(base)`` NOT covered by ``union(cover)`` --
    the exposed-collective computation."""
    return _union_seconds(list(base)) - _overlap_seconds(base, cover)


def _overlap_seconds(a: list[tuple[float, float]],
                     b: list[tuple[float, float]]) -> float:
    if not a or not b:
        return 0.0
    # merge each side first so double-covered stretches count once
    def merged(iv):
        iv = sorted(iv)
        out = [list(iv[0])]
        for s, e in iv[1:]:
            if s > out[-1][1]:
                out.append([s, e])
            else:
                out[-1][1] = max(out[-1][1], e)
        return out

    am, bm = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(am) and j < len(bm):
        lo = max(am[i][0], bm[j][0])
        hi = min(am[i][1], bm[j][1])
        if hi > lo:
            total += hi - lo
        if am[i][1] < bm[j][1]:
            i += 1
        else:
            j += 1
    return total


def find_capture(trace_dir) -> dict:
    """Locate the profiler artifacts under a ``--trace`` dir: the
    Chrome-format ``*.trace.json(.gz)`` files (one per host) and the
    xplane protos (schema we deliberately do NOT parse -- no
    tensorflow/xprof dependency in this container)."""
    d = os.fspath(trace_dir)
    traces = sorted(glob.glob(os.path.join(d, "**", "*.trace.json.gz"),
                              recursive=True)
                    + glob.glob(os.path.join(d, "**", "*.trace.json"),
                                recursive=True))
    xplanes = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                               recursive=True))
    return {"dir": d, "trace_json": traces, "xplane": xplanes}


def analyze_trace(trace_dir) -> dict:
    """Parse a ``--trace`` capture into measured per-op-class device
    seconds, the overlap-efficiency score, per-phase seconds, and the
    cross-rank straggler attribution.

    Degrades instead of raising: a missing/empty dir, an xplane-only
    capture (no trace.json the stdlib can read), or a corrupt file all
    return ``{"available": False, "why": ...}`` -- the callers print
    the why and keep the static verdict (the --explain contract)."""
    try:
        cap = find_capture(trace_dir)
    except OSError as e:
        return {"available": False, "why": f"{type(e).__name__}: {e}"}
    if not cap["trace_json"]:
        why = ("capture has xplane protos only -- no trace.json the "
               "stdlib can parse (xprof schema unavailable here)"
               if cap["xplane"] else
               f"no profiler capture under {cap['dir']} (profiler "
               f"unavailable or start failed)")
        return {"available": False, "why": why,
                "xplane_files": len(cap["xplane"])}

    op_s: dict[str, float] = {}
    op_solve_s: dict[str, float] = {}
    kind_s: dict[str, float] = {}
    kind_solve_s: dict[str, float] = {}
    phase_s: dict[str, float] = {}
    per_rank: list[dict] = []
    exposed = 0.0
    nsolve_windows = 0
    # each name's class and collective kind, classified once (a capture
    # repeats a few dozen kernel names hundreds of thousands of times)
    classes: dict[str, str | None] = {}
    kinds: dict[str, str] = {}
    for path in cap["trace_json"]:
        try:
            events = _op_events(path)
        except (OSError, ValueError) as e:
            return {"available": False,
                    "why": f"{os.path.basename(path)}: "
                           f"{type(e).__name__}: {e}"}
        rank_phase: dict[str, float] = {}
        rank_busy: list[tuple[float, float]] = []
        # pass 1: the acg:* phase brackets.  The "solve" windows matter
        # beyond reporting: a capture also contains the WARMUP solves
        # (full program executions inside the compile bracket) and
        # every --soak repeat, so per-op attribution must be windowed
        # to the timed solve(s) or the "measured" seconds overstate the
        # solve the op census describes
        solve_iv: list[tuple[float, float]] = []
        for e in events:
            name = str(e.get("name", ""))
            pname = name[4:] if name.startswith("acg:") else name
            if pname not in _PHASES:
                continue
            dur = float(e.get("dur", 0.0)) * 1e-6
            ts = float(e.get("ts", 0.0)) * 1e-6
            phase_s[pname] = phase_s.get(pname, 0.0) + dur
            rank_phase[pname] = rank_phase.get(pname, 0.0) + dur
            if pname == "solve":
                solve_iv.append((ts, ts + dur))
        nsolve_windows += len(solve_iv)
        # pass 2: op-class events.  The overlap algebra stays PER FILE:
        # each host's capture has its own profiler timebase (and its
        # own devices) -- pooling intervals across files would let one
        # host's compute "hide" another host's exposed collectives
        coll_iv: list[tuple[float, float]] = []
        comp_iv: list[tuple[float, float]] = []
        for e in events:
            name = str(e.get("name", ""))
            if name.startswith("$"):
                continue  # python-interpreter frames
            pname = name[4:] if name.startswith("acg:") else name
            if pname in _PHASES:
                continue
            if name not in classes:
                classes[name] = _classify_op(name)
            cls = classes[name]
            if cls is None:
                continue
            dur = float(e.get("dur", 0.0)) * 1e-6
            ts = float(e.get("ts", 0.0)) * 1e-6
            op_s[cls] = op_s.get(cls, 0.0) + dur
            mid = ts + dur / 2.0
            in_solve = any(a <= mid <= b for a, b in solve_iv)
            if in_solve:
                op_solve_s[cls] = op_solve_s.get(cls, 0.0) + dur
            iv = (ts, ts + dur)
            rank_busy.append(iv)
            if cls in ("allreduce", "halo"):
                # per-KIND breakdown (all_reduce / all_to_all /
                # collective_permute / dma): the row the commbench
                # alpha-beta fits are confronted with, kind by kind
                if name not in kinds:
                    kinds[name] = _collective_kind(name, cls)
                kind = kinds[name]
                kind_s[kind] = kind_s.get(kind, 0.0) + dur
                if in_solve:
                    kind_solve_s[kind] = (kind_solve_s.get(kind, 0.0)
                                          + dur)
                coll_iv.append(iv)
            else:
                comp_iv.append(iv)
        if coll_iv:
            exposed += _subtract_seconds(coll_iv, comp_iv)
        rank = os.path.basename(path).split(".")[0]
        per_rank.append({"rank": rank,
                         "phase_seconds": rank_phase,
                         "busy_seconds": _union_seconds(rank_busy)})

    coll_total = op_s.get("allreduce", 0.0) + op_s.get("halo", 0.0)
    overlap_eff = (1.0 - exposed / coll_total) if coll_total > 0 else None

    straggler = _phase_straggler(per_rank)
    return {"available": True, "dir": cap["dir"],
            "nfiles": len(cap["trace_json"]),
            "xplane_files": len(cap["xplane"]),
            "op_seconds": {k: round(v, 9)
                           for k, v in sorted(op_s.items())},
            "op_seconds_in_solve": {k: round(v, 9)
                                    for k, v in sorted(op_solve_s
                                                       .items())},
            "solve_windows": nsolve_windows,
            "collective_seconds": round(coll_total, 9),
            "collective_seconds_in_solve": round(
                op_solve_s.get("allreduce", 0.0)
                + op_solve_s.get("halo", 0.0), 9),
            "collective_kind_seconds": {k: round(v, 9)
                                        for k, v in sorted(
                                            kind_s.items())},
            "collective_kind_seconds_in_solve": {
                k: round(v, 9)
                for k, v in sorted(kind_solve_s.items())},
            "exposed_collective_seconds": round(exposed, 9),
            "overlap_efficiency": (round(overlap_eff, 6)
                                   if overlap_eff is not None else None),
            "phase_seconds": {k: round(phase_s[k], 9)
                              for k in _PHASES if k in phase_s},
            "per_rank": per_rank,
            "straggler": straggler}


def _phase_straggler(per_rank: list[dict]) -> dict | None:
    """Which rank's solve phase is slowest, and by how much over the
    median -- the measured twin of telemetry.aggregate_ranks' wall-time
    callout.  None below 2 ranks or under the STRAGGLER_RATIO bar."""
    import statistics

    solves = [(r.get("phase_seconds", {}).get("solve", 0.0),
               r.get("rank", str(i))) for i, r in enumerate(per_rank)]
    solves = [(t, r) for t, r in solves if t > 0]
    if len(solves) < 2:
        return None
    solves.sort()
    # the TRUE median (mean of the middle two on even counts) --
    # telemetry.aggregate_ranks uses np.median, and the upper-middle
    # shortcut could never flag a straggler across exactly 2 hosts
    med = statistics.median(t for t, _ in solves)
    worst_t, worst_r = solves[-1]
    if med <= 0 or worst_t <= STRAGGLER_RATIO * med:
        return None
    return {"rank": worst_r, "phase": "solve",
            "seconds": round(worst_t, 9),
            "ratio_to_median": round(worst_t / med, 4)}


# -- stats/ops/metrics attachment ----------------------------------------

# analysis op classes -> SolverStats.ops rows the measured seconds may
# REPLACE ("gemv" is the stats block's SpMV row; "fusion"/"program"/
# "copy" have no row and stay in the tracing: section only)
_MEASURED_OPS = ("gemv", "dot", "allreduce", "halo")


def attach(stats, analysis: dict | None,
           timeline: dict | None = None) -> None:
    """Fill the append-only ``tracing:`` stats section (and its
    ``--stats-json`` twin) from a capture analysis and/or a timeline
    export summary, and -- where the capture measured an op class the
    replay tier could only estimate -- overwrite that op row's seconds
    with the MEASURED ones.  A disarmed run records nothing and the
    report stays byte-identical (the costmodel/soak discipline)."""
    if analysis is not None:
        sec = {"available": bool(analysis.get("available"))}
        if analysis.get("available"):
            sec.update({
                "capture_files": analysis.get("nfiles", 0),
                "op_seconds": dict(analysis.get("op_seconds", {})),
                # the port's addition: the seconds inside the acg:solve
                # windows, which the op rows take
                "op_seconds_in_solve": dict(
                    analysis.get("op_seconds_in_solve", {})),
                "collective_seconds": analysis.get("collective_seconds",
                                                   0.0),
                "exposed_collective_seconds":
                    analysis.get("exposed_collective_seconds", 0.0),
            })
            if analysis.get("collective_kind_seconds"):
                sec["collective_kind_seconds"] = dict(
                    analysis["collective_kind_seconds"])
            if analysis.get("overlap_efficiency") is not None:
                sec["overlap_efficiency"] = \
                    analysis["overlap_efficiency"]
            if analysis.get("phase_seconds"):
                sec["phase_seconds"] = dict(analysis["phase_seconds"])
            strag = analysis.get("straggler")
            if strag:
                sec["straggler"] = dict(strag)
            filled = apply_measured_ops(stats, analysis)
            if filled:
                # provenance, not a claim that a replay ran: these rows
                # now hold capture-measured seconds (superseding the
                # --profile-ops replay estimate whenever one was there)
                sec["ops_source"] = ("trace (" + ", ".join(filled)
                                     + " measured from the capture's "
                                       "solve windows)")
        else:
            sec["why"] = analysis.get("why", "unavailable")
        stats.tracing.update(sec)
        from acg_tpu_torch import metrics
        metrics.record_trace_analysis(analysis)
    if timeline is not None:
        stats.tracing["timeline"] = dict(timeline)


def apply_measured_ops(stats, analysis: dict) -> list[str]:
    """Overwrite ``stats.ops[cls].t`` with the capture's measured
    seconds for every op class the capture actually resolved (card
    captures carry per-kernel device events; CPU captures carry none,
    so nothing is overwritten and the replay estimates stand).  Returns the classes replaced.

    Only events inside the ``solve`` phase bracket(s) count: a capture
    also contains the WARMUP solves (full program executions inside
    the ``compile`` bracket), which would inflate the "measured"
    seconds by (warmup+1)x against the census.  The in-solve seconds
    are summed over ALL solve windows -- the op rows' ``n``/``bytes``
    accumulate across ``--soak`` repeats and the timed windows do too,
    the same cumulative convention as the replay tier's
    ``t = per_call * n``, so GB/s and the ``other`` residual stay
    consistent.  A capture without solve brackets (foreign producer)
    overwrites nothing."""
    if int(analysis.get("solve_windows", 0)) < 1:
        return []
    filled = []
    for cls in _MEASURED_OPS:
        secs = float(analysis.get("op_seconds_in_solve",
                                  {}).get(cls, 0.0))
        if secs > 0 and cls in stats.ops and stats.ops[cls].n > 0:
            stats.ops[cls].t = secs
            filled.append(cls)
    return filled


def format_analysis(analysis: dict) -> list[str]:
    """Human lines for the --explain measured section and
    trace_report.py -- one writer so the two cannot drift."""
    if not analysis.get("available"):
        return [f"  (no usable capture: "
                f"{analysis.get('why', 'unavailable')})"]
    lines = []
    ops = analysis.get("op_seconds", {})
    if ops:
        width = max(len(k) for k in ops)
        for cls, secs in ops.items():
            lines.append(f"  {cls:<{width}}: {secs:.6f} s")
    else:
        lines.append("  (no per-op device events in this capture -- "
                     "CPU backends emit whole-program dispatches only)")
    kinds = analysis.get("collective_kind_seconds") or {}
    if kinds:
        lines.append("  collectives by kind: "
                     + ", ".join(f"{k} {v:.6f}s"
                                 for k, v in kinds.items()))
    coll = analysis.get("collective_seconds", 0.0)
    eff = analysis.get("overlap_efficiency")
    if eff is not None:
        lines.append(f"  overlap efficiency: {eff:.2%} of "
                     f"{coll:.6f} s collective time hidden under "
                     f"compute ({analysis.get('exposed_collective_seconds', 0.0):.6f} s exposed)")
    else:
        lines.append("  overlap efficiency: n/a (no collective events "
                     "in capture)")
    ph = analysis.get("phase_seconds", {})
    if ph:
        lines.append("  phases: " + ", ".join(f"{k} {v:.3f}s"
                                              for k, v in ph.items()))
    strag = analysis.get("straggler")
    if strag:
        lines.append(f"  straggler: {strag['rank']} "
                     f"({strag['ratio_to_median']:.2f}x median "
                     f"{strag['phase']} time)")
    elif len(analysis.get("per_rank", [])) > 1:
        lines.append(f"  no straggler across "
                     f"{len(analysis['per_rank'])} ranks (all within "
                     f"{STRAGGLER_RATIO:.1f}x of median)")
    return lines


def measured_comm_line(analysis: dict, predicted_comm_s: float,
                       label: str = "solve") -> str:
    """The measured-vs-predicted comm verdict line ``--explain``
    appends when a capture exists: the static ledger's predicted
    collective seconds confronted with the capture's measured ones.
    The measurement is windowed to the ``solve`` phase brackets when
    the capture has them -- the ledger prices the TIMED iterations,
    and a capture also holds the warmup solves' collectives (a
    systematic (warmup+1)x bias that would sit exactly on the
    consistent/underestimates boundary)."""
    windowed = int(analysis.get("solve_windows", 0)) >= 1
    meas = float(analysis.get("collective_seconds_in_solve", 0.0)
                 if windowed else
                 analysis.get("collective_seconds", 0.0))
    if meas <= 0:
        return (f"  comm: predicted {predicted_comm_s:.3e} s "
                f"({label}); capture measured no collective device "
                f"events{' in the solve windows' if windowed else ''} "
                f"-- nothing to confront the ledger with")
    ratio = meas / predicted_comm_s if predicted_comm_s > 0 else math.inf
    verdict = ("ledger consistent" if 0.5 <= ratio <= 2.0 else
               "ledger underestimates" if ratio > 2.0 else
               "ledger overestimates")
    return (f"  comm: predicted {predicted_comm_s:.3e} s vs measured "
            f"{meas:.3e} s collective device time"
            f"{' (solve windows)' if windowed else ''} "
            f"({ratio:.2f}x) -- {verdict}")
