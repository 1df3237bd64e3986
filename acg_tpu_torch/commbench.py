"""The communication observatory on stacked parts: collective
microbenchmarks, a measured alpha-beta calibration, and the measured
segment decomposition of an iteration.

The counterpart of ``acg_tpu/commbench.py`` (``--commbench [FILE]``,
``--calibration FILE``).  The port's parts are stacked on one device and
driven by one process (the single-controller layout the reference's
observatory requires), so each collective kind is what the port's tier
does with its parts:

* ``all_reduce``: the sum over the parts axis (:func:`~acg_tpu_torch.
  parallel.reductions.psum`, folded in part order), rescaled by 1/P and
  written back to every part;
* ``all_to_all``: the transposing plane copy of the xla halo transport
  (:mod:`acg_tpu_torch.parallel.halo`): ``recv[p, q] = send[q, p]``;
* ``collective_permute``: a roll over the parts axis;
* ``dma``: kernel K6 (:func:`acg_tpu_torch.ops.kernels.halo_put`) on an
  ``(nparts, nparts, maxcnt)`` f32 window plane -- dense, and gated by
  the counts to one ring distance for the per-edge rows.

Every kind chains ``reps`` rounds, each round's input the last round's
output, between two synchronizes, and is fitted to ``t = alpha + beta *
bytes`` over the bytes a part sends.  The segment decomposition times
the SpMV, halo and reduction probes of :mod:`acg_tpu_torch.recurrence`
(``build_*_segment_probes``), which run eager rounds of the solve loop's
own pieces.

The ``acg-tpu-commbench/1`` document has the reference's keys, so the
reference's validator accepts it and ``calibration_id`` hashes the same
content to the same id in both packages; it also records the transport
layout, the backend (``cuda`` or ``cpu``), the device's name and, on
the card, the hand kernels each phase launched.  On the CPU (the plain
versions) a failed dma sweep or segment pass is recorded as unavailable,
as in the reference; on a CUDA device a kernel's error raises.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import numpy as np

COMMBENCH_SCHEMA = "acg-tpu-commbench/1"

# the provenance value of a run without a calibration (stats manifest,
# convergence-log meta line); case keys fold in real ids only
UNCALIBRATED = "uncalibrated"

KINDS = ("all_reduce", "all_to_all", "collective_permute", "dma")

# message sizes (payload bytes a part sends).  The CPU sweep is the
# reference's, so the CPU twins compare like with like; the card's spans
# launch-bound (256 B: one launch's latency) to bandwidth-bound (16 MiB a
# part, 64 MiB a round on 4 parts: tens of microseconds of HBM traffic)
CPU_SWEEP = (256, 8192, 131072)
GPU_SWEEP = (256, 4096, 65536, 1048576, 16777216)

# chained rounds per timed run and timing repeats (min-of)
DEFAULT_REPS = 24
TIMED_REPEATS = 3
SEGMENT_REPS = 16

TRANSPORT_LAYOUT = "stacked parts on one device, one process"


# -- the alpha-beta fit ---------------------------------------------------

def fit_alpha_beta(points) -> dict | None:
    """Least-squares fit of ``t = alpha + beta * bytes`` over
    ``[(bytes, seconds), ...]`` with both coefficients clamped
    nonnegative (``acg_tpu/commbench.py:82``).  Returns ``{"alpha_s",
    "beta_s_per_byte", "npoints", "r2"}`` or None when nothing usable
    was measured."""
    pts = [(float(b), float(s)) for b, s in points
           if s > 0 and b >= 0 and np.isfinite(s) and np.isfinite(b)]
    if not pts:
        return None
    x = np.asarray([p[0] for p in pts], dtype=np.float64)
    y = np.asarray([p[1] for p in pts], dtype=np.float64)
    if len(pts) == 1 or np.ptp(x) == 0:
        b0, s0 = float(x[0]), float(np.min(y))
        return {"alpha_s": s0 if b0 == 0 else 0.0,
                "beta_s_per_byte": (s0 / b0) if b0 > 0 else 0.0,
                "npoints": len(pts), "r2": None}
    A = np.stack([np.ones_like(x), x], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    alpha, beta = float(coef[0]), float(coef[1])
    if beta < 0.0:
        # bandwidth buried in noise: a pure-latency fit
        alpha, beta = float(np.mean(y)), 0.0
    elif alpha < 0.0:
        # latency buried in noise: a pure-bandwidth fit through 0
        alpha, beta = 0.0, float((x @ y) / (x @ x))
    pred = alpha + beta * x
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = (1.0 - ss_res / ss_tot) if ss_tot > 0 else None
    return {"alpha_s": alpha, "beta_s_per_byte": beta,
            "npoints": len(pts),
            "r2": (round(r2, 6) if r2 is not None else None)}


def predict_seconds(fit, nbytes) -> float | None:
    """``alpha + beta * bytes`` of one fitted kind; None when the fit is
    absent."""
    if not isinstance(fit, dict) or "alpha_s" not in fit:
        return None
    return (float(fit["alpha_s"])
            + float(fit.get("beta_s_per_byte", 0.0))
            * max(float(nbytes), 0.0))


# -- timing ---------------------------------------------------------------

def _sync(t) -> None:
    from acg_tpu_torch._device import device_sync
    device_sync(t.device)


def _time_dispatch(runner, repeats: int = TIMED_REPEATS) -> float:
    """Min of ``repeats`` wall seconds of one ``runner()`` between two
    synchronizes (the runner returns a tensor on its device); a first,
    untimed call warms the caches and builds the kernels."""
    _sync(runner())
    ts = []
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        _sync(runner())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _launches_since(before: dict) -> dict:
    """The hand kernels launched since ``before`` (a copy of
    ``ops.kernels.launches``), nonzero entries only."""
    from acg_tpu_torch.ops import kernels as K
    return {k: v - before.get(k, 0) for k, v in K.launches.items()
            if v - before.get(k, 0)}


def _snapshot() -> dict:
    from acg_tpu_torch.ops import kernels as K
    return dict(K.launches)


# -- the collective kinds on stacked parts --------------------------------

def _collective_program(nparts: int, kind: str, nbytes: int, reps: int,
                        device):
    """``reps`` chained rounds of one kind over ``nparts`` stacked f32
    parts.  Returns ``(runner, bytes_per_part)``: the realised payload a
    part sends, which the fit is over."""
    import torch

    from acg_tpu_torch.parallel.reductions import psum

    P = int(nparts)
    item = 4
    if kind == "all_reduce":
        m = max(int(nbytes) // item, 1)
        x = torch.ones((P, m), dtype=torch.float32, device=device)
        scale = 1.0 / P

        def round_(v):
            # the sum of P equal parts, rescaled (the chained value stays
            # 1.0), written to each part: a broadcast view would let the
            # next round read one part's row P times from the L2
            return (psum(v) * scale).expand(P, m).contiguous()
        payload = m * item
    elif kind == "all_to_all":
        m = max(int(nbytes) // (item * P), 1)
        x = torch.ones((P, P, m), dtype=torch.float32, device=device)

        def round_(v):
            return v.transpose(0, 1).contiguous()
        payload = P * m * item
    elif kind == "collective_permute":
        m = max(int(nbytes) // item, 1)
        x = torch.ones((P, m), dtype=torch.float32, device=device)

        def round_(v):
            return torch.roll(v, 1, 0)
        payload = m * item
    else:
        raise ValueError(f"unknown collective kind {kind!r}")

    def run():
        v = x
        for _ in range(int(reps)):
            v = round_(v)
        return v

    return run, payload


def bench_collectives(nparts: int, sizes_bytes, reps: int = DEFAULT_REPS,
                      repeats: int = TIMED_REPEATS, device="cpu") -> dict:
    """Sweep the three plain collective kinds across message sizes; one
    ``{"alpha_s", "beta_s_per_byte", ..., "points": [...]}`` entry per
    kind."""
    out: dict = {}
    for kind in ("all_reduce", "all_to_all", "collective_permute"):
        points = []
        for nbytes in sizes_bytes:
            runner, payload = _collective_program(nparts, kind, int(nbytes),
                                                  reps, device)
            secs = _time_dispatch(runner, repeats) / reps
            points.append({"bytes": int(payload), "seconds": float(secs)})
        fit = fit_alpha_beta([(p["bytes"], p["seconds"])
                              for p in points]) or {}
        out[kind] = {**fit, "points": points}
    return out


def _dma_counts(nparts: int, maxcnt: int,
                distance: int | None) -> np.ndarray:
    """The count matrix of a benchmark exchange: ``distance=None`` the
    dense exchange, a ring distance d the distance-d pairs only."""
    cnt = np.zeros((nparts, nparts), np.int32)
    for p in range(nparts):
        for q in range(nparts):
            if p == q:
                continue
            d = min((q - p) % nparts, (p - q) % nparts)
            if distance is None or d == int(distance):
                cnt[p, q] = maxcnt
    return cnt


def _dma_program(nparts: int, maxcnt: int, reps: int, device,
                 distance: int | None = None):
    """``reps`` chained K6 exchanges of an ``(nparts, nparts, maxcnt)``
    f32 window plane (the put itself: no pack or unpack), the two planes
    taking turns as send and receive.  Returns ``(runner,
    bytes_per_part, peers_per_part)``."""
    import torch

    from acg_tpu_torch.ops import kernels as K

    cnt = _dma_counts(int(nparts), int(maxcnt), distance)
    peers = int((cnt[0] > 0).sum())
    gated = distance is not None
    counts = torch.from_numpy(cnt).to(device)
    planes = [torch.ones((nparts, nparts, maxcnt), dtype=torch.float32,
                         device=device),
              torch.zeros((nparts, nparts, maxcnt), dtype=torch.float32,
                          device=device)]

    def run():
        for i in range(int(reps)):
            K.halo_put(planes[i % 2], counts, planes[(i + 1) % 2],
                       gate_by_counts=gated)
        return planes[int(reps) % 2]

    return run, peers * maxcnt * 4, peers


def bench_dma(nparts: int, sizes_bytes, reps: int = DEFAULT_REPS,
              repeats: int = TIMED_REPEATS, device="cpu") -> dict:
    """The one-sided transport's sweep: dense K6 exchanges across window
    sizes, fitted over the bytes a part puts (P-1 windows)."""
    points = []
    for nbytes in sizes_bytes:
        maxcnt = max(int(nbytes) // (4 * max(nparts - 1, 1)), 1)
        runner, payload, _ = _dma_program(nparts, maxcnt, reps, device)
        secs = _time_dispatch(runner, repeats) / reps
        points.append({"bytes": int(payload), "seconds": float(secs)})
    fit = fit_alpha_beta([(p["bytes"], p["seconds"])
                          for p in points]) or {}
    import torch
    route = "K6" if torch.device(device).type == "cuda" else "plain"
    return {**fit, "points": points, "route": route}


def bench_dma_edges(nparts: int, window_bytes: int,
                    reps: int = DEFAULT_REPS,
                    repeats: int = TIMED_REPEATS,
                    device="cpu") -> list[dict]:
    """Per-edge K6 timing by ring distance: one exchange gated to the
    distance-d pairs for each d (every part puts one ``window_bytes``
    window to its distance-d peers)."""
    maxcnt = max(int(window_bytes) // 4, 1)
    rows = []
    for d in range(1, nparts // 2 + 1):
        runner, _payload, peers = _dma_program(nparts, maxcnt, reps,
                                               device, distance=d)
        secs = _time_dispatch(runner, repeats) / reps
        rows.append({"distance": int(d),
                     "window_bytes": int(maxcnt * 4),
                     "peers_per_shard": int(peers),
                     "put_wait_seconds": float(secs)})
    return rows


# -- measured segment decomposition ---------------------------------------

def segment_decomposition(solver, b, reps: int = SEGMENT_REPS,
                          repeats: int = TIMED_REPEATS) -> dict:
    """The measured SpMV, halo and reduction segments of the solver's
    iteration (:func:`acg_tpu_torch.recurrence.build_dist_segment_probes`
    or ``build_single_segment_probes``), each ``reps`` chained rounds.
    The halo segment is inside the SpMV segment, so the explained
    s/iter is ``spmv + reduction``; the rest of a measured s/iter is the
    vector updates and the loop's control.  A tier the probes do not
    cover (a ValueError: the CA recurrences, the fused single-device
    kernels, rank mode) degrades to ``{"available": False, "why"}``, as
    does any failure on the CPU; on a CUDA device a kernel's error
    raises."""
    from acg_tpu_torch import recurrence

    try:
        if getattr(solver, "problem", None) is not None:
            probes = recurrence.build_dist_segment_probes(solver, b, reps)
        else:
            probes = recurrence.build_single_segment_probes(solver, b,
                                                            reps)
    except ValueError as e:
        return {"available": False, "why": f"{type(e).__name__}: {e}"}
    from acg_tpu_torch.perfmodel import _dispatch_counter

    segs: dict = {}
    launches: dict = {}
    try:
        for name, runner, calls in probes:
            before = _snapshot()
            secs = _time_dispatch(runner, repeats) / reps
            # what a round dispatches (counted on one more, untimed
            # chain): the part of an iteration's launches the segment's
            # seconds already hold
            mid = _snapshot()
            with _dispatch_counter() as m:
                _sync(runner())
            kern = sum(_launches_since(mid).values())
            got = _launches_since(before)
            if got:
                launches[name] = got
            segs[name] = {"s_per_call": float(secs),
                          "calls_per_iteration": float(calls),
                          "s_per_iteration": float(secs) * float(calls),
                          "dispatches_per_call": (m.ops + kern) / reps}
    except Exception as e:  # noqa: BLE001 -- the CPU degrades, the card raises
        if solver.device.type == "cuda":
            raise
        return {"available": False, "why": f"{type(e).__name__}: {e}"}
    explained = sum(v["s_per_iteration"] for k, v in segs.items()
                    if k != "halo")
    out = {"available": True, "reps": int(reps), "segments": segs,
           "explained_s_per_iteration": float(explained),
           "note": "halo is contained in the spmv segment; "
                   "explained = spmv + reduction"}
    if launches:
        out["kernel_launches"] = launches
    return out


def comm_round_dispatches(solver, b) -> dict:
    """``{"reduction": n, "halo": n}``: the operations and hand-kernel
    launches of one reduction round and of one halo exchange of the
    stacked ``solver`` (:func:`acg_tpu_torch.recurrence.dist_comm_rounds`),
    each counted on a second call after a first one has built its
    kernels; ``halo`` is absent without ghosts."""
    from acg_tpu_torch import recurrence
    from acg_tpu_torch._device import device_sync
    from acg_tpu_torch.perfmodel import _dispatch_counter

    red, halo, v = recurrence.dist_comm_rounds(solver, b)
    out = {}
    for name, fn in (("reduction", red), ("halo", halo)):
        if fn is None:
            continue
        fn(v)
        device_sync(v.device)
        mid = _snapshot()
        with _dispatch_counter() as m:
            fn(v)
        device_sync(v.device)
        out[name] = m.ops + sum(_launches_since(mid).values())
    return out


# -- the calibration document ---------------------------------------------

def calibration_id(doc: dict) -> str:
    """Content-hashed id (``acg_tpu/commbench.py:384``, the same hash):
    any edit to the measurements makes another id."""
    payload = {k: v for k, v in doc.items() if k != "calibration_id"}
    h = hashlib.sha256(json.dumps(payload, sort_keys=True,
                                  default=str).encode()).hexdigest()
    backend = "x"
    man = doc.get("manifest")
    if isinstance(man, dict) and isinstance(man.get("backend"), dict):
        backend = str(man["backend"].get("platform", "x"))
    return f"cb-{backend}-{int(doc.get('nparts', 0))}p-{h[:10]}"


def _num(v) -> float | None:
    """A JSON value as a finite float, or None: the validator reports a
    malformed value, it never raises on one."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    v = float(v)
    return v if np.isfinite(v) else None


def validate_commbench(doc) -> list[str]:
    """Problems with a commbench document (empty = valid): schema, id
    integrity, per-kind fit and point sanity, edge rows
    (``acg_tpu/commbench.py:407``)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != COMMBENCH_SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, expected "
                        f"{COMMBENCH_SCHEMA!r}")
        return problems
    cid = doc.get("calibration_id")
    if not isinstance(cid, str) or not cid:
        problems.append("missing calibration_id")
    elif cid != calibration_id(doc):
        problems.append("calibration_id does not match the document "
                        "content (edited after capture?)")
    nparts = doc.get("nparts")
    if not isinstance(nparts, int) or isinstance(nparts, bool) \
            or nparts < 1:
        problems.append(f"nparts must be a positive int "
                        f"(got {nparts!r})")
    colls = doc.get("collectives")
    if not isinstance(colls, dict) or not colls:
        problems.append("missing collectives section")
        return problems
    fitted = 0
    for kind, entry in colls.items():
        if kind not in KINDS:
            problems.append(f"unknown collective kind {kind!r}")
            continue
        if not isinstance(entry, dict):
            problems.append(f"{kind}: not an object")
            continue
        if "alpha_s" not in entry:
            continue  # an unfitted kind is allowed
        alpha = _num(entry["alpha_s"])
        beta = _num(entry.get("beta_s_per_byte", 0.0))
        if alpha is None or beta is None or alpha < 0 or beta < 0:
            problems.append(f"{kind}: alpha/beta not nonnegative "
                            f"numbers")
        pts = entry.get("points")
        if not isinstance(pts, list) or not pts:
            problems.append(f"{kind}: fitted without points")
        else:
            for p in pts:
                nb = _num(p.get("bytes")) if isinstance(p, dict) else None
                sec = (_num(p.get("seconds")) if isinstance(p, dict)
                       else None)
                if nb is None or sec is None or nb < 0 or sec <= 0:
                    problems.append(f"{kind}: bad point {p!r}")
                    break
        fitted += 1
    if not fitted:
        problems.append("no fitted collective kinds")
    edges = doc.get("edges") or []
    if not isinstance(edges, list):
        problems.append("edges is not a list")
        edges = []
    for row in edges:
        d = _num(row.get("distance")) if isinstance(row, dict) else None
        sec = (_num(row.get("put_wait_seconds"))
               if isinstance(row, dict) else None)
        if d is None or sec is None or d < 1 or sec <= 0:
            problems.append(f"bad edge row {row!r}")
            break
    return problems


def load_calibration(path) -> dict:
    """Read and validate a saved commbench document; ValueError names
    every problem (the ``--calibration`` refusal text)."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except ValueError as e:
            raise ValueError(f"not JSON ({e})")
    problems = validate_commbench(doc)
    if problems:
        raise ValueError("not a valid acg-tpu-commbench/1 document: "
                         + "; ".join(problems))
    return doc


def write_document(doc: dict, dest) -> None:
    """Write the document to a path (``"-"``: stdout)."""
    if dest in (None, "-"):
        json.dump(doc, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return
    with open(dest, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


# -- calibrated comm pricing ----------------------------------------------

def _halo_fit(cal: dict, led: dict) -> tuple[dict | None, str]:
    """``(fit, kind_used)`` of the ledger's halo transport: the dma fit
    under the one-sided transport when it was benchmarked, else the
    all_to_all fit; ``kind_used`` names the fit applied."""
    kinds = cal.get("collectives", {})
    kind = "dma" if led.get("transport") == "dma" else "all_to_all"
    fit = kinds.get(kind)
    if not isinstance(fit, dict) or "alpha_s" not in fit:
        kind, fit = "all_to_all", kinds.get("all_to_all")
    if not isinstance(fit, dict) or "alpha_s" not in fit:
        return None, kind
    return fit, kind


def halo_exchange_seconds(cal: dict, led: dict) -> float | None:
    """Seconds of one halo exchange from the calibration's fit of the
    ledger's transport, over the padded plane the transport moves
    (``halo_plane_bytes_per_exchange``)."""
    if not led.get("halo_bytes_per_iteration"):
        return 0.0
    fit, _kind = _halo_fit(cal, led)
    nb = led.get("halo_plane_bytes_per_exchange")
    if nb is None:
        nb = (led.get("halo_bytes_per_iteration", 0)
              / max(int(led.get("nparts", 1)), 1))
    return predict_seconds(fit, nb)


def comm_seconds(cal: dict, led: dict) -> dict | None:
    """Communication seconds an iteration from the fitted alpha-beta
    model; None when the ledger or a needed fit is unusable."""
    if not isinstance(led, dict) or "error" in led:
        return None
    kinds = cal.get("collectives", {})
    nred = float(led.get("allreduce_per_iteration", 0) or 0)
    ar_bytes = float(led.get("allreduce_bytes_per_iteration", 0) or 0)
    ar_s = 0.0
    if nred > 0:
        p = predict_seconds(kinds.get("all_reduce"), ar_bytes / nred)
        if p is None:
            return None
        ar_s = nred * p
    halo_one = halo_exchange_seconds(cal, led)
    if halo_one is None:
        return None
    nex = float(led.get("halo_exchanges_per_iteration", 1) or 1)
    halo_s = (halo_one * nex
              if led.get("halo_bytes_per_iteration") else 0.0)
    _fit, kind = _halo_fit(cal, led)
    return {"allreduce_s": float(ar_s), "halo_s": float(halo_s),
            "total_s": float(ar_s + halo_s),
            "halo_kind": kind,
            "calibration_id": str(cal.get("calibration_id", ""))}


# -- the --commbench CLI mode ---------------------------------------------

def _fmt_gbs(beta: float) -> str:
    if beta <= 0:
        return "inf GB/s"
    return f"{1.0 / beta / 1e9:,.2f} GB/s"


def device_name(device) -> str:
    """The device's name: the card's, or ``cpu``."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def visible_parts(device, cap: int) -> int:
    """The default part count of the observatory passes: one part for
    each visible device, at most ``cap`` (one card: one part)."""
    import torch
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    return max(min(int(n), int(cap)), 1)


def collect_document(args, dtype, vec_dtype, err, device) -> dict:
    """Run the observatory over the configured case on ``device`` and
    return the commbench document (printing the summary to ``err``)."""
    import torch

    from acg_tpu_torch import metrics, perfmodel, telemetry
    from acg_tpu_torch.parallel.mesh import PARTS_AXIS
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    csr = perfmodel.explain_matrix(args)
    nparts = args.nparts or visible_parts(
        device, 4 if getattr(args, "explain", False) else 8)
    if nparts < 2:
        raise SystemExit("acg-tpu-torch: --commbench benchmarks the "
                         "collectives of the stacked parts; need --nparts "
                         ">= 2 (or more than one visible device)")
    sweep = GPU_SWEEP if on_cuda else CPU_SWEEP
    reps = DEFAULT_REPS
    name = device_name(device)
    err.write(f"== commbench: {nparts} stacked parts on {device.type} "
              f"({name}), {len(sweep)}-size sweep x {reps} chained "
              f"rounds ==\n")
    launches: dict = {}
    before = _snapshot()
    colls = bench_collectives(nparts, sweep, reps=reps, device=device)
    launches["collectives"] = _launches_since(before)
    edges: list[dict] = []
    before = _snapshot()
    try:
        dma_entry = bench_dma(nparts, sweep, reps=reps, device=device)
        launches["dma_sweep"] = _launches_since(before)
        before = _snapshot()
        edges = bench_dma_edges(nparts, max(sweep), reps=reps,
                                device=device)
        launches["edges"] = _launches_since(before)
    except Exception as e:  # noqa: BLE001 -- the CPU degrades, the card raises
        if on_cuda:
            raise
        dma_entry = {"unavailable": f"{type(e).__name__}: {e}"}
        err.write(f"  dma transport bench unavailable: "
                  f"{type(e).__name__}: {e}\n")
    colls["dma"] = dma_entry
    for kind in KINDS:
        entry = colls.get(kind)
        if not isinstance(entry, dict) or "alpha_s" not in entry:
            why = (entry or {}).get("unavailable", "not benchmarked")
            err.write(f"  {kind:<19}: ({why})\n")
            continue
        err.write(f"  {kind:<19}: alpha {entry['alpha_s']:.3e} s, "
                  f"beta {entry['beta_s_per_byte']:.3e} s/B "
                  f"({_fmt_gbs(entry['beta_s_per_byte'])}), "
                  f"{entry['npoints']} point(s)"
                  + (f", r2 {entry['r2']:.3f}"
                     if entry.get("r2") is not None else "") + "\n")
    for row in edges:
        err.write(f"  dma edge d={row['distance']}: "
                  f"{row['window_bytes']:,} B window put "
                  f"{row['put_wait_seconds']:.3e} s "
                  f"({row['peers_per_shard']} peer(s)/part)\n")
    scalar_lat = None
    ar_pts = (colls.get("all_reduce") or {}).get("points") or []
    if ar_pts:
        scalar_lat = min(p["seconds"] for p in ar_pts)
        err.write(f"  scalar all_reduce latency: {scalar_lat:.3e} s\n")

    # the case's segments, through the dist-tier construction --explain
    # analyses (one copy: the calibration describes what it prices)
    segs: dict = {"available": False,
                  "why": "dist tier construction failed"}
    case: dict = {"matrix": str(args.A), "n": int(csr.shape[0]),
                  "nnz": int(csr.nnz)}
    try:
        solver = perfmodel.build_explain_dist_solver(
            args, csr, nparts, dtype, vec_dtype, device)
        b = np.ones(csr.shape[0])
        segs = segment_decomposition(solver, b)
        # one warm-up solve, then the min of TIMED_REPEATS timed ones
        K = max(8, min(args.max_iterations, 60))
        before = _snapshot()
        best = float("inf")
        for i in range(TIMED_REPEATS):
            solver.stats.tsolve = 0.0
            solver.solve(b, criteria=StoppingCriteria(maxits=K),
                         warmup=1 if i == 0 else 0, host_result=False,
                         raise_on_divergence=False)
            best = min(best, solver.stats.tsolve)
        launches["timed_solve"] = _launches_since(before)
        case["measured_s_per_iteration"] = best / K
        case["timed_iterations"] = K
        case["warmup_solves"] = 1
        case["timed_solves"] = TIMED_REPEATS
        case["transport"] = solver.comm
        case["kernels"] = solver.kernels
    except Exception as e:  # noqa: BLE001 -- the CPU degrades, the card raises
        if on_cuda:
            raise
        err.write(f"acg-tpu-torch: commbench segment pass failed: "
                  f"{type(e).__name__}: {e}\n")
        segs = {"available": False, "why": f"{type(e).__name__}: {e}"}
    if segs.get("available"):
        parts_txt = ", ".join(
            f"{k} {v['s_per_iteration']:.3e} s/iter"
            for k, v in segs["segments"].items())
        err.write(f"  segments: {parts_txt}\n")
        meas = case.get("measured_s_per_iteration")
        if meas:
            err.write(f"  explained {segs['explained_s_per_iteration']:.3e}"
                      f" of measured {meas:.3e} s/iter "
                      f"({segs['explained_s_per_iteration'] / meas:.0%}; "
                      f"remainder = vector updates/control)\n")

    man = telemetry.run_manifest(metric="commbench", matrix=str(args.A),
                                 dtype=args.dtype)
    doc = {
        "schema": COMMBENCH_SCHEMA,
        "manifest": man,
        "nparts": int(nparts),
        "mesh_shape": {PARTS_AXIS: int(nparts)},
        "transport_layout": TRANSPORT_LAYOUT,
        "backend": device.type,
        "device": name,
        "interpret": not on_cuda,
        "reps": int(reps),
        "timed_repeats": TIMED_REPEATS,
        "sweep_bytes": [int(s) for s in sweep],
        "collectives": colls,
        "scalar_allreduce_latency_s": scalar_lat,
        "edges": edges,
        "segments": segs,
        "case": case,
    }
    launches = {k: v for k, v in launches.items() if v}
    if launches:
        doc["kernel_launches"] = launches
    doc["calibration_id"] = calibration_id(doc)
    err.write(f"  calibration id: {doc['calibration_id']}\n\n")
    metrics.record_commbench(doc)
    return doc


def run_commbench(args, dtype, vec_dtype, device) -> int:
    """Standalone ``--commbench``: run the suite, validate
    the document with this module's validator (a document that cannot be
    re-read is a bug), and write it."""
    err = sys.stderr
    doc = collect_document(args, dtype, vec_dtype, err, device)
    problems = validate_commbench(doc)
    if problems:
        err.write("acg-tpu-torch: commbench produced an invalid document: "
                  + "; ".join(problems) + "\n")
        return 1
    try:
        write_document(doc, args.commbench)
    except OSError as e:
        err.write(f"acg-tpu-torch: --commbench {args.commbench}: {e}\n")
        return 1
    if args.commbench not in (None, "-"):
        err.write(f"acg-tpu-torch: commbench document written to "
                  f"{args.commbench}\n")
    return 0
