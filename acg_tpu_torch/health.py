"""Numerical health observatory: in-loop true-residual audits, Lanczos
spectrum estimation, and accuracy gates across the solver tiers.

The port's copy of ``acg_tpu/health.py``: the host side (the spec, the
audit summary and events, the spectrum estimate) is the reference's;
the device helpers are torch functions the eager loops of
:mod:`acg_tpu_torch.solvers.cg` call at host-known iterations (the
audit's ``b - A x`` and ABFT's ``c = A 1`` run through the loop's own
SpMV, kernel K1 on DIA matrices).  The text below is the reference's.

Pipelined CG trades attainable accuracy for hidden latency: the
recursively-updated residual drifts away from the true residual
``b - A x`` as rounding accumulates through the extra recurrences, and
the drift grows with pipeline depth (Cornelis & Vanroose,
arXiv:1801.04728; the global-reduction-pipelined variants of
arXiv:1905.06850 inherit the same trade).  Nothing in the existing
observability stack (telemetry ring, cost model, service metrics)
watches *numerical* health -- a solve can report ``converged`` from a
recurrence residual that no longer resembles ``b - A x``.  This module
closes that gap with three layers:

1. **In-loop true-residual audit** (``--audit-every K``): every K
   iterations the compiled loop recomputes ``b - A x`` through the
   tier's OWN SpMV/halo machinery and carries the relative gap
   ``||r_true - r_rec|| / ||b||`` in a small audit vector riding the
   loop carry (and, when telemetry is armed, an extra ``gap`` column in
   the convergence ring).  A gap past ``--gap-threshold`` emits a
   structured ``accuracy_degraded`` event; ``--on-gap replace`` exits
   the loop through the breakdown path so the existing
   :class:`~acg_tpu.solvers.resilience.RecoveryDriver` restarts from
   the recomputed true residual -- a residual-replacement restart --
   and ``--on-gap abort`` raises.  Disarmed (the default) every tier's
   lowered program is byte-identical (static jit argument, the
   telemetry/faults/precond discipline; pinned in
   tests/test_hlo_structure.py).

2. **Post-hoc spectrum estimation**: the telemetry ring already records
   the per-iteration ``(alpha, beta)`` CG coefficients, which ARE the
   entries of the Lanczos tridiagonal ``T_k`` of the (preconditioned)
   operator.  :func:`spectrum_estimate` rebuilds ``T_k``, reports
   estimated extremal eigenvalues and ``kappa(M^-1 A)``, and
   :func:`predicted_iterations` turns the classical CG error bound into
   a predicted-vs-measured iteration verdict (the ``--explain``
   "convergence" section and the ``health:`` stats section).

3. **Device-side stagnation/divergence detectors**
   (``--stall-window N``): a windowed residual-non-decrease counter and
   dot-product sign anomalies (a negative ``(r, r)``/``(r, z)`` is
   arithmetic poison, not a property of an SPD system) feed the
   existing breakdown path.

Surfaces: the append-only ``health:`` stats section (stats schema
bumped additively to ``acg-tpu-stats/5``), ``acg_health_*`` Prometheus
gauges/counters (:mod:`acg_tpu.metrics`), the ``--explain``
convergence verdict, and gap drift tracked by ``--soak`` alongside
latency drift.

Matrix-free generalization (ROADMAP item 5, acg_tpu.ops.operator):
every mechanism here consumes the operator ONLY through applies -- the
audit recomputes ``b - A x`` through the tier's SpMV selection, and the
ABFT column checksum ``c = A^T 1`` is computed *through the apply* at
setup (``spmv_(A, ones)`` in the solve programs) -- so arming
``--audit-every``/``--abft`` over a matrix-free operator needs no code
here at all: the dispatch in :mod:`acg_tpu.ops.spmv` routes the applies
and the audited trajectories stay bitwise-equal to the assembled
tier's (tests/test_matfree.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

ACTIONS = ("warn", "replace", "abort")

# audit-vector slot layout (the sdt (4,) array riding the loop carry)
AUD_GAP = 0        # latest audited relative gap ||r_true - r_rec||/||b||
AUD_GAP_MAX = 1    # running max over the solve's audits
AUD_COUNT = 2      # audits performed
AUD_STALL = 3      # consecutive non-decreasing-residual iterations
AUD_SLOTS = 4
# ABFT extension (spec.abft -- the Huang-Abraham checksum SpMV test,
# part of the survivability tier): four more slots, present ONLY when
# abft is armed so an abft-off spec keeps the historical 4-slot vector
ABFT_REL = 4       # latest relative checksum mismatch
ABFT_REL_MAX = 5   # running max
ABFT_COUNT = 6     # checks performed
ABFT_TRIPS = 7     # checks whose mismatch exceeded the threshold
ABFT_SLOTS = 8


@dataclasses.dataclass(frozen=True)
class HealthSpec:
    """One parsed numerical-health selection: immutable and hashable so
    it rides the solve programs' STATIC jit arguments (the FaultSpec /
    PrecondSpec design) -- a given spec compiles its own cache entry
    and ``None`` compiles the byte-identical unaudited program.

    ``every``: audit period in iterations (0 = no audit).
    ``threshold``: relative-gap trip level (0 = record-only).
    ``action``: what a tripped gap does -- ``warn`` (event only),
    ``replace`` (breakdown-path exit; the recovery driver restarts from
    the recomputed true residual = residual replacement), ``abort``
    (breakdown-path exit with no restart budget).
    ``stall_window``: consecutive non-decreasing-residual iterations
    before the stagnation detector trips the breakdown path (0 = off).
    ``abft``: arm the Huang-Abraham checksum-protected SpMV (the
    survivability tier): the column checksum ``c = A^T 1`` (= ``A 1``
    for the SPD systems this suite solves) is computed once through the
    tier's own SpMV, and every ``every`` iterations the in-loop test
    compares ``sum(A p)`` against ``(c, p)`` -- an identity that holds
    to rounding, so SILENT bit-level corruption of the SpMV output
    (``sdc:flip``) is detected on device at machine-epsilon scale,
    far below any useful gap threshold, and routed into the breakdown
    -> rollback/recovery path.  ``abft_threshold``: relative mismatch
    trip level (0 = a dtype/size-derived default,
    :func:`abft_default_threshold`).
    """

    every: int = 0
    threshold: float = 0.0
    action: str = "warn"
    stall_window: int = 0
    abft: bool = False
    abft_threshold: float = 0.0

    def __post_init__(self):
        if self.every < 0:
            raise ValueError("audit period (every) must be >= 0")
        if self.threshold < 0:
            raise ValueError("gap threshold must be >= 0")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown on-gap action {self.action!r} "
                             f"(one of {', '.join(ACTIONS)})")
        if self.stall_window < 0:
            raise ValueError("stall window must be >= 0")
        if self.action != "warn" and not (self.every and self.threshold):
            raise ValueError(
                f"on-gap action {self.action!r} needs an armed audit "
                f"(every > 0) AND a positive gap threshold -- a gate "
                f"that could never trip must refuse, not silently warn")
        if self.abft and not self.every:
            raise ValueError(
                "the ABFT checksum test fires at the audit cadence; "
                "arm it with a positive audit period (every > 0)")
        if self.abft_threshold < 0:
            raise ValueError("ABFT threshold must be >= 0 (0 = the "
                             "dtype-derived default)")
        if self.abft_threshold and not self.abft:
            raise ValueError("abft_threshold needs abft armed -- a "
                             "threshold that could never be consulted "
                             "must refuse")

    @property
    def armed(self) -> bool:
        return self.every > 0 or self.stall_window > 0

    @property
    def arms_detect(self) -> bool:
        """Whether this spec needs the breakdown-detection machinery in
        the loop (early exit): tripping gaps, the stagnation/sign
        detectors, and the ABFT test (always a tripper: a detected
        checksum mismatch that could not exit the loop would be a
        detector wired to nothing) do; a record-only gap audit does
        not."""
        return ((self.action != "warn" and self.threshold > 0
                 and self.every > 0) or self.stall_window > 0
                or self.abft)

    def __str__(self) -> str:
        parts = [f"audit-every={self.every}"]
        if self.threshold:
            parts.append(f"gap-threshold={self.threshold:g}")
        parts.append(f"on-gap={self.action}")
        if self.stall_window:
            parts.append(f"stall-window={self.stall_window}")
        if self.abft:
            parts.append("abft")
            if self.abft_threshold:
                parts.append(f"abft-threshold={self.abft_threshold:g}")
        return ",".join(parts)


def make_spec(every: int = 0, threshold: float = 0.0,
              action: str = "warn",
              stall_window: int = 0, abft: bool = False,
              abft_threshold: float = 0.0) -> HealthSpec | None:
    """``HealthSpec`` or None when nothing is armed (the CLI entry
    point; None keeps every call site's kwargs untouched so disarmed
    programs stay byte-identical)."""
    spec = HealthSpec(every=int(every), threshold=float(threshold),
                      action=str(action), stall_window=int(stall_window),
                      abft=bool(abft),
                      abft_threshold=float(abft_threshold))
    return spec if spec.armed else None


# -- device-side helpers (the eager loops' own steps) ----------------------
#
# The reference runs these inside its compiled loop under ``lax.cond``;
# here the audit cadence is a host decision -- a live loop step's host
# index is its trajectory iteration -- so a non-audited step launches
# nothing, and every update is a ``where`` on the loop's ``live`` flag
# (a frozen step past convergence or breakdown leaves the vector alone).

def audit_init(sdt, spec: HealthSpec | None = None, device=None):
    """The carried audit vector: ``[gap, gap_max, naudits, stall]``,
    gap NaN until the first audit fires (NaN > threshold is False, so
    an unaudited solve can never trip).  With ABFT armed the vector
    grows four checksum slots ``[rel, rel_max, nchecks, ntrips]``
    (rel NaN until the first check)."""
    import torch

    slots = [math.nan, 0.0, 0.0, 0.0]
    if spec is not None and spec.abft:
        slots += [math.nan, 0.0, 0.0, 0.0]
    return torch.tensor(slots, dtype=sdt, device=device)


def _masked(new, old, live):
    import torch

    return new if live is None else torch.where(live, new, old)


def relative_gap(rt, r, dot, bnrm2, sdt):
    """THE gap definition, shared by every tier's audit:
    ``||r_true - r_rec|| / ||b||`` from the tier's freshly-computed
    true residual ``rt`` and its recurrence residual ``r``, with the
    difference widened to the scalar dtype before the (tier-supplied,
    possibly psum'd or compensated) dot."""
    import torch

    d = (rt - r).to(sdt)
    return torch.sqrt(dot(d, d)) / bnrm2


def audit_fires(spec: HealthSpec, k: int) -> bool:
    """Host-side: is trajectory iteration ``k`` on the audit period
    (``(k + 1) % every == 0``)?"""
    return bool(spec.every) and (int(k) + 1) % int(spec.every) == 0


def audit_update(aud, spec: HealthSpec, k, compute_gap, live=None):
    """``(aud', fire)``: run the audit when trajectory iteration ``k``
    is on the period, else pass the vector through (``fire`` False, no
    launch).  ``compute_gap()`` is the tier's closure producing the
    relative gap through its own SpMV."""
    if not audit_fires(spec, k):
        return aud, False
    import torch

    gap = compute_gap().reshape(()).to(aud.dtype)
    new = aud.clone()
    new[AUD_GAP] = gap
    new[AUD_GAP_MAX] = torch.maximum(aud[AUD_GAP_MAX], gap)
    new[AUD_COUNT] = aud[AUD_COUNT] + 1
    return _masked(new, aud, live), True


def stall_update(aud, spec: HealthSpec, progressing, live=None):
    """Windowed residual-non-decrease counter: reset on progress,
    increment otherwise (``progressing`` = this iteration's residual
    scalar decreased)."""
    if not spec.stall_window:
        return aud
    import torch

    new = aud.clone()
    new[AUD_STALL] = torch.where(progressing.reshape(()),
                                 torch.zeros((), dtype=aud.dtype,
                                             device=aud.device),
                                 aud[AUD_STALL] + 1)
    return _masked(new, aud, live)


def abft_default_threshold(sdt, n: int) -> float:
    """The relative-mismatch trip level when the spec leaves it 0:
    generous rounding headroom (the checksum identity holds to a few
    ulps of the summation; 64*sqrt(n) eps covers the worst observed
    cancellation) yet orders of magnitude below a single flipped
    element's signature (~2/n of the denominator for near-uniform
    SpMV outputs)."""
    import torch

    if isinstance(sdt, torch.dtype):
        eps = float(torch.finfo(sdt).eps)
    else:
        eps = float(np.finfo(np.dtype(sdt)).eps)
    return 64.0 * math.sqrt(max(float(n), 1.0)) * eps


def abft_update(aud, spec: HealthSpec, k, y, x, cvec, dot3, sdt,
                n: int, live=None):
    """The Huang-Abraham checksum verification of ``y = A x`` at the
    audit cadence: ``sum(y)`` against ``(c, x)`` with ``c = A 1``
    (computed once through the tier's own SpMV), the three scalars from
    the tier's fused ``dot3`` (one psum on stacked parts).  The relative
    mismatch is measured against ``sqrt(n (y, y)) + |sum y| + |(c, x)|``;
    a mismatch past the (default: dtype-derived) threshold increments
    the trip slot the breakdown predicate reads."""
    if not (spec.abft and audit_fires(spec, k)):
        return aud
    import torch

    tau = spec.abft_threshold or abft_default_threshold(sdt, n)
    ys = y.to(sdt)
    xs = x.to(sdt)
    st, cp, tt = dot3(ys, torch.ones_like(ys), cvec, xs, ys, ys)
    denom = (torch.sqrt(torch.clamp(tt, min=0) * n)
             + torch.abs(st) + torch.abs(cp) + torch.finfo(sdt).tiny)
    rel = (torch.abs(st - cp) / denom).reshape(()).to(aud.dtype)
    new = aud.clone()
    new[ABFT_REL] = rel
    new[ABFT_REL_MAX] = torch.maximum(aud[ABFT_REL_MAX], rel)
    new[ABFT_COUNT] = aud[ABFT_COUNT] + 1
    new[ABFT_TRIPS] = aud[ABFT_TRIPS] + (rel > tau).to(aud.dtype)
    return _masked(new, aud, live)


def trip(aud, spec: HealthSpec):
    """The breakdown-path predicate this spec contributes (a one-element
    bool tensor, or None when no detector trips): a tripped gap (action
    != warn), an exhausted stall window, and/or an ABFT mismatch."""
    t = None

    def orr(a, b):
        return b if a is None else a | b

    if spec.action != "warn" and spec.threshold > 0 and spec.every:
        t = orr(t, aud[AUD_GAP] > spec.threshold)
    if spec.stall_window:
        t = orr(t, aud[AUD_STALL] >= spec.stall_window)
    if spec.abft:
        t = orr(t, aud[ABFT_TRIPS] > 0)
    return t


def ring_gap(aud, fire: bool, sdt):
    """The ``gap`` column value for this iteration's telemetry record:
    the fresh gap when the audit fired, NaN otherwise."""
    import torch

    if fire:
        return aud[AUD_GAP]
    return torch.tensor(math.nan, dtype=sdt, device=aud.device)


# -- host-side audit summary ---------------------------------------------

def _clean(v: float):
    v = float(v)
    return v if math.isfinite(v) else None


def summarize_audit(aud, spec: HealthSpec) -> dict:
    """The ``health:`` stats entries for one solve's fetched audit
    vector (plus the armed configuration, so a reader can interpret
    the numbers without the launching shell)."""
    a = np.asarray(aud, dtype=np.float64).reshape(-1)
    out = {
        "audit_every": int(spec.every),
        "on_gap": spec.action,
        "gap_threshold": float(spec.threshold),
        "naudits": int(a[AUD_COUNT]) if math.isfinite(a[AUD_COUNT])
        else 0,
        "gap_last": _clean(a[AUD_GAP]),
        "gap_max": _clean(a[AUD_GAP_MAX]),
    }
    if spec.stall_window:
        out["stall_window"] = int(spec.stall_window)
        out["stall_count"] = _clean(a[AUD_STALL])
    if spec.abft and a.size >= ABFT_SLOTS:
        out["abft"] = {
            "threshold": float(spec.abft_threshold) or None,
            "nchecks": int(a[ABFT_COUNT]) if math.isfinite(a[ABFT_COUNT])
            else 0,
            "rel_last": _clean(a[ABFT_REL]),
            "rel_max": _clean(a[ABFT_REL_MAX]),
            "ntrips": int(a[ABFT_TRIPS]) if math.isfinite(a[ABFT_TRIPS])
            else 0,
        }
    return out


# the stats.health keys the audit summary owns (cleared when a new
# solve's first attempt reports, so a reused solver never shows a
# previous solve's numbers)
_AUDIT_KEYS = ("audit_every", "on_gap", "gap_threshold", "naudits",
               "gap_last", "gap_max", "stall_window", "stall_count",
               "abft", "spectrum")


def note_audit(stats, aud, spec: HealthSpec, what: str,
               fresh: bool = True) -> bool:
    """Record one solve ATTEMPT's audit vector onto ``stats.health``,
    feed the ``acg_health_*`` metrics, and emit the structured
    ``accuracy_degraded`` event when this attempt's gap exceeded the
    threshold.  ``fresh=False`` (the recovery loop's later attempts and
    the post-restart tail) MERGES with the attempts already recorded:
    ``naudits`` accumulates, ``gap_max`` keeps the worst gap of the
    whole solve -- a recovered solve must still show the drift that
    tripped it -- and ``gap_last`` survives a final attempt too short
    to audit.  Returns True when this attempt exceeded the threshold
    (the caller's recovery loop uses this to tell a gap trip from an
    arithmetic breakdown in its log)."""
    from acg_tpu_torch import metrics, telemetry

    summary = summarize_audit(aud, spec)
    attempt_naudits = summary["naudits"]
    attempt_gap_max = summary.get("gap_max")
    # copy: the fresh=False merge below mutates summary["abft"] in place,
    # and the metrics/event tail must see only THIS attempt's numbers
    attempt_abft = summary.get("abft")
    if attempt_abft is not None:
        attempt_abft = dict(attempt_abft)
    if fresh:
        for k in _AUDIT_KEYS:
            stats.health.pop(k, None)
    else:
        prev = stats.health
        summary["naudits"] += int(prev.get("naudits") or 0)
        pm = prev.get("gap_max")
        if pm is not None:
            summary["gap_max"] = (max(pm, summary["gap_max"])
                                  if summary["gap_max"] is not None
                                  else pm)
        if summary.get("gap_last") is None:
            summary["gap_last"] = prev.get("gap_last")
        pa = prev.get("abft")
        if pa is not None and attempt_abft is not None:
            ab = summary["abft"]
            ab["nchecks"] += int(pa.get("nchecks") or 0)
            ab["ntrips"] += int(pa.get("ntrips") or 0)
            pmx = pa.get("rel_max")
            if pmx is not None:
                ab["rel_max"] = (max(pmx, ab["rel_max"])
                                 if ab["rel_max"] is not None else pmx)
            if ab.get("rel_last") is None:
                ab["rel_last"] = pa.get("rel_last")
    stats.health.update(summary)
    # the Prometheus counter gets only THIS attempt's increment (it is
    # cumulative across the process by construction)
    metrics.record_health_audit(summary.get("gap_last"),
                                attempt_naudits)
    if attempt_abft is not None:
        metrics.record_abft(attempt_abft.get("nchecks") or 0,
                            attempt_abft.get("rel_last"),
                            attempt_abft.get("ntrips") or 0)
        if attempt_abft.get("ntrips"):
            telemetry.record_event(
                stats, "abft_mismatch",
                f"{what}: ABFT checksum mismatch "
                f"{attempt_abft.get('rel_max'):.3e} "
                f"({attempt_abft['ntrips']} tripped check(s)) -- "
                f"silent SpMV corruption detected on device")
    exceeded = (spec.threshold > 0
                and attempt_gap_max is not None
                and attempt_gap_max > spec.threshold)
    if exceeded:
        telemetry.record_event(
            stats, "accuracy_degraded",
            f"{what}: true-residual gap {attempt_gap_max:.3e} "
            f"exceeds threshold {spec.threshold:g} "
            f"(audit every {spec.every}, on-gap {spec.action})")
        metrics.record_gap_trip()
    return exceeded


# -- Lanczos spectrum estimation from the recorded (alpha, beta) ----------

def lanczos_tridiagonal(alphas, betas, pipelined: bool = False,
                        window_start: int = 0):
    """``(diag, offdiag)`` of the Lanczos tridiagonal ``T_m`` implied by
    a run of CG coefficients -- the classical CG <-> Lanczos identity::

        T[k, k]     = 1/alpha_k + beta_{k-1}/alpha_{k-1}   (beta_{-1}=0)
        T[k, k+1]   = sqrt(beta_k) / alpha_k

    ``pipelined`` marks Ghysels-Vanroose traces, whose recorded beta at
    iteration k is the CLASSIC ``beta_{k-1}`` (computed at the top of
    the iteration from the carried gamma) -- the rows are re-aligned
    here.  ``window_start > 0`` (a wrapped telemetry ring) drops the
    leading row whose ``beta_{k-1}/alpha_{k-1}`` term predates the
    window; the inner tridiagonal of a Lanczos run is itself a valid
    Lanczos matrix of the same operator, so the estimate stays sound,
    just over a shorter recurrence.  Returns ``(None, None)`` when
    fewer than 2 usable rows survive."""
    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    m = min(a.size, b.size)
    a, b = a[:m], b[:m]
    if m < 2:
        return None, None
    if pipelined:
        beta_prev = b.copy()                       # row k holds beta_{k-1}
        beta_cur = np.append(b[1:], np.nan)
    else:
        lead = 0.0 if window_start == 0 else np.nan
        beta_prev = np.concatenate([[lead], b[:-1]])
        beta_cur = b
    alpha_prev = np.concatenate([[np.nan], a[:-1]])
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 1.0 / a + np.where(beta_prev == 0.0, 0.0,
                               beta_prev / alpha_prev)
        e = np.sqrt(np.maximum(beta_cur, 0.0)) / a
    start = 0 if np.isfinite(d[0]) else 1
    d, e, a = d[start:], e[start:], a[start:]
    # longest healthy prefix: a poisoned tail (breakdown window, NaN
    # alpha, negative pivot) must not corrupt the whole estimate
    ok = np.isfinite(d) & (a > 0)
    n = int(np.argmin(ok)) if not ok.all() else d.size
    if n < 2:
        return None, None
    d = d[:n]
    e = e[:n - 1]
    if not np.isfinite(e).all():
        # an off-diagonal became non-finite before the diagonal did:
        # keep the prefix before it
        n = int(np.argmin(np.isfinite(e))) + 1
        if n < 2:
            return None, None
        d, e = d[:n], e[:n - 1]
    return d, e


def _tridiag_eigvalsh(d, e):
    try:
        from scipy.linalg import eigh_tridiagonal

        return eigh_tridiagonal(d, e, eigvals_only=True)
    except Exception:  # noqa: BLE001 -- scipy variant/LAPACK issues
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        return np.linalg.eigvalsh(T)


def spectrum_estimate(trace, precond: str | None = None) -> dict | None:
    """Estimated extremal eigenvalues and condition number of the
    (preconditioned) operator from one solve's telemetry window.

    The Ritz values of ``T_m`` converge to ``M^-1 A``'s extremal
    eigenvalues from inside, so ``kappa`` here is a LOWER bound that
    tightens with the iteration count -- good enough to grade a
    preconditioner and to drive the CG iteration bound, and free: the
    scalars were already recorded.  None when the window carries too
    few usable coefficients."""
    if trace is None or trace.records is None:
        return None
    rec = np.asarray(trace.records, dtype=np.float64)
    if rec.ndim != 2 or rec.shape[0] < 2 or rec.shape[1] < 3:
        return None
    # the CA recurrences (acg_tpu.recurrence: *-sstepS / *-plL solver
    # names) record CLASSIC-aligned rows by construction -- s-step
    # records each inner step's plain CG scalars, p(l) records
    # (q^2, 1/d, l^2, d) at solution-advance time, and alpha = 1/d /
    # beta = l^2 satisfy the classic CG<->Lanczos identity exactly --
    # so only the Ghysels-Vanroose names carry the re-alignment marker
    # (their spec names deliberately avoid the "pipelined" substring;
    # pinned in tests/test_recurrence.py)
    pipelined = "pipelined" in str(getattr(trace, "solver", ""))
    d, e = lanczos_tridiagonal(rec[:, 1], rec[:, 2],
                               pipelined=pipelined,
                               window_start=trace.first_iteration)
    if d is None:
        return None
    ev = _tridiag_eigvalsh(d, e)
    lmin = float(ev.min())
    lmax = float(ev.max())
    if not (math.isfinite(lmin) and math.isfinite(lmax)) or lmax <= 0:
        return None
    est: dict = {
        "m": int(d.size),
        "operator": ("M^-1 A" if precond and precond != "none" else "A"),
        "lambda_min": lmin,
        "lambda_max": lmax,
        "window_only": bool(getattr(trace, "wrapped", False)),
    }
    if lmin > 0:
        kappa = lmax / lmin
        est["kappa"] = kappa
        # asymptotic CG convergence factor (sqrt(k)-1)/(sqrt(k)+1)
        sk = math.sqrt(kappa)
        est["convergence_factor"] = (sk - 1.0) / (sk + 1.0)
    else:
        # a non-positive Ritz value: either the run broke down or the
        # window is too short to separate the low end -- report, don't
        # divide
        est["kappa"] = None
    return est


def predicted_iterations(kappa: float, rtol: float) -> int | None:
    """Iterations the classical CG bound predicts to reduce the A-norm
    error by ``rtol``: ``2 ((sqrt(k)-1)/(sqrt(k)+1))^j <= rtol``.  An
    upper bound on a worst-case spectrum -- clustered eigenvalues
    converge faster, so measured <= predicted is the healthy verdict.
    None when the inputs cannot drive the bound."""
    if not kappa or kappa <= 0 or not rtol or not 0 < rtol < 1:
        return None
    sk = math.sqrt(kappa)
    rate = (sk - 1.0) / (sk + 1.0)
    if rate <= 0:
        return 1
    return max(1, int(math.ceil(math.log(2.0 / rtol)
                                / -math.log(rate))))


def convergence_report(trace, niterations: int, rtol: float,
                       precond: str | None = None,
                       kappa_ref: float | None = None) -> dict | None:
    """The ``spectrum`` entry of the ``health:`` section (and the
    ``--explain`` convergence verdict): spectrum estimate + the
    predicted-vs-measured iteration comparison, plus the
    preconditioner-effectiveness score when an unpreconditioned
    ``kappa_ref`` is available to compare against."""
    est = spectrum_estimate(trace, precond=precond)
    if est is None:
        return None
    kappa = est.get("kappa")
    pred = predicted_iterations(kappa, rtol) if kappa else None
    est["measured_iterations"] = int(niterations)
    if pred is not None:
        est["predicted_iterations"] = pred
        est["rtol"] = float(rtol)
        est["bound_ratio"] = (float(niterations) / pred) if pred else None
    if kappa_ref is not None and kappa:
        # kappa(A) / kappa(M^-1 A): > 1 means the preconditioner
        # genuinely compressed the spectrum (the sqrt of this ratio is
        # the asymptotic iteration-count reduction)
        est["kappa_unpreconditioned"] = float(kappa_ref)
        est["precond_effectiveness"] = float(kappa_ref) / kappa
    return est


def attach_spectrum(stats, trace, rtol: float,
                    precond: str | None = None,
                    kappa_ref: float | None = None) -> dict | None:
    """Compute and record the post-hoc spectrum report onto
    ``stats.health`` (no-op without a usable trace) and feed the
    ``acg_health_kappa_estimate`` gauge."""
    rep = convergence_report(trace, stats.niterations, rtol,
                             precond=precond, kappa_ref=kappa_ref)
    if rep is None:
        return None
    stats.health["spectrum"] = rep
    from acg_tpu_torch import metrics, observatory

    if rep.get("kappa"):
        metrics.record_health_kappa(rep["kappa"])
        # live-observatory tier: the kappa CG-bound is the status
        # endpoint's preferred ETA source (no-op disarmed)
        observatory.note_kappa(rep["kappa"],
                               rep.get("predicted_iterations"))
    return rep
