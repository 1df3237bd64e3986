"""Soak driver: N repeated solves with latency/drift observability.

The port's copy of ``acg_tpu/soak.py``, over the port's solvers,
metrics registry and fault injector; the text below is the
reference's.

A single timed solve says nothing about a SERVICE: the fleet-scale
failure modes are latency drift (a leaking cache, a slowly contending
neighbour, thermal throttling) and jitter in the tail, which the
reduction-pipelining literature (arXiv:1905.06850) identifies -- not
mean cost -- as the scaling killer.  This driver runs ``nsolves``
repeated solves of one system, feeds every solve into the process-wide
metrics registry (:mod:`acg_tpu.metrics`), reports p50/p95/p99 solve
latency and iterations-to-converge FROM the registry histograms (so
the soak report and a Prometheus scrape of the same run agree), and
arms an EWMA drift detector over the measured latencies:

* baseline = median of the first ``BASELINE_FRACTION`` of solves
  (median, so the first solve's compile spike cannot poison it);
* after the baseline window, ``ewma = (1-alpha)*ewma + alpha*latency``;
* drift trips when ``ewma / baseline > 1 + threshold_pct/100`` --
  a structured ``drift`` event lands in ``SolverStats.events``
  (the ``--stats-json`` twin) and, under ``--fail-on-drift PCT``,
  the CLI exits nonzero (exit code 7).

The fault injector's ``solve:slow@K:secs=S`` site dilates every solve
from index K onward inside the timed window
(:func:`acg_tpu.faults.maybe_slow_solve`), so the detector's trip path
is exercisable deterministically end-to-end.

The driver never touches the compiled programs: it is a host loop
around the solver's own ``solve()`` -- the per-solve latency includes
dispatch, which is exactly what a serving fleet experiences.
"""

from __future__ import annotations

import math
import sys
import time

from acg_tpu_torch import metrics, observatory, telemetry, tracing

# EWMA smoothing for the drift detector: 0.2 remembers ~the last 10
# solves -- slow enough to ride out one contended solve, fast enough to
# trip within a couple of windows of a real degradation
EWMA_ALPHA = 0.2
# leading fraction of the run that defines the latency baseline
BASELINE_FRACTION = 0.2
# minimum solves in the baseline window (a --soak 5 run still gets a
# median-of-3 baseline, not a single-sample one)
BASELINE_MIN = 3
# warning threshold when no --fail-on-drift gate is set
DEFAULT_DRIFT_PCT = 50.0
# CLI exit code for a tripped --fail-on-drift gate (the process-wide
# contract lives in errors.ExitCode; --buildinfo renders the table)
from acg_tpu_torch.errors import ExitCode as _ExitCode

DRIFT_EXIT_CODE = int(_ExitCode.DRIFT)


class DriftDetector:
    """EWMA latency-drift detector with a median baseline window."""

    def __init__(self, nsolves: int, threshold_pct: float):
        self.threshold_pct = float(threshold_pct)
        self.nbaseline = max(BASELINE_MIN,
                             int(nsolves * BASELINE_FRACTION))
        self._window: list[float] = []
        self.baseline: float | None = None
        self.ewma: float | None = None
        self.tripped_at: int | None = None

    def update(self, i: int, latency: float) -> bool:
        """Feed solve ``i``'s latency; True the first time drift trips."""
        if len(self._window) < self.nbaseline:
            self._window.append(float(latency))
            if len(self._window) == self.nbaseline:
                self.baseline = sorted(self._window)[
                    len(self._window) // 2]
                self.ewma = self.baseline
            return False
        self.ewma = (1.0 - EWMA_ALPHA) * self.ewma \
            + EWMA_ALPHA * float(latency)
        if metrics.armed():
            metrics.DRIFT_RATIO.set(self.ratio)
        if (self.tripped_at is None and self.baseline > 0
                and self.ratio > 1.0 + self.threshold_pct / 100.0):
            self.tripped_at = int(i)
            return True
        return False

    @property
    def ratio(self) -> float:
        if not self.baseline or self.ewma is None:
            return 1.0
        return self.ewma / self.baseline

    def to_dict(self) -> dict:
        return {
            "baseline_s": self.baseline,
            "ewma_s": self.ewma,
            "ratio": round(self.ratio, 4),
            "threshold_pct": self.threshold_pct,
            "tripped": self.tripped_at is not None,
            "tripped_at_solve": self.tripped_at,
            "baseline_solves": self.nbaseline,
            "ewma_alpha": EWMA_ALPHA,
        }


def gate_is_vacuous(nsolves: int) -> bool:
    """True when a drift gate over ``nsolves`` solves could never trip:
    the baseline window consumes the whole run, so no solve is ever
    evaluated against it.  Callers wiring ``fail_on_drift`` must refuse
    such a run -- a gate that inspects nothing greens CI silently."""
    n = int(nsolves)
    return n <= max(BASELINE_MIN, int(n * BASELINE_FRACTION))


def _percentiles(hist) -> dict:
    out = {}
    for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        v = hist.quantile(q)
        out[name] = None if (v is None or math.isnan(v)) else v
    return out


def run_soak(solver, b, *, nsolves: int, x0=None, criteria=None,
             fail_on_drift: float | None = None,
             first_solve_kwargs: dict | None = None,
             solve_kwargs: dict | None = None,
             progress_every: int = 0, what: str = "soak"):
    """Run ``nsolves`` repeated solves and return ``(x, report)``.

    ``x`` is the last solve's solution (all solves share ``b``/``x0``,
    so any of them is THE solution; the last is returned so the CLI's
    output path is unchanged).  ``report`` is the JSON-able ``soak``
    section: per-run percentiles from the registry histograms, the
    drift verdict, and the registry's own solve counters.

    ``first_solve_kwargs`` ride only solve 0 (warmup, which absorbs the
    compile); ``solve_kwargs`` ride every solve.  Arms the metrics
    layer -- the soak driver IS a metrics consumer by definition.
    """
    from acg_tpu_torch import faults

    if nsolves < 1:
        raise ValueError(f"soak needs nsolves >= 1, got {nsolves}")
    if fail_on_drift is not None and gate_is_vacuous(nsolves):
        raise ValueError(
            f"fail_on_drift is vacuous at nsolves={nsolves}: the "
            f"baseline window consumes the whole run, so the gate "
            f"could never trip (need nsolves > "
            f"{max(BASELINE_MIN, int(nsolves * BASELINE_FRACTION))})")
    metrics.arm()
    threshold = (fail_on_drift if fail_on_drift is not None
                 else DEFAULT_DRIFT_PCT)
    det = DriftDetector(nsolves, threshold)
    st = solver.stats
    kwargs = dict(solve_kwargs or {})
    # run-local histograms with the SAME bucket ladders as the
    # process-wide ones: the registry accumulates for process life (a
    # bench process may soak several configurations back to back), so
    # THIS run's percentiles come from a private pair while every
    # observation still lands in the global registry via the solvers'
    # own record_solve hooks
    local = metrics.Registry()
    lat_hist = local.histogram("soak_solve_seconds",
                               buckets=metrics.SOLVE_SECONDS_BUCKETS)
    it_hist = local.histogram("soak_solve_iterations",
                              buckets=metrics.ITERATION_BUCKETS)
    t_run0 = time.perf_counter()
    latencies_max = 0.0
    # numerical-health tier: per-solve audit gaps (solver.stats.health,
    # present when --audit-every is armed) tracked ALONGSIDE latency --
    # a serving fleet's accuracy can drift (accumulating operator
    # updates, thermal-driven recompiles) just like its latency
    gaps: list[float] = []
    # batched tier (acg_tpu.solvers.batched): per-RHS iteration counts
    # and EFFECTIVE latencies across the run -- a batch completes
    # together, but each RHS's share of the wall clock is its frozen-at
    # iteration over the slowest RHS's, which is what a per-request SLA
    # on a coalescing service actually observes
    rhs_iters: list[int] = []
    rhs_lats: list[float] = []
    rhs_n = 0
    x = None
    for i in range(nsolves):
        kw = dict(kwargs)
        if i == 0 and first_solve_kwargs:
            kw.update(first_solve_kwargs)
        t0 = time.perf_counter()
        t0_wall = time.time()
        # the injected-slowdown site (solve:slow@K:secs=S) sleeps
        # INSIDE the timed window -- a deterministic stand-in for
        # contention/throttling that the drift detector must catch
        faults.maybe_slow_solve(i)
        x = solver.solve(b, x0=x0, criteria=criteria, **kw)
        lat = time.perf_counter() - t0
        # timeline tier: an INDEXED span per soak solve (the solver's
        # own "solve" phase spans are indistinguishable across N
        # repeats; a drift timeline needs to say which solve slowed)
        tracing.record_span(f"{what}[{i}]", t0_wall, t0_wall + lat,
                            cat="chunk", index=i)
        lat_hist.observe(lat)
        it_hist.observe(max(int(st.niterations), 0))
        latencies_max = max(latencies_max, lat)
        g = (st.health or {}).get("gap_last")
        if g is not None and math.isfinite(float(g)):
            gaps.append(float(g))
        batch = st.batch or {}
        if batch.get("nrhs", 0) >= 1 and batch.get("iterations"):
            rhs_n = int(batch["nrhs"])
            its_b = [int(v) for v in batch["iterations"]]
            kmax = max(max(its_b), 1)
            rhs_iters.extend(its_b)
            rhs_lats.extend(lat * it / kmax for it in its_b)
        # live-observatory tier: per-solve queue progress for the
        # status endpoint (no-op disarmed) and the SLO verdict for
        # this solve (no-op without declared objectives; breaches
        # land as structured events + acg_slo_* metrics)
        observatory.note_soak_solve(i, nsolves, lat)
        observatory.slo_observe(st, latency=lat,
                                iterations=int(st.niterations),
                                gap=g)
        if det.update(i, lat):
            msg = (f"latency drift: EWMA {det.ewma:.6f}s is "
                   f"{(det.ratio - 1.0) * 100.0:+.1f}% over the "
                   f"baseline {det.baseline:.6f}s at solve {i} "
                   f"(threshold {threshold:g}%)")
            # record_event routes to acg_events_total{kind=drift} too
            telemetry.record_event(st, "drift", msg)
            sys.stderr.write(f"acg-tpu-torch: {what}: WARNING: {msg}\n")
        if progress_every and (i + 1) % progress_every == 0:
            sys.stderr.write(
                f"acg-tpu-torch: {what}: {i + 1}/{nsolves} solves, "
                f"p50 {lat_hist.quantile(0.5):.6f}s, "
                f"drift ratio {det.ratio:.3f}\n")
    report = {
        "nsolves": int(nsolves),
        "wall_seconds": time.perf_counter() - t_run0,
        "latency": {**_percentiles(lat_hist), "max": latencies_max},
        "iterations": _percentiles(it_hist),
        "drift": det.to_dict(),
    }
    if rhs_iters:
        # per-RHS view of a batched soak (stats schema /9): quantiles
        # over every (solve, rhs) pair of the run
        def _q(vals, q):
            s = sorted(vals)
            return s[min(int(q * len(s)), len(s) - 1)]

        report["per_rhs"] = {
            "nrhs": rhs_n,
            "iterations": {"p50": _q(rhs_iters, 0.5),
                           "p95": _q(rhs_iters, 0.95),
                           "p99": _q(rhs_iters, 0.99)},
            "latency": {"p50": _q(rhs_lats, 0.5),
                        "p95": _q(rhs_lats, 0.95),
                        "p99": _q(rhs_lats, 0.99)},
        }
    if gaps:
        # accuracy-drift view of the run: how the audited true-residual
        # gap moved across repeated solves (the latency drift gate's
        # numerical twin; warn-only -- the per-solve threshold gate
        # already owns the hard verdict)
        report["gap"] = {
            "first": gaps[0], "last": gaps[-1], "max": max(gaps),
            "ratio": (gaps[-1] / gaps[0]) if gaps[0] > 0 else None,
        }
        if gaps[0] > 0 and gaps[-1] / gaps[0] > 1.0 + threshold / 100.0:
            msg = (f"residual-gap drift: last audit gap {gaps[-1]:.3e} "
                   f"is {(gaps[-1] / gaps[0] - 1.0) * 100.0:+.1f}% over "
                   f"the first solve's {gaps[0]:.3e} "
                   f"(threshold {threshold:g}%)")
            telemetry.record_event(st, "gap-drift", msg)
            sys.stderr.write(f"acg-tpu-torch: {what}: WARNING: {msg}\n")
    st.soak = report
    return x, report


def gate_exit_code(report: dict | None,
                   fail_on_drift: float | None) -> int:
    """The ``--fail-on-drift`` verdict for a completed soak run: 0, or
    :data:`DRIFT_EXIT_CODE` when the gate is set and drift tripped."""
    if (report is None or fail_on_drift is None
            or not report.get("drift", {}).get("tripped")):
        return 0
    return DRIFT_EXIT_CODE
