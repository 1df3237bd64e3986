#!/usr/bin/env python3
"""Render per-case trend tables from a ``--history`` run ledger of the
PyTorch/CUDA port: the twin of ``scripts/history_report.py`` over
``acg_tpu_torch.observatory``, with the same plan column and gates.

The enforced form of eyeballing BENCH rounds across time: point this at
the date-partitioned JSONL ledger ``--history DIR`` maintains
(acg-tpu-history/1 index lines, one per solve) and get, per case key,
how latency and iterations moved across every recorded run --
first/last/best, an EWMA latency trail (the soak drift detector's
estimator applied across RUNS instead of within one), and a DRIFT flag
when the EWMA ends more than the threshold above the early-runs
baseline (median of the leading window, so one slow first run cannot
poison it).

Captures recording only the ``bench_backend_unavailable`` sentinel are
listed (they are history) but never enter the trend math.

Planned solves (``--autotune``) carry a plan-vs-actual row in their
stats twin; those cases grow a plan column -- predicted/measured ratio
first -> last -- and ``--fail-on-misprediction PCT`` turns it into a
CI gate for cost-model drift.

Usage:
    python scripts/torch_history_report.py DIR [--threshold PCT]
        [--fail-on-drift] [--fail-on-misprediction PCT]

Exit codes: 0 = report printed, 1 = unreadable/empty ledger, and with
``--fail-on-drift`` / ``--fail-on-misprediction``: 7 when any case's
latency EWMA drifted past the threshold, or any case's latest
predicted/measured ratio strayed more than PCT from 1.0 (the soak
gate's exit code -- one contract for all the drift gates).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the soak drift detector's constants, applied across runs
EWMA_ALPHA = 0.2
BASELINE_MIN = 3
BASELINE_FRACTION = 0.2
DEFAULT_THRESHOLD_PCT = 50.0
DRIFT_EXIT_CODE = 7


def case_trend(entries: list[dict], threshold_pct: float) -> dict:
    """Trend statistics for one case's chronologically-sorted ledger
    entries: latency first/last/best/EWMA + slope, iteration
    first/last, and the drift verdict."""
    lats = [(e.get("latency_s"), e) for e in entries]
    lats = [(float(v), e) for v, e in lats
            if isinstance(v, (int, float)) and math.isfinite(v)
            and v > 0]
    out: dict = {"runs": len(entries), "timed_runs": len(lats)}
    its = [e.get("iterations") for e in entries
           if isinstance(e.get("iterations"), (int, float))]
    if its:
        out["iterations"] = {"first": int(its[0]), "last": int(its[-1]),
                             "min": int(min(its)), "max": int(max(its))}
    if not lats:
        return out
    vals = [v for v, _ in lats]
    nbase = max(BASELINE_MIN, int(len(vals) * BASELINE_FRACTION))
    window = sorted(vals[:nbase])
    baseline = window[len(window) // 2]
    # plan-vs-actual trail: planned solves record predicted/measured
    # into stats.plan (acg_tpu_torch.planner); unplanned runs have none
    ratios = []
    for e in entries:
        plan = ((e.get("doc") or {}).get("stats") or {}).get("plan")
        r = (plan or {}).get("misprediction_ratio")
        if isinstance(r, (int, float)) and math.isfinite(r) and r > 0:
            ratios.append(float(r))
    if ratios:
        out["plan"] = {"planned_runs": len(ratios),
                       "first": ratios[0], "last": ratios[-1]}
    ewma = vals[0]
    for v in vals[1:]:
        ewma = (1.0 - EWMA_ALPHA) * ewma + EWMA_ALPHA * v
    ratio = (ewma / baseline) if baseline > 0 else 1.0
    out["latency"] = {
        "first": vals[0], "last": vals[-1], "best": min(vals),
        "worst": max(vals), "ewma": ewma, "baseline": baseline,
        "ratio": ratio,
        # per-run EWMA slope over the trail: sign says which way the
        # case is moving even before the drift gate trips
        "ewma_slope_per_run": ((ewma - baseline) / max(len(vals) - 1, 1)
                               if baseline > 0 else 0.0),
    }
    # the gate inspects nothing when the baseline window consumes the
    # whole trail (the soak gate_is_vacuous rule)
    out["drift"] = (len(vals) > nbase and baseline > 0
                    and ratio > 1.0 + threshold_pct / 100.0)
    return out


def _fmt_s(v: float) -> str:
    return f"{v * 1e3:.3g}ms" if v < 1.0 else f"{v:.4g}s"


def render(cases: dict, threshold_pct: float,
           misprediction_pct: float | None = None,
           ) -> tuple[list[str], bool, bool]:
    lines: list[str] = []
    any_drift = any_mispredict = False
    for case in sorted(cases):
        t = cases[case]
        head = f"{case}: {t['runs']} run(s)"
        lat = t.get("latency")
        if lat:
            head += (f"  latency first {_fmt_s(lat['first'])} -> last "
                     f"{_fmt_s(lat['last'])} (best {_fmt_s(lat['best'])}"
                     f", EWMA {_fmt_s(lat['ewma'])}, "
                     f"x{lat['ratio']:.2f} vs baseline)")
        it = t.get("iterations")
        if it:
            head += (f"  iters {it['first']} -> {it['last']}"
                     + (f" (max {it['max']})"
                        if it["max"] != it["last"] else ""))
        plan = t.get("plan")
        if plan:
            head += (f"  plan x{plan['first']:.2f} -> x{plan['last']:.2f}"
                     f" ({plan['planned_runs']} planned)")
        else:
            head += "  plan -"
        if t.get("drift"):
            any_drift = True
            head += (f"  DRIFT (> +{threshold_pct:g}% over the "
                     f"early-runs baseline)")
        if (plan and misprediction_pct is not None
                and abs(plan["last"] - 1.0) * 100.0 > misprediction_pct):
            any_mispredict = True
            head += (f"  MISPREDICTION (latest predicted/measured "
                     f"x{plan['last']:.2f} strays > {misprediction_pct:g}% "
                     f"from 1.0)")
        lines.append(head)
    return lines, any_drift, any_mispredict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_history_report.py",
        description="per-case latency/iteration trend tables over a "
                    "--history run ledger, with the soak drift "
                    "detector's EWMA applied across runs")
    ap.add_argument("history", metavar="DIR",
                    help="the --history ledger directory")
    ap.add_argument("--threshold", type=float,
                    default=DEFAULT_THRESHOLD_PCT, metavar="PCT",
                    help="drift flag threshold in percent over the "
                         "early-runs baseline (default: 50)")
    ap.add_argument("--fail-on-drift", action="store_true",
                    help="exit 7 (the soak drift gate's code) when any "
                         "case drifted past the threshold")
    ap.add_argument("--fail-on-misprediction", type=float, default=None,
                    metavar="PCT",
                    help="exit 7 when any case's latest plan "
                         "predicted/measured ratio strays more than PCT "
                         "percent from 1.0 (cost-model drift gate)")
    args = ap.parse_args(argv)

    from acg_tpu_torch.observatory import history_scan
    from acg_tpu_torch.perfmodel import UNAVAILABLE_METRIC

    entries = history_scan(args.history)
    if not entries:
        print(f"history-report: {args.history}: no ledger entries "
              f"(not a --history directory?)", file=sys.stderr)
        return 1
    by_case: dict[str, list] = {}
    nunavail = 0
    for e in entries:
        case = e.get("case") or "(uncased)"
        if str(case).startswith(UNAVAILABLE_METRIC):
            nunavail += 1
            continue
        by_case.setdefault(str(case), []).append(e)
    trends = {case: case_trend(es, args.threshold)
              for case, es in by_case.items()}
    lines, any_drift, any_mispredict = render(
        trends, args.threshold,
        misprediction_pct=args.fail_on_misprediction)
    for ln in lines:
        print(ln)
    tail = (f"history-report: {len(entries)} entr"
            f"{'y' if len(entries) == 1 else 'ies'} over "
            f"{len(by_case)} case(s)")
    if nunavail:
        tail += (f"; {nunavail} backend-unavailable capture(s) "
                 f"excluded from trends")
    print(tail)
    if any_drift and args.fail_on_drift:
        return DRIFT_EXIT_CODE
    if any_mispredict:
        return DRIFT_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
