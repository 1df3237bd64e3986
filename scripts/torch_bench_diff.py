#!/usr/bin/env python3
"""Diff two captures of the PyTorch/CUDA port case by case and gate on
regressions: the twin of ``scripts/bench_diff.py`` over
``acg_tpu_torch.perfmodel`` (``load_cases``, ``compare_cases``, the
exit codes), which imports nothing of the JAX package.  Accepts EITHER
format on either side:

* ``--stats-json`` documents -- one indented document (CLI solves) or
  JSONL-appended (``bench.py --stats-json``, ``--explain``); the case
  value is iterations/second derived from the stats twin
  (``niterations / tsolve``), keyed by the manifest's metric (bench) or
  ``solver:matrix`` (CLI);
* bench summary-row JSONL (``BENCH_*.json``); the case value is the
  row's ``value``, keyed by ``metric``.  ``#`` commentary lines are
  skipped.

With ``--baseline-from-history DIR`` the baseline side comes from a
run-history ledger (``--history``, acg_tpu_torch.observatory): the
best-known USABLE prior capture per case, with
``bench_backend_unavailable`` entries skipped automatically; a ledger
whose entries are ALL unavailable refuses with exit 2 and the
re-baseline message (the BENCH_r05 stale-baseline trap).

Exit codes: 0 = no regression, 1 = at least one case regressed past the threshold,
2 = nothing comparable (unreadable input / no common cases /
all-unavailable history) -- 2 fails too, so a renamed metric cannot
silently green a CI gate.

Examples:
  torch_bench_diff.py old_stats.jsonl new_stats.jsonl --fail-on-regress 5
  torch_bench_diff.py --baseline-from-history ./history new_stats.jsonl
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_bench_diff.py",
        description="Diff two bench / --stats-json captures case-by-case "
                    "and exit nonzero on regression (the enforced BENCH "
                    "trajectory gate).",
        epilog="Exit codes: 0 = ok, 1 = regression past the threshold, "
               "2 = nothing comparable.")
    ap.add_argument("baseline", nargs="?", default=None,
                    help="prior capture (--stats-json JSONL/document, or "
                         "bench row JSONL like BENCH_*.json); omit when "
                         "--baseline-from-history supplies the baseline")
    ap.add_argument("candidate", help="new capture, same accepted formats")
    ap.add_argument("--baseline-from-history", metavar="DIR",
                    default=None,
                    help="take the baseline from a --history run ledger "
                         "instead of a capture file: best USABLE value "
                         "per case across every entry, "
                         "bench_backend_unavailable captures skipped; "
                         "an all-unavailable ledger refuses (exit 2)")
    ap.add_argument("--fail-on-regress", type=float, default=10.0,
                    metavar="PCT",
                    help="regression threshold in percent (default: 10)")
    args = ap.parse_args(argv)
    if (args.baseline is None) == (args.baseline_from_history is None):
        ap.error("give a baseline capture OR --baseline-from-history "
                 "DIR (exactly one)")

    # import AFTER parsing so --help answers without importing the
    # package (and torch with it)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from acg_tpu_torch.perfmodel import (compare_cases,
                                         load_baseline_cases, load_cases,
                                         refuse_unavailable)

    base = args.baseline or args.baseline_from_history
    try:
        # a directory baseline is the run-history ledger path; the
        # positional form accepts one too (check_regression parity)
        old = load_baseline_cases(base)
        new = load_cases(args.candidate)
    except OSError as e:
        print(f"bench-diff: {e}", file=sys.stderr)
        return 2
    if old is None:
        # the ledger was empty or ALL its captures were
        # backend-unavailable: load_baseline_cases printed the
        # re-baseline refusal
        return 2
    # a capture that only records the backend-unavailable sentinel
    # describes a run that never reached hardware: refuse outright
    old, new, refused = refuse_unavailable(old, new, base,
                                           args.candidate)
    if refused:
        return 2
    lines, nreg, ncmp = compare_cases(old, new, args.fail_on_regress)
    for ln in lines:
        print(ln)
    if ncmp == 0:
        print("bench-diff: no comparable cases between "
              f"{base} and {args.candidate}", file=sys.stderr)
        return 2
    print(f"bench-diff: {ncmp} case(s) compared, {nreg} regression(s) "
          f"past -{args.fail_on_regress:g}%")
    return 1 if nreg else 0


if __name__ == "__main__":
    sys.exit(main())
