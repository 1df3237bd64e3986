"""Breakdown restarts for the CG solvers.

The part of ``acg_tpu/solvers/resilience.py`` that the deep-pipelined
p(l) recurrence needs: its square-root breakdown is an expected event
of the method, and the remedy is a restart from the current iterate,
up to :data:`acg_tpu_torch.recurrence.PL_RESTART_BUDGET` times a solve
(the reference's ``pl_restart_policy``: no transport or host fallback).
The solver loop flags the breakdown in its result and exits; the
host-side :class:`RecoveryDriver` decides whether to restart, counts
what happened on :class:`~acg_tpu_torch.solvers.stats.SolverStats` (the
stats block's ``resilience:`` line and its event lines) and raises a
diagnosis once the budget is spent.

The reference's other rungs (backoff, transport and host fallbacks),
its multi-controller agreement, metrics and telemetry events, and the
``--recover``/``--max-restarts`` flags come with the observability and
robustness modules.
"""

from __future__ import annotations

import sys

from acg_tpu_torch.errors import BreakdownError


class RecoveryDriver:
    """Per-solve bookkeeping of a restart loop: the restart counter and
    the stats counters; the solver owns the program re-invocation."""

    def __init__(self, max_restarts: int, stats, what: str):
        self.max_restarts = max_restarts
        self.stats = stats
        self.what = what
        self.restarts = 0

    def record(self, event: str) -> None:
        self.stats.recovery_log.append(event)
        sys.stderr.write(f"acg-tpu-torch: {self.what}: {event}\n")

    def on_breakdown(self, niter: int) -> bool:
        """Account one detected breakdown; True when the budget grants a
        restart, False when the restarts are spent (the caller raises
        :meth:`give_up`)."""
        self.stats.nbreakdowns += 1
        if self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        self.stats.nrestarts += 1
        self.record(f"breakdown detected at iteration {niter}; "
                    f"restart {self.restarts}/{self.max_restarts} from "
                    f"the recomputed true residual")
        return True

    def give_up(self, niter: int, rnrm2: float) -> BreakdownError:
        """The no-restarts-left exit: a diagnosis-carrying exception."""
        return BreakdownError(
            f"{self.what}: breakdown (non-finite residual or "
            f"non-positive p^T A p) at iteration {niter}, residual "
            f"{rnrm2:.3e}; {self.stats.nrestarts} restart(s) exhausted "
            f"and no fallback available")
