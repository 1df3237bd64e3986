"""Breakdown-recovery policy for the CG solvers.

The port's copy of ``acg_tpu/solvers/resilience.py``: the policy, the
host-side ladder (restarts with backoff, the rollback rung of the
checkpoint chunk drivers, the transport rung of the stacked tier, the
host-solver rung), its stats counters, metrics and telemetry events.
The loops of :mod:`acg_tpu_torch.solvers.cg` flag the breakdown in a
device flag that joins their ``live`` flag; the host reads it with the
convergence flag, once per chunk.  p(l)'s restart rung is
:func:`acg_tpu_torch.recurrence.pl_restart_policy`.  Two rungs
differ from the reference's on the card: the host rung re-solves on the
CPU, so it runs for a solver on the CPU only (on the card the solve
raises), and the transport rung, which retires K6, runs there only when
the policy asks for it by name (``fallback_comm=True``).  Across
processes every restart verdict passes through the error agreement
(item 4 below, :meth:`RecoveryDriver._agree`).  The text below is the
reference's.

Pipelined and reduced-precision CG are numerically brittle: deep
pipelining and rounded recurrences can drive the residual non-finite or
(p, Ap) non-positive mid-solve (Cornelis & Vanroose, arXiv:1801.04728;
Cools et al., arXiv:1905.06850), and on a mesh a flaky transport can
inject the same poison from outside the arithmetic.  The standard
hardening move is detected-breakdown restart: the jitted loops flag the
breakdown in solver state (``detect=True`` programs in
:mod:`acg_tpu.solvers.jax_cg` / :mod:`acg_tpu.parallel.dist`), exit
early, and a HOST-side policy -- this module -- decides what happens
next:

  1. bounded restarts with backoff: re-enter the solve from the last
     finite iterate; the program's setup recomputes the TRUE residual
     ``r = b - A x0``, so the restart discards the poisoned recurrence
     state the same way the bf16 tier's replacement segments do;
  2. transport fallback (distributed): a second breakdown under
     ``comm="dma"`` retires the one-sided transport for the solve and
     rebuilds the program on the ``"xla"`` collectives;
  3. final fallback to the host reference solver when a matrix is
     available there;
  4. multi-controller: every restart/abort decision passes through the
     error-agreement checkpoint (:func:`acg_tpu.parallel.erragree.
     agree_status`), so all controllers restart or abort in unison
     instead of one looping while its peers wedge in a collective.

Every detection, restart, and fallback is counted on
:class:`acg_tpu.solvers.stats.SolverStats` and surfaced in the CLI
stats block.
"""

from __future__ import annotations

import dataclasses
import sys
import time

from acg_tpu_torch.errors import BreakdownError


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Host-side knobs for detected-breakdown recovery.

    ``max_restarts`` bounds the re-entries per solve (0 = detect only:
    a breakdown raises immediately).  ``backoff`` sleeps before the
    n-th restart for ``backoff * 2**(n-1)`` seconds -- transient
    environmental faults (a flaky link) get time to clear, numerical
    breakdowns restart immediately at the default 0.  ``fallback_comm``
    allows retiring the DMA halo transport for XLA collectives (None:
    on a solver on the CPU, as the reference's default; on the card
    only when set to True); ``fallback_host`` allows the final
    host-solver rung, which runs for a solver on the CPU only.
    ``agree_timeout`` bounds the multi-process restart agreement (the
    ``--err-timeout`` role at recovery checkpoints)."""

    max_restarts: int = 2
    backoff: float = 0.0
    fallback_comm: bool | None = None
    fallback_host: bool = True
    agree_timeout: float = 120.0
    # the survivability tier's FIRST rung (acg_tpu.checkpoint): on a
    # detected breakdown, roll the loop carry back to the last on-disk
    # snapshot BEFORE spending the restart budget -- a rollback resumes
    # the exact pre-corruption Krylov state, where a restart discards
    # it.  Only consulted by the checkpoint-armed chunk drivers (no
    # snapshot, no rung); 0 disables
    max_rollbacks: int = 1

    def comm_fallback(self, device) -> bool:
        """Whether the transport rung may retire K6 (``comm="dma"``) for
        the xla exchange on a solver on ``device``: what
        ``fallback_comm`` says, and by default on the CPU only."""
        if self.fallback_comm is None:
            import torch
            return torch.device(device).type == "cpu"
        return self.fallback_comm


def adopt_host_stats(st, host_stats) -> None:
    """Fold a host-fallback solve's last-solve stats into the device
    solver's accumulated stats -- shared by both fallback rungs so their
    reports cannot drift apart."""
    st.nsolves += 1
    st.niterations = host_stats.niterations
    st.ntotaliterations += host_stats.niterations
    # the host re-solve usually DOMINATES the wall time of a
    # fallen-back solve; dropping it would corrupt the timing evidence
    st.tsolve += host_stats.tsolve
    for f in ("bnrm2", "x0nrm2", "r0nrm2", "rnrm2", "dxnrm2",
              "converged"):
        setattr(st, f, getattr(host_stats, f))
    st.fexcept_arrays = host_stats.fexcept_arrays


class RecoveryDriver:
    """Per-solve bookkeeping shared by the device solvers' restart loops.

    Owns the attempt counter, the backoff sleeps and the stats
    counters; the solvers own program re-invocation (their argument
    layouts differ)."""

    def __init__(self, policy: RecoveryPolicy | None, stats, what: str):
        self.policy = policy
        self.stats = stats
        self.what = what
        self.restarts = 0
        self.rollbacks = 0

    def record(self, event: str, kind: str = "recovery") -> None:
        self.stats.recovery_log.append(event)
        # timestamped twin for the structured stats sink (--stats-json)
        from acg_tpu_torch.telemetry import record_event
        record_event(self.stats, kind, event)
        sys.stderr.write(f"acg-tpu-torch: {self.what}: {event}\n")

    def log_trace_window(self, trace) -> None:
        """Attach the in-loop telemetry's trailing residual window to
        the event log -- the trajectory that led INTO the breakdown is
        exactly what the post-hoc stats block cannot show.  No-op when
        the solve ran without a convergence trace."""
        if trace is None:
            return
        self.record(trace.tail_summary(), kind="trace-window")

    def note_breakdown(self, niter: int) -> None:
        """Account one detected breakdown (counter + metric + event) --
        exactly once per detection, whichever rung then handles it."""
        st = self.stats
        st.nbreakdowns += 1
        from acg_tpu_torch import metrics
        metrics.record_breakdown()
        from acg_tpu_torch.telemetry import record_event
        record_event(st, "breakdown",
                     f"breakdown detected at iteration {niter}")

    def on_rollback(self, niter: int, snapshot_iteration: int) -> bool:
        """The survivability tier's FIRST rung: roll the loop carry back
        to the last snapshot (acg_tpu.checkpoint).  Returns True when
        the policy grants it -- the caller restores the snapshot carry
        and re-enters the chunk loop; False sends the breakdown down
        the existing restart/fallback/abort ladder.  Does NOT
        consume the restart budget: a rollback resumes exact Krylov
        state, a restart rebuilds it -- they are different medicines
        and are bounded separately (``max_rollbacks``)."""
        pol = self.policy
        if pol is None or self.rollbacks >= pol.max_rollbacks:
            return False
        self.rollbacks += 1
        self.stats.nrollbacks += 1
        from acg_tpu_torch import metrics
        metrics.record_rollback()
        self.record(f"breakdown at iteration {niter}: rolling back to "
                    f"the snapshot at iteration {snapshot_iteration} "
                    f"(rollback {self.rollbacks}/{pol.max_rollbacks})",
                    kind="rollback")
        return True

    def on_breakdown(self, niter: int, noted: bool = False) -> bool:
        """Account one detected breakdown; returns True when the policy
        grants a restart (after the backoff sleep), False when retries
        are exhausted (caller falls back or raises).  Across processes
        the decision is error-agreed first: if any process is out of
        retries (or dead), every process refuses the restart together.
        ``noted=True`` (the rollback-rung callers) skips the breakdown
        accounting already done by :meth:`note_breakdown`."""
        st = self.stats
        if not noted:
            self.note_breakdown(niter)
        pol = self.policy
        want_restart = pol is not None and self.restarts < pol.max_restarts
        if not self._agree(0 if want_restart else 1):
            if want_restart:
                self.record("restart vetoed: a peer controller cannot "
                            "continue")
            return False
        if not want_restart:
            return False
        self.restarts += 1
        st.nrestarts += 1
        from acg_tpu_torch import metrics
        metrics.record_restart()
        if pol.backoff > 0:
            time.sleep(pol.backoff * (2 ** (self.restarts - 1)))
        self.record(f"breakdown detected at iteration {niter}; "
                    f"restart {self.restarts}/{pol.max_restarts} from "
                    f"the recomputed true residual", kind="restart")
        return True

    def on_fallback(self, event: str) -> None:
        self.stats.nfallbacks += 1
        from acg_tpu_torch import metrics
        metrics.record_fallback()
        self.record(event, kind="fallback")

    def _agree(self, code: int) -> bool:
        """Cross-process restart-vs-abort agreement; True = every
        process can restart.  One process: the local verdict."""
        from acg_tpu_torch.parallel import multihost

        if multihost.process_count() == 1:
            return code == 0
        from acg_tpu_torch.parallel.erragree import agree_status

        timeout = (self.policy.agree_timeout if self.policy is not None
                   else 120.0)
        return agree_status(code, what=f"{self.what} recovery",
                            timeout=timeout) == 0

    def give_up(self, niter: int, rnrm2: float,
                snapshot: str | None = None):
        """The no-IN-PROCESS-rungs-left exit: a diagnosis-carrying
        exception.  When a committed snapshot exists the diagnosis
        names the next rung OUT of process -- the survivor-mesh
        supervisor (acg_tpu.supervisor, ``--supervise``) relaunches
        with ``--resume`` from exactly that file, so the operator (or
        runbook) reads the recovery action off the error instead of
        grepping docs mid-incident."""
        hint = (f"; a committed snapshot exists at {snapshot} -- "
                f"relaunch with --resume (or run under --supervise "
                f"to automate it)" if snapshot else "")
        return BreakdownError(
            f"{self.what}: breakdown (non-finite residual or "
            f"non-positive p^T A p) at iteration {niter}, residual "
            f"{rnrm2:.3e}; {self.stats.nrestarts} restart(s) exhausted "
            f"and no fallback available{hint}")
