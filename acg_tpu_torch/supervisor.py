"""Survivor-mesh supervisor and chaos campaign: the elastic half of the
recovery ladder (``acg_tpu/supervisor.py``).

The in-process ladder (:mod:`acg_tpu_torch.solvers.resilience`:
rollback, restart, transport, agreed abort) ends where the process
ends: a crash, a lost peer or a spent restart budget leaves a committed
snapshot on disk and nothing to consume it.  This module closes the
loop from the host:

* :func:`supervise` (CLI ``--supervise``) runs the solve as a child
  process (``python -m acg_tpu_torch``) and watches the exit-code
  contract (:data:`acg_tpu_torch.errors.EXIT_CONTRACT`, rendered by
  ``--buildinfo``): a ``crash:exit`` death (rc 94), an error-agreement
  watchdog teardown (rc 97), an injected dead peer (rc 86), a signal
  death or a failed solve relaunches the child with ``--resume`` from
  the last committed snapshot, under a bounded relaunch budget with
  exponential backoff.  When the failure means a lost peer (``--shrink
  peer-lost``, the default; ``--shrink any`` lets a one-host crash show
  the same ladder) the relaunch halves ``--nparts`` and adds
  ``--resume-repartition``: the snapshot's row-permutation sidecar
  restores the N-part carry onto M parts, to the original tolerance.
  Drift (rc 7) and SLO (rc 8) verdicts describe completed runs and pass
  through.  Every decision lands on the ``acg_recovery_*`` metric
  families, a ``recovery:`` section on stderr, a ``--history`` document
  and the relaunched child's ``degraded`` status key
  (:data:`acg_tpu_torch.observatory.DEGRADED_ENV`).

* :func:`run_chaos` (CLI ``--chaos SEED[:N]``) runs N seeded schedules
  over the fault sites this configuration can fire, each through the
  supervisor, and verifies every green run on the host: the solution is
  read back from disk and its true relative residual checked against a
  host rebuild of the matrix.  The campaign exits
  :data:`~acg_tpu_torch.errors.ExitCode.WRONG_ANSWER` (96) if any
  schedule converged to a wrong answer.  The check is an oracle beside
  the card's answer, never a replacement for it.

* :class:`DaemonSupervisor` (CLI ``--serve --supervise``) keeps a
  long-lived ``--serve`` daemon up: every unexpected death is judged by
  the same contract and relaunched (the daemon warm-restores its
  operator cache from its state sidecar), crash-class deaths shrink
  ``--nparts``, and a shrunken daemon that served ``--grow-after``
  requests is relaunched toward its original width.

The supervising process manages processes only: this module imports no
torch and the supervisor never initialises CUDA (the card belongs to
the child), and every relaunch runs the same kernels on the card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

from acg_tpu_torch.errors import (PEER_LOST_CODES, RELAUNCHABLE_CODES,
                                  ExitCode)

# flags the supervisor consumes (flag -> number of value tokens), never
# forwarded to the child.  --metrics-file belongs to the supervisor: each
# child's registry dies with it, while the supervisor's carries the
# acg_recovery_* families across relaunches (acg_tpu/supervisor.py:62-81)
SUPERVISOR_FLAGS = {
    "--supervise": 0,
    "--relaunch-budget": 1,
    "--relaunch-backoff": 1,
    "--shrink": 1,
    "--min-parts": 1,
    "--grow-after": 1,
    "--chaos": 1,
    "--metrics-file": 1,
}

# bound on one child solve: a wedged child becomes a relaunchable
# failure, never a wedged supervisor
CHILD_TIMEOUT_SECS = 900.0

_TAG = "acg-tpu-torch"


# -- argv surgery ----------------------------------------------------------

def strip_flags(argv: list, flags: dict) -> list:
    """``argv`` without the named flags and their value tokens
    (``--flag=value`` forms too)."""
    out = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        name = tok.split("=", 1)[0]
        if name in flags:
            i += 1 + (flags[name] if "=" not in tok else 0)
            continue
        out.append(tok)
        i += 1
    return out


def flag_value(argv: list, flag: str):
    """The last value of ``--flag V`` / ``--flag=V`` in argv, or None."""
    val = None
    for i, tok in enumerate(argv):
        if tok == flag and i + 1 < len(argv):
            val = argv[i + 1]
        elif tok.startswith(flag + "="):
            val = tok.split("=", 1)[1]
    return val


def set_flag(argv: list, flag: str, value) -> list:
    """argv with ``--flag value`` replaced (or appended)."""
    out = strip_flags(argv, {flag: 1})
    return out + ([flag] if value is None else [flag, str(value)])


def _fault_site(argv: list, env: dict) -> str | None:
    """The armed fault spec's site (argv ``--fault-inject`` or the
    inherited environment variable), or None."""
    spec = flag_value(argv, "--fault-inject") \
        or env.get("ACG_TPU_FAULT_INJECT")
    return spec.split(":", 1)[0] if spec else None


def _strip_fault(argv: list, env: dict) -> tuple:
    """The relaunch's fault hygiene: an injected fault models a
    transient event whose damage is done, and re-arming it would re-break
    the run that exists to survive it.  ``crash:exit`` stays armed: its
    crossing semantics (:func:`acg_tpu_torch.faults.maybe_crash`) make it
    re-fire-safe on resume, which keeping it armed tests."""
    if _fault_site(argv, env) == "crash":
        return argv, env
    env = {k: v for k, v in env.items() if k != "ACG_TPU_FAULT_INJECT"}
    return strip_flags(argv, {"--fault-inject": 1}), env


def _reason(rc: int) -> str:
    if rc in PEER_LOST_CODES:
        return "peer-lost"
    if rc == int(ExitCode.CRASH_INJECTED):
        return "crash"
    if rc < 0:
        return "signal"
    if rc == int(ExitCode.BACKEND_UNAVAILABLE):
        return "backend"
    return "failure"


# -- the supervisor core ---------------------------------------------------

def supervise(child_argv: list, *, ckpt_path: str, budget: int = 3,
              backoff: float = 1.0, shrink: str = "peer-lost",
              min_parts: int = 1, nparts: int = 0, env: dict | None = None,
              capture: bool = False, label: str = "",
              timeout: float = CHILD_TIMEOUT_SECS,
              runner=None) -> dict:
    """Run ``python -m acg_tpu_torch <child_argv>`` under the relaunch
    policy; returns the report dict the ``recovery:`` section and the
    chaos ledger render:

    ``{"rc", "attempts", "relaunches": [{"rc", "reason", "parts"}...],
    "degraded": {"from", "to", "reason"} | None, "mttr_seconds",
    "outcome"}``

    ``nparts`` is the launch partition count (0 = unknown: no shrink);
    ``capture`` collects the children's output into the report (the
    chaos driver) instead of inheriting the terminal.  ``runner(cmd,
    env)`` (tests) stands in for the child run and returns its exit
    code."""
    from acg_tpu_torch import metrics

    child_env = dict(os.environ if env is None else env)
    argv = list(child_argv)
    cur_parts = int(nparts or 0)
    tag = f"supervisor{f' [{label}]' if label else ''}"
    report: dict = {"rc": None, "attempts": 0, "relaunches": [],
                    "degraded": None, "mttr_seconds": None}
    first_failure = None
    attempt = 0
    while True:
        attempt += 1
        report["attempts"] = attempt
        cmd = [sys.executable, "-m", "acg_tpu_torch", *argv]
        if runner is not None:
            rc = int(runner(cmd, child_env))
        else:
            try:
                proc = subprocess.run(
                    cmd, env=child_env, timeout=timeout,
                    capture_output=capture, text=capture)
                rc = int(proc.returncode)
                if capture:
                    report["stderr_tail"] = (proc.stderr or "")[-4000:]
                    report["stdout_tail"] = (proc.stdout or "")[-1000:]
            except subprocess.TimeoutExpired:
                rc = -1
                sys.stderr.write(f"{_TAG}: {tag}: child timed out after "
                                 f"{timeout:.0f}s; treating as a crash\n")
        if rc == 0:
            if first_failure is not None:
                mttr = time.monotonic() - first_failure
                report["mttr_seconds"] = round(mttr, 3)
                metrics.record_recovery_mttr(mttr)
            report["rc"] = 0
            report["outcome"] = "converged"
            return report
        if rc in (int(ExitCode.DRIFT), int(ExitCode.SLO_BREACH)):
            # the solve completed; the service-level gate tripped -- a
            # relaunch would re-run a finished solve
            sys.stderr.write(f"{_TAG}: {tag}: child exited rc {rc} "
                             f"({_reason(rc)} gate on a completed run); "
                             f"passing through\n")
            report["rc"] = rc
            report["outcome"] = "gate"
            return report
        reason = _reason(rc)
        if first_failure is None:
            first_failure = time.monotonic()
        relaunchable = (rc in RELAUNCHABLE_CODES or rc < 0)
        have_snap = os.path.exists(ckpt_path)
        if not relaunchable or not have_snap \
                or len(report["relaunches"]) >= max(int(budget), 0):
            why = ("relaunch budget exhausted" if relaunchable
                   and have_snap else
                   "no snapshot to resume from" if relaunchable
                   else "not a relaunchable failure")
            sys.stderr.write(f"{_TAG}: {tag}: child exited rc {rc} "
                             f"({reason}); {why} -- giving up\n")
            report["rc"] = (int(ExitCode.RELAUNCH_BUDGET)
                            if relaunchable and have_snap else rc)
            report["outcome"] = "agreed-abort"
            return report

        # -- relaunch with --resume (and maybe a shrunken mesh) ----------
        nrel = len(report["relaunches"]) + 1
        do_shrink = (shrink != "never"
                     and (reason == "peer-lost" or shrink == "any")
                     and cur_parts > max(int(min_parts), 1))
        argv, child_env = _strip_fault(argv, child_env)
        argv = set_flag(argv, "--resume", ckpt_path)
        mesh_note = ""
        if do_shrink:
            new_parts = max(max(int(min_parts), 1), cur_parts // 2)
            mesh_note = f", shrinking {cur_parts} -> {new_parts} parts"
            argv = set_flag(argv, "--nparts", new_parts)
            if "--resume-repartition" not in argv:
                argv.append("--resume-repartition")
            frm = report["degraded"]["from"] if report["degraded"] \
                else cur_parts
            report["degraded"] = {"from": int(frm), "to": int(new_parts),
                                  "reason": reason}
            from acg_tpu_torch.observatory import DEGRADED_ENV
            child_env[DEGRADED_ENV] = f"{frm}:{new_parts}:{reason}"
            cur_parts = new_parts
        sleep = max(float(backoff), 0.0) * (2 ** (nrel - 1))
        sys.stderr.write(
            f"{_TAG}: {tag}: child exited rc {rc} ({reason}); "
            f"relaunch {nrel}/{int(budget)} with --resume{mesh_note}"
            f"{f' after {sleep:.1f}s backoff' if sleep else ''}\n")
        report["relaunches"].append(
            {"rc": rc, "reason": reason, "parts": cur_parts})
        metrics.record_relaunch(reason)
        if sleep:
            time.sleep(sleep)


def _recovery_section(report: dict) -> str:
    """The ``recovery:`` stats section (stderr, the stats-block
    convention)."""
    lines = ["recovery:"]
    lines.append(f"  attempts: {report['attempts']}")
    rel = report["relaunches"]
    by: dict = {}
    for r in rel:
        by[r["reason"]] = by.get(r["reason"], 0) + 1
    detail = (" (" + ", ".join(f"{k}: {v}"
                               for k, v in sorted(by.items())) + ")"
              if by else "")
    lines.append(f"  relaunches: {len(rel)}{detail}")
    if report.get("degraded"):
        d = report["degraded"]
        lines.append(f"  degraded: {d['from']} -> {d['to']} parts "
                     f"({d['reason']})")
    if report.get("mttr_seconds") is not None:
        lines.append(f"  mttr seconds: {report['mttr_seconds']:.3f}")
    lines.append(f"  outcome: {report.get('outcome')} "
                 f"(rc {report.get('rc')})")
    return "\n".join(lines) + "\n"


def _history_recovery_doc(args, report: dict, kind: str = "recovery",
                          extra: dict | None = None) -> dict:
    """A ledger document for one supervised incident or schedule,
    index-compatible with :func:`acg_tpu_torch.observatory.
    history_append`."""
    doc = {
        "schema": f"acg-tpu-{kind}/1",
        "manifest": {"matrix": str(args.A), "solver": args.solver,
                     "nparts": int(args.nparts or 0),
                     "dtype": args.dtype,
                     "unix_time": time.time()},
        "stats": {"converged": report.get("rc") == 0},
        "recovery": {k: report.get(k) for k in
                     ("rc", "attempts", "relaunches", "degraded",
                      "mttr_seconds", "outcome")},
    }
    if extra:
        doc.update(extra)
    return doc


def _supervise_validate(args) -> None:
    if args.ckpt is None or (args.ckpt_every <= 0
                             and args.ckpt_secs <= 0):
        raise SystemExit(
            f"{_TAG}: --supervise/--chaos relaunch from committed "
            f"snapshots; arm --ckpt FILE with --ckpt-every K or "
            f"--ckpt-secs S")
    if args.resume is not None:
        raise SystemExit(
            f"{_TAG}: --supervise owns the --resume injection on "
            f"relaunch; start it without --resume")
    if args.relaunch_budget < 0:
        raise SystemExit(f"{_TAG}: --relaunch-budget must be >= 0")
    if args.relaunch_backoff < 0:
        raise SystemExit(f"{_TAG}: --relaunch-backoff must be >= 0 "
                         f"seconds")
    if args.min_parts < 1:
        raise SystemExit(f"{_TAG}: --min-parts must be >= 1")


def _write_metrics(args) -> None:
    from acg_tpu_torch import metrics

    if args.metrics_file:
        try:
            metrics.write_textfile(args.metrics_file)
        except OSError as e:
            sys.stderr.write(f"{_TAG}: --metrics-file "
                             f"{args.metrics_file}: {e}\n")


def _history(args, doc: dict) -> None:
    if args.history:
        from acg_tpu_torch import observatory
        try:
            observatory.history_append(args.history, doc)
        except OSError as e:
            sys.stderr.write(f"{_TAG}: --history {args.history}: {e}\n")


def run_supervised(args, argv: list) -> int:
    """The ``--supervise`` CLI mode."""
    from acg_tpu_torch import metrics

    _supervise_validate(args)
    child_argv = strip_flags(argv, SUPERVISOR_FLAGS)
    metrics.arm()
    report = supervise(
        child_argv, ckpt_path=args.ckpt,
        budget=args.relaunch_budget, backoff=args.relaunch_backoff,
        shrink=args.shrink, min_parts=args.min_parts,
        nparts=int(args.nparts or 0))
    sys.stderr.write(_recovery_section(report))
    _history(args, _history_recovery_doc(args, report))
    _write_metrics(args)
    metrics.disarm()
    return int(report["rc"])


# -- the daemon supervisor (--serve --supervise) ---------------------------

class DaemonSupervisor:
    """The relaunch loop for a LONG-LIVED child (the ``--serve``
    daemon).  :func:`supervise` models a batch child -- run to
    completion, then judge the exit code; a daemon never completes, so
    this variant runs the child under ``subprocess.Popen`` on a
    watcher thread and applies the same exit-code contract to every
    unexpected death: relaunch within budget (the daemon WARM-RESTORES
    its operator cache from the serve state sidecar -- no ``--resume``
    injection), shrink ``--nparts`` on crash-class deaths, and -- the
    other half of the shrink ratchet -- GROW back: a shrunken child
    that stays healthy for ``grow_after`` served requests is
    deliberately relaunched toward the original part count with
    ``--resume-repartition``, counted by
    ``acg_recovery_regrows_total``."""

    POLL_SECS = 0.2

    def __init__(self, child_argv: list, *, state_path: str,
                 budget: int = 3, backoff: float = 1.0,
                 shrink: str = "any", min_parts: int = 1,
                 nparts: int = 0, grow_after: int = 0,
                 env: dict | None = None, label: str = "serve"):
        import threading
        self.argv = list(child_argv)
        self.state_path = state_path
        self.budget = max(int(budget), 0)
        self.backoff = max(float(backoff), 0.0)
        self.shrink = shrink
        self.min_parts = max(int(min_parts), 1)
        self.orig_parts = int(nparts or 0)
        self.cur_parts = self.orig_parts
        self.grow_after = max(int(grow_after), 0)
        self.env = dict(os.environ if env is None else env)
        self.tag = f"supervisor [{label}]"
        self.report: dict = {"rc": None, "relaunches": [],
                             "regrows": 0, "degraded": None,
                             "outcome": None}
        self._proc: subprocess.Popen | None = None
        self._stop = threading.Event()
        self._served_at_launch = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="acg-daemon-supervisor",
                                        daemon=True)

    # -- state-file probes -------------------------------------------------

    def _served(self) -> int:
        """``requests_served`` of the running child from the serve state
        sidecar (the counter the daemon persists after every request);
        0 when unreadable or still the previous child's.  The sidecar
        names the pid that wrote it: a relaunched daemon counts from 0,
        while the sidecar holds its predecessor's count until the new
        daemon's first write (the reference's supervisor takes that
        count as the new child's baseline, so a daemon that served k
        requests before a crash regrows only after k + grow_after)."""
        import json
        try:
            with open(self.state_path) as f:
                doc = json.load(f)
            proc = self._proc
            if proc is None or doc.get("pid") != proc.pid:
                return 0
            return int(doc.get("requests_served", 0))
        except (OSError, ValueError, TypeError, AttributeError):
            return 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DaemonSupervisor":
        self._launch()
        self._thread.start()
        return self

    def stop(self) -> None:
        """Deliberate wind-down: never counted as a failure."""
        self._stop.set()
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def wait(self) -> int:
        """Block until the loop ends (clean child exit, budget
        exhausted, or a non-relaunchable death); the final rc."""
        while self._thread.is_alive():
            self._thread.join(timeout=0.5)
        return int(self.report["rc"] or 0)

    # -- the loop ----------------------------------------------------------

    def _launch(self) -> None:
        cmd = [sys.executable, "-m", "acg_tpu_torch", *self.argv]
        self._proc = subprocess.Popen(cmd, env=self.env)
        self._served_at_launch = self._served()

    def _relaunch(self, *, parts: int | None, reason: str,
                  grow: bool) -> None:
        from acg_tpu_torch import metrics
        mesh_note = ""
        if parts is not None and parts != self.cur_parts:
            mesh_note = (f", {'growing' if grow else 'shrinking'} "
                         f"{self.cur_parts} -> {parts} parts")
            self.argv = set_flag(self.argv, "--nparts", parts)
            if grow:
                if "--resume-repartition" not in self.argv:
                    self.argv.append("--resume-repartition")
                if parts >= self.orig_parts:
                    from acg_tpu_torch.observatory import DEGRADED_ENV
                    self.report["degraded"] = None
                    self.env.pop(DEGRADED_ENV, None)
            else:
                from acg_tpu_torch.observatory import DEGRADED_ENV
                frm = (self.report["degraded"]["from"]
                       if self.report["degraded"] else self.cur_parts)
                self.report["degraded"] = {"from": int(frm),
                                           "to": int(parts),
                                           "reason": reason}
                self.env[DEGRADED_ENV] = f"{frm}:{parts}:{reason}"
            self.cur_parts = parts
        if grow:
            self.report["regrows"] += 1
            metrics.record_regrow()
            sys.stderr.write(f"{_TAG}: {self.tag}: child healthy for "
                             f"{self.grow_after}+ requests -- regrow "
                             f"relaunch{mesh_note}\n")
        else:
            nrel = len(self.report["relaunches"]) + 1
            sleep = self.backoff * (2 ** (nrel - 1))
            sys.stderr.write(f"{_TAG}: {self.tag}: daemon died "
                             f"({reason}); relaunch {nrel}/"
                             f"{self.budget}{mesh_note}"
                             f"{f' after {sleep:.1f}s' if sleep else ''}"
                             "\n")
            self.report["relaunches"].append(
                {"reason": reason, "parts": self.cur_parts})
            metrics.record_relaunch(reason)
            if sleep:
                time.sleep(sleep)
        self._launch()

    def _loop(self) -> None:
        while not self._stop.is_set():
            proc = self._proc
            rc = proc.poll() if proc is not None else None
            if rc is None:
                if (self.grow_after > 0
                        and 0 < self.cur_parts < self.orig_parts
                        and (self._served() - self._served_at_launch
                             >= self.grow_after)):
                    proc.terminate()
                    try:
                        proc.wait(timeout=30.0)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=5.0)
                    self._relaunch(
                        parts=min(self.orig_parts,
                                  max(self.cur_parts * 2, 1)),
                        reason="regrow", grow=True)
                    continue
                self._stop.wait(self.POLL_SECS)
                continue
            if self._stop.is_set():
                break
            rc = int(rc)
            if rc == 0:
                self.report["rc"] = 0
                self.report["outcome"] = "clean-exit"
                return
            reason = _reason(rc)
            relaunchable = (rc in RELAUNCHABLE_CODES or rc < 0)
            if (not relaunchable
                    or len(self.report["relaunches"]) >= self.budget):
                why = ("relaunch budget exhausted" if relaunchable
                       else "not a relaunchable failure")
                sys.stderr.write(f"{_TAG}: {self.tag}: daemon died "
                                 f"rc {rc} ({reason}); {why} -- "
                                 f"giving up\n")
                self.report["rc"] = (int(ExitCode.RELAUNCH_BUDGET)
                                     if relaunchable else rc)
                self.report["outcome"] = "gave-up"
                return
            parts = None
            if (self.shrink != "never"
                    and (reason == "peer-lost" or self.shrink == "any")
                    and self.cur_parts > self.min_parts):
                parts = max(self.min_parts, self.cur_parts // 2)
            self._relaunch(parts=parts, reason=reason, grow=False)


def supervise_daemon(child_argv: list, *, state_path: str,
                     budget: int = 3, backoff: float = 1.0,
                     shrink: str = "any", min_parts: int = 1,
                     nparts: int = 0, grow_after: int = 0,
                     env: dict | None = None,
                     label: str = "serve") -> DaemonSupervisor:
    """Launch ``python -m acg_tpu_torch <child_argv>`` (a ``--serve``
    daemon) under the relaunch/shrink/grow policy; returns the STARTED
    :class:`DaemonSupervisor` (``.stop()`` to wind down, ``.wait()``
    to block)."""
    return DaemonSupervisor(
        child_argv, state_path=state_path, budget=budget,
        backoff=backoff, shrink=shrink, min_parts=min_parts,
        nparts=nparts, grow_after=grow_after, env=env,
        label=label).start()


def run_supervised_serve(args, argv: list) -> int:
    """The ``--serve --supervise`` CLI mode: the self-healing service.
    Unlike batch ``--supervise`` there is no snapshot-cadence
    requirement -- the daemon persists its serve state after every
    request -- but ``--ckpt`` must be armed so the state has a home."""
    import signal

    from acg_tpu_torch import metrics

    if args.ckpt is None:
        raise SystemExit(
            f"{_TAG}: --serve --supervise warm-restores the daemon "
            "from its persisted serve state; arm --ckpt FILE")
    if args.resume is not None:
        raise SystemExit(
            f"{_TAG}: --serve --supervise owns relaunches; start it "
            "without --resume")
    metrics.arm()
    child_argv = strip_flags(argv, SUPERVISOR_FLAGS)
    sup = supervise_daemon(
        child_argv, state_path=args.ckpt + ".serve.json",
        budget=args.relaunch_budget, backoff=args.relaunch_backoff,
        shrink=args.shrink, min_parts=args.min_parts,
        nparts=int(args.nparts or 0),
        grow_after=int(getattr(args, "grow_after", 0) or 0))

    def _term(signum, frame):
        sys.stderr.write(f"{_TAG}: supervisor [serve]: signal "
                         f"{signum} -- stopping the daemon\n")
        sup.stop()

    try:
        signal.signal(signal.SIGTERM, _term)
        signal.signal(signal.SIGINT, _term)
    except ValueError:
        pass
    try:
        rc = sup.wait()
    except KeyboardInterrupt:
        sup.stop()
        rc = 0
    rep = dict(sup.report)
    sys.stderr.write(
        "recovery:\n"
        f"  relaunches: {len(rep['relaunches'])}\n"
        f"  regrows: {rep['regrows']}\n"
        f"  outcome: {rep.get('outcome')} (rc {rep.get('rc')})\n")
    if args.metrics_file:
        try:
            metrics.write_textfile(args.metrics_file)
        except OSError as e:
            sys.stderr.write(f"{_TAG}: --metrics-file "
                             f"{args.metrics_file}: {e}\n")
    metrics.disarm()
    return rc


# -- the chaos campaign ----------------------------------------------------

def parse_chaos(spec: str) -> tuple:
    """``SEED[:N]`` -> (seed, nschedules); N defaults to 20 (the
    acceptance campaign's floor)."""
    head, _, tail = str(spec).partition(":")
    try:
        seed = int(head)
        n = int(tail) if tail else 20
        if n <= 0:
            raise ValueError
    except ValueError:
        raise SystemExit(f"{_TAG}: --chaos {spec!r}: expected SEED[:N] "
                         f"with positive N")
    return seed, n


def chaos_schedule(index: int, seed: int, args) -> str | None:
    """Schedule ``index``'s fault spec (None = a fault-free control
    run), deterministic in (seed, index) and the reference's draw
    (``acg_tpu/supervisor.py:648-700``), over the sites this
    configuration can fire: crash:exit needs the (enforced) checkpoint,
    sdc:flip an armed --abft, halo faults parts, peer faults processes,
    solve:slow the soak driver."""
    rng = np.random.default_rng([int(seed), int(index)])
    menu = ["none", "crash", "spmv:nan", "spmv:inf", "dot:nan",
            "dot:neg"]
    if int(args.nparts or 0) > 1:
        menu.append("halo:nan")
    if args.abft and int(getattr(args, "audit_every", 0)) > 0:
        menu.append("sdc:flip")
    if args.multihost or args.coordinator is not None:
        menu.append("peer:dead")
    if args.soak:
        menu.append("solve:slow")
    pick = menu[int(rng.integers(len(menu)))]
    if pick == "none":
        return None
    # the firing iteration biased low (quadratic): the iteration cap is
    # usually far past convergence, and a fault drawn past the last
    # iteration never fires (a silent extra control run, kept as a
    # schedule class of its own)
    hi = max(int(args.max_iterations * 0.6), 3)
    k = 2 + int((hi - 2) * float(rng.random()) ** 2)
    if pick == "sdc:flip":
        # the checksum test verifies the current SpMV product at the
        # audit cadence, so the flip lands on an audited iteration
        ae = max(int(args.audit_every), 1)
        k = max((k // ae) * ae + (ae - 1), ae - 1)
        return f"sdc:flip@{k}:seed={int(rng.integers(1 << 16))}"
    if pick == "crash":
        return f"crash:exit@{k}"
    if pick == "peer:dead":
        nproc = int(getattr(args, "num_processes", None) or 2)
        return f"peer:dead:proc={int(rng.integers(nproc))}"
    if pick == "solve:slow":
        return f"solve:slow@{max(int(args.soak) // 2, 1)}:secs=0.05"
    el = int(rng.integers(1 << 16))
    if pick.startswith("dot:"):
        return f"{pick}@{k}"
    return f"{pick}@{k}:seed={el}"


def _host_system(args):
    """The verification oracle: the matrix rebuilt on the host through
    the same synthesis dispatch the children's CLI uses, and the b they
    solved (ones).  Nothing of the children's device SpMV or solve
    enters the scipy residual computed here."""
    from acg_tpu_torch.matrix import SymCsrMatrix

    if args.A.startswith("gen:"):
        from acg_tpu_torch.cli import synthesize_host_matrix
        A = synthesize_host_matrix(args.A, aniso=args.aniso,
                                   seed=args.seed)
    else:
        from acg_tpu_torch.io.mtxfile import read_mtx
        A = SymCsrMatrix.from_mtx(read_mtx(args.A, binary=args.binary))
    csr = A.to_csr(epsilon=args.epsilon)
    return csr, np.ones(csr.shape[0])


def verify_solution(csr, b, out_path: str, rtol: float,
                    atol: float = 0.0) -> tuple:
    """``(ok, relative_residual)`` of the solution a child wrote: the
    wrong-answer-green detector.  The x50 margin covers a repartition's
    re-associated dots and a healthy run's recurrence-vs-true residual
    gap; silent corruption leaves residuals orders of magnitude past
    it."""
    from acg_tpu_torch.io.mtxfile import read_mtx

    x = np.asarray(read_mtx(out_path, binary=True).vals,
                   dtype=np.float64).reshape(-1)
    return verify_solution_dense(csr, b, x, rtol, atol)


def verify_solution_dense(csr, b, x, rtol: float,
                          atol: float = 0.0) -> tuple:
    """:func:`verify_solution` for a solution vector in memory: the same
    margin and the same wrong-answer-green contract."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    if x.size != b.size or not np.isfinite(x).all():
        return False, float("inf")
    bn = float(np.linalg.norm(b)) or 1.0
    rel = float(np.linalg.norm(b - csr @ x)) / bn
    bound = max(float(rtol), float(atol) / bn, 1e-14) * 50.0
    return rel <= bound, rel


def run_chaos(args, argv: list) -> int:
    """The ``--chaos SEED[:N]`` campaign driver."""
    import tempfile

    from acg_tpu_torch import metrics

    _supervise_validate(args)
    unsupported = [flag for flag, on in [
        ("--manufactured-solution (chaos verifies against b = ones)",
         args.manufactured_solution),
        ("b/x0 input files", bool(args.b or args.x0)),
        ("--distributed-read", args.distributed_read),
        ("--output-comm-matrix", args.output_comm_matrix),
        ("--fault-inject (the campaign owns the fault schedule)",
         args.fault_inject is not None),
    ] if on]
    if unsupported:
        raise SystemExit(f"{_TAG}: --chaos does not support: "
                         f"{', '.join(unsupported)}")
    seed, nsched = parse_chaos(args.chaos)
    try:
        csr, b = _host_system(args)
    except Exception as e:  # noqa: BLE001 -- refuse, don't crash
        raise SystemExit(
            f"{_TAG}: --chaos cannot build the host verification oracle "
            f"for {args.A}: {e}")
    base_argv = strip_flags(argv, SUPERVISOR_FLAGS)
    metrics.arm()
    tally = {"converged": 0, "agreed-abort": 0, "WRONG-ANSWER": 0}
    worst = []
    tmpdir = tempfile.mkdtemp(prefix="acg-chaos-")
    sys.stderr.write(f"{_TAG}: chaos: {nsched} schedules from seed "
                     f"{seed} over {args.A}\n")
    for i in range(nsched):
        spec = chaos_schedule(i, seed, args)
        out = os.path.join(tmpdir, f"x{i}.mtx")
        argv_i = set_flag(strip_flags(base_argv, {"--output": 1}),
                          "-o", out)
        argv_i = set_flag(argv_i, "--ckpt", os.path.join(tmpdir, f"ck{i}"))
        if "--quiet" not in argv_i and "-q" not in argv_i:
            argv_i.append("--quiet")
        env = dict(os.environ)
        env.pop("ACG_TPU_FAULT_INJECT", None)
        if spec is not None:
            env["ACG_TPU_FAULT_INJECT"] = spec
        report = supervise(
            argv_i, ckpt_path=os.path.join(tmpdir, f"ck{i}"),
            budget=args.relaunch_budget,
            backoff=min(args.relaunch_backoff, 0.2),
            shrink=args.shrink, min_parts=args.min_parts,
            nparts=int(args.nparts or 0), env=env, capture=True,
            label=f"chaos {i}")

        def checked():
            # a green run whose output is missing or unreadable is not
            # verified: it never passes silently
            try:
                return verify_solution(csr, b, out, args.residual_rtol,
                                       args.residual_atol)
            except Exception:  # noqa: BLE001
                return False, None

        rel = None
        if report["rc"] == 0:
            ok, rel = checked()
            outcome = "converged" if ok else "WRONG-ANSWER"
        elif report.get("outcome") == "gate":
            # a drift/SLO trip (rc 7/8) is a completed solve that wrote
            # its answer: it still owes the campaign a verdict
            ok, rel = checked()
            outcome = "gate" if ok else "WRONG-ANSWER"
        else:
            outcome = "agreed-abort"
        tally[outcome] = tally.get(outcome, 0) + 1
        if outcome == "WRONG-ANSWER":
            worst.append((i, spec, rel))
        sys.stderr.write(
            f"{_TAG}: chaos[{i}]: fault={spec or 'none'} "
            f"rc={report['rc']} attempts={report['attempts']} "
            f"-> {outcome}"
            f"{f' (true rel residual {rel:.3e})' if rel is not None else ''}"
            f"\n")
        _history(args, _history_recovery_doc(
            args, report, kind="chaos",
            extra={"chaos": {"schedule": i, "seed": seed, "fault": spec,
                             "outcome": outcome,
                             "true_rel_residual": rel}}))
    sys.stderr.write(
        "chaos:\n"
        f"  schedules: {nsched} (seed {seed})\n"
        f"  converged: {tally['converged']}\n"
        f"  agreed-abort: {tally['agreed-abort']}\n"
        + (f"  gate: {tally['gate']}\n" if tally.get("gate") else "")
        + f"  wrong-answer: {tally['WRONG-ANSWER']}\n")
    for i, spec, rel in worst:
        why = (f"true rel residual {rel:.3e}" if rel is not None
               else "output missing/unreadable")
        sys.stderr.write(f"  WRONG-ANSWER: schedule {i} "
                         f"(fault={spec}, {why})\n")
    _write_metrics(args)
    metrics.disarm()
    if tally["WRONG-ANSWER"]:
        return int(ExitCode.WRONG_ANSWER)
    return 0
