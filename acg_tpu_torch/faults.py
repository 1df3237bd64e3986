"""Deterministic fault injection for solver-resilience testing.

The port's copy of ``acg_tpu/faults.py``; the text below is the
reference's, but for the device sites.

The reference suite ships no fault injection; this module supplies the
missing tier for the TPU build (round-5 verdict: "race detection/
elasticity/fault injection: none").  A single seed-driven spec -- from
the ``--fault-inject`` CLI flag, the ``ACG_TPU_FAULT_INJECT`` env var
(which subprocess children inherit, so multi-process scenarios need no
plumbing), or :func:`install` in tests -- selects ONE fault site and
firing condition:

  ``SITE:MODE[@ITER][:KEY=VAL]...``

  * ``spmv:nan@7``          NaN into the SpMV output at iteration 7
  * ``spmv:inf@7:part=2``   Inf into part 2's local SpMV result
  * ``halo:nan@3``          NaN into the received halo payload
  * ``dot:neg@5``           (p, Ap) driven non-positive at iteration 5
  * ``precond:nan@4``       NaN into z = M^-1 r at iteration 4 (the
                            non-SPD-preconditioner breakdown path;
                            needs an armed --precond)
  * ``dot:nan@5``           NaN into the dot scalar
  * ``sdc:flip@7``          SIGN-FLIP one SpMV output element (finite:
                            invisible to the non-finite guards, caught
                            only by the ABFT checksum test, --abft)
  * ``crash:exit@20``       hard os._exit once a checkpointed solve
                            crosses 20 iterations (needs --ckpt)
  * ``peer:dead:proc=1``    controller 1 dies before its next
                            error-agreement checkpoint
  * ``peer:stall:proc=1:secs=30``  controller 1 stalls instead
  * ``backend:hang:secs=120``      backend init (probe children) hangs
  * ``solve:slow@10:secs=0.05``    every solve from soak index 10 on is
                                   dilated 50 ms (drift-detector test)

Keys: ``part`` (mesh part a vector fault targets; -1 = every part),
``proc`` (controller index for peer faults), ``secs`` (hang/stall
duration), ``seed`` (picks the poisoned element deterministically).

Device-site faults (``spmv``/``dot``/``halo``/``precond``/``sdc``) are
applied inside the eager solve loops of :mod:`acg_tpu_torch.solvers.cg`,
right after the kernel that produced the vector (the kernel itself never
poisons its output): the ``apply_*`` helpers are torch functions of the
TRAJECTORY iteration ``k`` the host knows (a live loop step's host index
equals the device count), and the poisoned write is a ``where`` on the
loop's ``live`` flag, so a frozen step past convergence or breakdown
never fires.  A disarmed loop calls none of them.  The numpy twins serve
the eager host solver.

The port keeps the reference's grammar and ``ACG_TPU_FAULT_INJECT`` (so
scripts carry over).  ``peer:*`` fires in the error agreement
(:func:`maybe_fail_peer`, called at the head of :func:`acg_tpu_torch.
parallel.erragree.agree_status`), ``backend:hang`` in the bounded
backend probe's child (:func:`maybe_hang_backend`, :mod:`acg_tpu_torch.
_device`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import numpy as np

DEVICE_SITES = ("spmv", "dot", "halo", "precond", "sdc")
_SITES = DEVICE_SITES + ("peer", "backend", "solve", "crash")
_MODES = {
    "spmv": ("nan", "inf"),
    "halo": ("nan", "inf"),
    # silent data corruption in the SpMV output: ONE element's sign is
    # flipped at the armed iteration -- a finite value, so the
    # non-finite breakdown guards can NEVER catch it; only the ABFT
    # checksum test (acg_tpu.health, --abft) detects it on device
    "sdc": ("flip",),
    # host-side hard process death between checkpoint chunks
    # (``crash:exit@K``: os._exit once the chunked solve crosses K
    # total iterations) -- the --ckpt/--resume survivability test
    # vector; refuses without an armed checkpoint (it could never fire)
    "crash": ("exit",),
    # the preconditioner apply's output z = M^-1 r (PCG tier,
    # acg_tpu.precond): a poisoned z drives the (r, z) scalar non-finite
    # or negative -- the non-SPD-M breakdown path, made deterministic
    "precond": ("nan", "inf"),
    "dot": ("nan", "zero", "neg"),
    "peer": ("dead", "stall"),
    "backend": ("hang",),
    # host-side latency dilation for the soak driver's drift detector
    # (``solve:slow@K:secs=S``: every solve from index K onward sleeps
    # S seconds inside the timed window) -- contention/throttling made
    # deterministic; the compiled programs are untouched
    "solve": ("slow",),
}
ENV_VAR = "ACG_TPU_FAULT_INJECT"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault: immutable and hashable (a jit static arg)."""

    site: str
    mode: str
    iteration: int = -1   # device sites: the 0-based iteration to fire at
    part: int = -1        # mesh part a vector fault targets (-1 = all)
    proc: int = 0         # controller index for peer faults
    secs: float = 300.0   # hang/stall duration
    seed: int = 0         # picks the poisoned element index

    @property
    def device_site(self) -> bool:
        return self.site in DEVICE_SITES

    def __str__(self) -> str:
        """The canonical ``SITE:MODE[@ITER][:KEY=VAL]`` spec string:
        ``parse_fault_spec(str(spec)) == spec``, so snapshot metadata
        and the chaos ledger record re-runnable specs instead of
        dataclass reprs."""
        s = f"{self.site}:{self.mode}"
        if self.iteration >= 0:
            s += f"@{self.iteration}"
        if self.part >= 0:
            s += f":part={self.part}"
        if self.proc != 0:
            s += f":proc={self.proc}"
        if self.secs != 300.0:
            s += f":secs={self.secs:g}"
        if self.seed != 0:
            s += f":seed={self.seed}"
        return s

    def shift(self, consumed: int) -> "FaultSpec | None":
        """The spec as seen by a RESTARTED solve that already ran
        ``consumed`` iterations: the firing iteration moves earlier, and
        a fault that already fired vanishes (None) -- restarts must not
        deterministically re-trigger the same breakdown forever."""
        if not self.device_site:
            return self
        it = self.iteration - int(consumed)
        if it < 0:
            return None
        return dataclasses.replace(self, iteration=it)

    # -- device-side application (eager torch, the loop's own step) ------

    def _fires(self, k) -> bool:
        """Host-side: does this spec fire at trajectory iteration ``k``
        (None: a setup SpMV, which never fires)?"""
        return k is not None and int(k) == self.iteration

    def _poison(self, y, live, value_of):
        """``y`` with element ``seed % n`` of the targeted part (a
        stacked ``(P, n)`` vector: row ``part``, or every row for -1)
        replaced by ``value_of(old)``, masked by ``live``."""
        import torch

        y = y.clone()
        idx = self.seed % max(int(y.shape[-1]), 1)
        if y.dim() == 1:
            old = y[idx]
            new = value_of(old)
            y[idx] = new if live is None else torch.where(
                live.reshape(()), new, old)
            return y
        rows = (slice(None) if self.part < 0
                else slice(self.part, self.part + 1))
        old = y[rows, idx]
        new = value_of(old)
        y[rows, idx] = new if live is None else torch.where(
            live.reshape(()), new, old)
        return y

    def _bad_value(self, old):
        import torch

        return torch.full_like(old, math.nan if self.mode == "nan"
                               else math.inf)

    def apply_spmv(self, y, k, live=None):
        """Poison one element of an SpMV output at the armed iteration.
        ``sdc:flip`` flips the element's SIGN instead of writing a
        non-finite -- bit-level corruption the finiteness guards are
        blind to (the ABFT test vector)."""
        if self.site not in ("spmv", "sdc") or not self._fires(k):
            return y
        if self.site == "sdc":
            return self._poison(y, live, lambda old: -old)
        return self._poison(y, live, self._bad_value)

    def apply_halo(self, ghost, k, live=None):
        """Poison one element of the received halo payload."""
        if self.site != "halo" or not self._fires(k):
            return ghost
        return self._poison(ghost, live, self._bad_value)

    def apply_precond(self, z, k, live=None):
        """Poison one element of the preconditioner apply's output."""
        if self.site != "precond" or not self._fires(k):
            return z
        return self._poison(z, live, self._bad_value)

    def apply_dot(self, s, k, live=None):
        """Corrupt a CG scalar: NaN, zero, or driven non-positive."""
        if self.site != "dot" or not self._fires(k):
            return s
        import torch

        if self.mode == "nan":
            bad = torch.full_like(s, math.nan)
        elif self.mode == "zero":
            bad = torch.zeros_like(s)
        else:  # neg: guaranteed non-positive whatever the true value
            bad = -torch.abs(s) - 1
        return bad if live is None else torch.where(live, bad, s)

    # -- host-side application (eager numpy) ----------------------------

    def apply_spmv_np(self, y: np.ndarray, k: int) -> np.ndarray:
        if self.site not in ("spmv", "sdc") or k != self.iteration:
            return y
        y = np.array(y, copy=True)
        idx = self.seed % max(y.size, 1)
        if self.site == "sdc":
            y[idx] = -y[idx]
        else:
            y[idx] = np.nan if self.mode == "nan" else np.inf
        return y

    def apply_precond_np(self, z: np.ndarray, k: int) -> np.ndarray:
        if self.site != "precond" or k != self.iteration:
            return z
        z = np.array(z, copy=True)
        z[self.seed % max(z.size, 1)] = (np.nan if self.mode == "nan"
                                         else np.inf)
        return z

    def apply_dot_np(self, s: float, k: int) -> float:
        if self.site != "dot" or k != self.iteration:
            return s
        if self.mode == "nan":
            return float("nan")
        if self.mode == "zero":
            return 0.0
        return -abs(s) - 1.0


def parse_fault_spec(text: str) -> FaultSpec:
    """Parse the ``SITE:MODE[@ITER][:KEY=VAL]...`` grammar; raises
    ``ValueError`` with the offending token named."""
    fields = [f for f in str(text).strip().split(":") if f]
    if len(fields) < 2:
        raise ValueError(
            f"fault spec {text!r}: expected SITE:MODE[@ITER][:KEY=VAL]")
    site = fields[0]
    mode = fields[1]
    kwargs: dict = {}
    if "@" in mode:
        mode, _, it = mode.partition("@")
        try:
            kwargs["iteration"] = int(it)
        except ValueError:
            raise ValueError(f"fault spec {text!r}: bad iteration {it!r}")
    if site not in _SITES:
        raise ValueError(f"fault spec {text!r}: unknown site {site!r} "
                         f"(one of {', '.join(_SITES)})")
    if mode not in _MODES[site]:
        raise ValueError(f"fault spec {text!r}: unknown mode {mode!r} for "
                         f"site {site!r} (one of {', '.join(_MODES[site])})")
    for kv in fields[2:]:
        key, eq, val = kv.partition("=")
        if not eq or key not in ("part", "proc", "secs", "seed"):
            raise ValueError(f"fault spec {text!r}: bad key {kv!r} "
                             f"(part=, proc=, secs=, seed=)")
        try:
            kwargs[key] = float(val) if key == "secs" else int(val)
        except ValueError:
            raise ValueError(f"fault spec {text!r}: bad value {kv!r}")
    if site in DEVICE_SITES + ("crash",) and "iteration" not in kwargs:
        raise ValueError(f"fault spec {text!r}: site {site!r} needs a "
                         f"firing iteration (e.g. {site}:{mode}@5)")
    if site == "solve" and "secs" not in kwargs:
        # the default 300 s stall is a hang-detection figure; a latency
        # dilation without an explicit magnitude is a footgun
        raise ValueError(f"fault spec {text!r}: solve:slow needs an "
                         f"explicit dilation (e.g. solve:slow@10:"
                         f"secs=0.05)")
    return FaultSpec(site=site, mode=mode, **kwargs)


_installed: FaultSpec | None = None
_suppressed: bool = False


@contextlib.contextmanager
def suppressed():
    """Temporarily disarm the injector (env var included): the recovery
    ladder's fallback rungs run under this -- the injected fault models
    the ACCELERATED path's failure, and re-firing it inside the host
    oracle would poison the very rung that exists to survive it."""
    global _suppressed
    prev = _suppressed
    _suppressed = True
    try:
        yield
    finally:
        _suppressed = prev


def install(spec: FaultSpec | None) -> None:
    """Arm (or with None, disarm) the process-wide injector."""
    global _installed
    _installed = spec


@contextlib.contextmanager
def injected(spec: FaultSpec | str):
    """Context manager for tests: arm ``spec`` inside the block."""
    if isinstance(spec, str):
        spec = parse_fault_spec(spec)
    prev = _installed
    install(spec)
    try:
        yield spec
    finally:
        install(prev)


def active_fault() -> FaultSpec | None:
    """The armed spec: :func:`install` wins, else ``ACG_TPU_FAULT_INJECT``
    (parsed fresh each call -- subprocess tests mutate the environment).
    A malformed env spec raises a typed AcgError (INVALID_VALUE) naming
    the variable -- this is read lazily deep inside solves, where a raw
    ValueError would dodge every caller's error handling."""
    if _suppressed:
        return None
    if _installed is not None:
        return _installed
    env = os.environ.get(ENV_VAR)
    if not env:
        return None
    try:
        return parse_fault_spec(env)
    except ValueError as e:
        from acg_tpu_torch.errors import AcgError, ErrorCode

        raise AcgError(ErrorCode.INVALID_VALUE, f"{ENV_VAR}: {e}")


def device_fault() -> FaultSpec | None:
    """The armed spec when it targets a device site, else None -- what
    the solvers thread into their compiled programs (peer/backend faults
    must not perturb the compiled solve)."""
    spec = active_fault()
    return spec if spec is not None and spec.device_site else None


def maybe_fail_peer(stage: str = "") -> None:
    """Peer-fault hook of the error agreement: on the targeted process,
    ``peer:dead`` exits hard BEFORE the agreement (the survivors'
    watchdog must abort them within the agreed timeout) and
    ``peer:stall`` sleeps through it."""
    spec = active_fault()
    if spec is None or spec.site != "peer":
        return
    from acg_tpu_torch.parallel import multihost

    if multihost.process_index() != spec.proc:
        return
    import sys

    if spec.mode == "dead":
        from acg_tpu_torch.errors import ExitCode

        sys.stderr.write(f"acg-tpu-torch: fault injector: controller "
                         f"{spec.proc} dying before checkpoint "
                         f"{stage or '?'}\n")
        sys.stderr.flush()
        os._exit(int(ExitCode.PEER_DEAD_INJECTED))
    sys.stderr.write(f"acg-tpu-torch: fault injector: controller "
                     f"{spec.proc} stalling {spec.secs:.0f}s at checkpoint "
                     f"{stage or '?'}\n")
    sys.stderr.flush()
    time.sleep(spec.secs)


def maybe_slow_solve(solve_index: int) -> float:
    """Soak-driver hook (``solve:slow@K:secs=S``): sleep ``S`` seconds
    inside the timed window of every solve from index ``K`` onward
    (``@ITER`` here is a SOLVE index, not an iteration -- the drift
    detector needs a clean baseline window first).  Returns the seconds
    slept so callers can log the dilation."""
    spec = active_fault()
    if spec is None or spec.site != "solve":
        return 0.0
    start = max(spec.iteration, 0)
    if int(solve_index) < start:
        return 0.0
    time.sleep(spec.secs)
    return spec.secs


def maybe_crash(before: int, after: int) -> None:
    """Checkpoint-chunk hook (``crash:exit@K``): hard ``os._exit`` the
    first time the chunked solve CROSSES K total iterations -- i.e.
    ``before < K <= after``, where ``before``/``after`` are the
    cumulative iteration counts around one chunk.  Crossing (not
    threshold) semantics matter for ``--resume``: a resumed solve
    starts at the last snapshot, which already lies at-or-past K, so
    the same inherited spec does not re-kill the relaunch.  Fires
    AFTER the chunk's snapshot committed (the chunk drivers call this
    right after their atomic write), modelling preemption between
    iterations."""
    spec = active_fault()
    if spec is None or spec.site != "crash":
        return
    K = max(int(spec.iteration), 0)
    if not (int(before) < K <= int(after)):
        return
    import sys

    from acg_tpu_torch.checkpoint import CRASH_EXIT_CODE

    sys.stderr.write(f"acg-tpu-torch: fault injector: hard exit at "
                     f"{int(after)} iterations (crash:exit@{K})\n")
    sys.stderr.flush()
    _crash_rendezvous(K)
    os._exit(CRASH_EXIT_CODE)


# how long the store host waits for its peers at a crash:exit rendezvous
CRASH_RENDEZVOUS_SECS = 30.0


def _crash_rendezvous(K: int) -> None:
    """Multi-process ``crash:exit``: process 0 hosts the run's TCPStore,
    and a peer can still be reading the agreement the crash follows when
    process 0 gets here -- its exit would end the peer's read with a
    store error (exit 1) instead of the peer's own crash.  Every process
    marks its arrival after its last read; process 0 leaves last, once
    every peer arrived or after :data:`CRASH_RENDEZVOUS_SECS` (a peer
    that died elsewhere)."""
    from acg_tpu_torch.parallel import multihost

    n = multihost.process_count()
    if n == 1:
        return
    import datetime

    store = multihost.world().store
    me = multihost.process_index()
    try:
        store.set(f"acg_tpu/crash/{K}/{me}", "1")
        if me == 0:
            store.wait([f"acg_tpu/crash/{K}/{q}" for q in range(1, n)],
                       datetime.timedelta(seconds=CRASH_RENDEZVOUS_SECS))
    except Exception:  # noqa: BLE001 -- the crash goes ahead regardless
        pass


def maybe_hang_backend() -> None:
    """Backend-fault hook of the probe child: ``backend:hang`` sleeps in
    place of the device runtime's initialisation, so a wedged runtime is
    reproducible without one."""
    spec = active_fault()
    if spec is not None and spec.site == "backend" and spec.mode == "hang":
        time.sleep(spec.secs)
