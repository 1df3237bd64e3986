"""Cross-process error agreement -- the ``acgerrmpi`` analog.

The counterpart of ``acg_tpu/parallel/erragree.py``.  The reference
wraps hazardous stages in a collective error agreement so every rank
learns the worst error code and all exit together, instead of one rank
dying alone while its peers wedge in the next collective
(``acg/error.c`` ``acgerrmpi``, used at ``cuda/acg-cuda.c:2410``).

:func:`agree_status` gathers an integer status from every process at a
stage boundary through the run's ``torch.distributed.TCPStore`` (the JAX
package's coordination-service key-value store, ``_coord_client``):
plain TCP to process 0, no device collective, so a poisoned card cannot
wedge it.  Keys are ``acg_tpu/erragree/<seq>/<rank>``; generation
``seq - 1`` is deleted once generation ``seq`` is reached (every process
finished reading it).  A watchdog guards the agreement itself: a peer
that died before reaching the boundary would leave the wait hanging, so
after ``timeout`` seconds the process prints a diagnosis and hard-exits
with :data:`PEER_LOST_EXIT` (97).  :class:`DeadlineHeartbeat` covers a
peer that dies inside the solve.
"""

from __future__ import annotations

import datetime
import itertools
import os
import sys
import threading
import time

from acg_tpu_torch.errors import ExitCode as _ExitCode
from acg_tpu_torch.parallel import multihost

PEER_LOST_EXIT = int(_ExitCode.PEER_LOST)

# per-process sequence numbers making each agreement's keys unique; they
# stay in lockstep across processes because every call site is a
# symmetric stage boundary
_seq = itertools.count()
# blob gathers and heartbeats count apart, so optional gathers never
# perturb the agreement keys
_blob_seq = itertools.count()


def _store():
    w = multihost.world()
    return None if w is None else w.store


def _gather_keys(base: str, value: str, timeout: float,
                 prev: str | None) -> list[str]:
    """Set ``base/<me>`` and read ``base/<q>`` for every process, then
    drop generation ``prev`` (finished on every process)."""
    store = _store()
    me, n = multihost.process_index(), multihost.process_count()
    store.set(f"{base}/{me}", value)
    keys = [f"{base}/{q}" for q in range(n)]
    store.wait(keys, datetime.timedelta(seconds=max(float(timeout), 0.001)))
    vals = [store.get(k).decode() for k in keys]
    if prev is not None:
        for q in range(n):
            try:
                store.delete_key(f"{prev}/{q}")
            except Exception:  # noqa: BLE001 -- cleanup, never fatal
                pass
    return vals


def _die(msg: str) -> None:
    sys.stderr.write(msg)
    sys.stderr.flush()
    os._exit(PEER_LOST_EXIT)


def agree_status(code: int, what: str = "", timeout: float = 120.0) -> int:
    """Collective max of per-process status codes (0 = OK).

    Every process must call this at the same stage boundary; it returns
    the agreed (worst) code so callers exit in unison.  ``timeout``
    bounds the arrival skew between processes: the watchdog starts when
    THIS process reaches the boundary, and past it the process exits
    with :data:`PEER_LOST_EXIT`.  Single-process: returns ``code``."""
    if multihost.process_count() == 1:
        return int(code)
    # the fault injector's peer:dead / peer:stall: the targeted process
    # dies or stalls HERE, before the collective -- the failure the
    # watchdog exists for (acg_tpu/parallel/erragree.py:320-325)
    from acg_tpu_torch.faults import maybe_fail_peer
    maybe_fail_peer(what)
    seq = next(_seq)
    tag = f" ({what})" if what else ""
    done = threading.Event()

    def _abort():
        if not done.is_set():
            _die(f"acg-tpu-torch: error agreement{tag} timed out after "
                 f"{timeout:.0f}s -- a peer controller died before its "
                 f"checkpoint; aborting this process\n")

    watchdog = threading.Timer(timeout, _abort)
    watchdog.daemon = True
    watchdog.start()
    try:
        codes = _gather_keys(f"acg_tpu/erragree/{seq}", str(int(code)),
                             timeout + 5.0,
                             f"acg_tpu/erragree/{seq - 1}" if seq else None)
        done.set()
    except Exception as e:  # noqa: BLE001 -- a peer died mid-connection
        done.set()
        _die(f"acg-tpu-torch: error agreement{tag} failed "
             f"({type(e).__name__}) -- a peer controller died; aborting "
             f"this process\n")
    finally:
        watchdog.cancel()
    return max(int(c) for c in codes)


def allgather_blobs(blob: str, tag: str = "blob",
                    timeout: float = 120.0) -> list[str]:
    """One small string from every process, in rank order (the K6 peer
    form's IPC handles ride this).  Every process calls it at the same
    point; payloads are kilobytes, they transit process 0's store."""
    if multihost.process_count() == 1:
        return [blob]
    seq = next(_blob_seq)
    return _gather_keys(f"acg_tpu/{tag}/{seq}", blob, timeout,
                        f"acg_tpu/{tag}/{seq - 1}" if seq else None)


def barrier(tag: str = "barrier", timeout: float = 120.0) -> float:
    """Rendezvous every process; returns ``time.time()`` taken right
    after every process arrived."""
    allgather_blobs("1", tag=tag, timeout=timeout)
    return time.time()


class DeadlineHeartbeat:
    """Dead-peer detection during the solve (``--heartbeat``).

    :func:`agree_status`'s watchdog guards only the boundaries between
    stages; a process that dies inside the solve leaves its peers
    blocked in a collective.  Here every process bumps its beat key
    (``acg_tpu/heartbeat/<gen>/<rank>``) every ``period`` seconds from a
    daemon thread and watches its peers' keys; a peer whose beat has not
    advanced for ``deadline`` seconds is declared dead and this process
    exits with :data:`PEER_LOST_EXIT`.  Single-process, :meth:`start` is
    a no-op.  ``on_lost`` overrides the hard exit (tests)."""

    def __init__(self, period: float = 5.0, deadline: float = 30.0,
                 what: str = "solve", on_lost=None):
        if period <= 0 or deadline <= period:
            raise ValueError("heartbeat needs 0 < period < deadline "
                             f"(got period={period}, deadline={deadline})")
        self.period = float(period)
        self.deadline = float(deadline)
        self.what = str(what)
        self.on_lost = on_lost
        self._stop = threading.Event()
        self._thread = None
        self._gen = next(_blob_seq)
        self._seen: dict = {}

    def _lost(self, peer: int, age: float) -> None:
        if self.on_lost is not None:
            self.on_lost(peer, age)
            return
        _die(f"acg-tpu-torch: heartbeat ({self.what}): controller {peer} "
             f"silent for {age:.0f}s (deadline {self.deadline:.0f}s) -- "
             f"peer died mid-solve; aborting this process\n")

    def _run(self, store, n: int, me: int) -> None:
        base = f"acg_tpu/heartbeat/{self._gen}"
        beat = 0
        while not self._stop.wait(self.period):
            beat += 1
            try:
                store.set(f"{base}/{me}", str(beat))
            except Exception:  # noqa: BLE001 -- store gone: the agreement
                return         # watchdogs own that teardown
            now = time.monotonic()
            for q in range(n):
                if q == me:
                    continue
                try:
                    key = f"{base}/{q}"
                    val = store.get(key).decode() if store.check([key]) \
                        else ""
                except Exception:  # noqa: BLE001 -- store gone
                    val = ""
                prev = self._seen.get(q)
                if prev is None or prev[0] != val:
                    self._seen[q] = (val, now)
                    continue
                if now - prev[1] > self.deadline:
                    self._lost(q, now - prev[1])
                    return

    def peer_ages(self) -> dict:
        """Seconds since each watched peer's beat last advanced."""
        now = time.monotonic()
        return {int(q): max(0.0, now - t)
                for q, (_v, t) in list(self._seen.items())}

    def start(self) -> "DeadlineHeartbeat":
        store = _store()
        n = multihost.process_count()
        if n == 1 or store is None:
            return self
        self._thread = threading.Thread(
            target=self._run, args=(store, n, multihost.process_index()),
            name="acg-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
