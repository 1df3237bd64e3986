"""The command line: parse it, start the other ranks, pin this process
to its share of the CPUs, then import torch and run the cell
(:func:`cgbench.harness.run`).

Nothing here imports torch at module level: on several cards the first
process starts the other ranks (``--rank``/``--port``, one process a
card) before it pays for its own import, so the ranks' start-ups run
side by side.  Each rank is pinned to a slice of its own of the usable
CPUs, so no two ranks' host threads contend for a core.  (The machines
the benchmark runs on expose no NUMA topology under ``/sys``, so the
slices cannot follow the cards' nodes.)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

from cgbench import spec


def cpu_plan(ranks: int, usable: set[int]) -> list[set[int]]:
    """The CPUs of each rank: the usable CPUs shared out in contiguous
    slices, the last rank taking what is left over; each rank at least
    one CPU."""
    cpus = sorted(usable)
    k = max(len(cpus) // ranks, 1)
    return [set(cpus[r * k:(r + 1) * k] if r < ranks - 1 else cpus[r * k:])
            or {cpus[-1]} for r in range(ranks)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """The other ranks' processes, watched: one that exits with an error
    ends this process too, after the others are stopped."""

    def __init__(self, argv: list[str], ranks: int):
        self.procs = [subprocess.Popen(argv + ["--rank", str(r)],
                                       stdout=subprocess.DEVNULL)
                      for r in range(1, ranks)]
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._done.wait(0.5):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code not in (None, 0):
                    print(f"cgbench: rank {r} exited with code {code}",
                          file=sys.stderr, flush=True)
                    self.stop()
                    os._exit(1)

    def join(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        for r, p in enumerate(self.procs, 1):
            code = p.wait(max(deadline - time.monotonic(), 0.1))
            if code != 0:
                raise RuntimeError(f"rank {r} exited with code {code}")
        self._done.set()

    def stop(self) -> None:
        self._done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def main(t0: float) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cgbench",
                                description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args()
    cell = spec.load_cell(a.workload)
    ranks = int(cell.traffic["ranks"])
    plan = cpu_plan(ranks, os.sched_getaffinity(0))
    port, others = a.port, None
    if ranks > 1 and a.rank == 0:
        port = _free_port()
        others = _Ranks([sys.executable, "-m", "cgbench", "--workload",
                         cell.name, "--seed", str(a.seed), "--seconds",
                         repr(a.seconds), "--trace", str(a.trace),
                         "--port", str(port)], ranks)
    os.sched_setaffinity(0, plan[a.rank])
    try:
        return _main(cell, a, port, t0, others)
    finally:
        if others is not None:
            others.stop()


def _main(cell, a, port, t0, others) -> int:
    import torch

    from cgbench import harness
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"cgbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    out = harness.run(cell, a.seed, a.seconds, bool(a.trace), rank=a.rank,
                      port=port, device="cuda", t0=t0)
    if others is not None:
        others.join()
    if out is None:
        return 0
    bad = harness.forbidden_modules()
    if bad:
        print(f"cgbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    try:
        line = harness.result_line(out, bool(a.trace))
    except ValueError as e:
        print(f"cgbench: {e}", file=sys.stderr)
        return 4
    print("cgbench: set-up seconds by phase: " + "; ".join(
        f"rank {q} " + ", ".join(f"{k} {v:.3f}" for k, v in ph.items())
        for q, ph in enumerate(out.phases)), file=sys.stderr)
    print("cgbench: CPUs " + "; ".join(
        f"rank {q} {c}" for q, c in enumerate(out.cpus)), file=sys.stderr)
    for name, c in out.shown.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
