"""Run one cell once and build its result line.

Set-up (import, the kernel library, the mix's pool of right-hand sides,
the solver built on the device, one warm-up solve of the cell's own
kind) is timed from process start to the first timed solve, phase by
phase.  The window is a closed loop of solves for ``--seconds``: one
caller, the next solve starting when the last has synchronised; it ends
at the end of the first solve that finishes after ``--seconds``.  With
``--trace 1`` a slice of whole solves is profiled after the window.
Then, with the program's state freed, a sample of the window's answers
drawn from the seed is compared with the plain reference
(:mod:`cgbench.checks`).

On several cards (one process a card, started by
:mod:`cgbench.launch`) rank 0 decides when the window closes, and alone
builds the result.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from cgbench import checks, counts, program, reference, spec, trace

# top-level module names that must not be loaded in the printing process
FORBIDDEN = ("jax", "jaxlib", "flax", "acg_tpu")

WARMUP_SOLVES = 1   # solves of the cell's own kind before the window


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float
    build_s: float
    window_s: float
    solves: list              # (wall_s, iterations, converged) a solve
    cards: list | None = None  # trace.summarize of each card's slice
    slice_solves: int = 0
    slice_iterations: int = 0

    @property
    def spmv_bytes_card(self) -> float:
        c = self.cell.config
        return counts.spmv_bytes(c["n"], c["dim"]) / self.cell.chips

    @property
    def iteration_bytes_card(self) -> float:
        c = self.cell.config
        return counts.iteration_bytes(c["n"], c["dim"]) / self.cell.chips


def forbidden_modules() -> list[str]:
    """The forbidden top-level names loaded in this process, compared
    whole (``acg_tpu_torch`` is not ``acg_tpu``)."""
    top = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _keep(kept: list, cap: int, i: int, item, rng) -> None:
    """Reservoir sampling: each of the window's answers stays with the
    same chance, drawn from the seed (alike on every rank)."""
    if len(kept) < cap:
        kept.append(item)
        return
    j = int(rng.integers(0, i + 1))
    if j < cap:
        kept[j] = item


def _gather_rows(x: torch.Tensor, nrows: list[int]) -> torch.Tensor:
    import torch.distributed as dist
    m = max(nrows)
    pad = torch.zeros(m, dtype=x.dtype, device=x.device)
    pad[:x.numel()] = x
    parts = [torch.empty_like(pad) for _ in nrows]
    dist.all_gather(parts, pad)
    return torch.cat([p[:k] for p, k in zip(parts, nrows)])


def _all(obj, ranks: int) -> list:
    if ranks == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * ranks
    dist.all_gather_object(out, obj)
    return out


def _barrier(ranks: int) -> None:
    if ranks > 1:
        import torch.distributed as dist
        dist.barrier()


def _agree(go: bool, dev, ranks: int) -> bool:
    """Rank 0's decision, on every rank."""
    if ranks == 1:
        return go
    import torch.distributed as dist
    flag = torch.tensor([int(go)], dtype=torch.int32, device=dev)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _traced_slice(solver, bs, first: int, nsolves: int, maxits: int,
                  rtol: float, dev, ranks: int):
    """``(card summary, iterations)`` of ``nsolves`` whole solves under
    ``torch.profiler`` (CPU and CUDA activity), bracketed by barriers."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    _barrier(ranks)
    _sync(dev)
    iters = 0
    with profile(activities=acts) as prof:
        with record_function(trace.SLICE):
            for s in range(nsolves):
                _, k, _ = program.solve(solver, bs[(first + s) % len(bs)],
                                        maxits, rtol)
                iters += k
            _sync(dev)
    _barrier(ranks)
    device, host, marks = trace.events_of(prof)
    lo, hi = trace.slice_bounds(marks)
    return trace.summarize(device, host, lo, hi), iters


@dataclasses.dataclass
class Outcome:
    run: Run
    correct: bool
    attempted: int
    failed: int
    shown: dict
    kind: str
    memory_peak: int
    phases: list    # each rank's set-up seconds by phase
    cpus: list      # each rank's CPUs


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        rank: int = 0, port: int = 0, device: str = "cuda",
        t0: float | None = None) -> Outcome | None:
    """One run of ``cell``; the outcome on rank 0, None on the others.
    On several ranks each rank's process calls this with the same
    ``port``."""
    t0 = time.perf_counter() if t0 is None else t0
    cfg, tr = cell.config, cell.traffic
    ranks = int(tr["ranks"])
    n, dim = int(cfg["n"]), int(cfg["dim"])
    pool = int(tr["rhs_pool"])
    maxits, rtol = int(tr["iterations"]), float(tr["rtol"])
    phases = {"import": time.perf_counter() - t0}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        _sync(dev)
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    if ranks > 1:
        dev = program.join(port, ranks, rank, device)
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    phase("join")
    rhs_seed = int(tr.get("rhs_seed", seed))
    rhs = reference.manufactured_rhs(rhs_seed, pool, n, dim, dev)
    phase("rhs")
    solver = program.build(cfg, ranks, dev)
    phase("build")
    build_s = phases["build"]
    if ranks > 1:
        r0, nloc = program.rows(solver)
        bs = [rhs[j, r0:r0 + nloc].clone() for j in range(pool)]
        del rhs
    else:
        nloc = n ** dim
        bs = list(rhs)
    # the pool in an order drawn from the seed: a mix with a fixed pool
    # (``rhs_seed``) gives every seed the same work in another order
    perm = np.random.default_rng([seed, 1]).permutation(pool)
    order = [int(j) for j in perm]
    bs = [bs[j] for j in order]
    for _ in range(WARMUP_SOLVES):
        program.solve(solver, bs[0], maxits, rtol)
    phase("warm-up")
    _barrier(ranks)
    phase("barrier")
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    cap = checks.SAMPLES
    kept, solves = [], []
    start = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        x, k, conv = program.solve(solver, bs[i % pool], maxits, rtol)
        _sync(dev)
        te = time.perf_counter()
        solves.append((te - ts, k, conv))
        _keep(kept, cap, i, (x, order[i % pool], k), rng)
        i += 1
        if not _agree(te - start < seconds, dev, ranks):
            break
    window_s = te - start

    cards, slice_iters, nslice = None, 0, 0
    if traced:
        nslice = int(tr["slice_solves"])
        card, slice_iters = _traced_slice(solver, bs, i, nslice, maxits,
                                          rtol, dev, ranks)
        cards = _all(card, ranks)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    peak = max(_all(int(peak), ranks))
    phases = _all(phases, ranks)
    aff = sorted(os.sched_getaffinity(0))
    cpus = _all(f"{aff[0]}-{aff[-1]} ({len(aff)})", ranks)
    del solver, bs, x

    if ranks > 1:
        nrows = _all(nloc, ranks)
        whole = [_gather_rows(x, nrows) for x, _, _ in kept]
        kept = [(w, j, k) for w, (_, j, k) in zip(whole, kept)]
        del whole
        program.leave()
        if rank != 0:
            return None
        rhs = reference.manufactured_rhs(rhs_seed, pool, n, dim, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    answers = [checks.Answer(x=x, rhs=j, iterations=k) for x, j, k in kept]
    values = checks.numbers(answers, rhs, tr, n, dim)
    correct, shown = checks.judge(values, cell.checks)
    # a solve fails that did not converge, or that ran another number of
    # iterations than a fixed-iteration mix asks for
    failed = sum(1 for _, k, c in solves
                 if not c or (rtol == 0 and k != maxits))
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return Outcome(run=Run(cell=cell, setup_s=setup_s, build_s=build_s,
                           window_s=window_s, solves=solves, cards=cards,
                           slice_solves=nslice, slice_iterations=slice_iters),
                   correct=correct and failed == 0, attempted=len(solves),
                   failed=failed, shown=shown, kind=kind, memory_peak=peak,
                   phases=phases, cpus=cpus)


def result_line(out: Outcome, traced: bool) -> dict:
    """The contract's last line; raises ValueError on a traced run whose
    busy time is not above 0 and at most its window."""
    r = out.run
    metrics = {}
    for m in (r.cell.per_layer if traced else r.cell.end_to_end):
        v = m.read(r)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    device = {"platform": "gpu" if out.kind != "cpu" else "cpu",
              "kind": out.kind, "count": r.cell.chips,
              "memory_peak_bytes": int(out.memory_peak)}
    line = {"correct": bool(out.correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if traced:
        busy, window = trace.combine(r.cards)
        if not 0 < busy <= window:
            per = "; ".join(f"rank {q}: busy {c['busy_s']!r} s of "
                            f"{c['window_s']!r} s"
                            for q, c in enumerate(r.cards))
            raise ValueError(f"device busy {busy!r} s is not in (0, window "
                             f"{window!r} s]: {per}")
        device["busy_s"] = busy
        device["window_s"] = window
        line["breakdown"] = trace.breakdown(r.cards)
    line["checks"] = out.shown
    return line
