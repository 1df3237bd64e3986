#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (acg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and the
checkout it sits in.  Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi), and the kernel build
   from the sources in acg_tpu_torch/csrc/ (ptxas registers, shared
   memory and spills of K1, K3/K4, K4 alone, K6 and K7 printed; every
   kernel's in the log);
2. every kernel of the paths against its plain PyTorch version on the
   card, at the paths' shapes: vectors bitwise-equal (the kernels are
   built with --fmad=false), dots within the stated relative error;
   K1 batched over the flagship's 4 band parts in every dtype, K5 on
   their flat stack (with and without the live flag) and its flagged
   form of a detecting loop (the breakdown flag clear, and set with a
   finite and a NaN alpha: x, r and w kept) in f64, f32 and bf16, and
   K6 gated and
   dense on that 4-part halo plan, on the irregular matrix's 4-part
   graph plan and on an 8-part all-pairs plane; K7 (the matrix-free
   Poisson stencil) in f64 and f32 on 2D n = 2048, 3D n = 512 and its
   edge shapes (ragged 3D n = 37, 1D, odd n = 2047, n = 2046, 3D 131
   and 130, n = 2 and 3 below the rows a thread, and 1D n = 2^31 + 5 in
   f32 on 64-bit indices), bitwise against its plain version and
   against K1 on the same operator's assembled planes, and K7 stacked
   over the flagship's 4 band parts and over 8 ragged parts of 2D 2047
   against the generated planes through dia_mv; K3 on its edge shapes
   in f32, mixed and bf16 (odd n, one-sided offsets, the 3D 7-point
   planes, each on the first iteration and frozen); K4 on its edge
   shapes in f32, mixed and bf16 (odd n, n = 1, 3, 7, 9, 2048^2 + 5,
   every pointer off 16 bytes; the live flag absent, true and false; the
   same bits twice);
   K1 on its edge shapes in every dtype, single and over 3 parts: odd
   n, offsets all >= 0 or all <= 0, a 64-diagonal band, the 512^3
   device-built planes and a band of 2.1e9 plane values (64-bit
   indices); K6 on a 16-part plane of gated and ungated
   pairs, windows of a byte length off 16 and a 5-part plane of 7-value
   windows, into receive planes of random values; the per-part dot
   (part_dot) on the flagship's 4-part stack in f64, f32 and bf16,
   within the dot tolerance of its plain version and a part's bits the
   same in stacks of 4, 2 and 1, from a row off 16 bytes and twice;
3. the paths through acg_tpu_torch.cli.main, with the kernels' launch
   counters reset before and read after each run: on gen:poisson2d:2048
   (a) classic f64 --kernels auto, (b) pipelined f64, (c) --kernels
   fused f32 against --kernels xla, (d) --dtype mixed against f32 at a
   fixed 500 iterations (bitwise-equal iterates), then the multi-part
   tier, all parts stacked on the card: (e) --nparts 4 --comm dma
   classic f64, (f) the same with --comm xla (bitwise-equal x), (g)
   pipelined f64 --nparts 4 --comm dma, and (h) gen:irregular:262144
   --nparts 4 --partition-method graph (binned-ELL local blocks), run
   twice for bitwise-equal x; then the matrix-free tier: (i) (a) with
   --operator stencil (the same iterations, x bitwise-equal to (a), K7
   and no K1), (j) (b) with --operator stencil (bitwise-equal to (b), K7
   and K5), (k) (e) with --operator stencil (bitwise-equal to (e),
   stacked K7 and K6, no batched K1), (l) the gen-direct tier on
   gen:poisson3d:512 (134M rows, no host matrix), 300 iterations
   assembled on the device (K1) and with --operator stencil (K7), x
   bitwise-equal, and (m) the single-device gather formats, binned ELL
   with hub rows on gen:irregular:262144 and --spmv-format coo on
   gen:irregular:65536, each solved twice to the same bits; then the
   preconditioned and precision tiers: (n) --precond jacobi classic f64
   (K1 once per SpMV), (o) (n) with --operator stencil (K7, no K1, x
   bitwise-equal to (n)), (p) --aniso 0.01 with --precond cheby:4
   against plain CG (fewer iterations; K1 counted exactly: 5 per step
   and setup plus the power iteration's 25), (q) --nparts 4 --precond
   bjacobi:32 classic and --precond jacobi pipelined on --comm dma (K6
   and batched K1 once per SpMV), each again on --comm xla to the same
   bits, (r) --dtype f32 --precise-dots at 1e-9 beside the same run
   without the flag, and pipelined with the flag for 500 iterations
   (K5), (s) --dtype bf16 --replace-every 50 for 2000 iterations (the
   reported residual is the true f32 one; bf16 and mixed K1 counted)
   and (t) --dtype f32 --refine to a true f64 residual of 1e-12; then
   the host layer and the batched tier: (u) the offline tools at full
   width (genmatrix -n 2048 binary and text, mtxpartition --parts 4,
   mtx2bin --expand --partition with its .perm.mtx sidecar) and a
   classic f64 solve of the permuted binary matrix with (a)'s
   right-hand side in the original order: x in the original order
   within 1e-8 of (a)'s, iterations within 1, the format auto picked
   printed; (v) --solver host, host-native and petsc beside the device
   solve on gen:poisson2d:512 (iterations within 1, x within 1e-10;
   the native core built; --buildinfo logged); (w) --nrhs 8 batched
   classic f64 (manufactured columns) to rtol 1e-8, each column stopped
   by its own live flag, against the single-RHS solver on each column
   (iterations within 1, x within 1e-9, every column's true residual
   <= 1e-7), the library's batched solve of the same block the same
   bits, no K1 or K5 launch; (x) --nrhs 8 a fixed BATCH_ITS iterations
   with --solver acg-pipelined (each column within 1e-7 of its
   single-RHS pipelined solve of the same count), --operator stencil (x
   within 1e-12 of the library's classic block at that count),
   --precond jacobi (within 1e-9 of it), and --block-cg against the batched mode on gen:poisson2d:512
   --aniso 0.01 (fewer column iterations, every column's true
   residual <= 1e-7); (y) --nrhs 1, bitwise-equal to (a) with K1
   counted as in (a); then the communication-avoiding recurrences and
   the batched multi-part tier: (z) --algorithm sstep:4 (twice, the
   same bits) and sstep:8 (iterations within S of (a)'s, K1 counted
   exactly: 2S-1 per block run, 1 setup, 25 power iterations),
   sstep:4 with --operator stencil (the same iterations and bits, K7
   where K1 was) and pipelined:2 twice (converged to 1e-7 through its
   restarts, the same bits); (aa) --nparts 4 --algorithm sstep:4 under
   dma and xla (the same bits; K6 and batched K1 once per SpMV, counted
   exactly); (ab) --nparts 4 --nrhs 8 classic at BATCH_ITS (each column
   against the stacked single solve of the same count, the library's
   batched solve the same bits, no kernel) and pipelined (within 1e-7 of
   (x)'s pipelined block); then the overlapped and sharded tiers: (ac)
   --nparts 4 --kernels fused (the halo exchange on a side stream beside
   batched K1) classic f64 under dma through the CLI, and under dma
   again and xla through DistCGSolver on the same parts and right-hand
   side (path (e)'s iterations and bits each, batched K1 and K6 once per
   SpMV), pipelined under dma against (g) (K5), --operator stencil
   against (k) (stacked K7), ELL local blocks on gen:poisson2d:512
   --partition-method graph against the unsplit tier, and path (h)'s
   binned ELL refused by name; (ad) gen:poisson3d:512 --nparts 4, 300
   iterations on the sharded tier (K1 on the whole planes, 301
   launches), x bitwise-equal to (l)'s; (ae) the north star,
   gen:poisson3d:512 --dtype f32 --manufactured-solution --refine
   --residual-rtol 1e-9 (the analytic spot check under 1e-5, converged,
   K1 alone at least once per inner iteration and pass, the df64 error
   norm under 1e-9, passes and inner iterations; beside it the same
   refine of an f32-rounded b, whose error the 1e-9 limit rejects);
   then the multi-process tier, two child processes of
   ``python -m acg_tpu_torch`` (--coordinator 127.0.0.1:PORT
   --num-processes 2 --process-id I) sharing the one card, gloo for the
   host-side collectives and CUDA IPC for K6's peer puts, each child
   timed out and failing the smoke if it fails: (af) --nparts 4
   classic f64 under dma (path (e)'s iterations and bits,
   halo_put_peer and batched K1 once per SpMV on each rank, rank 0
   alone printing stats), and under xla and pipelined under dma a fixed
   AF_ITS iterations (the bits of a one-process stacked solve of the
   same count); (ag) --distributed-read of the flagship expanded
   by mtx2bin's reader with (e)'s band bounds and b, AF_ITS iterations,
   --output written rootless (af-xla)'s x, byte for byte; (af) under dma also writes
   --stats-json/--timeline/--progress 500 (the ranks block holds both
   processes, process 0 alone writes the aligned timeline, one heartbeat
   line a sample); (ah) gen:poisson3d:512 --nparts 2,
   300 iterations on the sharded tier (K1 on each rank's halo'd window,
   301 launches a rank, each rank's device memory peak, x within 1e-12
   of (l)'s) and the manufactured draw timed, of all 134M normals and
   of one rank's window; and K6's
   peer form on two processes (a child mode of this script) on path
   (h)'s irregular plan and the flagship's band plan in f64, f32 and
   bf16: bitwise its plain version and the stacked halo_put, twice the
   same bits, ungated rows untouched, 50 lockstep exchanges timed with
   their acks, put and flag waits apart, 20 pre-signalled exchanges
   (the peer put first and went idle), the one-flag ping-pong floor
   between the two contexts, and a peer that stops after one exchange,
   whose flag rank 0 must give up on, raising, within its 2 s timeout;
   then the observability tier: (ai) path (a) with --warmup 1 and every
   flag (--convergence-log of 512, --progress 500, --stats-json,
   --metrics-file, --status-file, --history, --slo, --profile-ops 3,
   --trace, --timeline): (a)'s iterations and bits, K1 twice (a)'s plus
   the replay's chains, the log's 512 records ending at the last
   iteration with the stats block's residual, the heartbeat at 500,
   1000, ..., the capture's in-solve gemv (K1) seconds and the replay's
   gemv a call logged beside K1's time, the textfile and the timeline
   through the reference's checkers, the card in the manifest; the
   armed ring and heartbeat against off (rates in turns, device
   launches an iteration); (aj) path (e) under --trace/--timeline/
   --stats-json/--convergence-log: (e)'s bits and launches, in-solve
   seconds of K1 batched (gemv), K6 (halo, kind dma) and the per-part
   dot (dot), overlap efficiency, one timeline pid a part;
   then the robustness tier (see robustness_paths): (ak) spmv:nan@7
   --recover, (al) pipelined dot:neg@5 --recover on K5's flagged form,
   (am) --abft with sdc:flip@7 and a clean audited solve, (ao) 4
   stacked parts under dma with halo:nan@3 --recover and the transport
   rung (named by the policy: the one run in which a rung leaves a
   kernel; every CLI run fails the smoke if a fallback rung ran),
   (ap) --soak 8 --fail-on-drift 50 and its drift trip; and, as
   child-process jobs run JOB_WORKERS at a time beside (af)-(ah) (see
   elastic_paths), rank-mode recovery (aq), checkpoints (ar), precond
   and sstep:4 (as) on a pair, the sharded tier's checkpoint and audit
   (at), the supervisor's crash relaunch and shrink (au), a chaos
   campaign (av), the batched and s-step checkpoints (aw), and the
   supervisor's fault sites, a dead peer and a hung runtime (ax).
   (af)-(ah) run as those jobs too; the communication and decision
   layers (see decision_paths) are jobs of the same pool, started
   first with the service's, beside (a)-(ab): (ay) --commbench on the
   flagship's 4 parts under dma (the document valid, every kind
   fitted, K6's launches each phase's exchanges), (az) --explain
   --calibration (three tiers, verdicts and dispatch terms, one
   iteration's hand kernels counted) and (ba) --autotune twice at
   512^2 (a probed winner dispatched, the plans valid, the second
   self-corrected); after those jobs, (ay-twin) in this process: a
   4-part dma solve, the segment probes and the planner's comm-round
   count, the same solve again, its x bitwise and its launches equal;
   and the service layer (see service_paths), jobs in the same pool
   started first, beside (a)-(ab), with (ay)-(ba): (bb) the
   single-part --serve daemon on the flagship (caches: miss then hit
   with acg_compiles_total
   unmoved; the first answer bitwise the one-shot CLI solve of its b;
   three requests coalesced behind a slow lead, each bitwise its single
   answer; typed 504 and 500; /status, /metrics, /requests; the access
   log and timeline through the reference's checkers; SIGTERM exits 0),
   (bb-429) a daemon of queue depth 1 shedding a typed 429, (bc) the
   4-part daemon under dma (a classic and a pipelined request bitwise
   the one-shot CLI solves of their b on the same tier; batched K1, K6,
   the per-part dot and K5 counted: twice the CLI runs'), (bd) --serve
   --supervise at 512^2 (a crash request, the relaunch on 2 parts
   warm-restored, the regrow to 4 after 2 requests) and (be) the live
   chaos campaign --serve --chaos 5:4 at 512^2;
4. times: solve rates (1000 iterations after a 50-iteration warm-up;
   200 for --precise-dots),
   single-device (classic, --kernels fused in f32, mixed and bf16,
   pipelined; --precond jacobi and cheby:4 in f64, cheby also as
   SpMVs/s; f32 with and without --precise-dots) and 4-part with each
   transport, and per-kernel medians of 50 CUDA-event-timed launches
   (after 50 ms of warm-up launches, L2 flushed before each) beside
   each kernel's bound, its plain version and, where one PyTorch call
   computes the same function, that call (cuSPARSE through torch.mv on
   a CSR tensor for the SpMVs, a transposing copy for K6, also timed on
   the irregular graph plan; the port never calls them); nvidia-smi's
   SM clock and power draw beside them; torch.profiler breakdowns by
   op, with the device's busy share, of the 4-part --comm dma solve,
   the --precond jacobi f64 solve, the single-part --operator stencil
   solves (f64 and f32 at 2048^2, f64 at 512^3: K7 in the loop) and the
   --kernels fused solves in f32, mixed and bf16 (K3 and K4 in the
   loop); path (h)'s SpMV split into local block, halo exchange and
   ghost block; K7 at 2048^2 and 512^3 in f64 and f32 beside K1 on the
   assembled planes, stacked K7 on the 4-part plan, and K1 on the 512^3
   planes in mixed and bf16; first of all, classic f64 with --recover
   armed and no fault against off (in turns, and one solve to 1e-8 of
   each) and the device launches an iteration of each (the disarmed
   loop's must stay 13.3);
   classic f64 rates with --operator stencil against assembled at
   2048^2 and 512^3; --nrhs 8 rates (batched classic and pipelined,
   block CG) as loop and column-iterations/s, and a profile of the
   batched classic solve; sstep:4, sstep:8 and pipelined:2 beside
   classic f64 (iters/s, p(l) with its restarts; the SpMV launches of
   the timed solves against their iterations), a profile of sstep:4,
   sstep:4 on the 4 parts (--comm dma) beside the 4-part classic with a
   profile, and --nparts 4 --nrhs 8 classic and pipelined as
   column-iterations/s; the 4-part classic f64 rates with --kernels
   fused beside the unsplit ones on each transport, in turns, and a
   trace of the fused dma solve by stream (the streams of K1 and K6, the
   halo chain's device time and the share of it under K1); the sharded
   512^3 rate on 4 parts beside the single part's.  The
   --nrhs 8 rates take one timed solve each.  K1, K3, K4, K6 and K7 are
   also timed with L2
   flushed by reading (clean_l2_ms), K4 and K7 beside a copy of their
   bytes (copy_ms).

The children print their launch counts (``-vv``), which the
``kernels`` line adds to the paths' counts; ``halo_put_peer`` appears
there with its lockstep median, bound, plain and library times.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device,
and outside a checkout of the repository.  A log of every phase, with
the CLI runs' stats blocks, goes to acg_tpu_torch/_build/chip_smoke.log.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# the card's published rates (H100 SXM data sheet): HBM bytes/s, and
# operations/s per type outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f64": 34e12, "f32": 67e12, "bf16": 67e12, "mixed": 67e12}
FLAGSHIP = 2048
MAIN_SPEC = f"gen:poisson2d:{FLAGSHIP}"
NPARTS = 4
IRREGULAR_SPEC = "gen:irregular:262144"
COO_SPEC = "gen:irregular:65536"
DIRECT_N = 512   # gen:poisson3d:512, the gen-direct tier's size
LOG = []
ITS = {}   # iterations of each phase-3 path, by path letter
MP_TIMEOUT = 420   # seconds a child process (or a pair of them) may take
XS = {}    # solutions later paths are held against, by path tag


def say(msg: str) -> None:
    print(msg, flush=True)
    LOG.append(msg)


def clocks_line() -> str:
    """SM clock, power draw and limit as nvidia-smi reads them now."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                              "clocks.max.sm,power.draw,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "not read"


def device_line(torch) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def bound_ms(nbytes: float, nops: float, kind: str):
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate of their type, whichever is larger."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = nops / PEAK_OPS_S[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


_FLUSH = {}


def median_ms(torch, fn, reps: int = 50, warm_s: float = 0.05,
              clean: bool = False) -> float:
    """Median time of one call of ``fn`` over ``reps`` launches, each
    bracketed by CUDA events, after at least ``warm_s`` seconds of
    back-to-back calls (short kernels otherwise time the card's clock
    ramp, not the kernel).  The 50 MB L2 is flushed before each timed
    launch, as a CG iteration's other vector passes evict it: the bf16
    flagship planes (42 MB) would otherwise be timed from cache.  The
    flush writes 256 MB, so the launch also pays for writing back the
    dirty lines it finds; ``clean`` flushes by reading instead."""
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                    device="cuda")   # 256 MB
    t0 = time.perf_counter()
    while True:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= warm_s:
            break
    evs = []
    for _ in range(reps):
        if clean:
            _FLUSH["buf"].sum()
        else:
            _FLUSH["buf"].zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: check failed: {what}")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# -- phase 2: kernels against their plain versions -----------------------

DOT_REL = {"f64": 1e-12, "f32": 1e-5, "mixed": 1e-5, "bf16": 1e-5}


def kinds(torch):
    """K1's dtype labels: (plane dtype, vector dtype)."""
    return {"f64": (torch.float64, torch.float64),
            "f32": (torch.float32, torch.float32),
            "mixed": (torch.bfloat16, torch.float32),
            "bf16": (torch.bfloat16, torch.bfloat16)}


def ptxas_lines(build_log: str) -> dict:
    """The ptxas lines (entries, registers, shared memory, and the stack
    frame and spill line under each entry) of the build log, by source
    file."""
    out, cur = {}, None
    for ln in build_log.splitlines():
        if " -c " in ln:   # the nvcc command of one source
            cur = os.path.basename(ln.split(" -c ", 1)[1].split()[0])
        elif cur and ("ptxas" in ln or "bytes spill" in ln):
            out.setdefault(cur, []).append(ln.strip())
    return out


def ptxas_entries(lines: list) -> list:
    """One source's ptxas lines cut into kernels: each list starts at its
    "Compiling entry function" line."""
    out = []
    for ln in lines:
        if "Compiling entry function" in ln or not out:
            out.append([])
        out[-1].append(ln)
    return out


def kernel_checks(torch, K, dev):
    from acg_tpu_torch.io.generators import poisson_dia

    dt = kinds(torch)
    g = torch.Generator(device=dev).manual_seed(1234)
    inputs = {}
    errs = {}
    for label, n, dim in (("2d-2048", FLAGSHIP, 2), ("3d-128", 128, 3),
                          ("2d-1000", 1000, 2)):
        planes, offsets, N = poisson_dia(n, dim)
        P64 = torch.from_numpy(np.stack(planes)).to(dev)
        ot = torch.tensor(offsets, dtype=torch.int64, device=dev)
        x64 = torch.randn(N, generator=g, dtype=torch.float64, device=dev)
        for kind in dt:
            pdt, xdt = dt[kind]
            P, x = P64.to(pdt).contiguous(), x64.to(xdt)
            k1_check(torch, K, label, kind, P, offsets, x, errs)
            if label == "2d-2048":
                inputs[("dia", kind)] = (P, offsets, x)
        if label != "2d-2048":
            continue
        N2 = N
        for kind in ("f32", "mixed", "bf16"):
            pdt, vdt = dt[kind]
            P = P64.to(pdt).contiguous()
            r, po, xx = (torch.randn(N2, generator=g, dtype=torch.float64,
                                     device=dev).to(vdt) for _ in range(3))
            gm = torch.tensor(2.0, device=dev)
            gp = torch.tensor(4.0, device=dev)
            pdt_ = torch.tensor(1.5e4, device=dev)
            pa, ta, da = K.cg_phase_a(P, offsets, r, po, gm, gp,
                                      offsets_t=ot)
            pr, tr, drr = K.cg_phase_a_plain(P, offsets, r, po, gm, gp)
            xb, rb = xx.clone(), r.clone()
            _, _, gb = K.cg_phase_b(xb, pa, rb, ta, gm, pdt_)
            xw, rw, gw = K.cg_phase_b_plain(xx, pa, r, ta, gm, pdt_)
            torch.cuda.synchronize()
            rel_a = abs(float(da) - float(drr)) / abs(float(drr))
            rel_b = abs(float(gb) - float(gw)) / abs(float(gw))
            say(f"K3 cg_phase_a 2d-2048 {kind}: p bitwise="
                f"{torch.equal(pa, pr)} t bitwise={torch.equal(ta, tr)}, "
                f"(p,t) rel err {rel_a:.3e}")
            say(f"K4 cg_phase_b 2d-2048 {kind}: x bitwise="
                f"{torch.equal(xb, xw)} r bitwise={torch.equal(rb, rw)}, "
                f"(r,r) rel err {rel_b:.3e}")
            check(torch.equal(pa, pr) and torch.equal(ta, tr),
                  f"K3 {kind} vectors")
            check(torch.equal(xb, xw) and torch.equal(rb, rw),
                  f"K4 {kind} vectors")
            check(rel_a <= 1e-5 and rel_b <= 1e-5, f"K3/K4 {kind} dots")
            errs[("cg_phase_a", kind)] = max(max_abs(pa, pr),
                                             max_abs(ta, tr))
            errs[("cg_phase_b", kind)] = max(max_abs(xb, xw),
                                             max_abs(rb, rw))
            inputs[("fused", kind)] = (P, offsets, ot, r, po, xx, gm, gp,
                                       pdt_)
        for kind in ("f64", "f32", "bf16"):
            vdt = dt[kind][1]
            vs = [torch.randn(N2, generator=g, dtype=torch.float64,
                              device=dev).to(vdt) for _ in range(7)]
            sdt = K.acc_dtype(vdt)
            al = torch.tensor(0.37, dtype=sdt, device=dev)
            be = torch.tensor(0.81, dtype=sdt, device=dev)
            want = K.pipelined_update_plain(*vs, al, be)
            got = K.pipelined_update(*[v.clone() for v in vs[:6]], vs[6],
                                     al, be)
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            say(f"K5 pipelined_update 2d-2048 {kind}: 6 outputs bitwise={ok}")
            check(ok, f"K5 {kind}")
            errs[("pipelined_update", kind)] = max(
                max_abs(a, b) for a, b in zip(got, want))
            inputs[("pipe", kind)] = (vs, al, be)
            # the flagged form of a detecting loop: the breakdown flag
            # set keeps x/r/w (p/t/z still update), clear is the plain
            # update; alpha NaN with the flag set must not reach x/r/w
            for bad in (False, True):
                flag = torch.tensor(bad, device=dev)
                for a_ in (al, torch.full_like(al, float("nan"))):
                    if not bad and a_ is not al:
                        continue
                    want_f = K.pipelined_update_plain(*vs, a_, be, flag)
                    got_f = K.pipelined_update(
                        *[v.clone() for v in vs[:6]], vs[6], a_, be,
                        bad=flag)
                    torch.cuda.synchronize()
                    ok = all(torch.equal(a, b) or (
                        torch.isnan(a).equal(torch.isnan(b))
                        and torch.equal(torch.nan_to_num(a),
                                        torch.nan_to_num(b)))
                        for a, b in zip(got_f, want_f))
                    kept = (not bad or all(torch.equal(got_f[i], vs[i])
                                           for i in range(3)))
                    nan = "NaN alpha" if a_ is not al else "alpha 0.37"
                    say(f"K5 pipelined_update flagged 2d-2048 {kind} "
                        f"bad={bad} {nan}: 6 outputs bitwise={ok}, x/r/w "
                        f"kept={kept}")
                    check(ok and kept, f"K5 flagged {kind} bad={bad} {nan}")
                    errs[("pipelined_update", kind)] = max(
                        errs[("pipelined_update", kind)],
                        max(max_abs(torch.nan_to_num(a),
                                    torch.nan_to_num(b))
                            for a, b in zip(got_f, want_f)))
    return inputs, errs


def k1_check(torch, K, label, kind, P, offsets, x, errs, abs_scale=False):
    """K1 bitwise against its plain version (single-part x also with the
    dot, within DOT_REL of the plain dot, or with ``abs_scale`` of sum
    |x_i y_i|: random planes give terms of both signs, whose sum may lie
    far below its terms)."""
    single = x.dim() == 1
    y = K.dia_spmv(P, offsets, x)
    if single:
        yr, dr = K.dia_spmv_plain(P, offsets, x, with_dot=True)
        yd, d = K.dia_spmv(P, offsets, x, with_dot=True)
        scale = float((yr.double() * x.double()).abs().sum()) if abs_scale \
            else abs(float(dr))
        rel = abs(float(d) - float(dr)) / scale
        ok = torch.equal(y, yr) and torch.equal(yd, yr)
    else:
        yr = K.dia_spmv_plain(P, offsets, x)
        ok = torch.equal(y, yr)
    torch.cuda.synchronize()
    name = "dia_spmv" if single else "dia_spmv_batched"
    errs[(name, kind)] = max(errs.get((name, kind), 0.0), max_abs(y, yr))
    plan = K.dia_tile_plan(tuple(offsets), x.shape[-1], P.dtype,
                           1 if single else x.shape[0])
    say(f"K1 dia_spmv {label} {kind} {tuple(x.shape)}, {len(offsets)} "
        f"diagonals, {plan.index_bits}-bit index: y bitwise={ok}"
        + (f", dot err {rel:.3e} of "
           f"{'sum |x y|' if abs_scale else '|x . y|'} (limit "
           f"{DOT_REL[kind]:g})" if single else ""))
    check(ok, f"K1 {label} {kind} y")
    if single:
        check(rel <= DOT_REL[kind], f"K1 {label} {kind} dot")


def k1_edge_checks(torch, K, dev, errs):
    """K1's edge shapes in every dtype, single and batched over 3 parts:
    odd n (every part of a batch starts off a 16-byte boundary),
    one-sided offsets, a 64-diagonal band 12,600 rows wide, the 3D 512^3
    device-built planes (single), and a band whose nd * P * n passes
    2^31 (64-bit index arithmetic)."""
    from acg_tpu_torch.io.generators import poisson_dia_device

    g = torch.Generator(device=dev).manual_seed(2468)
    wide = tuple(200 * k for k in range(-32, 32))
    cases = (("odd n", (-1001, -1, 0, 1, 1001), 333_333),
             ("offsets >= 0", (0, 1, 2, 1024, 4096), 500_001),
             ("offsets <= 0", (-4096, -1024, -2, -1, 0), 500_001),
             ("64-diagonal band", wide, 1_000_003))
    for kind, (pdt, xdt) in kinds(torch).items():
        for label, offsets, n in cases:
            for nparts in (1, 3):
                shape = (n,) if nparts == 1 else (nparts, n)
                P = torch.randn((len(offsets),) + shape, generator=g,
                                device=dev).to(pdt)
                x = torch.randn(shape, generator=g, device=dev).to(xdt)
                k1_check(torch, K, label, kind, P, offsets, x, errs,
                         abs_scale=True)
        planes, offsets, N = poisson_dia_device(DIRECT_N, 3,
                                                dtype=torch.float64,
                                                device=dev)
        planes = planes.to(pdt)
        x = torch.randn(N, generator=g, dtype=torch.float32,
                        device=dev).to(xdt)
        k1_check(torch, K, f"3d-{DIRECT_N} device planes", kind, planes,
                 offsets, x, errs, abs_scale=True)
        del planes, x
        # 64 x (2^25 + 1) planes: 2.1e9 values, past 31-bit indices
        n = 2 ** 25 + 1
        P = torch.empty((64, n), dtype=pdt, device=dev).uniform_(
            -1, 1, generator=g)
        x = torch.randn(n, generator=g, device=dev).to(xdt)
        k1_check(torch, K, "64-bit index band", kind, P, wide, x, errs,
                 abs_scale=True)
        del P, x
        torch.cuda.empty_cache()


def k6_edge_checks(torch, K, dev, errs):
    """K6 on a 16-part plane with gated and ungated pairs mixed, windows
    whose byte length is not a multiple of 16 (odd maxcnt, bf16 and f32)
    and a 5-part plane of 7-value windows, gated and dense, each into a
    receive plane that starts from random values."""
    g = torch.Generator(device=dev).manual_seed(1357)
    for P, maxcnt in ((16, 1001), (16, 4096), (5, 7)):
        cnt = torch.randint(-1, 3, (P, P), generator=g, device=dev,
                            dtype=torch.int32)
        ungated = int(((cnt <= 0) & ~torch.eye(P, dtype=torch.bool,
                                                device=dev)).sum())
        for kind in ("f64", "f32", "bf16"):
            vdt = kinds(torch)[kind][1]
            send = torch.randn((P, P, maxcnt), generator=g,
                               device=dev).to(vdt)
            recv0 = torch.randn((P, P, maxcnt), generator=g,
                                device=dev).to(vdt)
            for gate in (True, False):
                got = K.halo_put(send, cnt, recv0.clone(), gate_by_counts=gate)
                want = K.halo_put_plain(send, cnt, recv0.clone(), gate)
                torch.cuda.synchronize()
                ok = torch.equal(got, want)
                say(f"K6 halo_put {P}-part plane {tuple(send.shape)} {kind} "
                    f"({maxcnt * send.element_size()} bytes a window, "
                    f"{ungated} ungated pairs) {'gated' if gate else 'dense'}"
                    f": recv bitwise={ok}")
                check(ok, f"K6 {P} parts maxcnt {maxcnt} {kind} gate={gate}")
                errs[("halo_put", kind)] = max(
                    errs.get(("halo_put", kind), 0.0), max_abs(got, want))


def flagship_parts(csr):
    """The flagship matrix band-partitioned into NPARTS stacked parts, as
    the CLI's --nparts 4 builds it (--partition-method auto picks band)."""
    from acg_tpu_torch.parallel.dist import DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    t0 = time.perf_counter()
    part = partition_rows(csr, NPARTS, method="band")
    prob = DistributedProblem.build(csr, part, NPARTS)
    say(f"flagship {NPARTS}-part band problem built in "
        f"{time.perf_counter() - t0:.1f} s: local {prob.local.format} "
        f"offsets {prob.local.offsets}, nmax_owned {prob.nmax_owned}, halo "
        f"maxcnt {prob.halo.maxcnt}, ghost rows {prob.ghost.bmax}")
    return prob


def irregular_parts():
    """The irregular matrix of path (h) on the graph partition the CLI's
    --partition-method graph builds (its default --seed 42): (csr,
    problem)."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.parallel.dist import DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    A = synthesize_host_matrix(IRREGULAR_SPEC).to_csr()
    t0 = time.perf_counter()
    part = partition_rows(A, NPARTS, seed=42, method="graph")
    t1 = time.perf_counter()
    prob = DistributedProblem.build(A, part, NPARTS)
    say(f"{IRREGULAR_SPEC} {NPARTS}-part graph problem: partition "
        f"{t1 - t0:.1f} s, build {time.perf_counter() - t1:.1f} s; local "
        f"{prob.local.format}, nmax_owned {prob.nmax_owned}, halo maxcnt "
        f"{prob.halo.maxcnt}, ghost rows {prob.ghost.bmax}")
    return A, prob


def dist_kernel_checks(torch, K, dev, prob, irr, inputs, errs):
    """K1 batched over the parts, K5 on the flat stack and K6 against
    their plain versions, at the shapes the multi-part paths give them:
    the flagship's 4 band parts (e)-(g) and the irregular matrix's 4
    graph parts (h)."""
    from acg_tpu_torch.parallel.halo import pack

    g = torch.Generator(device=dev).manual_seed(4321)
    dt = kinds(torch)
    P64 = torch.from_numpy(prob.local.arrays[0]).to(dev)
    offs = prob.local.offsets
    x64 = torch.randn((prob.nparts, prob.nmax_owned), generator=g,
                      dtype=torch.float64, device=dev)
    for kind, (pdt, xdt) in dt.items():
        P, x = P64.to(pdt).contiguous(), x64.to(xdt)
        k1_check(torch, K, "batched flagship parts", kind, P, offs, x, errs)
        inputs[("dia_b", kind)] = (P, offs, x)
    part_dot_checks(torch, K, dev, g, x64, inputs, errs)
    halo = prob.halo.to(dev)
    scnt = torch.from_numpy(prob.neighbor_counts()[0]).to(dev)
    c8 = torch.full((8, 8), 4096, dtype=torch.int32, device=dev)
    for kind in ("f64", "f32", "bf16"):
        vdt = dt[kind][1]
        planes = {"4-part plan": (pack(x64.to(vdt), halo.send_idx), scnt),
                  "8-part all pairs": (torch.randn(
                      (8, 8, 4096), generator=g, dtype=torch.float64,
                      device=dev).to(vdt), c8)}
        for label, (send, cnt) in planes.items():
            for gate in (True, False):
                got = K.halo_put(send, cnt, torch.zeros_like(send),
                                 gate_by_counts=gate)
                want = K.halo_put_plain(send, cnt, torch.zeros_like(send),
                                        gate)
                torch.cuda.synchronize()
                ok = torch.equal(got, want)
                say(f"K6 halo_put {label} {tuple(send.shape)} {kind} "
                    f"{'gated' if gate else 'dense'}: recv bitwise={ok}")
                check(ok, f"K6 {label} {kind} gate={gate}")
                if label == "4-part plan":
                    errs[("halo_put", kind)] = max(
                        errs.get(("halo_put", kind), 0.0),
                        max_abs(got, want))
        inputs[("halo", kind)] = planes["4-part plan"]
    # K5 on the flat (parts x nmax_owned) view the pipelined path (g)
    # updates: 4,195,124 rows, a partial last block; a false live flag
    # must leave all six vectors as they were
    NP = prob.nparts * prob.nmax_owned
    for kind in ("f64", "f32", "bf16"):
        vdt = dt[kind][1]
        vs = [torch.randn(NP, generator=g, dtype=torch.float64,
                          device=dev).to(vdt) for _ in range(7)]
        sdt = K.acc_dtype(vdt)
        al = torch.tensor(0.37, dtype=sdt, device=dev)
        be = torch.tensor(0.81, dtype=sdt, device=dev)
        want = K.pipelined_update_plain(*vs, al, be)
        for live in (None, True, False):
            flag = None if live is None else torch.tensor(live, device=dev)
            got = K.pipelined_update(*[v.clone() for v in vs[:6]], vs[6],
                                     al, be, live=flag)
            exp = vs[:6] if live is False else want
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) for a, b in zip(got, exp))
            say(f"K5 pipelined_update flat {prob.nparts}x{prob.nmax_owned} "
                f"(N={NP}) {kind} live={live}: 6 outputs bitwise={ok}")
            check(ok, f"K5 flat stack {kind} live={live}")
            errs[("pipelined_update", kind)] = max(
                errs[("pipelined_update", kind)],
                max(max_abs(a, b) for a, b in zip(got, exp)))
    # K6 on the irregular graph partition's plane: every pair gated,
    # maxcnt not a multiple of the block; the receive plane starts from
    # random values, which ungated rows must keep
    _, iprob = irr
    ihalo = iprob.halo.to(dev)
    icnt = torch.from_numpy(iprob.neighbor_counts()[0]).to(dev)
    ix = torch.randn((iprob.nparts, iprob.nmax_owned), generator=g,
                     dtype=torch.float64, device=dev)
    for kind in ("f64", "f32", "bf16"):
        vdt = dt[kind][1]
        send = pack(ix.to(vdt), ihalo.send_idx)
        recv0 = torch.randn(tuple(send.shape), generator=g,
                            dtype=torch.float64, device=dev).to(vdt)
        for gate in (True, False):
            got = K.halo_put(send, icnt, recv0.clone(), gate_by_counts=gate)
            want = K.halo_put_plain(send, icnt, recv0.clone(), gate)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            say(f"K6 halo_put {IRREGULAR_SPEC} graph plan "
                f"{tuple(send.shape)} {kind} "
                f"{'gated' if gate else 'dense'}: recv bitwise={ok}")
            check(ok, f"K6 irregular plan {kind} gate={gate}")
            errs[("halo_put", kind)] = max(errs[("halo_put", kind)],
                                           max_abs(got, want))
        inputs[("halo_irr", kind)] = (send, icnt)


def part_dot_checks(torch, K, dev, g, x64, inputs, errs):
    """The per-part dot at the flagship's (4, nmax_owned) stack in each
    vector dtype: within DOT_REL of sum |a c| of its plain version
    (another summation order), and a part's bits the same in the stack
    of 4, of 2 (a rank's), alone, from a row off a 16-byte boundary, and
    twice."""
    P, n = x64.shape
    y64 = torch.randn((P, n), generator=g, dtype=torch.float64, device=dev)
    for kind in ("f64", "f32", "bf16"):
        vdt = kinds(torch)[kind][1]
        sdt = K.acc_dtype(vdt)
        a, c = x64.to(vdt), y64.to(vdt)
        got = K.part_dot(a, c, sdt)
        want = K.part_dot_plain(a, c, sdt)
        scale = (a.double() * c.double()).abs().sum(-1)
        rel = float(((got.double() - want.double()).abs() / scale).max())
        buf = torch.empty(2 * n + 1, dtype=vdt, device=dev)
        off = buf[1:].view(2, n)
        off.copy_(torch.stack([a[3], c[3]]))
        same = (torch.equal(K.part_dot(a, c, sdt), got)
                and torch.equal(K.part_dot(a[:2], c[:2], sdt), got[:2])
                and torch.equal(K.part_dot(a[2:], c[2:], sdt), got[2:])
                and all(torch.equal(K.part_dot(a[p:p + 1], c[p:p + 1], sdt),
                                    got[p:p + 1]) for p in range(P))
                and torch.equal(K.part_dot(off[:1], off[1:], sdt), got[3:]))
        torch.cuda.synchronize()
        say(f"part_dot {P}x{n} {kind}: max rel dev from plain {rel:.3e} of "
            f"sum |a c| (limit {DOT_REL[kind]:g}); a part's bits the same "
            f"in stacks of 4, 2, 1, off 16 bytes and twice = {same}")
        check(rel <= DOT_REL[kind], f"part_dot {kind} within {DOT_REL[kind]}")
        check(same, f"part_dot {kind}: bits independent of the stack")
        errs[("part_dot", kind)] = max_abs(got, want)
        inputs[("dot", kind)] = (a, c, sdt)


def armed_parts(torch, prob):
    """The flagship's 4-part band problem with the f64 Poisson stencil
    armed (a copy: ``prob`` keeps its assembled local planes)."""
    import dataclasses

    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.parallel.dist import arm_matfree

    return arm_matfree(dataclasses.replace(prob), poisson_stencil(
        FLAGSHIP, 2, dtype=torch.float64, device="cuda"))


# K7's grids: (label, n, dim, dtypes); the paths' grids (2D 2048, 3D
# 512), then the edge shapes: ragged N (3D 37), odd n (every +-n vector
# off the 16-byte phase), n = 2 mod 4 (off it in f32), n below the rows
# a thread (2, 3), 1D, and 1D past 2^31 rows (64-bit indices; f32 only:
# one f32 vector is 8.6 GB)
K7_GRIDS = (("2d-2048", FLAGSHIP, 2, ("f64", "f32")),
            ("3d-512", DIRECT_N, 3, ("f64", "f32")),
            ("3d-37", 37, 3, ("f64", "f32")),
            ("1d-1000003", 1000003, 1, ("f64", "f32")),
            ("2d-2047", 2047, 2, ("f64", "f32")),
            ("2d-2046", 2046, 2, ("f64", "f32")),
            ("3d-131", 131, 3, ("f64", "f32")),
            ("3d-130", 130, 3, ("f64", "f32")),
            ("2d-2", 2, 2, ("f64", "f32")),
            ("2d-3", 3, 2, ("f64", "f32")),
            ("3d-3", 3, 3, ("f64", "f32")),
            ("1d-2^31+5", 2 ** 31 + 5, 1, ("f32",)))


def stencil_checks(torch, K, dev, mf, errs):
    """K7 against its plain version (the shifted-view apply) and against
    K1 on the same operator's device-built assembled planes, bitwise, on
    every grid of K7_GRIDS; stacked K7 against the generated planes
    through dia_mv on the flagship's 4-part band plan (real row0/nowned)
    and on an 8-part band plan of ragged owned counts over 2D 2047 whose
    parts start off 16-byte boundaries."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil

    g = torch.Generator(device=dev).manual_seed(777)
    types = {"f64": torch.float64, "f32": torch.float32}
    for label, n, dim, kinds_ in K7_GRIDS:
        for kind in kinds_:
            dt = types[kind]
            op = poisson_stencil(n, dim, dtype=dt, device=dev)
            x = torch.randn(op.nrows, generator=g, dtype=dt, device=dev)
            y = K.stencil_spmv(op, x)
            yr = K.stencil_spmv_plain(op, x)
            torch.cuda.synchronize()
            same = torch.equal(y, yr)
            err = 0.0 if same else max_abs(y, yr)
            del yr
            torch.cuda.empty_cache()
            planes, offs, _ = poisson_dia_device(n, dim, dtype=dt,
                                                 device=dev)
            y1 = K.dia_spmv(planes, offs, x)
            torch.cuda.synchronize()
            same_k1 = torch.equal(y, y1)
            # the kernel's index width (csrc/stencil_spmv.cu dispatch)
            tile = 256 * 16 // x.element_size()
            bits = 32 if op.nrows + 2 * n ** (dim - 1) + 2 * tile \
                < 2 ** 31 - 1 else 64
            say(f"K7 stencil_spmv {label} {kind} (N={op.nrows}, {bits}-bit "
                f"index): y bitwise={same} vs plain, bitwise={same_k1} vs "
                f"K1 on the assembled planes")
            check(same and same_k1, f"K7 {label} {kind}")
            errs[("stencil_spmv", kind)] = max(
                err, errs.get(("stencil_spmv", kind), 0.0))
            del x, y, y1, planes
            torch.cuda.empty_cache()
    row0, nowned = (torch.from_numpy(a).to(dev) for a in mf.local.arrays[:2])
    plans = {f"{mf.nparts}x{mf.nmax_owned} (flagship {mf.nparts}-part band)":
             (FLAGSHIP, row0, nowned, mf.nmax_owned)}
    r8, o8, nrows8 = ragged_plan(torch, 2047 ** 2, 8)
    plans[f"8x{nrows8} (2D 2047, ragged)"] = (2047, r8.to(dev), o8.to(dev),
                                              nrows8)
    for label, (n, r0, no, nrows) in plans.items():
        for kind, dt in types.items():
            op = poisson_stencil(n, 2, dtype=dt, device=dev)
            x = torch.randn((r0.shape[0], nrows), generator=g, dtype=dt,
                            device=dev)
            y = K.stencil_spmv(op, x, row0=r0, nowned=no)
            yr = K.stencil_spmv_plain(op, x, r0, no)
            torch.cuda.synchronize()
            say(f"K7 stencil_spmv batched {label} {kind} (row0 "
                f"{r0.tolist()}, nowned {no.tolist()}): y bitwise="
                f"{torch.equal(y, yr)}")
            check(torch.equal(y, yr), f"K7 batched {label} {kind}")
            errs[("stencil_spmv_batched", kind)] = max(
                max_abs(y, yr), errs.get(("stencil_spmv_batched", kind), 0.0))


def ragged_plan(torch, N, nparts, seed=11):
    """A band plan of ``nparts`` contiguous parts of uneven sizes over N
    rows: (row0, nowned) int64 tensors and a padded row count that is
    odd, so every part but the first starts off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, N), nparts - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [N]])
    nowned = np.diff(bounds)
    nrows = int(nowned.max()) + 1 + int(nowned.max()) % 2
    return (torch.from_numpy(bounds[:-1].astype(np.int64)),
            torch.from_numpy(nowned.astype(np.int64)), nrows)


def k3_edge_checks(torch, K, dev, errs):
    """K3 on its edge shapes in f32, mixed and bf16: odd n (2D 2047
    Poisson planes: plane rows and the +-1 vectors off the 16-byte
    phase), offsets all >= 0 or all <= 0 (random planes), the 3D 7-point
    planes (128^3), each with gamma_prev finite and infinite (the first
    iteration, beta = 0) and with the live flag true and false (a frozen
    solve: p = p_old): p and t bitwise-equal to the plain version, (p,
    t) within 1e-5 of sum |p_i t_i| (random planes give terms of both
    signs, whose sum may lie far below them)."""
    from acg_tpu_torch.io.generators import poisson_dia_device

    g = torch.Generator(device=dev).manual_seed(1122)
    cases = []
    for label, n, dim in (("odd n 2d-2047", 2047, 2), ("3d-128", 128, 3)):
        planes, offs, N = poisson_dia_device(n, dim, dtype=torch.float64,
                                             device=dev)
        cases.append((label, planes, offs, N))
    for label, offs in (("offsets >= 0", (0, 1, 2, 1024, 4096)),
                        ("offsets <= 0", (-4096, -1024, -2, -1, 0))):
        cases.append((label, torch.randn((len(offs), 500_001), generator=g,
                                         dtype=torch.float64, device=dev),
                      offs, 500_001))
    dt = kinds(torch)
    gm = torch.tensor(2.0, device=dev)
    for label, P64, offs, N in cases:
        ot = torch.tensor(offs, dtype=torch.int64, device=dev)
        for kind in ("f32", "mixed", "bf16"):
            pdt, vdt = dt[kind]
            P = P64.to(pdt)
            r, po = (torch.randn(N, generator=g, dtype=torch.float64,
                                 device=dev).to(vdt) for _ in range(2))
            for gp_v, live in ((4.0, None), (float("inf"), None),
                               (4.0, True), (4.0, False)):
                gp = torch.tensor(gp_v, device=dev)
                lv = None if live is None else torch.tensor(live, device=dev)
                pa, ta, da = K.cg_phase_a(P, offs, r, po, gm, gp,
                                          offsets_t=ot, live=lv)
                pr, tr, dr = K.cg_phase_a_plain(P, offs, r, po, gm, gp, lv)
                torch.cuda.synchronize()
                scale = float((pr.double() * tr.double()).abs().sum())
                rel = abs(float(da) - float(dr)) / scale
                ok = torch.equal(pa, pr) and torch.equal(ta, tr)
                if live is False:
                    ok = ok and torch.equal(pa, po)
                if gp_v == float("inf"):
                    ok = ok and torch.equal(pa, r)
                say(f"K3 cg_phase_a {label} (N={N}, {len(offs)} offsets) "
                    f"{kind} gamma_prev={gp_v} live={live}: p, t bitwise="
                    f"{ok}, (p,t) err {rel:.3e} of sum |p t| (limit 1e-5)")
                check(ok and rel <= 1e-5,
                      f"K3 {label} {kind} gamma_prev={gp_v} live={live}")
                errs[("cg_phase_a", kind)] = max(
                    errs[("cg_phase_a", kind)], max_abs(pa, pr),
                    max_abs(ta, tr))
            del P, r, po
        del P64
        torch.cuda.empty_cache()


# K4's edge shapes: (label, n, elements each vector sits past a 16-byte
# boundary); odd n (a ragged last tile), n below and near the rows a
# thread (4 f32, 8 bf16), n past a whole tile count, and every pointer
# one element off 16 bytes
K4_CASES = (("odd n 2047^2", 2047 ** 2, 0), ("n=1", 1, 0), ("n=3", 3, 0),
            ("n=7", 7, 0), ("n=9", 9, 0), ("n=2048^2+5", FLAGSHIP ** 2 + 5, 0),
            ("n=2048^2, pointers off 16 bytes", FLAGSHIP ** 2, 1),
            ("n=9, pointers off 16 bytes", 9, 1))


def k4_edge_checks(torch, K, dev, errs):
    """K4 on the K4_CASES shapes in f32, mixed (f32 vectors, as the fused
    tier runs them under bf16 planes) and bf16, each with the live flag
    absent, true and false: x and r bitwise-equal to the plain version
    and untouched when live is false, gamma' within 1e-5 of sum r_i^2
    (relative), the same bits twice, and nothing written outside the
    vectors (each is the view [off, off + n) of a buffer of n + off + 1
    elements)."""
    g = torch.Generator(device=dev).manual_seed(3344)
    gm = torch.tensor(2.0, device=dev)
    pd = torch.tensor(6.0, device=dev)   # alpha = 1/3
    for label, n, off in K4_CASES:
        for kind in ("f32", "mixed", "bf16"):
            vdt = kinds(torch)[kind][1]
            bufs = [torch.randn(n + off + 1, generator=g, device=dev).to(vdt)
                    for _ in range(4)]
            x0, p, r0, t = (b[off:off + n] for b in bufs)
            for live in (None, True, False):
                lv = None if live is None else torch.tensor(live, device=dev)
                xw, rw, _ = K.cg_phase_b_plain(x0, p, r0, t, gm, pd, lv)
                runs = []
                for _ in range(2):
                    xb, rb = bufs[0].clone(), bufs[2].clone()
                    x, r = xb[off:off + n], rb[off:off + n]
                    _, _, gam = K.cg_phase_b(x, p, r, t, gm, pd, live=lv)
                    runs.append((xb, rb, gam))
                torch.cuda.synchronize()
                xb, rb, gam = runs[0]
                ok = torch.equal(xb[off:off + n], xw) and \
                    torch.equal(rb[off:off + n], rw)
                if live is False:
                    ok = ok and torch.equal(xw, x0) and torch.equal(rw, r0)
                outside = all(torch.equal(v[:off], b[:off])
                              and torch.equal(v[off + n:], b[off + n:])
                              for v, b in ((xb, bufs[0]), (rb, bufs[2])))
                twice = all(torch.equal(a, b)
                            for a, b in zip(runs[0], runs[1]))
                ref = float((rw.double() ** 2).sum())
                rel = abs(float(gam) - ref) / ref
                say(f"K4 cg_phase_b {label} (N={n}) {kind} live={live}: x, r "
                    f"bitwise={ok}, outside untouched={outside}, same bits "
                    f"twice={twice}, (r,r) rel err {rel:.3e} (limit 1e-5)")
                check(ok and outside and twice and rel <= 1e-5,
                      f"K4 {label} {kind} live={live}")
                errs[("cg_phase_b", kind)] = max(
                    errs[("cg_phase_b", kind)],
                    max_abs(xb[off:off + n], xw), max_abs(rb[off:off + n], rw))
            del bufs, x0, p, r0, t, runs
        torch.cuda.empty_cache()


# -- phase 3: the main path through the CLI ------------------------------

def run_cli(torch, K, argv, tag):
    """One cli.main run with the launch counters reset just before and
    read just after; returns (rc, stderr text, counts)."""
    from acg_tpu_torch import cli

    K.reset_launches()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    text = err.getvalue()
    LOG.append(f"--- {tag}: {' '.join(argv)}\n{text}")
    say(f"path {tag}: rc={rc} wall {time.perf_counter() - t0:.1f} s, "
        f"launches {counts}")
    _no_fallback(text, tag)
    return rc, text, counts


def _no_fallback(text: str, tag: str) -> None:
    """No rung that leaves the card's kernels ran (the CLI names neither
    the transport rung nor, on the card, has a host rung)."""
    m = re.search(r"resilience: .* (\d+) fallbacks", text)
    check(not (m and int(m.group(1))) and ": fallback: " not in text,
          f"path {tag}: no fallback rung ran")


def launch_lines(text: str) -> list:
    """The counts of every ``kernel launches:`` line a child printed
    (``-vv``), in order: one a CLI run that finished its solve."""
    return [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines()
            if ln.startswith("kernel launches: ")]


def stat(text: str, key: str) -> str:
    for line in text.splitlines():
        if line.strip().startswith(key + ":"):
            return line.split(":", 1)[1].strip()
    raise AssertionError(f"chip_smoke: no '{key}' line in the stats block")


def read_x(path):
    from acg_tpu_torch.io.mtxfile import read_mtx
    return np.asarray(read_mtx(path, binary=True).vals, np.float64)


def main_path(torch, K, tmp, csr, irr, prob):
    """Phase 3: the paths, this process's own runs in turn and the
    child-process jobs in one pool, JOB_WORKERS at a time."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=JOB_WORKERS) as pool:
        return _main_path(torch, K, tmp, csr, irr, prob, pool)


def _main_path(torch, K, tmp, csr, irr, prob, pool):
    # the service jobs (bb)-(be) and the decision jobs (ay)-(ba) read
    # nothing of this process's paths: they start first, beside (a)-(ab)
    # ((u) joins them once (a) wrote its x), and end long before the
    # jobs submitted below
    t_early = time.perf_counter()
    early = [pool.submit(j) for j in service_paths(torch, K, tmp, csr)
             + decision_paths(torch, K, tmp).early]
    base = [MAIN_SPEC, "--warmup", "0", "-q"]
    xsol = np.random.default_rng(42).standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    b = csr @ xsol   # the CLI's --manufactured-solution right-hand side
    paths = {}

    def true_rel_residual(x):
        return float(np.linalg.norm(b - csr @ x) / np.linalg.norm(b))

    # (a) the default path: classic CG, f64, --kernels auto
    out = os.path.join(tmp, "a.bin")
    rc, text, c = run_cli(torch, K, base + [
        "--manufactured-solution", "--residual-rtol", "1e-8",
        "--max-iterations", "20000", "-o", out], "a-classic-f64")
    its = int(stat(text, "iterations").replace(",", ""))
    stat_of = {"a": its}
    ITS["a"] = its
    res = true_rel_residual(read_x(out))
    say(f"path a: {its} iterations, true relative residual {res:.3e} "
        f"(limit 1e-7), solver time {stat(text, 'total solver time')}")
    check(rc == 0 and res <= 1e-7, "path a converged to 1e-7")
    check(c["dia_spmv"] >= its, "path a went through K1")
    paths["a"] = c

    # (b) pipelined CG, f64
    out = os.path.join(tmp, "b.bin")
    rc, text, c = run_cli(torch, K, base + [
        "--manufactured-solution", "--residual-rtol", "1e-8",
        "--max-iterations", "20000", "--solver", "acg-pipelined",
        "-o", out], "b-pipelined-f64")
    its = int(stat(text, "iterations").replace(",", ""))
    ITS["b"] = its
    res = true_rel_residual(read_x(out))
    say(f"path b: {its} iterations, true relative residual {res:.3e} "
        f"(limit 1e-6), solver time {stat(text, 'total solver time')}")
    check(rc == 0 and res <= 1e-6, "path b converged to 1e-6")
    check(c["pipelined_update"] >= its and c["dia_spmv"] >= its,
          "path b went through K5 and K1")
    paths["b"] = c

    # (c) the fused tier against the plain tier, f32, shifted matrix
    fused = base + ["--dtype", "f32", "--epsilon", "2", "--residual-rtol",
                    "1e-6", "--max-iterations", "2000"]
    rc, text, c = run_cli(torch, K, fused + [
        "--kernels", "fused", "-o", os.path.join(tmp, "cf.bin")],
        "c-fused-f32")
    its = int(stat(text, "iterations").replace(",", ""))
    rc2, text2, c2 = run_cli(torch, K, fused + [
        "--kernels", "xla", "-o", os.path.join(tmp, "cx.bin")],
        "c-xla-f32")
    xf, xx = read_x(os.path.join(tmp, "cf.bin")), read_x(
        os.path.join(tmp, "cx.bin"))
    rel = float(np.linalg.norm(xf - xx) / np.linalg.norm(xx))
    # the flag is read once per chunk of iterations, so the last chunk's
    # frozen iterations launch too: the counts exceed the iteration count
    # by less than one chunk
    from acg_tpu_torch.solvers.cg import CHUNK
    say(f"path c: fused {its} iterations, xla "
        f"{stat(text2, 'iterations')}, solutions rel diff {rel:.3e} "
        f"(limit 1e-5); K3/K4 launches {c['cg_phase_a']}/"
        f"{c['cg_phase_b']} for {its} iterations (chunk {CHUNK})")
    check(rc == 0 and rc2 == 0 and rel <= 1e-5, "path c fused == xla")
    check(its <= c["cg_phase_b"] == c["cg_phase_a"] < its + CHUNK,
          "path c went through K3/K4 once per iteration")
    check(sum(c2.values()) == 0, "--kernels xla launched no kernel")
    paths["c"] = c

    # (d) --dtype mixed against f32, classic, exactly 500 iterations
    fixed = base + ["--residual-rtol", "0", "--max-iterations", "500"]
    rc, text, c = run_cli(torch, K, fixed + [
        "--dtype", "mixed", "-o", os.path.join(tmp, "dm.bin")],
        "d-mixed")
    rc2, text2, c2 = run_cli(torch, K, fixed + [
        "--dtype", "f32", "-o", os.path.join(tmp, "df.bin")], "d-f32")
    same = np.array_equal(read_x(os.path.join(tmp, "dm.bin")),
                          read_x(os.path.join(tmp, "df.bin")))
    say(f"path d: mixed vs f32 after {stat(text, 'iterations')} "
        f"iterations: bitwise equal = {same}")
    check(rc == 0 and rc2 == 0 and same, "path d mixed == f32 bitwise")
    check(c["dia_spmv"] == 501 and c2["dia_spmv"] == 501,
          "path d: one K1 launch per iteration plus the setup residual")
    paths["d"] = c
    # (u) reads (a)'s x: a child-process job from here on
    early.append(pool.submit(tool_job(torch, K, tmp, b, csr)))
    its_a = int(stat_of["a"])
    paths.update(multipart_paths(torch, K, tmp, base, b, csr, its_a, irr))
    paths.update(matfree_paths(torch, K, tmp, base, paths))
    paths.update(gen_direct_paths(torch, K, tmp))
    paths.update(reproducible_gather_paths(torch, K, tmp, irr))
    paths.update(precond_paths(torch, K, tmp, base, b, csr, prob))
    paths.update(precision_paths(torch, K, tmp, base, b, csr))
    paths.update(host_paths(torch, K, tmp))
    paths.update(batched_paths(torch, K, tmp, base, csr, paths))
    paths.update(ca_paths(torch, K, tmp, base, b, csr))
    paths.update(dist_batched_paths(torch, K, tmp, base, csr, prob))
    for f in early:
        paths.update(f.result())
    say(f"paths bb-be, ay-ba and u ({len(early)} jobs beside (a)-(ab)) "
        f"ended {time.perf_counter() - t_early:.1f} s into phase 3")
    # the other child-process paths as jobs, JOB_WORKERS at a time, the
    # longest first, started once the files they read exist; this
    # process's own checks go on meanwhile, and the timing-sensitive
    # paths ((ai)'s rates, (ap)'s drift gate) only after the last job
    pairs = multiprocess_paths(torch, K, tmp, base, csr, prob)
    elastic = elastic_paths(torch, K, tmp, base, b, csr, prob)
    t0 = time.perf_counter()
    futures = [pool.submit(j) for j in elastic.early[:3] + pairs.early
               + elastic.early[3:]]
    paths.update(fused_dist_paths(torch, K, tmp, base, csr, prob, irr))
    paths.update(north_star_path(torch, K, tmp))
    for group in (pairs, elastic):
        paths.update(group.local())
        futures += [pool.submit(j) for j in group.late]
    say(f"paths ac, ae, at, aw and the twins (this process) took "
        f"{time.perf_counter() - t0:.1f} s")
    for f in futures:
        paths.update(f.result())
    say(f"paths ac, ae, at, aw, af-ah and aq-ax ({len(futures)} jobs, "
        f"{JOB_WORKERS} at a time) took {time.perf_counter() - t0:.1f} s")
    paths.update(probe_twin_path(torch, K, prob, b))
    paths.update(observability_paths(torch, K, tmp, paths))
    paths.update(robustness_paths(torch, K, tmp, base, b, csr, prob, paths))
    return paths


def chunked(its: int) -> int:
    """The loop steps a converged solve ran: the convergence flag is read
    once per CHUNK steps, and the last chunk's frozen steps launch too."""
    from acg_tpu_torch.solvers.cg import CHUNK
    return -(-its // CHUNK) * CHUNK


# paths whose checks need no in-process state run as child processes,
# this many at a time: their host work (ingest, partition, the eager
# loops' launches) overlaps, and the card, idle most of a host-bound
# solve, takes their kernels in turn
JOB_WORKERS = 4


class Jobs(NamedTuple):
    """A group of main_path's child-process jobs: ``early`` start at
    once; ``local()`` then runs in this process (the one-process twins
    the ``late`` jobs are held to, and in-process paths) and returns its
    launch counts by path; ``late`` start after it."""
    early: list
    local: Callable[[], dict]
    late: list


# the environment of every child process, fixed by main() before any
# thread starts: without the fault injector's variable (a CLI run armed
# in this process exports it while it runs) and with
# ACG_TPU_SKIP_BACKEND_PROBE set
CHILD_ENV: dict = {}


def proc_cli(argv, tag, env=None, timeout=MP_TIMEOUT):
    """``python -m acg_tpu_torch ARGV -vv`` as a child process from the
    checkout's root, under ``env`` (default CHILD_ENV): (rc, stderr, the
    counts of its last ``kernel launches:`` line, wall seconds); no
    fallback rung may have run."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "acg_tpu_torch", *argv,
                          "-vv"], cwd=HERE, capture_output=True, text=True,
                         timeout=timeout,
                         env=CHILD_ENV if env is None else env)
    wall = time.perf_counter() - t0
    text = res.stderr
    LOG.append(f"--- {tag}: rc={res.returncode} {' '.join(argv)}\n{text}")
    lines = launch_lines(text)
    counts = lines[-1] if lines else {}
    say(f"path {tag}: rc={res.returncode} wall {wall:.1f} s (a child "
        f"process), launches {counts}")
    _no_fallback(text, tag)
    return res.returncode, text, counts, wall


def solve_path(torch, K, tmp, argv, tag, rhs=None, A=None):
    """One CLI run writing x to ``tag``.bin: returns (rc, stats text,
    launch counts, K1's counts by dtype pair, iterations, x, true
    relative residual of x against ``rhs`` through host ``A``)."""
    out = os.path.join(tmp, f"{tag}.bin")
    rc, text, c = run_cli(torch, K, argv + ["-o", out], tag)
    types = dict(K.dia_spmv_types)
    its = int(stat(text, "iterations").replace(",", ""))
    x = read_x(out) if os.path.exists(out) else None
    res = (float(np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs))
           if x is not None and A is not None else float("nan"))
    return rc, text, c, types, its, x, res


def library_twin(torch, K, prob, b, tag, **kw):
    """A DistCGSolver solve of ``b`` on the flagship's parts ``prob`` to
    the CLI's tolerance, the launch counters reset just before and read
    just after: :func:`solve_path`'s tuple (x in global order)."""
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria

    t0 = time.perf_counter()
    K.reset_launches()
    s = DistCGSolver(prob, device="cuda", **kw)
    x = s.solve(b, criteria=StoppingCriteria(maxits=20000,
                                             residual_rtol=1e-8))
    torch.cuda.synchronize()
    counts = dict(K.launches)
    say(f"path {tag}: DistCGSolver({kw}) wall "
        f"{time.perf_counter() - t0:.1f} s, launches {counts}")
    return 0, "", counts, None, int(s.stats.niterations), x, float("nan")


def precond_paths(torch, K, tmp, base, b, csr, prob):
    """(n)-(q): the preconditioned tier on the card.  (n) --precond
    jacobi, classic f64 (K1 once per SpMV); (o) the same with --operator
    stencil (K7 in place of K1, x bitwise-equal: both diagonals are 4,
    and K7 equals K1 on these planes); (p) the anisotropic family
    (--aniso 0.01) with --precond cheby:4 against plain CG (fewer
    iterations, K1 counted exactly: 5 per step and setup, and the power
    iteration's 25); (q) 4 stacked parts with bjacobi:32 (classic) and
    jacobi (pipelined) on --comm dma, K6 and batched K1 once per SpMV,
    and each again on --comm xla to the same bits (through the library
    on the CLI's parts: the CLI's ingest is (q-dma)'s)."""
    out = {}
    mp = base + ["--manufactured-solution", "--residual-rtol", "1e-8",
                 "--max-iterations", "20000"]
    rc, text, c, _, its, xn, res = solve_path(
        torch, K, tmp, mp + ["--precond", "jacobi"], "n-jacobi-f64", b, csr)
    say(f"path n: --precond jacobi {its} iterations (path a: {ITS['a']}), "
        f"true relative residual {res:.3e} (limit 1e-7), K1 launches "
        f"{c['dia_spmv']} (steps run {chunked(its)} + setup 1), solver "
        f"time {stat(text, 'total solver time')}")
    check(rc == 0 and res <= 1e-7, "path n converged to 1e-7")
    check(c["dia_spmv"] == chunked(its) + 1
          and sum(c.values()) == c["dia_spmv"],
          "path n: one K1 launch per SpMV and no other kernel")
    out["n"] = c

    rc, text, c, _, its_o, xo, _ = solve_path(
        torch, K, tmp, mp + ["--precond", "jacobi", "--operator", "stencil"],
        "o-jacobi-operator-f64")
    same = xo is not None and np.array_equal(xo, xn)
    say(f"path o: {its_o} iterations (path n: {its}), x bitwise equal to "
        f"path n = {same}; K7 launches {c['stencil_spmv']}, K1 "
        f"{c['dia_spmv']}")
    check(rc == 0 and its_o == its and same, "path o == path n bitwise")
    check(c["stencil_spmv"] == chunked(its) + 1 and c["dia_spmv"] == 0,
          "path o ran K7 where path n ran K1, and no K1")
    out["o"] = c

    from acg_tpu_torch.cli import synthesize_host_matrix
    aniso = synthesize_host_matrix(MAIN_SPEC, aniso=0.01).to_csr()
    xs = np.random.default_rng(42).standard_normal(aniso.shape[0])
    ba = aniso @ (xs / np.linalg.norm(xs))
    ap = base + ["--aniso", "0.01", "--manufactured-solution",
                 "--residual-rtol", "1e-8", "--max-iterations", "40000"]
    rc, text, c, _, its_p, _, res = solve_path(
        torch, K, tmp, ap + ["--precond", "cheby:4"], "p-cheby4-aniso",
        ba, aniso)
    lam = (stat(text, "lambda_min"), stat(text, "lambda_max"))
    rc0, text0, c0, _, its_0, _, res0 = solve_path(
        torch, K, tmp, ap, "p-plain-aniso", ba, aniso)
    want = 5 * (chunked(its_p) + 1) + 25
    say(f"path p: {MAIN_SPEC} --aniso 0.01 --precond cheby:4 {its_p} "
        f"iterations (interval {lam[0]} .. {lam[1]}), true relative "
        f"residual {res:.3e}, solver time "
        f"{stat(text, 'total solver time')}; plain CG {its_0} iterations "
        f"(rc {rc0}), residual {res0:.3e}, solver time "
        f"{stat(text0, 'total solver time')}; K1 launches {c['dia_spmv']} "
        f"(5 x (steps {chunked(its_p)} + setup 1) + 25 power iterations "
        f"= {want}), plain {c0['dia_spmv']}")
    check(rc == 0 and res <= 1e-7, "path p (cheby:4) converged to 1e-7")
    check(its_p < its_0, "path p: cheby:4 took fewer iterations than CG")
    check(c["dia_spmv"] == want and c0["dia_spmv"] == chunked(its_0) + 1,
          "path p: K1 launched once per SpMV, counted exactly")
    out["p"] = {k: c[k] + c0[k] for k in c}

    q = base + ["--nparts", str(NPARTS), "--manufactured-solution",
                "--residual-rtol", "1e-8", "--max-iterations", "20000"]
    for tag, extra, setup, limit in (
            ("q-bjacobi32", ["--precond", "bjacobi:32"], 1, 1e-7),
            ("q-jacobi-pipelined", ["--precond", "jacobi", "--solver",
                                    "acg-pipelined"], 2, 1e-6)):
        runs = {"dma": solve_path(torch, K, tmp, q + extra + [
            "--comm", "dma"], f"{tag}-dma", b, csr),
                "xla": library_twin(torch, K, prob, b, f"{tag}-xla",
                                    comm="xla", precond=extra[1],
                                    pipelined="--solver" in extra)}
        rc, text, c, _, its_q, xq, res = runs["dma"]
        rcx, _, cx, _, its_x, xx, _ = runs["xla"]
        nspmv = chunked(its_q) + setup
        same = np.array_equal(xq, xx)
        say(f"path {tag}: {its_q} iterations, true relative residual "
            f"{res:.3e} (limit {limit:g}), solver time "
            f"{stat(text, 'total solver time')}; K6 {c['halo_put']} and "
            f"batched K1 {c['dia_spmv_batched']} launches for {nspmv} "
            f"SpMVs; --comm xla {its_x} iterations, x bitwise equal = "
            f"{same}")
        check(rc == 0 and res <= limit, f"path {tag} converged")
        check(c["halo_put"] == c["dia_spmv_batched"] == nspmv,
              f"path {tag}: K6 and batched K1 once per SpMV")
        check(rcx == 0 and its_x == its_q and same
              and cx["halo_put"] == 0
              and cx["dia_spmv_batched"] == nspmv,
              f"path {tag}: --comm xla gives the same bits")
        out[tag] = {k: c[k] + cx[k] for k in c}
    return out


def precision_paths(torch, K, tmp, base, b, csr):
    """(r)-(t): the precision tier on the card.  (r) --dtype f32
    --precise-dots at 1e-9 against the same run without the flag, and
    the pipelined solver with the flag for 500 fixed iterations (K5 once
    per step); (s)
    --dtype bf16 --replace-every 50, 2000 iterations: the reported
    residual is the true f32 residual, bf16 K1 in the segments and mixed
    K1 for each replacement counted exactly; (t) --dtype f32 --refine to
    1e-12, checked with the host's f64 residual."""
    out = {}
    mp = base + ["--manufactured-solution"]
    r = mp + ["--dtype", "f32", "--residual-rtol", "1e-9",
              "--max-iterations", "20000"]
    rc, text, c, _, its, _, res = solve_path(
        torch, K, tmp, r + ["--precise-dots"], "r-precise-f32", b, csr)
    rc0, text0, c0, _, its0, _, res0 = solve_path(
        torch, K, tmp, r, "r-plain-f32", b, csr)
    say(f"path r: --dtype f32 --precise-dots {its} iterations (rc {rc}), "
        f"reported residual {stat(text, 'residual 2-norm')}, true relative "
        f"residual {res:.3e}, solver time {stat(text, 'total solver time')}"
        f"; without the flag {its0} iterations (rc {rc0}, "
        f"{'converged' if rc0 == 0 else 'stalled'}), reported residual "
        f"{stat(text0, 'residual 2-norm')}, true relative residual "
        f"{res0:.3e}, solver time {stat(text0, 'total solver time')}")
    check(rc == 0, "path r: f32 with --precise-dots converged to 1e-9")
    check(c["dia_spmv"] == chunked(its) + 1,
          "path r: one K1 launch per SpMV")
    # the unpreconditioned pipelined loop keeps K5 under --precise-dots;
    # its f32 recurrences stall short of tight tolerances, so it runs a
    # fixed 500 iterations
    rcp, textp, cp, _, itsp, xp, resp = solve_path(
        torch, K, tmp, mp + ["--dtype", "f32", "--precise-dots", "--solver",
                             "acg-pipelined", "--residual-rtol", "0",
                             "--max-iterations", "500"],
        "r-precise-pipelined-f32", b, csr)
    say(f"path r pipelined: --dtype f32 --precise-dots --solver "
        f"acg-pipelined, {itsp} fixed iterations: true relative residual "
        f"{resp:.3e}, solver time {stat(textp, 'total solver time')}; K5 "
        f"launches {cp['pipelined_update']}, K1 {cp['dia_spmv']} (500 "
        f"steps + setup 2)")
    check(rcp == 0 and itsp == 500 and bool(np.isfinite(xp).all())
          and resp < 1.0, "path r pipelined: a finite, reduced residual")
    check(cp["pipelined_update"] == 500 and cp["dia_spmv"] == 502,
          "path r pipelined: K5 once per step, K1 once per SpMV")
    out["r"] = {k: c[k] + c0[k] + cp[k] for k in c}

    rc, text, c, types, its, x, _ = solve_path(
        torch, K, tmp, mp + ["--dtype", "bf16", "--replace-every", "50",
                             "--residual-rtol", "0", "--max-iterations",
                             "2000"], "s-bf16-replace50")
    rep = float(stat(text, "residual 2-norm"))
    true = float(np.linalg.norm(b - csr @ x))
    bn = float(np.linalg.norm(b))
    say(f"path s: --dtype bf16 --replace-every 50, {its} iterations: "
        f"reported residual {rep:.6e}, true residual of x {true:.6e} "
        f"(|difference| {abs(rep - true):.3e}, limit 1e-5 x ||b|| = "
        f"{1e-5 * bn:.3e}), relative {true / bn:.3e}; K1 launches by "
        f"(planes/x) {types}, solver time "
        f"{stat(text, 'total solver time')}")
    check(rc == 0 and its == 2000 and abs(rep - true) <= 1e-5 * bn,
          "path s: the reported residual is the true f32 residual")
    check(types == {"bf16/bf16": 2000, "bf16/f32": 41},
          "path s: bf16 K1 per iteration, mixed K1 per replacement")
    out["s"] = c

    rc, text, c, _, its, x, res = solve_path(
        torch, K, tmp, mp + ["--dtype", "f32", "--refine",
                             "--residual-rtol", "1e-12",
                             "--max-iterations", "20000"],
        "t-f32-refine", b, csr)
    say(f"path t: --dtype f32 --refine {its} inner iterations, true f64 "
        f"relative residual {res:.3e} (limit 1e-12), solver time "
        f"{stat(text, 'total solver time')}, K1 launches {c['dia_spmv']}")
    check(rc == 0 and res <= 1e-12, "path t: refined to 1e-12 in f64")
    check(c["dia_spmv"] >= its, "path t went through K1")
    out["t"] = c
    return out


def matfree_paths(torch, K, tmp, base, paths):
    """(i)-(k): paths (a), (b) and (e) again with --operator stencil: the
    same iterations and bits, K7 (stacked over parts for (k)) in place of
    K1, launched as often as K1 was."""
    out = {}
    for tag, ref, k1, extra in (
            ("i", "a", "dia_spmv", []),
            ("j", "b", "dia_spmv", ["--solver", "acg-pipelined"]),
            ("k", "e", "dia_spmv_batched", ["--nparts", str(NPARTS),
                                            "--comm", "dma"])):
        k7 = "stencil_spmv_batched" if tag == "k" else "stencil_spmv"
        x_out = os.path.join(tmp, f"{tag}.bin")
        rc, text, c = run_cli(torch, K, base + [
            "--manufactured-solution", "--residual-rtol", "1e-8",
            "--max-iterations", "20000", "--operator", "stencil", "-o",
            x_out] + extra, f"{tag}-operator-of-{ref}")
        its = int(stat(text, "iterations").replace(",", ""))
        same = np.array_equal(read_x(x_out),
                              read_x(os.path.join(tmp, f"{ref}.bin")))
        say(f"path {tag}: {its} iterations (path {ref}: {ITS[ref]}), x "
            f"bitwise equal to path {ref} = {same}; {k7} launches "
            f"{c[k7]} ({ref}'s {k1}: {paths[ref][k1]}), {k1} launches "
            f"{c[k1]}, solver time {stat(text, 'total solver time')}")
        check(rc == 0 and its == ITS[ref] and same,
              f"path {tag} == path {ref}: iterations and bits")
        check(c[k7] == paths[ref][k1] and c[k1] == 0 and c["dia_spmv"] == 0,
              f"path {tag} ran K7 where {ref} ran K1, and no K1")
        if tag == "j":
            check(c["pipelined_update"] == paths["b"]["pipelined_update"],
                  "path j went through K5 as path b did")
        if tag == "k":
            check(c["halo_put"] == paths["e"]["halo_put"],
                  "path k went through K6 as path e did")
        out[tag] = c
    return out


def gen_direct_paths(torch, K, tmp):
    """(l): gen:poisson3d:512 (134,217,728 rows) through the gen-direct
    tier, 300 iterations with no tolerance: DIA planes built on the
    device (K1), then --operator stencil (K7); the two x bitwise-equal,
    and no host matrix built."""
    spec = f"gen:poisson3d:{DIRECT_N}"
    argv = [spec, "--warmup", "0", "-v", "--max-iterations", "300",
            "--residual-rtol", "0"]
    xs, counts = [], {}
    for tag, extra, kern in (("l-assembled", [], "dia_spmv"),
                             ("l-operator", ["--operator", "stencil"],
                              "stencil_spmv")):
        x_out = os.path.join(tmp, f"{tag}.bin")
        torch.cuda.reset_peak_memory_stats()
        rc, text, c = run_cli(torch, K, argv + extra + ["-o", x_out], tag)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        direct = [ln for ln in text.splitlines() if "gen-direct" in ln]
        say(f"path {tag}: {stat(text, 'iterations')} iterations, solver "
            f"time {stat(text, 'total solver time')}, {kern} launches "
            f"{c[kern]}, peak device memory {peak:.2f} GiB; "
            f"{direct[0] if direct else 'no gen-direct line'}")
        check(rc == 0 and direct and "no host matrix" in direct[0]
              and "synthesizing" not in text,
              f"path {tag} took the gen-direct tier with no host matrix")
        check(c[kern] == 301 and sum(c.values()) == 301,
              f"path {tag}: 301 launches of {kern} and no other kernel")
        x = read_x(x_out)
        if tag == "l-assembled":
            # path (ah) holds its two-process x against this one
            os.replace(x_out, os.path.join(tmp, "l.bin"))
        else:
            os.remove(x_out)
        check(x.shape == (DIRECT_N ** 3,) and bool(np.isfinite(x).all()),
              f"path {tag}: a finite x of N rows")
        xs.append(x)
        counts[tag] = c
    same = np.array_equal(xs[0], xs[1])
    say(f"path l: operator x bitwise equal to assembled x = {same}")
    check(same, "path l: operator == assembled, bitwise")
    # (ad) the sharded tier: the same solve over 4 parts, K1 on the whole
    # planes; the vectors and dots are the single part's, so x is path
    # (l)'s, bitwise
    x_out = os.path.join(tmp, "ad.bin")
    torch.cuda.reset_peak_memory_stats()
    rc, text, c = run_cli(torch, K, argv + ["--nparts", str(NPARTS), "-o",
                                            x_out], "ad-sharded-4part")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    direct = [ln for ln in text.splitlines() if "gen-direct" in ln]
    x = read_x(x_out)
    os.remove(x_out)
    same = np.array_equal(x, xs[0])
    say(f"path ad: {stat(text, 'iterations')} iterations, solver time "
        f"{stat(text, 'total solver time')}, K1 launches "
        f"{c['dia_spmv']}, peak device memory {peak:.2f} GiB, x "
        f"bitwise equal to path l = {same}; "
        f"{direct[0] if direct else 'no gen-direct line'}")
    check(rc == 0 and direct and "sharded" in direct[0]
          and "pallas-roll" in direct[0],
          "path ad took the sharded tier's K1")
    check(c["dia_spmv"] == 301 and sum(c.values()) == 301,
          "path ad: 301 launches of K1 and no other kernel")
    check(same, "path ad == path l, bitwise")
    return {"l": {k: counts["l-assembled"][k] + counts["l-operator"][k]
                  for k in counts["l-assembled"]}, "ad": c}


def reproducible_gather_paths(torch, K, tmp, irr):
    """(m): the single-device gather formats solved twice each to the
    same bits -- binned ELL with hub rows in its tail on the irregular
    matrix, and --spmv-format coo on a smaller one."""
    A = irr[0]
    row_nnz = np.diff(A.indptr)
    out = {}
    for tag, spec, extra in (("m-bell", IRREGULAR_SPEC, []),
                             ("m-coo", COO_SPEC, ["--spmv-format", "coo"])):
        argv = [spec, "--warmup", "0", "-q", "--comm", "none",
                "--manufactured-solution", "--residual-rtol", "1e-8",
                "--max-iterations", "20000"] + extra
        runs = []
        for k in range(2):
            x_out = os.path.join(tmp, f"{tag}{k}.bin")
            rc, text, c = run_cli(torch, K, argv + ["-o", x_out],
                                  f"{tag}-run{k}")
            check(rc == 0, f"path {tag} run {k} converged")
            runs.append((int(stat(text, "iterations").replace(",", "")),
                         read_x(x_out), stat(text, "total solver time")))
        same = runs[0][0] == runs[1][0] and np.array_equal(runs[0][1],
                                                            runs[1][1])
        hubs = (f", {int((row_nnz > 512).sum())} hub rows past the widest "
                f"bin (512; longest {int(row_nnz.max())})"
                if tag == "m-bell" else "")
        say(f"path {tag}: {spec}{hubs}: {runs[0][0]} / {runs[1][0]} "
            f"iterations, x bitwise equal across the two runs = {same}, "
            f"solver times {runs[0][2]} / {runs[1][2]}")
        check(same, f"path {tag}: the same iterations and bits twice")
        out[tag] = c
    return out


def multipart_paths(torch, K, tmp, base, b, csr, its_a, irr):
    """(e)-(h): the multi-part tier, every part stacked on the card."""
    from acg_tpu_torch.solvers.cg import CHUNK

    paths = {}
    mp = base + ["--nparts", str(NPARTS), "--manufactured-solution",
                 "--residual-rtol", "1e-8", "--max-iterations", "20000"]

    def true_rel_residual(A, rhs, x):
        return float(np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs))

    def launched_per_spmv(c, name, nspmv):
        # one launch per SpMV; the last chunk's frozen iterations launch
        # too (the flag is read once per CHUNK iterations)
        return nspmv <= c[name] <= nspmv + CHUNK

    # (e) classic f64, the one-sided transport on K6
    out_e = os.path.join(tmp, "e.bin")
    rc, text, c = run_cli(torch, K, mp + ["--comm", "dma", "-o", out_e],
                          "e-4part-dma-f64")
    its = int(stat(text, "iterations").replace(",", ""))
    ITS["e"] = its
    res = true_rel_residual(csr, b, read_x(out_e))
    say(f"path e: {its} iterations (single part: {its_a}), true relative "
        f"residual {res:.3e} (limit 1e-7), solver time "
        f"{stat(text, 'total solver time')}, partition "
        f"{stat(text, 'partition')}, halo exchanges "
        f"{stat(text, 'MPI_HaloExchange')}")
    check(rc == 0 and res <= 1e-7, "path e converged to 1e-7")
    check(abs(its - its_a) <= 2, "path e within 2 iterations of path a")
    check(launched_per_spmv(c, "halo_put", its + 1)
          and launched_per_spmv(c, "dia_spmv_batched", its + 1),
          "path e went through K6 and batched K1 once per SpMV")
    paths["e"] = c

    # (f) the same solve on the plain transport: the same bits move
    out_f = os.path.join(tmp, "f.bin")
    rc, text, c = run_cli(torch, K, mp + ["--comm", "xla", "-o", out_f],
                          "f-4part-xla-f64")
    its_f = int(stat(text, "iterations").replace(",", ""))
    same = np.array_equal(read_x(out_e), read_x(out_f))
    say(f"path f: {its_f} iterations, x bitwise equal to path e = {same}")
    check(rc == 0 and its_f == its and same,
          "path f (xla) == path e (dma) bitwise")
    check(c["halo_put"] == 0 and c["dia_spmv_batched"] == paths["e"][
        "dia_spmv_batched"], "path f: batched K1, no K6")
    paths["f"] = c

    # (g) pipelined f64 on the one-sided transport
    out = os.path.join(tmp, "g.bin")
    rc, text, c = run_cli(torch, K, mp + [
        "--comm", "dma", "--solver", "acg-pipelined", "-o", out],
        "g-4part-dma-pipelined-f64")
    its = int(stat(text, "iterations").replace(",", ""))
    ITS["g"] = its
    res = true_rel_residual(csr, b, read_x(out))
    say(f"path g: {its} iterations, true relative residual {res:.3e} "
        f"(limit 1e-6), solver time {stat(text, 'total solver time')}")
    check(rc == 0 and res <= 1e-6, "path g converged to 1e-6")
    check(launched_per_spmv(c, "halo_put", its + 2)
          and launched_per_spmv(c, "dia_spmv_batched", its + 2)
          and c["pipelined_update"] >= its,
          "path g went through K6, batched K1 and K5")
    paths["g"] = c

    # (h) an irregular matrix on a graph partition: binned-ELL local
    # blocks (plain PyTorch gathers), K6 for the halo; solved again, and
    # the two solutions must be the same bits
    A = irr[0]
    xsol = np.random.default_rng(42).standard_normal(A.shape[0])
    xsol /= np.linalg.norm(xsol)
    bh = A @ xsol
    argv_h = [IRREGULAR_SPEC, "--warmup", "0", "-q", "--nparts",
              str(NPARTS), "--partition-method", "graph", "--comm", "dma",
              "--manufactured-solution", "--residual-rtol", "1e-8",
              "--max-iterations", "20000"]
    out = os.path.join(tmp, "h.bin")
    rc, text, c = run_cli(torch, K, argv_h + ["-o", out],
                          "h-irregular-graph-f64")
    its = int(stat(text, "iterations").replace(",", ""))
    res = true_rel_residual(A, bh, read_x(out))
    say(f"path h: {IRREGULAR_SPEC} ({A.nnz:,} nonzeros) {its} iterations, "
        f"true relative residual {res:.3e} (limit 1e-7), partition "
        f"{stat(text, 'partition')}, solver time "
        f"{stat(text, 'total solver time')}")
    check(rc == 0 and res <= 1e-7, "path h converged to 1e-7")
    check(launched_per_spmv(c, "halo_put", its + 1),
          "path h went through K6 once per SpMV")
    # again through the library on the CLI's parts (its ingest and graph
    # partition are the first run's), from the CLI's own right-hand side
    from acg_tpu_torch.cli import synthesize_host_matrix
    b_cli = synthesize_host_matrix(IRREGULAR_SPEC).dsymv(xsol, epsilon=0.0)
    rc2, _, c2, _, its2, x2, _ = library_twin(
        torch, K, irr[1], b_cli, "h-irregular-graph-f64-again", comm="dma")
    same = np.array_equal(read_x(out), x2)
    say(f"path h again: {its2} iterations, x bitwise equal to the first "
        f"run = {same}")
    check(rc2 == 0 and its2 == its and same,
          "path h reproducible: the same iterations and bits twice")
    paths["h"] = c
    return paths


# -- phase 3 (u)-(y): tools, host oracles, the batched tier ----------------

HOST_SPEC = "gen:poisson2d:512"
NRHS = 8
# the batched paths (x) and (ab) run this many iterations, no tolerance,
# each held against its twin at the same count ((w) converges)
BATCH_ITS = 200
# block CG against the batched mode on the ill-conditioned family, at a
# quarter of the flagship's side: at 1024^2 its random columns took
# ~17,000 batched iterations (26 s) and block CG 9,327 trips (18 s)
ANISO_SPEC = f"gen:poisson2d:{FLAGSHIP // 4}"


def _device_format(text: str) -> str:
    m = re.search(r"device matrix: (\w+)", text)
    return m.group(1) if m else "not logged"


def tool_job(torch, K, tmp, b, csr):
    """(u), a child-process job (started once (a) wrote its x): the
    offline tools at full width and the permuted input, each a
    ``python -m acg_tpu_torch.tools...`` child: genmatrix (binary and
    text), mtxpartition --parts 4 on the binary file, mtx2bin --expand
    --partition on the text file with its .perm.mtx sidecar; then classic
    f64 on the permuted binary matrix with (a)'s right-hand side given in
    the original row order.  The solution comes back in the original
    order: within 1e-8 of (a)'s x, iterations within 1 of (a)'s, true
    residual <= 1e-7."""
    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx

    def job() -> dict:
        t0 = time.perf_counter()
        tb = os.path.join(tmp, "u-A.bin.mtx")
        tt = os.path.join(tmp, "u-A.mtx")
        part = os.path.join(tmp, "u-part.mtx")
        perm = os.path.join(tmp, "u-P.bin.mtx")
        steps = []
        for what, argv, stdout in (
                ("genmatrix --binary", ["genmatrix", "-n", str(FLAGSHIP),
                                        "--binary", "-o", tb], None),
                ("genmatrix", ["genmatrix", "-n", str(FLAGSHIP), "-o", tt],
                 None),
                (f"mtxpartition --parts {NPARTS}",
                 ["mtxpartition", tb, "--binary", "--parts", str(NPARTS)],
                 part),
                ("mtx2bin --expand --partition",
                 ["mtx2bin", "--expand", "--partition", part, tt, perm],
                 None)):
            ts = time.perf_counter()
            with open(stdout or os.devnull, "wb") as out:
                res = subprocess.run(
                    [sys.executable, "-m", f"acg_tpu_torch.tools.{argv[0]}",
                     *argv[1:]], cwd=HERE, env=CHILD_ENV, stdout=out,
                    stderr=subprocess.PIPE, text=False, timeout=MP_TIMEOUT)
            check(res.returncode == 0, f"path u: {what} "
                  f"({res.stderr.decode()[-500:]})")
            steps.append(f"{what} {time.perf_counter() - ts:.1f} s")
        check(os.path.exists(perm + ".perm.mtx")
              and os.path.exists(perm + ".bounds.mtx"),
              "path u: mtx2bin wrote the .perm.mtx and .bounds.mtx sidecars")
        bfile = os.path.join(tmp, "u-b.bin")
        write_mtx(bfile, vector_mtx(b), binary=True)
        out = os.path.join(tmp, "u-permuted.bin")
        rc, text, c, _ = proc_cli(
            [perm, bfile, "--binary", "--warmup", "0", "-q", "-v",
             "--residual-rtol", "1e-8", "--max-iterations", "20000", "-o",
             out], "u-permuted")
        its = int(stat(text, "iterations").replace(",", ""))
        x = read_x(out)
        res = float(np.linalg.norm(b - csr @ x) / np.linalg.norm(b))
        xa = read_x(os.path.join(tmp, "a.bin"))
        rel = float(np.linalg.norm(x - xa) / np.linalg.norm(xa))
        say(f"path u: tools {'; '.join(steps)}; the permuted solve: format "
            f"auto picked {_device_format(text)}, {its} iterations (path a: "
            f"{ITS['a']}), x vs path a's rel {rel:.3e} (limit 1e-8), true "
            f"relative residual {res:.3e} (limit 1e-7), solver time "
            f"{stat(text, 'total solver time')}, launches {c}; path u took "
            f"{time.perf_counter() - t0:.1f} s (a child-process job)")
        check(rc == 0 and abs(its - ITS["a"]) <= 1 and rel <= 1e-8
              and res <= 1e-7, "path u: the permuted solve is path a's")
        return {"u": c}

    return job


def host_paths(torch, K, tmp):
    """(v): the host oracles (--solver host, host-native, petsc) beside
    the device classic f64 solve on gen:poisson2d:512: the same
    iterations within 1, x within 1e-10 relative; the native core
    available on this machine; --buildinfo logged."""
    from acg_tpu_torch import _native, cli

    t0 = time.perf_counter()
    check(_native.available(), f"path v: the native host core built "
          f"({_native.build_error})")
    info = io.StringIO()
    with contextlib.redirect_stdout(info):
        check(cli.main(["--buildinfo"]) == 0, "path v: --buildinfo")
    for line in info.getvalue().splitlines():
        say(f"  buildinfo: {line}")
    argv = [HOST_SPEC, "--warmup", "0", "-q", "--manufactured-solution",
            "--residual-rtol", "1e-8", "--max-iterations", "20000"]
    runs = {}
    for solver in ("acg", "host", "host-native", "petsc"):
        rc, text, c, _, its, x, _ = solve_path(
            torch, K, tmp, argv + ["--solver", solver], f"v-{solver}")
        check(rc == 0, f"path v: --solver {solver} converged")
        runs[solver] = (its, x, stat(text, "total solver time"), c)
    its0, x0 = runs["acg"][:2]
    msg = []
    for solver, (its, x, tsolve, c) in runs.items():
        rel = float(np.linalg.norm(x - x0) / np.linalg.norm(x0))
        msg.append(f"{solver} {its} iterations, rel {rel:.2e}, "
                   f"{tsolve}")
        check(abs(its - its0) <= 1 and rel <= 1e-10,
              f"path v: --solver {solver} agrees with the device solve")
        if solver != "acg":
            check(sum(c.values()) == 0,
                  f"path v: --solver {solver} launched no kernel")
    say(f"path v: {HOST_SPEC}: " + "; ".join(msg)
        + f" (limits: iterations +-1, x 1e-10); path v took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"v": runs["acg"][3]}


def _batched_run(torch, K, tmp, argv, tag):
    """One --nrhs CLI run (with -v): (rc, stats text, launch counts,
    per-RHS iterations, the (n, B) solution)."""
    from acg_tpu_torch.io.mtxfile import read_mtx

    out = os.path.join(tmp, f"{tag}.bin")
    rc, text, c = run_cli(torch, K, argv + ["-v", "-o", out], tag)
    m = re.search(r"per-RHS iterations \[([\d, ]*)\]", text)
    iters = [int(v) for v in m.group(1).split(",")] if m else []
    X = None
    if os.path.exists(out):
        mx = read_mtx(out, binary=True)
        X = np.asarray(mx.vals, np.float64).reshape((mx.nrows, mx.ncols),
                                                    order="F")
    return rc, text, c, iters, X


def batched_paths(torch, K, tmp, base, csr, paths):
    """(w)-(y): the batched multi-RHS tier on the card (plain PyTorch:
    no kernel), then --nrhs 1 on the single-RHS path.  See the module
    docstring for each path's checks."""
    from acg_tpu_torch.io.generators import batched_rhs

    out = {}
    n = csr.shape[0]
    tol = ["--residual-rtol", "1e-8", "--max-iterations", "20000"]
    # manufactured columns, as path (a)'s: smooth right-hand sides.  (w)
    # runs to the tolerance (~2,100 iterations, each column stopped by
    # its own live flag); (x) runs a fixed BATCH_ITS iterations, each
    # path held against its twin at the same count
    fixed = ["--residual-rtol", "0", "--max-iterations", str(BATCH_ITS)]
    man = base + ["--nrhs", str(NRHS), "--manufactured-solution"]
    bat = man + fixed
    crit = dict(maxits=BATCH_ITS)
    conv = dict(maxits=20000, residual_rtol=1e-8)

    # (w) batched classic f64 to the tolerance against single-RHS solves
    # of its columns
    t0 = time.perf_counter()
    rc, text, c, iters_w, Xw = _batched_run(torch, K, tmp, man + tol,
                                            "w-batched")
    check(rc == 0 and len(iters_w) == NRHS, "path w converged")
    t_batched = stat(text, "total solver time")
    # the CLI's --seed 42 block: unit-norm columns xsol, B = A xsol
    xsol = np.random.default_rng(42).standard_normal((n, NRHS))
    xsol /= np.linalg.norm(xsol, axis=0, keepdims=True)
    B = csr @ xsol
    res_w = (np.linalg.norm(B - csr @ Xw, axis=0)
             / np.linalg.norm(B, axis=0))
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
    from acg_tpu_torch.solvers.batched import BatchedCGSolver
    Ad = device_matrix_from_csr(csr, dtype=torch.float64, device="cuda")
    # the same bits twice: the library's batched solve of the same block;
    # then the block at BATCH_ITS, the twin of (x)'s operator and jacobi
    again = BatchedCGSolver(Ad, device="cuda")
    same = np.array_equal(again.solve(B, criteria=StoppingCriteria(
        **conv)), Xw) and again.stats.batch["iterations"] == iters_w
    X_fixed = again.solve(B, criteria=StoppingCriteria(**crit))
    del again
    # the reference: each column solved alone by the single-RHS solver
    # (the library, on K1; launches outside a path run are not counted),
    # classic to the tolerance, pipelined at BATCH_ITS for (x)
    single, single_p = [], []
    for pipe, acc, kw in ((False, single, conv), (True, single_p, crit)):
        one = TorchCGSolver(Ad, device="cuda", pipelined=pipe)
        for j in range(NRHS):
            x1 = one.solve(B[:, j], criteria=StoppingCriteria(**kw))
            acc.append((one.stats.niterations, x1))
        del one
    del Ad
    rels = [float(np.linalg.norm(Xw[:, j] - x1) / np.linalg.norm(x1))
            for j, (_, x1) in enumerate(single)]
    say(f"path w: --nrhs {NRHS} classic f64 on {MAIN_SPEC}: per-RHS "
        f"iterations {iters_w}, single solves {[s[0] for s in single]}; "
        f"x vs the single solves, worst column rel {max(rels):.2e} "
        f"(limit 1e-9); true relative residuals max {res_w.max():.2e} "
        f"(limit 1e-7); the library's batched solve the same bits = "
        f"{same}; launches {c}; "
        f"batched solver time {t_batched}; path w took "
        f"{time.perf_counter() - t0:.1f} s")
    check(all(abs(a - s[0]) <= 1 for a, s in zip(iters_w, single)),
          "path w: each column's iterations within 1 of its single solve")
    check(max(rels) <= 1e-9, "path w: x within 1e-9 of the single solves")
    check(res_w.max() <= 1e-7, "path w: every column at its tolerance")
    check(same, "path w: the same bits twice")
    check(c.get("dia_spmv", 0) == 0 and c.get("pipelined_update", 0) == 0,
          "path w: no K1 or K5 launch on the batched tier")
    out["w"] = c

    # (x) pipelined, the operator, jacobi; block CG on the aniso family
    t0 = time.perf_counter()
    for tag, extra in (("x-pipelined", ["--solver", "acg-pipelined"]),
                       ("x-stencil", ["--operator", "stencil"]),
                       ("x-jacobi", ["--precond", "jacobi"])):
        rc, text, c, iters, X = _batched_run(torch, K, tmp, bat + extra,
                                             tag)
        check(rc == 0 and iters == [BATCH_ITS] * NRHS,
              f"path {tag} ran {BATCH_ITS} iterations a column")
        rel = float(np.linalg.norm(X - X_fixed) / np.linalg.norm(X_fixed))
        say(f"path {tag}: iterations {iters}, x vs (w)'s block at the same "
            f"count rel {rel:.2e}, {stat(text, 'total solver time')}, "
            f"launches {c}")
        if tag == "x-stencil":
            check(rel <= 1e-12, "path x: --operator stencil is (w)'s "
                  "classic block (x within 1e-12)")
        elif tag == "x-jacobi":
            # M = 4 I on the Poisson matrix scales every vector by a
            # power of two: (w)'s classic iterates
            check(rel <= 1e-9, "path x-jacobi: (w)'s classic block "
                  "within 1e-9")
        else:
            # the pipelined recurrence rounds otherwise: each column is
            # held against its single-RHS pipelined solve (K1, K5)
            relp = max(float(np.linalg.norm(X[:, j] - x1)
                             / np.linalg.norm(x1))
                       for j, (_, x1) in enumerate(single_p))
            say(f"path x-pipelined: x vs the single pipelined solves, "
                f"worst column rel {relp:.2e} (limit 1e-7)")
            check(relp <= 1e-7, "path x-pipelined: x within 1e-7 of the "
                  "single-RHS pipelined solves")
            out["x-pipelined-X"] = X
        check(sum(c.values()) == 0, f"path {tag}: no kernel launched")
        out[tag] = c
    XS["x-pipelined"] = out.pop("x-pipelined-X")
    aniso = [ANISO_SPEC, "--aniso", "0.01", "--warmup", "0", "-q",
             "--nrhs", str(NRHS)] + tol
    rc, text, c, iters_b, _ = _batched_run(torch, K, tmp, aniso,
                                           "x-aniso-batched")
    check(rc == 0, "path x: --aniso batched converged")
    tb = stat(text, "total solver time")
    rc, text, c, iters_k, Xk = _batched_run(torch, K, tmp, aniso
                                            + ["--block-cg"],
                                            "x-aniso-block")
    check(rc == 0, "path x: --block-cg converged")
    trips = int(stat(text, "block_iterations").replace(",", ""))
    from acg_tpu_torch.cli import synthesize_host_matrix
    Aa = synthesize_host_matrix(ANISO_SPEC, aniso=0.01).to_csr()
    Ba = batched_rhs(Aa.shape[0], NRHS, seed=42)
    res = (np.linalg.norm(Ba - Aa @ Xk, axis=0)
           / np.linalg.norm(Ba, axis=0))
    say(f"path x-block: {ANISO_SPEC} --aniso 0.01: batched "
        f"{sum(iters_b)} column iterations ({tb}), --block-cg {trips} "
        f"trips x {NRHS} = {trips * NRHS} "
        f"({stat(text, 'total solver time')}), per-column true residuals "
        f"max {res.max():.2e} (limit 1e-7); path x took "
        f"{time.perf_counter() - t0:.1f} s")
    check(trips * NRHS < sum(iters_b),
          "path x: block CG takes fewer column iterations")
    check(res.max() <= 1e-7, "path x: every block-CG column at its "
          "tolerance")
    out["x-block"] = c

    # (y) --nrhs 1 is the single-RHS path: (a) bit for bit
    t0 = time.perf_counter()
    rc, text, c, _, its, x, _ = solve_path(
        torch, K, tmp, base + ["--manufactured-solution", "--nrhs", "1"]
        + tol, "y-nrhs1")
    xa = read_x(os.path.join(tmp, "a.bin"))
    same = np.array_equal(x, xa)
    say(f"path y: --nrhs 1: {its} iterations (path a: {ITS['a']}), x "
        f"bitwise equal to path a = {same}, K1 launches "
        f"{c.get('dia_spmv', 0)} (path a: {paths['a']['dia_spmv']}); "
        f"{time.perf_counter() - t0:.1f} s")
    check(rc == 0 and same and its == ITS["a"]
          and c.get("dia_spmv") == paths["a"]["dia_spmv"],
          "path y: --nrhs 1 is path a")
    out["y"] = c
    return out


# -- phase 3 (z)-(ab): the CA recurrences and the batched multi-part tier --

def sstep_blocks_run(its: int, s: int, maxits: int) -> int:
    """The s-step blocks a converged solve of ``its`` iterations ran: the
    stop flag is read once every CHUNK // s blocks, and the frozen blocks
    of the last read's stretch build their bases too."""
    from acg_tpu_torch.solvers.cg import CHUNK
    per = max(1, CHUNK // s)
    live = -(-its // s)
    return min(-(-live // per) * per, -(-maxits // s))


def _resilience(text: str) -> tuple:
    """(breakdowns, restarts) from a stats block's resilience: line."""
    m = re.search(r"resilience: (\d+) breakdowns detected, (\d+) restarts",
                  text)
    return (int(m.group(1)), int(m.group(2))) if m else (0, 0)


def ca_paths(torch, K, tmp, base, b, csr):
    """(z)-(aa): the communication-avoiding recurrences at full width.
    (z) --algorithm sstep:4 and sstep:8 on the flagship f64: iterations
    within S of path (a)'s, K1 counted exactly ((2S-1) per block run, 1
    setup, 25 power iterations), no other kernel; sstep:4 with
    --operator stencil: the same iterations and bits with K7 where K1
    was; pipelined:2: converged to a true residual <= 1e-7 through its
    restarts, counted from the resilience: line; sstep:4 and pipelined:2
    solved again by the library's TorchCGSolver on the CLI's right-hand
    side: the same bits.  (aa) --nparts 4 --algorithm sstep:4 under
    --comm dma and xla: the same bits, K6 and batched K1 once per SpMV
    (counted exactly as in (z))."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

    out = {}
    mp = base + ["--manufactured-solution", "--residual-rtol", "1e-8"]
    maxits = 20000
    mp += ["--max-iterations", str(maxits)]
    # the CLI's own --manufactured-solution right-hand side, computed as
    # it computes it, for the library's solves of the same system
    xsol = np.random.default_rng(42).standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    b_cli = synthesize_host_matrix(MAIN_SPEC).dsymv(xsol, epsilon=0.0)
    Ad = device_matrix_from_csr(csr, dtype=torch.float64, device="cuda")

    def again(algorithm):
        s = TorchCGSolver(Ad, device="cuda", algorithm=algorithm)
        x = s.solve(b_cli, criteria=StoppingCriteria(maxits=maxits,
                                                     residual_rtol=1e-8))
        return s.stats.niterations, x

    runs = {}
    for tag, extra in (("z-sstep4", ["--algorithm", "sstep:4"]),
                       ("z-sstep8", ["--algorithm", "sstep:8"]),
                       ("z-sstep4-stencil", ["--algorithm", "sstep:4",
                                             "--operator", "stencil"])):
        runs[tag] = solve_path(torch, K, tmp, mp + extra, tag, b, csr)
    for tag, s in (("z-sstep4", 4), ("z-sstep8", 8)):
        rc, text, c, _, its, x, res = runs[tag]
        blocks = sstep_blocks_run(its, s, maxits)
        want = (2 * s - 1) * blocks + 1 + 25
        say(f"path {tag}: {its} iterations (path a: {ITS['a']}), true "
            f"relative residual {res:.3e} (limit 1e-7), solver time "
            f"{stat(text, 'total solver time')}; K1 launches "
            f"{c['dia_spmv']} ({2 * s - 1} x {blocks} blocks run + setup "
            f"1 + 25 power iterations = {want}), launches {c}")
        check(rc == 0 and res <= 1e-7, f"path {tag} converged to 1e-7")
        check(abs(its - ITS["a"]) <= s,
              f"path {tag}: iterations within S of path a's")
        check(c["dia_spmv"] == want and sum(c.values()) == want,
              f"path {tag}: K1 counted exactly, no other kernel")
        ITS[tag] = its
        out[tag] = c
    x4 = runs["z-sstep4"][5]
    its, x = again("sstep:4")
    same = its == ITS["z-sstep4"] and np.array_equal(x, x4)
    say(f"path z-sstep4 again (the library): {its} iterations, the same "
        f"bits = {same}")
    check(same, "path z: sstep:4 gives the same bits twice")
    rc, _, c, _, its, x, _ = runs["z-sstep4-stencil"]
    same = its == ITS["z-sstep4"] and np.array_equal(x, x4)
    k1 = out["z-sstep4"]["dia_spmv"]
    say(f"path z-sstep4-stencil: {its} iterations, x bitwise equal to "
        f"path z-sstep4 = {same}; K7 {c['stencil_spmv']} (K1 there: "
        f"{k1}), K1 {c['dia_spmv']}")
    check(rc == 0 and same, "path z: --operator stencil sstep:4 is the "
          "assembled solve, bit for bit")
    check(c["stencil_spmv"] == k1 and c["dia_spmv"] == 0,
          "path z: K7 launched where K1 was, and no K1")
    out["z-sstep4-stencil"] = c

    # p(l): its square-root breakdowns restart from the current iterate
    rc, text, c, _, its, x, res = solve_path(
        torch, K, tmp, mp + ["--algorithm", "pipelined:2"], "z-pl2", b, csr)
    nbd, nrs = _resilience(text)
    its2, x2 = again("pipelined:2")
    same = its2 == its and np.array_equal(x2, x)
    del Ad
    say(f"path z-pl2: --algorithm pipelined:2 {its} iterations (path a: "
        f"{ITS['a']}), {nbd} breakdowns, {nrs} restarts, true relative "
        f"residual {res:.3e} (limit 1e-7), solver time "
        f"{stat(text, 'total solver time')}, K1 {c['dia_spmv']}; again "
        f"(the library): the same bits = {same}; launches {c}")
    check(rc == 0 and res <= 1e-7, "path z-pl2 converged to 1e-7")
    check(nbd == nrs, "path z-pl2: every breakdown restarted")
    check(c["dia_spmv"] >= its + 26 and c["pipelined_update"] == 0,
          "path z-pl2 went through K1 (no K5: p(l) is not GV)")
    check(same, "path z-pl2: the same bits twice")
    ITS["z-pl2"] = its
    out["z-pl2"] = c

    # (aa) 4 stacked parts under each transport
    q = mp + ["--nparts", str(NPARTS), "--algorithm", "sstep:4"]
    dist = {comm: solve_path(torch, K, tmp, q + ["--comm", comm],
                             f"aa-4part-sstep4-{comm}", b, csr)
            for comm in ("dma", "xla")}
    rc, text, c, _, its, x, res = dist["dma"]
    rcx, _, cx, _, itsx, xx, _ = dist["xla"]
    want = 7 * sstep_blocks_run(its, 4, maxits) + 1 + 25
    same = its == itsx and np.array_equal(x, xx)
    say(f"path aa: --nparts {NPARTS} --algorithm sstep:4: {its} "
        f"iterations, true relative residual {res:.3e} (limit 1e-7), "
        f"solver time {stat(text, 'total solver time')}; K6 "
        f"{c['halo_put']} and batched K1 {c['dia_spmv_batched']} (want "
        f"{want}); --comm xla {itsx} iterations, x bitwise equal = {same}, "
        f"K6 {cx['halo_put']}, batched K1 {cx['dia_spmv_batched']}")
    check(rc == 0 and res <= 1e-7, "path aa converged to 1e-7")
    check(abs(its - ITS["a"]) <= 4, "path aa: within S of path a")
    check(c["halo_put"] == c["dia_spmv_batched"] == want,
          "path aa: K6 and batched K1 once per SpMV, counted exactly")
    check(rcx == 0 and same and cx["halo_put"] == 0
          and cx["dia_spmv_batched"] == want,
          "path aa: --comm xla gives the same bits")
    out["aa"] = {k: c[k] + cx[k] for k in c}
    return out


def dist_batched_paths(torch, K, tmp, base, csr, prob):
    """(ab): --nparts 4 --nrhs 8 on the flagship f64 (manufactured
    columns), classic and pipelined: each classic column against the
    library DistCGSolver's solve of it on the same 4 band parts
    (iterations within 1, x within 1e-9), the library
    BatchedDistCGSolver's solve of the same block the same bits as the
    CLI's, pipelined iterations within 1 % of classic and true residuals
    <= 1e-6; no kernel launched (the batched multi-part tier is plain
    PyTorch)."""
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.parallel.dist_batched import BatchedDistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria

    t0 = time.perf_counter()
    out = {}
    n = csr.shape[0]
    crit = StoppingCriteria(maxits=BATCH_ITS)
    bat = base + ["--nparts", str(NPARTS), "--nrhs", str(NRHS),
                  "--manufactured-solution", "--residual-rtol", "0",
                  "--max-iterations", str(BATCH_ITS)]
    rc, text, c, iters, X = _batched_run(torch, K, tmp, bat, "ab-4part-nrhs")
    check(rc == 0 and iters == [BATCH_ITS] * NRHS,
          f"path ab ran {BATCH_ITS} iterations a column")
    xsol = np.random.default_rng(42).standard_normal((n, NRHS))
    xsol /= np.linalg.norm(xsol, axis=0, keepdims=True)
    B = csr @ xsol
    again = BatchedDistCGSolver(prob, device="cuda")
    same = np.array_equal(again.solve(B, criteria=crit), X) and \
        again.stats.batch["iterations"] == iters
    del again
    one = DistCGSolver(prob, device="cuda")
    single = []
    for j in range(NRHS):
        x1 = one.solve(B[:, j], criteria=crit)
        single.append((one.stats.niterations, x1))
    del one
    rels = [float(np.linalg.norm(X[:, j] - x1) / np.linalg.norm(x1))
            for j, (_, x1) in enumerate(single)]
    say(f"path ab: --nparts {NPARTS} --nrhs {NRHS} classic f64: per-RHS "
        f"iterations {iters}, stacked single solves "
        f"{[s[0] for s in single]}; x vs them, worst column rel "
        f"{max(rels):.2e} (limit 1e-9); the library's batched solve the "
        f"same bits = {same}; "
        f"solver time {stat(text, 'total solver time')}; launches {c}")
    check(all(a == s[0] for a, s in zip(iters, single)),
          "path ab: each column's iterations its single solve's")
    check(max(rels) <= 1e-9, "path ab: x within 1e-9 of the single solves")
    check(same, "path ab: the same bits twice")
    check(sum(c.values()) == 0,
          "path ab: no kernel launched on the batched multi-part tier")
    out["ab"] = c
    rc, text, c, iters_p, Xp = _batched_run(
        torch, K, tmp, bat + ["--solver", "acg-pipelined"],
        "ab-4part-nrhs-pipelined")
    # its twin: the single-device batched pipelined solve of path x
    Xx = XS["x-pipelined"]
    rel = float(np.linalg.norm(Xp - Xx) / np.linalg.norm(Xx))
    say(f"path ab-pipelined: per-RHS iterations {iters_p}, x vs path "
        f"x-pipelined rel {rel:.2e} (limit 1e-7), solver time "
        f"{stat(text, 'total solver time')}, launches {c}; path ab took "
        f"{time.perf_counter() - t0:.1f} s")
    check(rc == 0 and iters_p == [BATCH_ITS] * NRHS and rel <= 1e-7,
          "path ab-pipelined: path x-pipelined's x within 1e-7 at the "
          "same count")
    check(sum(c.values()) == 0, "path ab-pipelined: no kernel launched")
    out["ab-pipelined"] = c
    return out


# -- phase 3 (ac)-(ae): the fused multi-part tier and the sharded tier ------

def fused_dist_paths(torch, K, tmp, base, csr, prob, irr):
    """(ac): --nparts 4 --kernels fused, the classic and pipelined loops
    over the interior/border overlapped SpMV (the halo
    exchange on a side stream beside K1): classic f64 under dma through
    the CLI, then through DistCGSolver on the same band parts and
    right-hand side under dma again and under xla, each with path (e)'s
    iterations and bits, batched K1 and (dma) K6 once per SpMV;
    pipelined under dma against (g); --operator stencil against (k) with
    stacked K7; ELL local blocks on a graph partition against the
    unsplit tier; and path (h)'s binned-ELL blocks refused by name."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria
    from acg_tpu_torch.solvers.cg import CHUNK

    mp = base + ["--nparts", str(NPARTS), "--manufactured-solution",
                 "--residual-rtol", "1e-8", "--max-iterations", "20000",
                 "--kernels", "fused"]
    x_e = read_x(os.path.join(tmp, "e.bin"))
    out = {}

    def per_spmv(c, name, nspmv):
        return nspmv <= c[name] <= nspmv + CHUNK

    def api(tag, comm, pipelined=False):
        """One solve of the CLI's right-hand side through DistCGSolver,
        the launch counters reset just before and read just after."""
        s = DistCGSolver(prob, comm=comm, kernels="fused",
                         pipelined=pipelined, device=torch.device("cuda"))
        K.reset_launches()
        t0 = time.perf_counter()
        x = s.solve(b_cli, criteria=StoppingCriteria(maxits=20000,
                                                     residual_rtol=1e-8))
        torch.cuda.synchronize()
        c = dict(K.launches)
        say(f"path {tag}: DistCGSolver(comm={comm!r}, kernels='fused', "
            f"pipelined={pipelined}) wall {time.perf_counter() - t0:.1f} s, "
            f"launches {c}")
        return s.stats.niterations, x, c

    # the CLI's --manufactured-solution right-hand side, as it makes it
    xsol = np.random.default_rng(42).standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    b_cli = synthesize_host_matrix(MAIN_SPEC).dsymv(xsol)
    x_out = os.path.join(tmp, "ac-dma.bin")
    rc, text, c = run_cli(torch, K, mp + ["--comm", "dma", "-o", x_out],
                          "ac-dma")
    runs = {"ac-dma": (rc, int(stat(text, "iterations").replace(",", "")),
                       read_x(x_out), c)}
    for tag, comm in (("ac-dma-again", "dma"), ("ac-xla", "xla")):
        its, x, c = api(tag, comm)
        runs[tag] = (0, its, x, c)
    for tag, (rc, its, x, c) in runs.items():
        same = np.array_equal(x, x_e)
        say(f"path {tag}: {its} iterations (path e: {ITS['e']}), x bitwise "
            f"equal to path e = {same}")
        check(rc == 0 and its == ITS["e"] and same,
              f"path {tag} == path e: iterations and bits")
        k6 = its + 1 if "dma" in tag else 0
        check(per_spmv(c, "dia_spmv_batched", its + 1)
              and (per_spmv(c, "halo_put", k6) if k6 else
                   c["halo_put"] == 0)
              and c["pipelined_update"] == 0,
              f"path {tag}: batched K1 once per SpMV, K6 "
              f"{'once per SpMV' if k6 else 'never'}")
        out[tag] = c
    check(np.array_equal(runs["ac-dma"][2], runs["ac-dma-again"][2]),
          "path ac: the same bits twice")

    # pipelined on the one-sided transport, against path (g)
    its, xp, c = api("ac-pipelined", "dma", pipelined=True)
    xg = read_x(os.path.join(tmp, "g.bin"))
    rel = float(np.linalg.norm(xp - xg) / np.linalg.norm(xg))
    say(f"path ac-pipelined: {its} iterations (path g: {ITS['g']}), x vs "
        f"path g rel {rel:.3e} (limit 1e-10; bitwise equal = "
        f"{np.array_equal(xp, xg)}), K5 {c['pipelined_update']}, K6 "
        f"{c['halo_put']}, batched K1 {c['dia_spmv_batched']}")
    check(its == ITS["g"] and rel <= 1e-10,
          "path ac-pipelined: path g's iterations, x within 1e-10")
    check(c["pipelined_update"] >= its and per_spmv(c, "halo_put", its + 2)
          and per_spmv(c, "dia_spmv_batched", its + 2),
          "path ac-pipelined went through K5, K6 and batched K1")
    out["ac-pipelined"] = c

    # matrix-free local blocks: stacked K7 in place of K1, against (k)
    x_out = os.path.join(tmp, "ac-stencil.bin")
    rc, text, c = run_cli(torch, K, mp + ["--comm", "dma", "--operator",
                                          "stencil", "-o", x_out],
                          "ac-stencil-dma")
    its = int(stat(text, "iterations").replace(",", ""))
    same = np.array_equal(read_x(x_out), read_x(os.path.join(tmp, "k.bin")))
    say(f"path ac-stencil: {its} iterations, x bitwise equal to path k = "
        f"{same}; stacked K7 {c['stencil_spmv_batched']}, K6 "
        f"{c['halo_put']}, batched K1 {c['dia_spmv_batched']}")
    check(rc == 0 and its == ITS["e"] and same,
          "path ac-stencil == path k: iterations and bits")
    check(per_spmv(c, "stencil_spmv_batched", its + 1)
          and per_spmv(c, "halo_put", its + 1)
          and c["dia_spmv_batched"] == 0,
          "path ac-stencil: stacked K7 and K6 once per SpMV, no K1")
    out["ac-stencil"] = c

    # ELL local blocks on a graph partition (no K1: the gathers run on
    # the compute stream), against the unsplit tier
    argv = [HOST_SPEC, "--warmup", "0", "-q", "--nparts", str(NPARTS),
            "--partition-method", "graph", "--comm", "dma",
            "--manufactured-solution", "--residual-rtol", "1e-8",
            "--max-iterations", "20000"]
    runs = {}
    for tag, kern in (("ac-ell-fused", "fused"), ("ac-ell-auto", "auto")):
        x_out = os.path.join(tmp, f"{tag}.bin")
        rc, text, c = run_cli(torch, K, argv + ["--kernels", kern, "-o",
                                                x_out], tag)
        check(rc == 0, f"path {tag} converged")
        runs[tag] = (int(stat(text, "iterations").replace(",", "")),
                     read_x(x_out), c)
    (i1, x1, c1), (i2, x2, _) = runs["ac-ell-fused"], runs["ac-ell-auto"]
    same = i1 == i2 and np.array_equal(x1, x2)
    say(f"path ac-ell: {HOST_SPEC} graph partition, fused {i1} / unsplit "
        f"{i2} iterations, x bitwise equal = {same}; K6 {c1['halo_put']}, "
        f"batched K1 {c1['dia_spmv_batched']}")
    check(same and per_spmv(c1, "halo_put", i1 + 1)
          and c1["dia_spmv_batched"] == 0,
          "path ac-ell: ELL blocks, the unsplit bits, K6 once per SpMV")
    out["ac-ell"] = c1

    # path (h)'s binned-ELL local blocks have no per-row form: refused
    _, iprob = irr
    try:
        DistCGSolver(iprob, comm="dma", kernels="fused",
                     device=torch.device("cuda"))
        msg = None
    except ValueError as e:
        msg = str(e)
    say(f"path ac-h: {iprob.local.format} local blocks with --kernels "
        f"fused: {msg}")
    check(iprob.local.format == "binnedell" and msg is not None
          and "kernels='fused' needs DIA, ELL or matrix-free" in msg,
          "path ac-h: binned ELL refused by name")
    return out


def north_star_path(torch, K, tmp):
    """(ae): the north star, gen:poisson3d:512 --dtype f32
    --manufactured-solution --refine --residual-rtol 1e-9 on the sharded
    gen-direct tier: the analytic spot check of the device-drawn b under
    1e-5, converged, K1 alone at least once per inner iteration and
    pass, the df64 error norm under 1e-9, passes and inner iterations.
    Beside it the same refine through the API of the same x with an
    f32-rounded b (``manufactured``, not ``manufactured_df``): its error
    must lie above the limit, so the limit tells a df64 b from an f32
    one."""
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver
    from acg_tpu_torch.solvers import StoppingCriteria

    spec = f"gen:poisson3d:{DIRECT_N}"
    limit = 1e-9
    torch.cuda.reset_peak_memory_stats()
    rc, text, c = run_cli(torch, K, [
        spec, "--dtype", "f32", "--manufactured-solution", "--refine",
        "--residual-rtol", "1e-9", "--max-iterations", "20000",
        "--warmup", "0", "-q", "-v"], "ae-north-star")
    dev = float(text.split("max rel dev ")[1].split()[0])
    err = [ln for ln in text.splitlines() if ln.startswith("error 2-norm:")]
    passes = [ln for ln in text.splitlines() if ln.startswith("refine:")]
    # main_path runs (ae) while the child-process jobs share the card and
    # the host: its solver time is a loaded one; the peak is this
    # process's allocator's alone (the jobs are other processes, and
    # (ah)'s draw in this one runs before them)
    say(f"path ae: {spec} f32 --refine: spot check max rel dev {dev:.3e} "
        f"(limit 1e-5); {passes[0] if passes else 'no refine line'}; "
        f"{err[0] if err else 'no error line'}; solver time "
        f"{stat(text, 'total solver time')} (under the child jobs' load); "
        f"residual {stat(text, 'residual 2-norm')} of "
        f"{stat(text, 'initial residual 2-norm')}; K1 {c['dia_spmv']}; "
        f"this process's peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(dev < 1e-5, "path ae: the spot check")
    check(rc == 0 and bool(err) and bool(passes), "path ae converged")
    words = passes[0].split()
    npass, inner = int(words[1]), int(words[3])
    check(c["dia_spmv"] >= inner + npass
          and sum(c.values()) == c["dia_spmv"],
          f"path ae: K1 ({c['dia_spmv']}) at least once per inner "
          f"iteration and pass ({inner} + {npass}), no other kernel")
    e = float(err[0].split(":")[1])
    check(np.isfinite(e) and e < limit,
          f"path ae: the df64 error norm under {limit:g}")
    s = build_sharded_poisson_solver(DIRECT_N, 3, dtype=torch.float32,
                                     device=torch.device("cuda"))
    xsol, b = s.manufactured(seed=42)
    t0 = time.perf_counter()
    xh, xl = s.solve_refined(b, criteria=StoppingCriteria(
        maxits=20000, residual_rtol=1e-9))
    e32 = s.error_norms_df(xh, xl, xsol)[1]
    say(f"path ae-f32b: the same x with an f32-rounded b: "
        f"{s.stats.nrefine} passes, {s.stats.niterations} inner "
        f"iterations, {time.perf_counter() - t0:.2f} s, error 2-norm "
        f"{e32:.4g} against {e:.4g} with the df64 b (limit {limit:g})")
    check(e32 > limit, f"path ae-f32b: an f32-rounded b's error above "
                       f"{limit:g}")
    del s, xsol, b, xh, xl
    torch.cuda.empty_cache()
    return {"ae": c}


# -- phase 3 (ai)-(aj): the observability tier on the flagship ------------

PROFILE_REPS = 3   # --profile-ops REPS of path (ai)
OBS_WINDOW = 512   # --telemetry-window of path (ai)
OBS_EVERY = 500    # --progress of path (ai)


def _script(name, *argv):
    """One of the reference's checking scripts on a file: (rc, output)."""
    res = subprocess.run([sys.executable, os.path.join("scripts", name),
                          *argv], cwd=HERE, capture_output=True,
                         text=True, timeout=300, env=CHILD_ENV)
    return res.returncode, (res.stdout + res.stderr).strip()


def _beat_iterations(text: str) -> list:
    """The iterations the --progress heartbeat lines name, in order."""
    return [int(ln.split(": iteration ")[1].split(":")[0])
            for ln in text.splitlines()
            if ": iteration " in ln and "residual 2-norm" in ln]


def _launches_per_iteration(torch, s, b, nits: int = 100,
                            kernels_only: bool = False) -> float:
    """Device launches an iteration of solver ``s``'s unbounded solve of
    ``b`` under torch.profiler (setup included), as phase 4 counts
    them; ``kernels_only`` leaves out the copies and fills."""
    from torch.profiler import ProfilerActivity, profile

    from acg_tpu_torch.solvers import StoppingCriteria

    s.solve(b, criteria=StoppingCriteria(maxits=10))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.solve(b, criteria=StoppingCriteria(maxits=nits))
        torch.cuda.synchronize()
    skip = ("Activity Buffer",) + (("Memcpy", "Memset") if kernels_only
                                   else ())
    n = sum(ev.count for ev in prof.key_averages()
            if ev.device_type != torch.autograd.DeviceType.CPU
            and not ev.key.startswith(skip))
    return n / nits


def observability_paths(torch, K, tmp, paths):
    """(ai) path (a) with every observability flag armed: x and K1's
    launches as (a)'s, the 512-record convergence log ending at the last
    iteration, the heartbeat at each 500, the capture's in-solve gemv
    (K1) seconds, the metrics textfile, manifest and timeline through
    the reference's checkers; the armed against the off rate and
    launches an iteration.  (aj) path (e) under --trace/--timeline: x
    and launches as (e)'s, in-solve seconds of K1 batched (gemv), K6
    (halo, kind dma) and the per-part dot (dot), one timeline pid a
    part.  A missing or empty capture fails."""
    from acg_tpu_torch import telemetry
    from acg_tpu_torch.solvers.profile import INNER

    t_phase = time.perf_counter()
    out = {}
    d = os.path.join(tmp, "obs")
    os.makedirs(d)
    f = {k: os.path.join(d, v) for k, v in (
        ("x", "ai.bin"), ("conv", "ai.jsonl"), ("stats", "ai.json"),
        ("prom", "ai.prom"), ("status", "ai.status"), ("hist", "hist"),
        ("trace", "trace-ai"), ("tl", "ai-timeline.json"))}
    rc, text, c = run_cli(torch, K, [
        MAIN_SPEC, "--warmup", "1", "-q", "--manufactured-solution",
        "--residual-rtol", "1e-8", "--max-iterations", "20000",
        "-o", f["x"], "--convergence-log", f["conv"],
        "--telemetry-window", str(OBS_WINDOW), "--progress",
        str(OBS_EVERY), "--stats-json", f["stats"], "--metrics-file",
        f["prom"], "--status-file", f["status"], "--history", f["hist"],
        "--slo", "iters=100000", "--profile-ops", str(PROFILE_REPS),
        "--trace", f["trace"], "--timeline", f["tl"]], "ai-observed")
    check(rc == 0, "path ai exit 0")
    its = int(stat(text, "iterations").replace(",", ""))
    same = np.array_equal(read_x(f["x"]),
                          read_x(os.path.join(tmp, "a.bin")))
    check(its == ITS["a"] and same,
          f"path ai: path a's iterations and bits ({its}, bitwise {same})")
    # the warm-up and timed solves are (a)'s solve twice; the replay's
    # gemv chains run 5 INNER launches (INNER and 4 INNER) a rep, plus
    # one untimed chain each
    replay = 5 * INNER * (PROFILE_REPS + 1)
    check(c["dia_spmv"] == 2 * paths["a"]["dia_spmv"] + replay,
          f"path ai: K1 counted as in (a): {c['dia_spmv']} = 2 x "
          f"{paths['a']['dia_spmv']} + {replay}")
    meta, recs = telemetry.read_convergence_log(f["conv"])
    block = stat(text, "residual 2-norm")
    check(len(recs) == OBS_WINDOW and recs[-1]["it"] == its - 1
          and meta["wrapped"] and f"{recs[-1]['rnrm2']:.15g}" == block,
          f"path ai: {len(recs)} records ending at iteration "
          f"{recs[-1]['it']}, last rnrm2 {recs[-1]['rnrm2']!r} against "
          f"the block's {block}")
    beats = _beat_iterations(text)
    check(beats == list(range(OBS_EVERY, its + 1, OBS_EVERY)),
          f"path ai: heartbeat iterations {beats}, once each in order")
    doc = json.load(open(f["stats"]))
    tr = doc["stats"]["tracing"]
    ins = tr.get("op_seconds_in_solve", {})
    check(tr.get("available") is True and ins.get("gemv", 0) > 0
          and "gemv" in tr.get("ops_source", ""),
          f"path ai: the capture measured gemv in the solve window "
          f"({tr.get('why', '')}{ins})")
    replay_line = [ln for ln in text.splitlines()
                   if ln.startswith("per-op replay (seconds a call)")]
    check(bool(replay_line), "path ai: the --profile-ops replay ran")
    per_call = dict(kv.split() for kv in
                    replay_line[0].split(": ", 1)[1].split(", "))
    k1_timed = paths["a"]["dia_spmv"]
    say(f"path ai: --profile-ops gemv {float(per_call['gemv']) * 1e6:.1f} "
        f"us a call (K1 85.4 us in PERF.md); capture: gemv "
        f"{ins.get('gemv', 0.0):.6f} s in the solve window over "
        f"{k1_timed} K1 launches = "
        f"{ins.get('gemv', 0.0) / max(k1_timed, 1) * 1e6:.1f} us each; "
        f"in-solve {ins}; phases {tr.get('phase_seconds')}")
    rc_m, msg = _script("check_metrics_textfile.py", f["prom"],
                        "--require", "acg_solves_total")
    mem = [float(ln.split()[-1]) for ln in open(f["prom"])
           if ln.startswith("acg_device_memory_bytes{")]
    check(rc_m == 0 and mem and max(mem) > 0,
          f"path ai: metrics textfile ({msg}; device memory {mem})")
    kind = doc["manifest"]["backend"]["device_kind"]
    check(kind == torch.cuda.get_device_name(0),
          f"path ai: the manifest names the card ({kind})")
    rc_t, msg = _script("check_timeline.py", f["tl"])
    check(rc_t == 0, f"path ai: timeline ({msg})")
    status = json.load(open(f["status"]))
    check(status["phase"] == "exited" and doc["stats"]["slo"]["breached"]
          is False and os.listdir(f["hist"]),
          "path ai: status file, --slo verdict and history ledger")
    out["ai"] = c
    _armed_rates(torch)
    aj = _observed_stacked(torch, K, tmp, d, paths)
    out["aj"] = aj
    say(f"paths ai-aj took {time.perf_counter() - t_phase:.1f} s")
    return out


def _armed_rates(torch):
    """Classic f64 at 2048^2, 1000 iterations after 50, with the ring and
    heartbeat armed against off, in turns (off, armed, armed, off), and
    the device launches an iteration of each."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

    dev = torch.device("cuda", 0)
    A = device_matrix_from_csr(synthesize_host_matrix(MAIN_SPEC).to_csr(),
                               dtype=torch.float64, device=dev)
    b = np.ones(A.nrows)
    rates = {"off": [], "armed": []}
    for turn in ("off", "armed", "armed", "off"):
        kw = {} if turn == "off" else {"trace": OBS_WINDOW,
                                       "progress": OBS_EVERY}
        s = TorchCGSolver(A, device=dev, **kw)
        with contextlib.redirect_stderr(io.StringIO()):
            s.solve(b, criteria=StoppingCriteria(maxits=50))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve(b, criteria=StoppingCriteria(maxits=1000))
            torch.cuda.synchronize()
        rates[turn].append(1000 / (time.perf_counter() - t0))
    with contextlib.redirect_stderr(io.StringIO()):
        lpi = {turn: _launches_per_iteration(torch, TorchCGSolver(
            A, device=dev, **kw), b) for turn, kw in (
            ("off", {}), ("armed", {"trace": OBS_WINDOW,
                                    "progress": OBS_EVERY}))}
    say(f"path ai rates, classic f64 {MAIN_SPEC}: off "
        f"{[round(r, 1) for r in rates['off']]} iters/s, ring and "
        f"heartbeat armed {[round(r, 1) for r in rates['armed']]}; "
        f"device launches an iteration off {lpi['off']:.2f}, armed "
        f"{lpi['armed']:.2f}; {device_line(torch)}")
    check(lpi["off"] < lpi["armed"] <= lpi["off"] + 8,
          "path ai: the armed loop adds at most 8 launches an iteration")


def _observed_stacked(torch, K, tmp, d, paths):
    """(aj): path (e) with --trace/--timeline/--stats-json/
    --convergence-log."""
    f = {k: os.path.join(d, v) for k, v in (
        ("x", "aj.bin"), ("conv", "aj.jsonl"), ("stats", "aj.json"),
        ("trace", "trace-aj"), ("tl", "aj-timeline.json"))}
    rc, text, c = run_cli(torch, K, [
        MAIN_SPEC, "--warmup", "0", "-q", "--nparts", str(NPARTS),
        "--comm", "dma", "--manufactured-solution", "--residual-rtol",
        "1e-8", "--max-iterations", "20000", "-o", f["x"],
        "--trace", f["trace"], "--timeline", f["tl"], "--stats-json",
        f["stats"], "--convergence-log", f["conv"]], "aj-observed")
    check(rc == 0, "path aj exit 0")
    its = int(stat(text, "iterations").replace(",", ""))
    same = np.array_equal(read_x(f["x"]),
                          read_x(os.path.join(tmp, "e.bin")))
    check(its == ITS["e"] and same,
          f"path aj: path e's iterations and bits ({its}, bitwise {same})")
    for k in ("dia_spmv_batched", "halo_put", "part_dot"):
        check(c[k] == paths["e"][k],
              f"path aj: {k} launched as in (e) ({c[k]})")
    tr = json.load(open(f["stats"]))["stats"]["tracing"]
    ins = tr.get("op_seconds_in_solve", {})
    kinds = tr.get("collective_kind_seconds", {})
    check(tr.get("available") is True and ins.get("gemv", 0) > 0
          and ins.get("halo", 0) > 0 and ins.get("dot", 0) > 0
          and kinds.get("dma", 0) > 0,
          f"path aj: in-solve gemv/halo/dot and dma seconds "
          f"({tr.get('why', '')}{ins}, kinds {kinds})")
    check("overlap_efficiency:" in text,
          "path aj: the stats block prints overlap_efficiency")
    tl = json.load(open(f["tl"]))
    pids = {e["pid"] for e in tl["traceEvents"]}
    rc_t, msg = _script("check_timeline.py", f["tl"])
    check(len(pids) == NPARTS and rc_t == 0,
          f"path aj: timeline pids {sorted(pids)} ({msg})")
    def per(op, k):
        return ins.get(op, 0.0) / max(c[k], 1) * 1e6

    say(f"path aj: in-solve {ins}; gemv {per('gemv', 'dia_spmv_batched'):.1f}"
        f" us a batched K1, halo {per('halo', 'halo_put'):.1f} us a K6, "
        f"dot {per('dot', 'part_dot'):.1f} us a part_dot "
        f"(launch counts of the solve); overlap efficiency "
        f"{tr.get('overlap_efficiency')}, exposed "
        f"{tr.get('exposed_collective_seconds')} s; phases "
        f"{tr.get('phase_seconds')}")
    return c


# -- phase 3 (ak)-(ap): the robustness tier on the flagship ---------------

ROBUST_TOL = ["--residual-rtol", "1e-8", "--max-iterations", "20000"]
CKPT_EVERY = 500     # --ckpt-every of paths (ar) and (au)
CRASH_AT = 1200      # crash:exit@ of paths (ar), (au) and (aw)
RECOVER_RUNS = 3     # timed solves of each phase-4 --recover rate
SOAK_SOLVES = 8      # --soak of path (ap): its baseline of 3 and 5 judged


def _fault_env():
    """The injector's env var cleared (the CLI exports it while a run is
    armed and restores it after; a child must not inherit one)."""
    from acg_tpu_torch import faults
    os.environ.pop(faults.ENV_VAR, None)
    faults.install(None)


def robustness_paths(torch, K, tmp, base, b, csr, prob, paths):
    """(ak)-(ap): the robustness tier at the flagship's width.  (ak)
    classic f64 with spmv:nan@7 under --recover: one breakdown at
    iteration 8 (the fault's 0-based 7), one restart, converged, K1
    counted, its x the library twin's bits (the same fault through the
    API).  (al) pipelined with dot:neg@5 under --recover: the detecting
    loop runs K5's flagged form (launches counted), one restart,
    converged.  (am) --abft --audit-every 8 with sdc:flip@7: the
    checksum trips at iteration 7 (one ABFT trip, breakdown at 8); a
    clean --abft --audit-every 100 solve: no trip, (a)'s iterations and
    x bits.  ((an), the crash and the manual --resume, is path (au)'s
    first supervised run since the supervisor was ported.)  (ao) 4 stacked
    parts under --comm dma with halo:nan@3 --recover: one restart on
    the CLI, and, through the API with the fault kept armed while the
    transport is dma (a link that keeps corrupting) and the policy
    naming the rung (``fallback_comm=True``: on the card it is off
    unless named), the transport rung retiring dma for xla.  (ap) --soak
    8 --fail-on-drift 50: exit 0 and no drift; --soak 5 with
    solve:slow@3:secs=3 on the quarter-width matrix: exit 7."""
    from acg_tpu_torch import faults
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
    from acg_tpu_torch.solvers.resilience import RecoveryPolicy

    t_phase = time.perf_counter()
    out = {}
    _fault_env()
    man = base + ["--manufactured-solution"] + ROBUST_TOL
    xa = read_x(os.path.join(tmp, "a.bin"))

    def true_rel(x):
        return float(np.linalg.norm(b - csr @ x) / np.linalg.norm(b))

    # (ak) spmv:nan@7 --recover, and its library twin
    rc, text, c, _, its, x, _ = solve_path(
        torch, K, tmp, man + ["--fault-inject", "spmv:nan@7",
                              "--recover"], "ak-spmv-nan-recover")
    bd = _resilience(text)
    Ad = device_matrix_from_csr(csr, dtype=torch.float64, device="cuda")
    twin = TorchCGSolver(Ad, device="cuda", recovery=RecoveryPolicy())
    with faults.injected("spmv:nan@7"):
        xt = twin.solve(b, criteria=StoppingCriteria(maxits=20000,
                                                     residual_rtol=1e-8))
    same = (np.array_equal(x, xt) and twin.stats.niterations == its
            and twin.stats.nfallbacks == 0)
    del twin
    rel = float(np.linalg.norm(x - xa) / np.linalg.norm(xa))
    say(f"path ak: {its} iterations (a: {ITS['a']}), breakdowns/restarts "
        f"{bd}, '{'breakdown detected at iteration 8' in text}' logged, "
        f"true relative residual {true_rel(x):.3e}, x vs (a) rel "
        f"{rel:.3e} (a restart changes the trajectory: each converged "
        f"to its tolerance), the library twin's bits = {same}; K1 "
        f"{c['dia_spmv']}")
    check(rc == 0 and bd == (1, 1)
          and "breakdown detected at iteration 8" in text
          and true_rel(x) <= 1e-7 and same and c["dia_spmv"] >= its,
          "path ak: one breakdown at 8, one restart, converged, the "
          "library twin's bits")
    ITS["ak"] = its
    out["ak"] = c

    # (al) pipelined dot:neg@5 --recover: K5's flagged form
    rc, text, c, _, its, x, _ = solve_path(
        torch, K, tmp, man + ["--solver", "acg-pipelined", "--fault-inject",
                              "dot:neg@5", "--recover"],
        "al-pipelined-dot-neg-recover")
    bd = _resilience(text)
    say(f"path al: {its} iterations (b: {ITS['b']}), breakdowns/restarts "
        f"{bd}, true relative residual {true_rel(x):.3e} (limit 1e-6); "
        f"K5 {c['pipelined_update']}, K1 {c['dia_spmv']}")
    check(rc == 0 and bd == (1, 1)
          and "breakdown detected at iteration 6" in text
          and true_rel(x) <= 1e-6 and c["pipelined_update"] >= its,
          "path al: one breakdown at 6, one restart, converged on K5's "
          "flagged form")
    out["al"] = c

    # (am) ABFT: sdc:flip@7 detected at 7; a clean audited solve
    rc, text, c, _, its, x, _ = solve_path(
        torch, K, tmp, man + ["--abft", "--audit-every", "8",
                              "--fault-inject", "sdc:flip@7"],
        "am-abft-sdc-flip")
    bd = _resilience(text)
    trips = re.search(r"ntrips: (\d+)", text)
    say(f"path am: {its} iterations, breakdowns/restarts {bd}, ABFT trips "
        f"{trips.group(1) if trips else None}, true relative residual "
        f"{true_rel(x):.3e}; K1 {c['dia_spmv']}")
    check(rc == 0 and bd == (1, 1) and trips and int(trips.group(1)) == 1
          and "breakdown detected at iteration 8" in text
          and true_rel(x) <= 1e-7,
          "path am: the flipped element detected at iteration 7 (one "
          "trip, breakdown at 8), recovered")
    out["am"] = c
    rc, text, c, _, its, x, _ = solve_path(
        torch, K, tmp, man + ["--abft", "--audit-every", "100"],
        "am-abft-clean")
    trips = re.search(r"ntrips: (\d+)", text)
    nchecks = re.search(r"nchecks: (\d+)", text)
    say(f"path am-clean: {its} iterations (a: {ITS['a']}), ABFT checks "
        f"{nchecks.group(1) if nchecks else None}, trips "
        f"{trips.group(1) if trips else None}, x bitwise (a) = "
        f"{np.array_equal(x, xa)}; K1 {c['dia_spmv']} (a: "
        f"{paths['a']['dia_spmv']})")
    check(rc == 0 and trips and int(trips.group(1)) == 0
          and its == ITS["a"] and np.array_equal(x, xa)
          and _resilience(text) == (0, 0),
          "path am-clean: no trip, (a)'s iterations and bits")
    out["am-clean"] = c

    # (ao) 4 stacked parts under dma: halo:nan@3 --recover on the CLI,
    # then the transport rung through the API
    rc, text, c, _, its, x, _ = solve_path(
        torch, K, tmp, man + ["--nparts", str(NPARTS), "--comm", "dma",
                              "--fault-inject", "halo:nan@3",
                              "--recover"], "ao-4part-dma-halo-nan")
    bd = _resilience(text)
    say(f"path ao: {its} iterations (e: {ITS['e']}), breakdowns/restarts "
        f"{bd}, true relative residual {true_rel(x):.3e}; K6 "
        f"{c['halo_put']}, batched K1 {c['dia_spmv_batched']}")
    check(rc == 0 and bd == (1, 1) and true_rel(x) <= 1e-7
          and c["halo_put"] >= its,
          "path ao: one breakdown, one restart, converged on K6")
    out["ao"] = c
    from acg_tpu_torch.parallel.dist import DistCGSolver
    orig_shift = faults.FaultSpec.shift
    # the transport rung runs on the card only when the policy names it
    solver = DistCGSolver(prob, comm="dma", device="cuda",
                          recovery=RecoveryPolicy(max_restarts=3,
                                                  fallback_comm=True))

    def shift_persistent_while_dma(spec, consumed):
        if solver.comm == "dma":
            return spec           # the faulty link keeps corrupting
        return orig_shift(spec, consumed)

    faults.FaultSpec.shift = shift_persistent_while_dma
    K.reset_launches()
    try:
        with faults.injected("halo:nan@3"), \
                contextlib.redirect_stderr(io.StringIO()):
            x = solver.solve(b, criteria=StoppingCriteria(
                maxits=20000, residual_rtol=1e-8))
    finally:
        faults.FaultSpec.shift = orig_shift
    cr = dict(K.launches)
    st = solver.stats
    text = st.fwrite()
    say(f"path ao-transport: comm now {solver.comm}, breakdowns "
        f"{st.nbreakdowns}, restarts {st.nrestarts}, fallbacks "
        f"{st.nfallbacks}, {st.niterations} iterations after the rung, "
        f"true relative residual {true_rel(x):.3e}; K6 {cr['halo_put']}")
    check(solver.comm == "xla" and st.nfallbacks == 1 and st.converged
          and "fallback: halo transport dma -> xla" in text
          and true_rel(x) <= 1e-7 and cr["halo_put"] > 0,
          "path ao: the transport rung retired dma for xla")
    del solver

    # (ap) the soak driver and its drift gate
    t0 = time.perf_counter()
    rc, text, c = run_cli(torch, K, base + ["--manufactured-solution"]
                          + ROBUST_TOL + ["--soak", str(SOAK_SOLVES),
                                          "--fail-on-drift", "50"], "ap-soak")
    tripped = re.search(r"tripped: (\w+)", text)
    ratio = re.search(r"ratio: ([\d.]+)", text)
    say(f"path ap: --soak {SOAK_SOLVES} rc={rc}, drift tripped "
        f"{tripped.group(1) if tripped else None}, ratio "
        f"{ratio.group(1) if ratio else None}, p50 "
        f"{stat(text, 'p50')} s; {time.perf_counter() - t0:.1f} s")
    check(rc == 0 and tripped and tripped.group(1) == "False"
          and c["dia_spmv"] >= SOAK_SOLVES * ITS["a"],
          f"path ap: {SOAK_SOLVES} solves on K1, no drift")
    out["ap"] = c
    # the gate's trip on the quarter-width matrix (solves of ~0.3 s):
    # the drift, not the width, is what this run shows
    rc, text, c = run_cli(torch, K, [ANISO_SPEC, "--warmup", "0", "-q"]
                          + ROBUST_TOL + ["--soak", "5", "--fail-on-drift",
                                          "50", "--fault-inject",
                                          "solve:slow@3:secs=3"],
                          "ap-soak-slow")
    tripped = re.search(r"tripped: (\w+)", text)
    say(f"path ap-slow: rc={rc} (7: drift), tripped "
        f"{tripped.group(1) if tripped else None}")
    check(rc == 7 and tripped and tripped.group(1) == "True",
          "path ap: solve:slow trips the drift gate (exit 7)")
    _fault_env()
    say(f"paths ak-ap took {time.perf_counter() - t_phase:.1f} s")
    return out


def robustness_rates(torch):
    """Classic f64 at 2048^2: --recover armed with no fault against off,
    1000 iterations after 50 in turns (off, armed, armed, off), the
    device launches an iteration of each (the disarmed loop's must stay
    PR 13's 13.3), and one tolerance-bounded solve (rtol 1e-8) of each,
    whose loop carries the live flag either way."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
    from acg_tpu_torch.solvers.resilience import RecoveryPolicy

    dev = torch.device("cuda", 0)
    A = device_matrix_from_csr(synthesize_host_matrix(MAIN_SPEC).to_csr(),
                               dtype=torch.float64, device=dev)
    b = np.ones(A.nrows)
    rates = {"off": [], "armed": []}
    bounded = {}
    for turn in ("off", "armed", "armed", "off"):
        kw = {} if turn == "off" else {"recovery": RecoveryPolicy()}
        s = TorchCGSolver(A, device=dev, **kw)
        s.solve(b, criteria=StoppingCriteria(maxits=50))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.solve(b, criteria=StoppingCriteria(maxits=1000))
        torch.cuda.synchronize()
        rates[turn].append(1000 / (time.perf_counter() - t0))
        if turn not in bounded:
            s.stats.tsolve = 0.0
            s.solve(b, criteria=StoppingCriteria(maxits=20000,
                                                 residual_rtol=1e-8))
            bounded[turn] = (s.stats.niterations, s.stats.tsolve)
    # launches an iteration over 100 iterations with the setup (PR 13's
    # measure), and the loop's kernels alone: the difference of a 200-
    # and a 100-iteration solve, copies left out (the setup's copies the
    # profiler records vary with where in the run it is taken: 13.15 to
    # 13.34 over 100 iterations in one run)
    lpi, loop = {}, {}
    for turn, kw in (("off", {}),
                     ("armed", {"recovery": RecoveryPolicy()})):
        lpi[turn] = _launches_per_iteration(torch, TorchCGSolver(
            A, device=dev, **kw), b)
        n1, n2 = (_launches_per_iteration(torch, TorchCGSolver(
            A, device=dev, **kw), b, nits=n, kernels_only=True)
            for n in (100, 200))
        loop[turn] = (n2 * 200 - n1 * 100) / 100
    say(f"rates --recover, classic f64 {MAIN_SPEC}: off "
        f"{[round(r, 1) for r in rates['off']]} iters/s, armed with no "
        f"fault {[round(r, 1) for r in rates['armed']]}; device launches "
        f"an iteration off {lpi['off']:.2f} (PR 13: 13.3), armed "
        f"{lpi['armed']:.2f}; kernels in the loop alone off "
        f"{loop['off']:.2f}, armed {loop['armed']:.2f}; to rtol 1e-8: off "
        f"{bounded['off'][0]} "
        f"iterations in {bounded['off'][1]:.3f} s, armed "
        f"{bounded['armed'][0]} in {bounded['armed'][1]:.3f} s; "
        f"{device_line(torch)}")
    # K1, two cuBLAS dots of two launches, two divisions and three
    # two-launch updates: 13; PR 13's 13.3 adds the setup over 100
    check(abs(loop["off"] - 13.0) <= 0.05,
          "the disarmed classic loop launches 13 kernels an iteration "
          "(PR 13's 13.3 with the setup's over 100)")
    check(loop["armed"] > loop["off"]
          and bounded["armed"][0] == bounded["off"][0],
          "the armed loop takes the disarmed loop's iterations")
    return rates, lpi


# -- phase 3 (af)-(ah) and K6 across processes: two processes on the card --

NPROC = 2          # processes of the multi-process paths, on the one card
# (af-xla) and (af-pipelined) run this many iterations, no tolerance,
# held bitwise against a one-process stacked solve of the same count
AF_ITS = 300
AF_EVERY = 100     # --progress of path (af-dma)
STOP_TIMEOUT_S = 2.0   # K6 peer's wait timeout in the stopped-peer check


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(args_of, tag, timeout=MP_TIMEOUT, env=None):
    """NPROC child processes, each ``python`` + ``args_of(rank, port)``
    from the checkout's root, started together; all are killed when one
    pair outlives ``timeout``, and that fails the smoke; ``env`` defaults
    to CHILD_ENV.  Returns [(rc, stdout, stderr), ...] in rank order."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable] + args_of(r, port), cwd=HERE,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=CHILD_ENV if env is None else env)
             for r in range(NPROC)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"chip_smoke: {tag}: a child process ran past "
                             f"{timeout} s; both were killed")
    res = [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]
    for r, (rc, o, e) in enumerate(res):
        LOG.append(f"--- {tag} rank {r}: rc={rc}\n{e}")
    return res


def cli_pair(argv, tag, timeout=MP_TIMEOUT):
    """``python -m acg_tpu_torch ARGV -vv --coordinator ...`` as NPROC
    processes sharing the card; each must exit 0.  Returns (results,
    launch counts summed over the ranks, the ranks' counts)."""
    t0 = time.perf_counter()
    res = run_pair(lambda r, port: [
        "-m", "acg_tpu_torch", *argv, "-vv", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", str(NPROC),
        "--process-id", str(r)], tag, timeout)
    per = []
    for r, (rc, _, err) in enumerate(res):
        check(rc == 0, f"path {tag}: rank {r} exit 0 (rc {rc}; its stderr "
                       f"ends: {err[-600:]!r})")
        lines = launch_lines(err)
        check(bool(lines), f"path {tag}: rank {r} printed its launches")
        per.append(lines[-1])
        _no_fallback(err, f"{tag} rank {r}")
        mh = [ln for ln in err.splitlines() if ln.startswith("multihost:")]
        check(bool(mh) and "backend" in mh[0],
              f"path {tag}: rank {r} named its backend")
    total = {k: sum(c.get(k, 0) for c in per) for k in per[0]}
    mh0 = [ln for ln in res[0][2].splitlines()
           if ln.startswith("multihost:")][0]
    say(f"path {tag}: {NPROC} processes on the card, wall "
        f"{time.perf_counter() - t0:.1f} s; {mh0}; launches by rank {per}")
    return res, total, per


def _rank0_only(res, tag):
    """Rank 0 alone prints the stats block and writes the solution."""
    (rc0, so0, se0), (rc1, so1, se1) = res[0], res[1]
    check("total solver time" in se0, f"path {tag}: rank 0 printed stats")
    check("total solver time" not in se1 and "%%MatrixMarket" not in so1
          and "error 2-norm" not in se1,
          f"path {tag}: rank 1 printed nothing of the stats or solution")


def _peak_gib(err: str) -> float:
    line = [ln for ln in err.splitlines()
            if ln.startswith("device memory peak: ")]
    return float(line[-1].split()[3]) if line else float("nan")


def multiprocess_paths(torch, K, tmp, base, csr, prob):
    """Paths (af)-(ah) as :class:`Jobs`, whose ``local()`` solves the
    one-process twins the late jobs are held to.  (af)-(ah):
    the multi-process tier, NPROC processes sharing the one
    card (gloo for the host-side collectives, CUDA IPC for K6's peer
    puts: one card, NPROC contexts time-slicing it, not a cross-card
    measurement).  (af) --nparts 4 classic f64 on --comm dma, xla, and
    pipelined on dma, a fixed AF_ITS iterations each: the bits of a
    one-process stacked solve of the same count, K6's peer form once per
    SpMV on each rank under dma ((ar)'s resumed pair holds the pair to
    (e)'s converged bits); (ag)
    --distributed-read of the flagship's expanded binary file with (e)'s
    band bounds and right-hand side, AF_ITS iterations, written rootless
    with --output: (af-xla)'s x and bytes; (ah)
    gen:poisson3d:512 --nparts 2, 300 iterations on the sharded tier (K1
    on each rank's halo'd window), x beside (l)'s, each rank's device
    memory peak, and the manufactured-solution draw timed once."""
    from acg_tpu_torch.solvers.cg import CHUNK

    # the children allocate on the card too: hand back this process's
    # cached blocks first
    torch.cuda.empty_cache()
    mp = base + ["--nparts", str(NPARTS), "--manufactured-solution",
                 "--residual-rtol", "1e-8", "--max-iterations", "20000"]
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria

    fixed = ["--residual-rtol", "0", "--max-iterations", str(AF_ITS)]
    xsol = np.random.default_rng(42).standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    b = csr @ xsol   # the CLI's --manufactured-solution right-hand side
    def twins():
        for tag, comm, pipe in (("af-xla", "xla", False),
                                ("af-pipelined", "dma", True)):
            one = DistCGSolver(prob, comm=comm, pipelined=pipe,
                               device="cuda")
            np.save(os.path.join(tmp, f"{tag}-one.npy"),
                    one.solve(b, criteria=StoppingCriteria(maxits=AF_ITS)))
            del one
        torch.cuda.empty_cache()
        return {}

    def af(tag, extra, ref, its_ref, extra_spmv):
        out = os.path.join(tmp, f"{tag}.bin")
        obs = []
        if tag == "af-dma":
            # the observability sinks ride this pair: their gathers run
            # after the solve, whose bits the check below holds
            obs = ["--stats-json", os.path.join(tmp, "af.json"),
                   "--timeline", os.path.join(tmp, "af-timeline.json"),
                   "--progress", str(AF_EVERY)]
        res, total, per = cli_pair(mp + extra + obs + ["-o", out], tag)
        _rank0_only(res, tag)
        its = int(stat(res[0][2], "iterations").replace(",", ""))
        twin = (np.load(os.path.join(tmp, ref)) if ref.endswith(".npy")
                else read_x(os.path.join(tmp, ref)))
        same = np.array_equal(read_x(out), twin)
        name = (f"path {ref[0]}" if ref.endswith(".bin")
                else "the one-process stacked solve")
        say(f"path {tag}: {its} iterations ({name}: {its_ref}), x bitwise "
            f"equal to {name} = {same}, solver time "
            f"{stat(res[0][2], 'total solver time')}")
        check(its == its_ref and same,
              f"path {tag}: {name}'s iterations and bits")
        if obs:
            _af_observed(tmp, res, its)
        nspmv = its + extra_spmv
        for r, c in enumerate(per):
            if "dma" in extra:
                check(nspmv <= c["halo_put_peer"] <= nspmv + CHUNK
                      and c["halo_put"] == 0,
                      f"path {tag}: rank {r} ran K6's peer form once per "
                      f"SpMV ({c['halo_put_peer']} for {nspmv})")
            else:
                check(c["halo_put_peer"] == 0 and c["halo_put"] == 0,
                      f"path {tag}: rank {r}: no K6 on the xla transport")
            check(nspmv <= c["dia_spmv_batched"] <= nspmv + CHUNK,
                  f"path {tag}: rank {r} ran batched K1 once per SpMV")
        return {tag: total}

    def af_xla_then_ag():
        # (ag) holds its rootless file against (af-xla)'s
        out = af("af-xla", ["--comm", "xla"] + fixed, "af-xla-one.npy",
                 AF_ITS, 1)
        out.update(distributed_read_path(torch, K, tmp, base, csr))
        return out

    # the pairs are jobs: main_path runs them with the other child-process
    # paths, JOB_WORKERS at a time; the one-process twins come first.  The
    # dma transport's twin is the xla one: (f) shows the two give the
    # same bits.  (ah)'s draws are timed here, before any job runs
    draws = manufactured_draws(torch)
    return Jobs([lambda: sharded_multiprocess_path(torch, K, tmp, draws)],
                twins, [
        lambda: af("af-dma", ["--comm", "dma"] + fixed, "af-xla-one.npy",
                   AF_ITS, 1),
        af_xla_then_ag,
        lambda: af("af-pipelined", ["--comm", "dma", "--solver",
                                    "acg-pipelined"] + fixed,
                   "af-pipelined-one.npy", AF_ITS, 2)])


def _af_observed(tmp, res, its):
    """(af-dma)'s sinks: the stats document's ranks block holds both
    processes, process 0 alone wrote the clock-aligned timeline, and
    each heartbeat sample is printed once, by process 0."""
    doc = json.load(open(os.path.join(tmp, "af.json")))
    procs = [p["process"] for p in doc["ranks"]["per_rank"]]
    agg = doc["ranks"]["aggregate"]
    check(procs == [0, 1] and agg["processes"] == NPROC,
          f"path af-dma: the ranks block holds both processes ({procs})")
    tl = json.load(open(os.path.join(tmp, "af-timeline.json")))
    meta = tl["metadata"]
    (_, _, se0), (_, _, se1) = res[0], res[1]
    rc_t, msg = _script("check_timeline.py",
                        os.path.join(tmp, "af-timeline.json"))
    check(meta["nranks"] == NPROC and meta["clock"]["aligned"]
          and "timeline:" in se0 and "timeline:" not in se1 and rc_t == 0,
          f"path af-dma: process 0 wrote the timeline of both, aligned "
          f"(skew {meta['clock']['max_skew_s']} s; {msg})")
    beats = _beat_iterations(se0)
    check(beats == list(range(AF_EVERY, its + 1, AF_EVERY))
          and not _beat_iterations(se1),
          f"path af-dma: one heartbeat line a sample ({beats})")
    from acg_tpu_torch.telemetry import format_rank_report
    say(f"path af-dma: {format_rank_report(agg)}")


def distributed_read_path(torch, K, tmp, base, csr):
    """(ag): --distributed-read of the flagship as mtx2bin --expand writes
    it, with path (e)'s band bounds as the .bounds.mtx sidecar and the
    CLI's manufactured right-hand side as a b file; --output written
    rootless (each rank its windows, rank 0 the header)."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.io.mtxfile import (expand_to_rowsorted_full, read_mtx,
                                          vector_mtx, write_mtx)
    from acg_tpu_torch.partition import partition_rows

    t0 = time.perf_counter()
    A = os.path.join(tmp, "ag-A.bin.mtx")
    write_mtx(A, expand_to_rowsorted_full(read_mtx(
        os.path.join(tmp, "u-A.bin.mtx"), binary=True)), binary=True)
    part = partition_rows(csr, NPARTS, seed=42, method="band")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(part))])
    check(bool((np.diff(part) >= 0).all()), "path ag: a band partition")
    write_mtx(A + ".bounds.mtx", vector_mtx(bounds.astype(np.int64),
                                            field="integer"))
    xsol = np.random.default_rng(42).standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    bfile = os.path.join(tmp, "ag-b.bin")
    write_mtx(bfile, vector_mtx(synthesize_host_matrix(MAIN_SPEC).dsymv(
        xsol)), binary=True)
    prep = time.perf_counter() - t0
    out = os.path.join(tmp, "ag.bin")
    res, total, per = cli_pair([A, bfile, "--binary", "--distributed-read",
                                "--warmup", "0", "-q", "--residual-rtol",
                                "0", "--max-iterations", str(AF_ITS), "-o",
                                out], "ag-distributed-read")
    _rank0_only(res, "ag")
    its = int(stat(res[0][2], "iterations").replace(",", ""))
    # (af-xla) ran the same AF_ITS iterations on the same band parts: the
    # one-process stacked solve's bits, which (f) shows the dma transport
    # gives bit for bit
    with open(out, "rb") as f1, open(os.path.join(tmp, "af-xla.bin"),
                                     "rb") as f2:
        same_bytes = f1.read() == f2.read()
    same = np.array_equal(read_x(out), read_x(os.path.join(tmp,
                                                           "af-xla.bin")))
    say(f"path ag: the expanded file, bounds and b written in {prep:.1f} s; "
        f"{its} iterations (af-xla: {AF_ITS}), x bitwise (af-xla)'s = "
        f"{same}, the rootless file byte-identical to (af-xla)'s "
        f"one-process write = {same_bytes}, solver time "
        f"{stat(res[0][2], 'total solver time')}")
    check(its == AF_ITS and same and same_bytes,
          "path ag: (af-xla)'s x, written byte for byte")
    for f in (A, A + ".bounds.mtx", bfile, out):
        os.remove(f)
    return {"ag": total}


def manufactured_draws(torch) -> tuple:
    """(ah)'s manufactured-solution draw timed on the card, in this
    process before any job starts: once for all 134M rows of
    gen:poisson3d:512 and once for rank 0's window of a pair (its rows
    and the band's reach past them: what a rank draws).  Returns
    (seconds of the whole draw, seconds of the window's, the window)."""
    from acg_tpu_torch import prng

    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = prng.normal(42, DIRECT_N ** 3, torch.float64, dev)
    torch.cuda.synchronize()
    draw = time.perf_counter() - t0
    check(bool(torch.isfinite(x).all()) and 0.99 < float(x.std()) < 1.01,
          "path ah: the manufactured draw is a finite unit normal")
    win = (0, DIRECT_N ** 3 // NPROC + DIRECT_N ** 2)
    t0 = time.perf_counter()
    xw = prng.normal(42, DIRECT_N ** 3, torch.float64, dev, rows=win)
    torch.cuda.synchronize()
    draw_win = time.perf_counter() - t0
    check(torch.equal(xw, x[win[0]:win[1]]),
          "path ah: a rank's window is the whole draw's slice, bitwise")
    del x, xw
    torch.cuda.empty_cache()
    return draw, draw_win, win


def sharded_multiprocess_path(torch, K, tmp, draws):
    """(ah): gen:poisson3d:512 --nparts 2 on two processes, classic f64,
    300 iterations: K1 on each rank's halo'd window, each rank's device
    memory peak; x beside path (l)'s one-part solve (the dots are two
    ranks' partials folded, not one reduction over N, so the bits may
    differ: the check is 1e-12), and :func:`manufactured_draws`' times."""
    draw, draw_win, win = draws
    spec = f"gen:poisson3d:{DIRECT_N}"
    out = os.path.join(tmp, "ah.bin")
    res, total, per = cli_pair([spec, "--nparts", str(NPROC), "--warmup",
                                "0", "--max-iterations", "300",
                                "--residual-rtol", "0", "-o", out],
                               "ah-sharded-2proc")
    _rank0_only(res, "ah")
    x, xl = read_x(out), read_x(os.path.join(tmp, "l.bin"))
    rel = float(np.linalg.norm(x - xl) / np.linalg.norm(xl))
    peaks = [_peak_gib(e) for _, _, e in res]
    say(f"path ah: {stat(res[0][2], 'iterations')} iterations, x vs path "
        f"l's rel {rel:.3e} (limit 1e-12; bitwise = "
        f"{np.array_equal(x, xl)}), K1 by rank "
        f"{[c['dia_spmv'] for c in per]}, device memory peak by rank "
        f"{peaks} GiB, solver time {stat(res[0][2], 'total solver time')}; "
        f"the manufactured draw of {DIRECT_N ** 3} f64 normals on the card "
        f"{draw:.3f} s, of rank 0's window of {win[1] - win[0]} "
        f"{draw_win:.3f} s")
    check(rel <= 1e-12, "path ah: x within 1e-12 of path l's")
    check(all(c["dia_spmv"] == 301 and sum(c.values()) == 301 for c in per),
          "path ah: each rank ran K1 on its window once per SpMV, no other "
          "kernel")
    os.remove(out)
    return {"ah": total}


# -- phase 3 (aq)-(ax): rank-mode robustness, the tiers' checkpoints, the --
# -- supervisor and its fault sites, run as jobs beside (af)-(ah) -----------

ERR_TIMEOUT = 10     # --err-timeout of path (ax)'s dead peer
# --max-iterations of path (av): the campaign draws a fault's iteration
# in [2, 0.6 x this] = [2, 3600].  Its children solve b = ones (the host
# oracle's right-hand side), which takes more than 3,000 iterations (a
# cap of 3,000 stopped every child) and fewer than 4,915 (a dot fault
# drawn there never fired): every draw lands inside the solve, and a
# rollback replays at most CKPT_EVERY iterations within the cap
CHAOS_MAXITS = 6000
PROBE_TIMEOUT = 5    # ACG_TPU_PROBE_TIMEOUT of path (ax)'s hung runtime


def mp_run(argv, tag, env=None):
    """``python -m acg_tpu_torch ARGV -vv`` as NPROC processes sharing
    the card, each rc whatever it is: (results, wall, per-rank launch
    counts; {} for a rank that printed none)."""
    t0 = time.perf_counter()
    res = run_pair(lambda r, port: [
        "-m", "acg_tpu_torch", *argv, "-vv", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", str(NPROC),
        "--process-id", str(r)], tag, env=env)
    per = []
    for r, (rc, _, err) in enumerate(res):
        lines = launch_lines(err)
        per.append(lines[-1] if lines else {})
        _no_fallback(err, f"{tag} rank {r}")
    wall = time.perf_counter() - t0
    say(f"path {tag}: {NPROC} processes on the card, rcs "
        f"{[r[0] for r in res]}, wall {wall:.1f} s; launches by rank {per}")
    return res, wall, per


def _sum_counts(per) -> dict:
    keys = {k for c in per for k in c}
    return {k: sum(c.get(k, 0) for c in per) for k in sorted(keys)}


def elastic_paths(torch, K, tmp, base, b, csr, prob):
    """Paths (aq)-(ax) on the flagship f64, pairs as NPROC processes on
    the card, as :class:`Jobs`.  The early jobs are the child-process
    runs that need nothing of this process; main_path starts them with
    (af)-(ah), JOB_WORKERS at a time, then calls ``local()``, which runs
    the one-process twins and the runs in this process ((at) and (aw)'s
    chunked runs) while they go on; the late jobs are the pair runs held
    to those twins.  (aq) the (af) pair, pipelined under
    --comm dma, AF_ITS iterations with spmv:nan@7:part=2 --recover: one
    restart on each rank, x and the iterations bitwise the one-process
    stacked solve of the same fault, K6's peer form, the per-part dot
    and K5's flagged form counted.  (ar) the pair
    to 1e-8 checkpointing every 100 with crash:exit@150: both ranks exit
    94 after the snapshot at 200; the pair's --resume ends on (e)'s
    bits; one process resumes the two-process snapshot with
    --resume-repartition to 1e-8.  (as) the pair with --precond jacobi
    and with --algorithm sstep:4, AF_ITS iterations under dma: each
    bitwise its one-process stacked twin.  (at) gen:poisson3d:512
    --nparts 4 with --ckpt-every 150 (one 3 GB snapshot) and
    --audit-every 100, 300 iterations: (l)'s bits.  (au) --supervise of
    (a) with --ckpt-every 500 and crash:exit@1200: the child's rc 94 at
    its snapshot at 1,500 with no stats and no solution, one relaunch
    that resumed from 1,500 and ran (a)'s remaining iterations (K1 once a
    loop step), the recovery: section, (a)'s bits; then 4 parts under
    dma with --shrink any: relaunched on 2 parts with
    --resume-repartition, degraded 4 -> 2, converged.  (av) --chaos
    2026:3 --recover with --max-iterations CHAOS_MAXITS: every schedule
    converged or agreed-abort, every fault fired inside its solve (read
    from the campaign's --history ledger), no wrong answer, each green
    run verified on the host.
    (aw) (ab)'s --nparts 4 --nrhs 8 run with --ckpt-every 100: (ab)'s
    bits; sstep:4 with --ckpt-every 512: (z-sstep4)'s bits, and so is
    its crash:exit@1200 child's resume.  (ax) peer:dead:proc=1 on a
    pair: rank 1 exits 86, rank 0 97 within --err-timeout (the pair's
    wall under ERR_TIMEOUT + 30 s: a watchdog on the 120 s default fails
    it); backend:hang under ACG_TPU_PROBE_TIMEOUT: exit 3 within
    seconds.  Every child runs under CHILD_ENV."""
    from acg_tpu_torch import faults
    from acg_tpu_torch.checkpoint import load_snapshot

    _fault_env()
    tol = ["--residual-rtol", "1e-8", "--max-iterations", "20000"]
    tol_av = ["--residual-rtol", "1e-8", "--max-iterations",
              str(CHAOS_MAXITS)]
    man = base + ["--manufactured-solution"] + tol
    mp = man + ["--nparts", str(NPARTS), "--comm", "dma"]
    fixed = ["--residual-rtol", "0", "--max-iterations", str(AF_ITS)]
    mpf = base + ["--manufactured-solution", "--nparts", str(NPARTS),
                  "--comm", "dma"] + fixed
    fault_aq = "spmv:nan@7:part=2"

    def true_rel(x):
        return float(np.linalg.norm(b - csr @ x) / np.linalg.norm(b))

    z = read_x(os.path.join(tmp, "z-sstep4.bin"))
    sst = man + ["--algorithm", "sstep:4", "--ckpt-every", "512"]
    twins = {}

    def aq():
        x_out = os.path.join(tmp, "aq.bin")
        res, wall, per = mp_run(mpf + ["--solver", "acg-pipelined",
                                       "--fault-inject", fault_aq,
                                       "--recover", "-o", x_out], "aq")
        x1, its1, rs1 = twins["aq"]
        its = int(stat(res[0][2], "iterations").replace(",", ""))
        # each rank logs its restarts (rank 0's stats block repeats them)
        restarts = [sum(1 for ln in e.splitlines()
                        if ln.startswith("acg-tpu-torch: dist-cg: ")
                        and "; restart 1/" in ln) for _, _, e in res]
        same = np.array_equal(read_x(x_out), x1)
        say(f"path aq: {its} iterations (the one-process stacked twin: "
            f"{its1}, {rs1} restart), restarts by rank {restarts}, x "
            f"bitwise the twin's = {same}, resilience "
            f"{_resilience(res[0][2])}")
        check([r[0] for r in res] == [0] * NPROC,
              "path aq: every rank exit 0")
        check(restarts == [1] * NPROC and rs1 == 1
              and _resilience(res[0][2]) == (1, 1),
              "path aq: one restart on every rank")
        check(its == its1 and same,
              "path aq: the one-process stacked solve's iterations and bits")
        check(all(c.get("halo_put_peer", 0) > AF_ITS
                  and c.get("part_dot", 0) > AF_ITS
                  and c.get("pipelined_update", 0) >= AF_ITS for c in per),
              "path aq: K6's peer form, the per-part dot and K5's flagged "
              "form on every rank")
        return {"aq": _sum_counts(per)}

    def ar():
        ck = os.path.join(tmp, "ar.ckpt")
        res, _, per = mp_run(mp + ["--ckpt", ck, "--ckpt-every", "100",
                                   "--fault-inject", "crash:exit@150"],
                             "ar-crash")
        snap = load_snapshot(ck)
        check([r[0] for r in res] == [94] * NPROC
              and snap.iteration == 200 and snap.meta["nparts"] == NPARTS,
              "path ar: both ranks died after the snapshot at 200")
        x_out = os.path.join(tmp, "ar.bin")
        res2, _, per2 = mp_run(mp + ["--resume", ck, "-o", x_out],
                               "ar-resume")
        same = np.array_equal(read_x(x_out), read_x(os.path.join(tmp,
                                                                 "e.bin")))
        check([r[0] for r in res2] == [0] * NPROC
              and "resumed_from: 200" in res2[0][2] and same,
              "path ar: the pair's resume ends on (e)'s bits")
        x1 = os.path.join(tmp, "ar-one.bin")
        rc, text, c, _ = proc_cli(man + ["--resume", ck,
                                         "--resume-repartition", "-o", x1],
                                  "ar-repartition")
        res1 = true_rel(read_x(x1))
        say(f"path ar: the pair's snapshot at {snap.iteration}; the resumed "
            f"pair's x bitwise (e)'s = {same}; one process resumed it "
            f"repartitioned: {stat(text, 'iterations')} iterations, true "
            f"relative residual {res1:.3e}")
        check(rc == 0 and "repartitioned_from" in text and res1 <= 1e-7,
              "path ar: the repartitioned resume converged to 1e-7")
        return {"ar": _sum_counts(per + per2 + [c])}

    def as_(tag, extra):
        def job():
            x_out = os.path.join(tmp, f"{tag}.bin")
            res, _, per = mp_run(mpf + extra + ["-o", x_out], tag)
            same = np.array_equal(read_x(x_out), twins[tag])
            say(f"path {tag}: x bitwise the one-process stacked twin's = "
                f"{same}")
            check([r[0] for r in res] == [0] * NPROC and same,
                  f"path {tag}: the one-process stacked solve's bits")
            check(all(c.get("dia_spmv_batched", 0) >= AF_ITS
                      and c.get("halo_put_peer", 0) > 0 for c in per),
                  f"path {tag}: batched K1 and K6's peer form on every "
                  f"rank")
            return {tag: _sum_counts(per)}
        return job

    def supervised(argv, tag):
        """``argv`` under --supervise: (rc, stderr, the finished
        children's launch counts; a crashed child prints none)."""
        rc, text, _, _ = proc_cli(argv + ["--supervise",
                                          "--relaunch-backoff", "0"], tag)
        per = launch_lines(text)
        say(f"path {tag}: the children's launches {per}")
        return rc, text, per

    def au1():
        x_out = os.path.join(tmp, "au.bin")
        # the crash fires after the first snapshot at or past CRASH_AT
        snap_at = -(-CRASH_AT // CKPT_EVERY) * CKPT_EVERY
        rc, text, per = supervised(
            man + ["--ckpt", os.path.join(tmp, "au.ckpt"), "--ckpt-every",
                   str(CKPT_EVERY), "--fault-inject", f"crash:exit@{CRASH_AT}",
                   "-o", x_out], "au-supervise")
        crashed, relaunch, resumed = text.partition(
            "supervisor: child exited rc 94 (crash); relaunch 1/3 with "
            "--resume\n")
        # the crashed child's output ends at its hard exit inside the
        # solve: no stats block, no launch counts, so no solution written
        died = (f"hard exit at {snap_at} iterations (crash:exit@{CRASH_AT})"
                in crashed and "total solver time" not in crashed
                and not launch_lines(crashed))
        same = os.path.exists(x_out) and np.array_equal(
            read_x(x_out), read_x(os.path.join(tmp, "a.bin")))
        from_ = re.search(r"resumed_from: (\d+)", resumed)
        traj = re.search(r"\n  iteration: ([\d,]+)", resumed)
        its = (int(stat(resumed, "iterations").replace(",", ""))
               if relaunch else None)
        # the relaunch keeps --ckpt-every: its loop runs the checkpoint
        # chunks from the snapshot and, in the last, the flag's chunks
        last = snap_at + (ITS["a"] - snap_at - 1) // CKPT_EVERY * CKPT_EVERY
        k1 = last - snap_at + min(chunked(ITS["a"] - last), CKPT_EVERY)
        say(f"path au: the first child died at its snapshot ({died}), "
            f"resumed from {from_.group(1) if from_ else None}: {its} "
            f"iterations, trajectory {traj.group(1) if traj else None} "
            f"(a: {ITS['a']}), K1 {[c.get('dia_spmv') for c in per]} "
            f"(expected {k1}); x bitwise (a)'s = {same}")
        check(rc == 0 and relaunch and died and "recovery:" in resumed
              and "relaunches: 1 (crash: 1)" in resumed and same,
              f"path au: rc 94 after the snapshot at {snap_at} and no "
              f"solution, one relaunch, the recovery: section, (a)'s bits")
        check(from_ and int(from_.group(1)) == snap_at
              and its == ITS["a"] - snap_at and traj
              and int(traj.group(1).replace(",", "")) == ITS["a"]
              and len(per) == 1 and per[0].get("dia_spmv") == k1,
              f"path au: the relaunch resumed at {snap_at} and ran (a)'s "
              f"remaining {ITS['a'] - snap_at} iterations, K1 once a "
              f"loop step")
        return {"au": _sum_counts(per)}

    def au2():
        x_out = os.path.join(tmp, "au2.bin")
        rc, text, per = supervised(
            mp + ["--ckpt", os.path.join(tmp, "au2.ckpt"), "--ckpt-every",
                  str(CKPT_EVERY), "--fault-inject", f"crash:exit@{CRASH_AT}",
                  "--shrink", "any", "-o", x_out], "au-shrink")
        res2 = true_rel(read_x(x_out)) if os.path.exists(x_out) else 1.0
        say(f"path au-shrink: true relative residual {res2:.3e}")
        check(rc == 0 and f"shrinking {NPARTS} -> {NPARTS // 2} "
              f"parts" in text and f"degraded: {NPARTS} -> "
              f"{NPARTS // 2} parts (crash)" in text
              and "repartitioned_from" in text and res2 <= 1e-7,
              "path au: relaunched on 2 parts with --resume-repartition, "
              "converged to 1e-7")
        return {"au-shrink": _sum_counts(per)}

    def av():
        hist = os.path.join(tmp, "av-hist")
        rc, text, _, _ = proc_cli(
            base + tol_av + ["--recover", "--ckpt", os.path.join(
                tmp, "av.ckpt"), "--ckpt-every", str(CKPT_EVERY), "--chaos",
                "2026:3", "--relaunch-backoff", "0", "--history", hist],
            "av-chaos", timeout=2 * MP_TIMEOUT)
        verdicts = re.findall(r"chaos\[\d\]: fault=(\S+) .*-> (\S+)"
                              r"( \(true rel residual)?", text)
        fired = _chaos_fired(hist)
        say(f"path av: schedules {verdicts}; each fault, whether it fired "
            f"and the finishing child's iterations {fired}")
        check(rc == 0 and "wrong-answer: 0" in text
              and len(verdicts) == 3
              and all(v in ("converged", "agreed-abort")
                      for _, v, _ in verdicts)
              and all(ver for _, v, ver in verdicts if v == "converged"),
              "path av: every schedule converged (verified) or "
              "agreed-abort")
        check(len(fired) == 3 and all(f[1] for f in fired),
              "path av: every schedule's fault fired inside its solve")
        return {}

    def aw_crash():
        ck = os.path.join(tmp, "aw-s2.ckpt")
        rcc, _, c, _ = proc_cli(sst + ["--ckpt", ck, "--fault-inject",
                                       f"crash:exit@{CRASH_AT}"],
                                "aw-sstep-crash")
        snap_it = load_snapshot(ck).iteration
        x_out = os.path.join(tmp, "aw-sstep2.bin")
        rc2, _, c2, _ = proc_cli(man + ["--algorithm", "sstep:4",
                                        "--resume", ck, "-o", x_out],
                                 "aw-sstep-resume")
        same = rc2 == 0 and np.array_equal(read_x(x_out), z)
        say(f"path aw: the crashed sstep:4 child rc {rcc} at its snapshot "
            f"{snap_it}, resumed: (z-sstep4)'s bits = {same}")
        check(rcc == 94 and snap_it == 1536 and same,
              "path aw: sstep:4 crashed then resumed is (z-sstep4)'s bits")
        return {"aw-crash": _sum_counts([c, c2])}

    def ax():
        t0 = time.perf_counter()
        res, wall, _ = mp_run(mpf + ["--fault-inject", "peer:dead:proc=1",
                                     "--err-timeout", str(ERR_TIMEOUT)],
                              "ax-peer-dead")
        rcs = [r[0] for r in res]
        check(rcs == [97, 86] and "dying before checkpoint" in res[1][2]
              and wall < ERR_TIMEOUT + 30,
              f"path ax: rank 1 died (86), rank 0's watchdog tore it down "
              f"(97) within --err-timeout {ERR_TIMEOUT} s (rcs {rcs})")
        env = {k: v for k, v in CHILD_ENV.items()
               if k != "ACG_TPU_SKIP_BACKEND_PROBE"}
        env.update({faults.ENV_VAR: "backend:hang:secs=60",
                    "ACG_TPU_PROBE_TIMEOUT": str(PROBE_TIMEOUT)})
        rc, text, _, w = proc_cli(man, "ax-backend-hang", env=env)
        say(f"path ax: the dead peer's rcs {rcs} in {wall:.1f} s; the hung "
            f"runtime's rc {rc} in {w:.1f} s; "
            f"{time.perf_counter() - t0:.1f} s")
        check(rc == 3 and f"backend init exceeded {PROBE_TIMEOUT}s" in text
              and w < PROBE_TIMEOUT + 30,
              "path ax: the bounded probe exits BACKEND_UNAVAILABLE (3)")
        return {}

    # the longest first: the pool's tail is its last job
    return Jobs([av, ar, au2, au1, ax, aw_crash],
                lambda: _elastic_local(torch, K, tmp, base, b, csr, prob, man,
                                       z, sst, fault_aq, twins),
                [aq, as_("as-jacobi", ["--precond", "jacobi"]),
                 as_("as-sstep4", ["--algorithm", "sstep:4"])])


def _chaos_fired(hist: str) -> list:
    """Each chaos schedule's (fault, whether it fired, the last child's
    iterations) from the campaign's --history ledger, where each
    schedule's children append their stats documents before the
    campaign's row: a crash relaunched its child once after rc 94; a
    device fault left a breakdown and a restart or rollback in the stats
    of the child that finished; a control run (no fault) fires nothing
    and counts as fired."""
    from acg_tpu_torch import observatory

    out, stats = [], []
    for e in observatory.history_scan(hist):
        doc = e["doc"]
        if doc.get("schema") != "acg-tpu-chaos/1":
            stats.append(doc.get("stats") or {})
            continue
        fault, rec = doc["chaos"]["fault"], doc["recovery"]
        last = stats[-1] if stats else {}
        res = last.get("resilience") or {}
        if fault is None:
            ok = True
        elif fault.startswith("crash:"):
            ok = (rec["attempts"] == 2
                  and [r["rc"] for r in rec["relaunches"]] == [94])
        else:
            ok = (res.get("nbreakdowns", 0) >= 1
                  and res.get("nrestarts", 0) + res.get("nrollbacks", 0) >= 1)
        out.append((fault, ok, last.get("niterations")))
        stats = []
    return out


def _elastic_local(torch, K, tmp, base, b, csr, prob, man, z, sst,
                   fault_aq, twins) -> dict:
    """:func:`elastic_paths`' work in this process: the one-process
    stacked twins of (aq) and (as) into ``twins``, then (at) and (aw)'s
    chunked runs; their launch counts."""
    from acg_tpu_torch import faults
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria
    from acg_tpu_torch.solvers.resilience import RecoveryPolicy

    out = {}
    # the one-process stacked twins, on this process's parts of (e)
    with faults.injected(fault_aq), \
            contextlib.redirect_stderr(io.StringIO()):
        s = DistCGSolver(prob, comm="dma", pipelined=True, device="cuda",
                         recovery=RecoveryPolicy(max_restarts=2))
        twins["aq"] = (s.solve(b, criteria=StoppingCriteria(
            maxits=AF_ITS)), s.stats.niterations, s.stats.nrestarts)
    for tag, kw in (("as-jacobi", dict(precond="jacobi")),
                    ("as-sstep4", dict(algorithm="sstep:4"))):
        s = DistCGSolver(prob, comm="dma", device="cuda", **kw)
        twins[tag] = s.solve(b, criteria=StoppingCriteria(maxits=AF_ITS))
    del s
    torch.cuda.empty_cache()

    # (at) the sharded tier's checkpoints and audit, in this process
    x_out = os.path.join(tmp, "at.bin")
    rc, text, c = run_cli(torch, K, [f"gen:poisson3d:{DIRECT_N}",
                                     "--warmup", "0", "-v",
                                     "--max-iterations", "300",
                                     "--residual-rtol", "0", "--nparts",
                                     str(NPARTS), "--ckpt",
                                     os.path.join(tmp, "at.ckpt"),
                                     "--ckpt-every", "150", "--audit-every",
                                     "100", "-o", x_out], "at-sharded-hooks")
    same = np.array_equal(read_x(x_out), read_x(os.path.join(tmp, "l.bin")))
    say(f"path at: snapshots {stat(text, 'snapshots')}, audits "
        f"{stat(text, 'naudits')}, x bitwise (l)'s = {same}")
    check(rc == 0 and same and stat(text, "snapshots") == "1"
          and stat(text, "naudits") == "3",
          "path at: the chunked, audited sharded solve is (l)'s bits")
    check(c["dia_spmv"] >= 301, "path at ran K1")
    for f in (x_out, os.path.join(tmp, "at.ckpt")):
        os.remove(f)
    out["at"] = c

    # (aw) the batched and s-step checkpoints, in this process
    x_out = os.path.join(tmp, "aw-nrhs.bin")
    bat = base + ["--nparts", str(NPARTS), "--nrhs", str(NRHS),
                  "--manufactured-solution", "--residual-rtol", "0",
                  "--max-iterations", str(BATCH_ITS)]
    rc, text, c = run_cli(torch, K, bat + ["--ckpt", os.path.join(
        tmp, "aw-nrhs.ckpt"), "--ckpt-every", "100", "-o", x_out],
        "aw-nrhs-ckpt")
    with open(x_out, "rb") as f1, open(os.path.join(
            tmp, "ab-4part-nrhs.bin"), "rb") as f2:
        same = f1.read() == f2.read()
    say(f"path aw: --nrhs 8 chunked every 100: (ab)'s bytes = {same}")
    check(rc == 0 and same and stat(text, "snapshots") == "1",
          "path aw: the chunked --nrhs 8 run is (ab)'s bits")
    x_out = os.path.join(tmp, "aw-sstep.bin")
    rc, text, c2 = run_cli(torch, K, sst + ["--ckpt", os.path.join(
        tmp, "aw-s1.ckpt"), "-o", x_out], "aw-sstep-ckpt")
    same = np.array_equal(read_x(x_out), z)
    say(f"path aw: sstep:4 chunked every 512: (z-sstep4)'s bits = {same}, "
        f"snapshots {stat(text, 'snapshots')}")
    check(rc == 0 and same, "path aw: sstep:4 chunked is (z-sstep4)'s bits")
    out["aw"] = {k: c.get(k, 0) + c2.get(k, 0) for k in c2}

    return out


AUTOTUNE_SPEC = "gen:poisson2d:512"
# the reference's candidate labels: algorithm/kernels/comm/precond/operand
PLAN_LABEL = re.compile(r"^(classic|pipelined|sstep:\d+|pipelined:\d+)/"
                        r"(auto|fused)/(xla|dma)/(none|jacobi|bjacobi:\d+|"
                        r"cheby:\d+)/(assembled|matfree)$")
# the hand kernels of one iteration of each --explain tier under --comm
# dma: K1 (single or batched over parts), K5, K6 and the per-part dot
EXPLAIN_LAUNCHES = {"cg": {"dia_spmv": 1.0},
                    "cg-pipelined": {"dia_spmv": 1.0,
                                     "pipelined_update": 1.0},
                    "dist-cg": {"dia_spmv_batched": 1.0, "halo_put": 1.0,
                                "part_dot": 2.0}}


def probe_twin_path(torch, K, prob, b):
    """(ay-twin), in this process once no job runs: the probes leave the
    solve loop unchanged on the card.  The flagship's 4 parts under dma
    solve ``b`` to 1e-8; then the segment probes
    (``commbench.segment_decomposition``) and the planner's count of a
    reduction round and a halo exchange run on the same solver; then the
    same solve again: x bitwise, the iterations and each kernel's
    launches equal."""
    from acg_tpu_torch import commbench as cb
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria

    t0 = time.perf_counter()
    start = dict(K.launches)
    s = DistCGSolver(prob, comm="dma", device="cuda")
    crit = StoppingCriteria(maxits=20000, residual_rtol=1e-8)

    def solve():
        before = dict(K.launches)
        x = s.solve(b, criteria=crit)
        torch.cuda.synchronize()
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        return x, int(s.stats.niterations), {
            n: v - before.get(n, 0) for n, v in K.launches.items()
            if v - before.get(n, 0)}

    x0, it0, c0 = solve()
    segs = cb.segment_decomposition(s, b, reps=4, repeats=1)
    rounds = cb.comm_round_dispatches(s, b)
    x1, it1, c1 = solve()
    check(segs["available"] and set(segs["segments"]) == {
        "spmv", "halo", "reduction"}, "path ay-twin: the probes ran")
    check(np.array_equal(x0, x1) and it0 == it1 and c0 == c1,
          f"path ay-twin: the solve after the probes is the solve before "
          f"them (bitwise x: {np.array_equal(x0, x1)}, iterations "
          f"{it0}/{it1}, launches {c0} / {c1})")
    counts = {n: v - start.get(n, 0) for n, v in K.launches.items()}
    say(f"path ay-twin: {it0} iterations twice, x bitwise equal, "
        f"launches a solve {c0}, around the probes "
        f"{segs.get('kernel_launches')} and a comm round {rounds}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ay-twin": counts}


def decision_paths(torch, K, tmp):
    """Paths (ay)-(ba), the communication and decision layers, as two
    child-process jobs ((ay) then (az); (ba), which waits for (ay)'s
    calibration):
    (ay) ``--commbench`` on the flagship's 4 parts under dma: the
    document validates with no ``unavailable`` entry, alpha >= 0 and
    beta > 0 for each kind, the segments positive, K6's launches the
    dense sweep's, the edges', the SpMV and halo probes' (warm-up,
    timed and counted chains) and the timed solve's exchanges; (az) ``--explain --calibration``:
    the calibration header and the three tiers, each with a verdict and
    a dispatch term, one iteration's counted hand kernels the loop's
    (K1, K5, K6 and the per-part dot), the timed solves' launches those
    of their iterations; (ba) ``--autotune --calibration`` twice at
    512^2 on 4 parts with a --history ledger: both dispatch a probed
    winner (never the fallback), each plan validates with the
    reference's labels, the plan-vs-actual row lands, and the second
    plan self-corrects.  The card is shared with the other jobs while
    these run: their checks are structural, their times are not kept."""
    from acg_tpu_torch import commbench as cb
    from acg_tpu_torch import planner

    cal = os.path.join(tmp, "ay-cal.json")
    base = [MAIN_SPEC, "--nparts", str(NPARTS), "--comm", "dma",
            "--max-iterations", "60", "--warmup", "0", "-q"]

    def commbench_run() -> dict:
        rc, text, c, wall = proc_cli(base + ["--commbench", cal],
                                     "ay-commbench")
        check(rc == 0 and os.path.exists(cal), "path ay: --commbench ran")
        with open(cal) as f:
            doc = json.load(f)
        check(cb.validate_commbench(doc) == [] and "unavailable" not in
              json.dumps(doc), "path ay: the document validates, every "
              "kind and segment measured")
        for kind in cb.KINDS:
            fit = doc["collectives"][kind]
            check(fit["alpha_s"] >= 0 and fit["beta_s_per_byte"] > 0,
                  f"path ay: {kind} alpha >= 0, beta > 0")
        segs = doc["segments"]["segments"]
        check(set(segs) == {"spmv", "halo", "reduction"} and all(
            v["s_per_iteration"] > 0 for v in segs.values()),
            "path ay: the SpMV, halo and reduction segments positive")
        reps, rep = doc["reps"], doc["timed_repeats"]
        seg_l = doc["segments"].get("kernel_launches", {})
        L = doc.get("kernel_launches", {})
        nits = doc["case"]["timed_iterations"]
        want = {"dma_sweep": len(doc["sweep_bytes"]) * (1 + rep) * reps,
                "edges": len(doc["edges"]) * (1 + rep) * reps,
                # the warm-up chain, the timed ones, the counted one
                "spmv probe": (2 + rep) * cb.SEGMENT_REPS,
                "halo probe": (2 + rep) * cb.SEGMENT_REPS,
                # one warm-up solve and the timed ones, each its
                # iterations' exchanges and the setup residual's
                "timed solve": (1 + doc["case"]["timed_solves"])
                * (nits + 1)}
        got = {"dma_sweep": L.get("dma_sweep", {}).get("halo_put", 0),
               "edges": L.get("edges", {}).get("halo_put", 0),
               "spmv probe": seg_l.get("spmv", {}).get("halo_put", 0),
               "halo probe": seg_l.get("halo", {}).get("halo_put", 0),
               "timed solve": L.get("timed_solve", {}).get("halo_put", 0)}
        check(got == want and c.get("halo_put") == sum(want.values()),
              f"path ay: K6's launches {c.get('halo_put')} are the "
              f"phases' exchanges {got} (want {want})")
        meas = doc["case"]["measured_s_per_iteration"]
        say(f"path ay: {doc['calibration_id']}; fits " + "; ".join(
            f"{k} alpha {doc['collectives'][k]['alpha_s']:.3e} s beta "
            f"{doc['collectives'][k]['beta_s_per_byte']:.3e} s/B"
            for k in cb.KINDS) + "; edges " + ", ".join(
            f"d={e['distance']} {e['put_wait_seconds']:.3e} s"
            for e in doc["edges"]) + "; segments " + ", ".join(
            f"{k} {v['s_per_iteration']:.3e}" for k, v in segs.items())
            + f" s/iter, explained "
            f"{doc['segments']['explained_s_per_iteration']:.3e} of "
            f"measured {meas:.3e} s/iter; {wall:.1f} s")
        return c

    def explain_run() -> dict:
        sj = os.path.join(tmp, "az-explain.jsonl")
        rc, text, c, wall = proc_cli(base + [
            "--explain", "--calibration", cal, "--no-probe-cache",
            "--stats-json", sj], "az-explain")
        check(rc == 0 and "== explain: calibration ==" in text
              and "WARNING" not in text,
              "path az: --explain --calibration ran on a matching "
              "calibration")
        with open(sj) as f:
            rows = [json.loads(ln)["manifest"]["explain"] for ln in f
                    if ln.strip()]
        check(len(rows) == 3, "path az: three tiers reported")
        for row in rows:
            tier = row["tier"].split(" ")[0]
            per_it = row["kernel_launches_per_iteration"]
            timed = row["timed_kernel_launches"]
            k = row["timed_iterations"]
            check(per_it == EXPLAIN_LAUNCHES[tier],
                  f"path az: one {tier} iteration launches "
                  f"{EXPLAIN_LAUNCHES[tier]} (counted {per_it})")
            check(all(0 <= timed.get(n, 0) - 2 * k * v <= 8
                      for n, v in per_it.items()),
                  f"path az: the {tier} timed solves' launches {timed} "
                  f"are 2 x {k} iterations' and the setup's")
            check(row["components_s"]["dispatch-bound"] > 0
                  and row["bound"].endswith("-bound"),
                  f"path az: {tier} has a verdict and a dispatch term")
            say(f"path az: {row['tier']}: measured "
                f"{row['measured_s_per_iter']:.3e} s/iter, predicted "
                f"{row['predicted_s_per_iter']:.3e} (uncalibrated "
                f"{row['uncalibrated_predicted_s_per_iter']:.3e}); "
                f"{row['dispatches_per_iteration']:g} dispatches/iter; "
                f"components " + ", ".join(
                    f"{n} {v:.3e}" for n, v in row["components_s"].items())
                + f"; verdict {row['bound']}")
        return c

    def autotune_runs() -> dict:
        hist = os.path.join(tmp, "ba-hist")
        out, plans = {}, []
        for i in (1, 2):
            plan = os.path.join(tmp, f"ba-plan{i}.json")
            st = os.path.join(tmp, f"ba-stats{i}.json")
            rc, text, c, wall = proc_cli([
                AUTOTUNE_SPEC, "--nparts", str(NPARTS), "--autotune",
                "--calibration", cal, "--no-probe-cache", "--plan", plan,
                "--history", hist, "--stats-json", st, "--residual-rtol",
                "1e-6", "--max-iterations", "3000", "--warmup", "0", "-q"],
                f"ba-autotune-{i}")
            check(rc == 0 and "autotune: dispatching" in text
                  and "provenance: fallback" not in text,
                  f"path ba: run {i} dispatched a probed winner")
            with open(plan) as f:
                doc = json.load(f)
            with open(st) as f:
                row = json.load(f)["stats"]["plan"]
            check(planner.validate_plan(doc) == [] and all(
                PLAN_LABEL.match(r["label"]) for r in doc["ranked"]),
                f"path ba: plan {i} validates, the reference's labels")
            check(row["source"] == "planned"
                  and row["plan_id"] == doc["plan_id"]
                  and row["measured_s_per_solve"] > 0,
                  f"path ba: run {i}'s plan-vs-actual row")
            say(f"path ba: run {i}: {row['selected']}, predicted "
                f"{row['predicted_s_per_solve']:.3e} s, measured "
                f"{row['measured_s_per_solve']:.3e} s "
                f"(x{row['misprediction_ratio']:.3f}), correction "
                f"x{doc['correction']['scale']:.3f} over "
                f"{doc['correction']['nsamples']}; {wall:.1f} s")
            plans.append(doc)
            out[f"ba-{i}"] = c
        corr = plans[1]["correction"]
        check(corr["nsamples"] >= 1 and corr["scale"] != 1.0,
              "path ba: the second plan self-corrects from the first "
              "run's row")
        return out

    import threading
    calibrated = threading.Event()
    state = {}

    def commbench_explain() -> dict:
        t0 = time.perf_counter()
        try:
            state["ay"] = commbench_run()
        finally:
            calibrated.set()
        out = {"ay": state["ay"], "az": explain_run()}
        say(f"paths ay-az took {time.perf_counter() - t0:.1f} s")
        return out

    def autotune() -> dict:
        t0 = time.perf_counter()
        calibrated.wait(MP_TIMEOUT)
        check("ay" in state, "path ba: (ay)'s calibration was written")
        out = autotune_runs()
        say(f"path ba took {time.perf_counter() - t0:.1f} s (its wait for "
            f"(ay) included)")
        return out

    return Jobs([commbench_explain, autotune], lambda: {}, [])


SERVE_SMALL = "gen:poisson2d:512"   # (bd) and (be): relaunches, not rates
SERVE_TOL = {"rtol": 1e-9, "maxits": 20000}
SERVE_SLOW_S = 4.0       # the slow lead that holds (bb)'s worker
# a request's deadline on the flagship daemons: (bb)'s members wait out
# the lead, its solve and the batch's warm-up and solve, ~1 min on a
# loaded card, past the daemon's default 60 s
SERVE_DEADLINE = ["--serve-deadline", "600"]
CHAOS_SERVE_SEED = 5     # (be): schedules dot:nan@2, crash, slow, dot:nan@6


class ServeChild:
    """``python -m acg_tpu_torch ARGV -vv`` as a long-lived child (a
    ``--serve`` daemon or its supervisor), its stderr in a file: the port
    lines it prints, its exit on SIGTERM."""

    def __init__(self, argv, tag, tmp):
        self.tag, self.argv = tag, argv
        self.log = os.path.join(tmp, f"{tag}.stderr")
        self._f = open(self.log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "acg_tpu_torch", *argv, "-vv"],
            cwd=HERE, env=CHILD_ENV, stdout=subprocess.DEVNULL,
            stderr=self._f)

    def text(self) -> str:
        with open(self.log) as f:
            return f.read()

    def port(self, nth: int = 1, timeout: float = MP_TIMEOUT) -> int:
        """The port of the ``nth`` daemon this child started."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            ports = re.findall(r"listening on port (\d+)", self.text())
            if len(ports) >= nth:
                return int(ports[nth - 1])
            check(self.proc.poll() is None,
                  f"path {self.tag}: the daemon is up (stderr: "
                  f"{self.text()[-2000:]})")
            time.sleep(0.2)
        raise AssertionError(f"path {self.tag}: no daemon listened in "
                             f"{timeout:.0f} s")

    def stop(self, timeout: float = 120.0) -> tuple:
        """SIGTERM, then (rc, stderr text); logged with the wall time."""
        import signal
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=timeout)
        self._f.close()
        text = self.text()
        LOG.append(f"--- {self.tag}: rc={rc} {' '.join(self.argv)}\n{text}")
        say(f"path {self.tag}: rc={rc} wall "
            f"{time.perf_counter() - self.t0:.1f} s (a daemon child)")
        _no_fallback(text, self.tag)
        return rc, text

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self._f.closed:
            self._f.close()


def _http(base, method, path, doc=None, timeout=300.0):
    from acg_tpu_torch.serve import _http_json
    return _http_json(method, base + path, doc, timeout=timeout)


def _http_text(base, path, timeout=60.0) -> str:
    import urllib.request
    with urllib.request.urlopen(base + path, timeout=timeout) as resp:
        return resp.read().decode()


def _metric(text: str, name: str) -> float:
    """The sum of a family's samples in a Prometheus exposition."""
    total = 0.0
    for line in text.splitlines():
        head, _, val = line.rpartition(" ")
        if not line.startswith("#") and (head == name
                                         or head.startswith(name + "{")):
            total += float(val)
    return total


def _serving(base, timeout=MP_TIMEOUT) -> dict:
    """Wait for ``base`` to answer /healthz; its /status document."""
    from acg_tpu_torch.serve import _wait_serving
    check(_wait_serving(base, timeout), f"{base} came up")
    return _http(base, "GET", "/status")[1]


def _until(cond, what, timeout=60.0, every=0.05):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            if cond():
                return
        except OSError:
            pass
        time.sleep(every)
    raise AssertionError(f"chip_smoke: timed out waiting for {what}")


def _held(base, rid: str, timeout: float = 60.0) -> None:
    """Wait until the daemon's worker holds request ``rid``: popped from
    the queue, its coalesce window closed (its /requests document has
    the stage), its solve begun -- not merely admitted."""
    def held():
        docs = _http(base, "GET", "/requests")[1]["inflight"]
        return any(d["request_id"] == rid and "coalesce" in d["stages"]
                   for d in docs)
    _until(held, f"the worker to hold {rid}", timeout)


def _ended(child) -> tuple:
    """Stop ``child`` if it still runs: (rc, stderr text)."""
    try:
        if child.proc.poll() is None:
            return child.stop()
        LOG.append(f"--- {child.tag}: rc={child.proc.returncode} "
                   f"{' '.join(child.argv)}\n{child.text()}")
        return child.proc.returncode, child.text()
    finally:
        child.kill()


def _rel_res(A, b, x) -> float:
    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def service_paths(torch, K, tmp, csr):
    """Paths (bb)-(be), the service layer, as child-process jobs: every
    daemon a ``python -m acg_tpu_torch ... --serve`` child on localhost,
    its requests sent from this process, every green answer verified
    here against the host matrix (b is ``default_rng(b_seed)``'s normals,
    as the daemon draws it).
    (bb) the single-part daemon on the flagship: the operator preloaded,
    a first request missing only the program cache and a second hitting
    both with ``acg_compiles_total`` unmoved, the first bitwise the
    one-shot CLI solve of the same b (``--kernels xla``, the daemon's
    single-RHS program); three requests queued behind a slow lead
    coalesced into one batch, each bitwise its single answer with the
    same iterations; a typed 504 for an expired deadline and a typed 500
    for maxits 2; /status, /metrics and /requests; the access log through
    the reference's checker; SIGTERM: exit 0, the "served" line, a
    timeline with the worker row and request lanes.  (bb-429) a second
    daemon at queue depth 1 sheds a typed 429.  (bc) the 4-part daemon
    under dma: a classic and a pipelined request each bitwise the
    one-shot CLI solve of the same b on the same tier, same iterations,
    and its launches (batched K1, K6, the per-part dot, K5) twice the
    CLI runs' (each request a program miss: a warm-up and the solve).
    (bd) ``--serve --supervise --nparts 4 --shrink any --grow-after 2`` at
    512^2: a crash request kills the daemon, the relaunch serves on 2
    parts and warm-restores, and after 2 served requests it regrows to 4.
    (be) the live chaos campaign at 512^2: exit 0, every green answer
    verified, the daemon serving at the end.  Returns the jobs; each logs
    the numbers PERF.md keeps."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx

    n = csr.shape[0]

    def b_of(seed, size=n):
        return np.random.default_rng(seed).standard_normal(size)

    def b_file(seed, tag):
        path = os.path.join(tmp, f"{tag}-b{seed}.bin")
        write_mtx(path, vector_mtx(b_of(seed)), binary=True)
        return path

    def doc(**kw):
        d = {"matrix": MAIN_SPEC, **SERVE_TOL}
        d.update(kw)
        return d

    def single() -> dict:
        t_job = time.perf_counter()
        ledger = os.path.join(tmp, "bb-access.jsonl")
        tl = os.path.join(tmp, "bb-timeline.json")
        d = ServeChild([MAIN_SPEC, "--serve", "--serve-port", "0",
                        "--serve-faults", "--serve-coalesce", "4",
                        "--access-log", ledger, "--timeline", tl, "--ckpt",
                        os.path.join(tmp, "bb-ck")] + SERVE_DEADLINE, "bb",
                       tmp)
        try:
            # the one-shot CLI solve of request 1's system while the daemon
            # ingests
            xcli = os.path.join(tmp, "bb-cli.bin")
            rc, text, _, cli_wall = proc_cli([
                MAIN_SPEC, b_file(1, "bb"), "--binary", "--kernels", "xla",
                "--residual-rtol", str(SERVE_TOL["rtol"]),
                "--max-iterations", str(SERVE_TOL["maxits"]),
                "--warmup", "0", "-q", "-o", xcli], "bb-cli")
            check(rc == 0, "path bb: the one-shot CLI solve ran")
            cli_its = int(stat(text, "iterations").replace(",", ""))
            cli_solve = stat(text, "total solver time")
            base = f"http://127.0.0.1:{d.port()}"
            st = _serving(base)
            check(st["operator_cache"]["keys"] == [[MAIN_SPEC, "f64", 0]],
                  "path bb: the operator is preloaded")
            comp0 = _metric(_http_text(base, "/metrics"),
                            "acg_compiles_total")
            s1, r1 = _http(base, "POST", "/solve", doc(b_seed=1))
            comp1 = _metric(_http_text(base, "/metrics"),
                            "acg_compiles_total")
            s2, r2 = _http(base, "POST", "/solve", doc(b_seed=2))
            comp2 = _metric(_http_text(base, "/metrics"),
                            "acg_compiles_total")
            res = [_rel_res(csr, b_of(k), r["x"]) for k, r in ((1, r1),
                                                               (2, r2))]
            check(s1 == s2 == 200 and r1["cache"] == {
                "operator": "hit", "program": "miss"} and r2["cache"] == {
                "operator": "hit", "program": "hit"},
                  f"path bb: miss then hit ({r1.get('cache')}, "
                  f"{r2.get('cache')})")
            check(comp1 > comp0 and comp2 == comp1,
                  f"path bb: the miss absorbed a warm-up, the hit none "
                  f"(acg_compiles_total {comp0}, {comp1}, {comp2})")
            check(max(res) <= 1e-8, f"path bb: true residuals {res} <= "
                                    f"1e-8")
            check(np.array_equal(np.asarray(r1["x"]), read_x(xcli))
                  and r1["iterations"] == cli_its,
                  "path bb: request 1 bitwise the one-shot CLI solve, "
                  "same iterations")
            # coalescing: three singles, then the same three queued behind
            # a slow lead and drained as one batch
            singles = {s: _http(base, "POST", "/solve", doc(
                b_seed=s, coalesce=False, request_id=f"bb-single-{s}"))[1]
                for s in (11, 22, 33)}
            check(all(r.get("coalesced") == 1 for r in singles.values()),
                  "path bb: three single answers")
            import threading
            got = {}

            def post(key, body):
                got[key] = _http(base, "POST", "/solve", body)

            lead = threading.Thread(target=post, args=("lead", doc(
                b_seed=99, fault=f"slow:{SERVE_SLOW_S}",
                request_id="bb-lead")))
            lead.start()
            _held(base, "bb-lead")
            members = [threading.Thread(target=post, args=(s, doc(
                b_seed=s, request_id=f"bb-member-{s}")))
                for s in (11, 22, 33)]
            for t in members:
                t.start()
            _until(lambda: _http(base, "GET", "/status")[1][
                "queue_depth"] == 3, "three queued members")
            for t in [lead] + members:
                t.join(timeout=MP_TIMEOUT)
            for s in (11, 22, 33):
                st_, r = got[s]
                xs, x1 = (np.asarray(v.get("x", [np.nan])) for v in (
                    r, singles[s]))
                diff = (float(np.max(np.abs(xs - x1)))
                        if xs.shape == x1.shape else None)
                check(st_ == 200 and r["coalesced"] == 3
                      and np.array_equal(xs, x1)
                      and r["iterations"] == singles[s]["iterations"],
                      f"path bb: member {s} coalesced {r.get('coalesced')} "
                      f"wide (3), bitwise its single answer (max diff "
                      f"{diff}), iterations {r.get('iterations')} "
                      f"({singles[s].get('iterations')}); status {st_} "
                      f"{r.get('error')}")
                check(_rel_res(csr, b_of(s), r["x"]) <= 1e-8,
                      f"path bb: member {s} verified")
            # the typed answers: an expired deadline, maxits too small
            lead = threading.Thread(target=post, args=("lead2", doc(
                b_seed=98, fault="slow:2", request_id="bb-lead2")))
            lead.start()
            _held(base, "bb-lead2")
            s504, r504 = _http(base, "POST", "/solve",
                               doc(b_seed=97, timeout=0.5))
            lead.join(timeout=MP_TIMEOUT)
            s500, r500 = _http(base, "POST", "/solve",
                               doc(b_seed=1, maxits=2))
            check(s504 == 504 and r504["error"]["type"] == "deadline-expired"
                  and r504["error"]["retryable"],
                  "path bb: a typed 504 for an expired deadline")
            check(s500 == 500 and r500["error"]["type"] ==
                  "NotConvergedError", "path bb: a typed 500 for maxits 2")
            status = _http(base, "GET", "/status")[1]
            reqs = _http(base, "GET", "/requests")[1]
            expo = _http_text(base, "/metrics")
            check(status["schema"] == "acg-serve/1"
                  and reqs["schema"] == "acg-serve-requests/1"
                  and "acg_serve_requests_total" in expo
                  and status["requests"]["outcomes"].get("ok") == 10,
                  "path bb: /status, /requests and /metrics answer")
        finally:
            rc, text = _ended(d)
        check(rc == 0 and "served 10 request(s), 1 failed -- bye" in text,
              "path bb: SIGTERM: exit 0 with its served line")
        counts = launch_lines(text)[-1]
        chk = subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts",
                                          "check_access_log.py"), ledger,
             "--min-rows", "12", "--require-outcome", "ok",
             "--require-outcome", "deadline-expired",
             "--require-outcome", "request-failed"],
            capture_output=True, text=True)
        check(chk.returncode == 0, f"path bb: the access log passes the "
              f"checker ({chk.stderr[-500:]})")
        chk = subprocess.run([sys.executable, os.path.join(
            HERE, "scripts", "check_timeline.py"), tl], capture_output=True,
            text=True)
        with open(tl) as f:
            rows = {e.get("args", {}).get("name") for e in
                    json.load(f)["traceEvents"] if e.get("ph") == "M"}
        check(chk.returncode == 0 and "serve worker" in rows
              and "request lane 0" in rows,
              "path bb: the timeline has the worker row and request lanes")
        with open(ledger) as f:
            led = [json.loads(ln) for ln in f]
        by_id = {r["id"]: r for r in led}

        def stages(r):
            return ", ".join(f"{k} {v:.4f}" for k, v in
                             by_id[r["id"]]["stages"].items())

        coal = [r for r in led if r["request_id"].startswith("bb-member")]
        singles_s = sum(singles[s]["latency_seconds"] for s in (11, 22, 33))
        say(f"path bb: miss {r1['latency_seconds']:.3f} s ({stages(r1)}), "
            f"hit {r2['latency_seconds']:.3f} s ({stages(r2)}), "
            f"{r1['iterations']} and {r2['iterations']} iterations; the "
            f"one-shot CLI {cli_wall:.1f} s of wall (solver {cli_solve}); "
            f"coalesced 3: batch solve "
            f"{coal[0]['batch']['solve_seconds']:.3f} s (its warm-up "
            f"{coal[0]['stages'].get('compile', 0.0):.3f} s) against the "
            f"three singles' {singles_s:.3f} s; launches {counts}; "
            f"{time.perf_counter() - t_job:.1f} s")
        return {"bb": counts}

    def queue_full() -> dict:
        t_job = time.perf_counter()
        d = ServeChild([MAIN_SPEC, "--serve", "--serve-port", "0",
                        "--serve-queue-depth", "1", "--serve-faults"],
                       "bb-429", tmp)
        try:
            base = f"http://127.0.0.1:{d.port()}"
            _serving(base)
            import threading
            got = {}

            def post(key, body):
                got[key] = _http(base, "POST", "/solve", body)

            lead = threading.Thread(target=post, args=("lead", doc(
                b_seed=1, maxits=2, fault=f"slow:{SERVE_SLOW_S}",
                request_id="bb429-lead")))
            lead.start()
            _held(base, "bb429-lead")
            filler = threading.Thread(target=post, args=("filler", doc(
                b_seed=2, maxits=2)))
            filler.start()
            _until(lambda: _http(base, "GET", "/status")[1][
                "queue_depth"] == 1, "(bb-429)'s queue to fill")
            s429, r429 = _http(base, "POST", "/solve", doc(b_seed=3))
            for t in (lead, filler):
                t.join(timeout=MP_TIMEOUT)
        finally:
            rc, text = _ended(d)
        check(s429 == 429 and r429["error"]["type"] == "shed-queue-full"
              and r429["error"]["retryable"],
              "path bb-429: a full queue of depth 1 sheds a typed 429")
        check(rc == 0 and got["lead"][0] == got["filler"][0] == 500,
              "path bb-429: the queued requests answered, exit 0")
        say(f"path bb-429: {time.perf_counter() - t_job:.1f} s")
        return {"bb-429": launch_lines(text)[-1]}

    def four_parts() -> dict:
        t_job = time.perf_counter()
        ledger = os.path.join(tmp, "bc-access.jsonl")
        d = ServeChild([MAIN_SPEC, "--serve", "--serve-port", "0",
                        "--nparts", str(NPARTS), "--comm", "dma",
                        "--access-log", ledger] + SERVE_DEADLINE, "bc", tmp)
        cli, cli_counts = {}, []
        try:
            for seed, extra in ((5, []), (6, ["--solver", "acg-pipelined"])):
                xo = os.path.join(tmp, f"bc-cli{seed}.bin")
                rc, text, c, wall = proc_cli([
                    MAIN_SPEC, b_file(seed, "bc"), "--binary", "--nparts",
                    str(NPARTS), "--comm", "dma", "--residual-rtol",
                    str(SERVE_TOL["rtol"]), "--max-iterations",
                    str(SERVE_TOL["maxits"]), "--warmup", "0", "-q", "-o",
                    xo] + extra, f"bc-cli{seed}")
                check(rc == 0, f"path bc: the one-shot CLI solve {seed} ran")
                cli[seed] = (read_x(xo), int(stat(text, "iterations")
                                             .replace(",", "")),
                             stat(text, "total solver time"), wall)
                cli_counts.append(c)
            base = f"http://127.0.0.1:{d.port()}"
            _serving(base)
            answers = {5: _http(base, "POST", "/solve", doc(b_seed=5)),
                       6: _http(base, "POST", "/solve",
                                doc(b_seed=6, algorithm="pipelined"))}
        finally:
            rc, text = _ended(d)
        check(rc == 0, "path bc: the 4-part daemon exits 0")
        for seed, (s, r) in answers.items():
            x, its, _, _ = cli[seed]
            # pipelined CG's true residual trails its recurrence's: held to
            # path (b)'s 1e-6, classic to 1e-8
            lim = 1e-8 if seed == 5 else 1e-6
            rel = _rel_res(csr, b_of(seed), r["x"]) if s == 200 else None
            check(s == 200 and rel <= lim, f"path bc: request {seed} "
                  f"verified (true residual {rel} <= {lim:g})")
            check(np.array_equal(np.asarray(r["x"]), x)
                  and r["iterations"] == its,
                  f"path bc: request {seed} bitwise the one-shot CLI solve "
                  f"on the same tier, {its} iterations")
        counts = launch_lines(text)[-1]
        want = {k: 2 * sum(c.get(k, 0) for c in cli_counts)
                for k in ("dia_spmv_batched", "halo_put", "part_dot",
                          "pipelined_update")}
        check(all(counts.get(k) == v > 0 for k, v in want.items()),
              f"path bc: the daemon's launches {counts} are twice the CLI "
              f"solves' (a warm-up and the solve each) {want}")
        with open(ledger) as f:
            led = {json.loads(ln)["id"]: json.loads(ln) for ln in f}
        numbers = {
            seed: {"latency_s": r["latency_seconds"],
                   "solve_s": led[r["id"]]["stages"]["solve"],
                   "iterations": r["iterations"], "cli_solver": cli[seed][2]}
            for seed, (s, r) in answers.items()}
        say(f"path bc: " + "; ".join(
            f"{'classic' if k == 5 else 'pipelined'} {v['iterations']} "
            f"iterations, solve {v['solve_s']:.3f} s (latency "
            f"{v['latency_s']:.3f} s with its warm-up), the CLI's solver "
            f"time {v['cli_solver']}" for k, v in numbers.items())
            + f"; launches {counts}; {time.perf_counter() - t_job:.1f} s")
        return {"bc": counts}

    small = None

    def small_csr():
        nonlocal small
        if small is None:
            small = synthesize_host_matrix(SERVE_SMALL).to_csr()
        return small

    def supervised() -> dict:
        t_job = time.perf_counter()
        A = small_csr()
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        sup = ServeChild([SERVE_SMALL, "--serve", "--serve-port", str(port),
                          "--supervise", "--nparts", str(NPARTS),
                          "--shrink", "any", "--grow-after", "2",
                          "--serve-faults", "--relaunch-backoff", "0",
                          "--ckpt", os.path.join(tmp, "bd-ck")], "bd", tmp)
        small_doc = {"matrix": SERVE_SMALL, **SERVE_TOL}
        res, parts = [], []
        try:
            parts.append(_serving(base)["nparts"])
            s, r = _http(base, "POST", "/solve", dict(small_doc, b_seed=1))
            res.append(_rel_res(A, b_of(1, A.shape[0]), r["x"]))
            t_crash = time.perf_counter()
            try:
                _http(base, "POST", "/solve", dict(small_doc,
                                                   fault="crash"), 60.0)
                crashed = False
            except OSError:
                crashed = True
            sup.port(nth=2)
            st = _serving(base)
            mttr = time.perf_counter() - t_crash
            parts.append(st["nparts"])
            warm = _metric(_http_text(base, "/metrics"),
                           "acg_serve_warm_restores_total")
            for seed in (2, 3):
                s, r = _http(base, "POST", "/solve",
                             dict(small_doc, b_seed=seed))
                res.append(_rel_res(A, b_of(seed, A.shape[0]), r["x"]))
            sup.port(nth=3)
            parts.append(_serving(base)["nparts"])
            s, r = _http(base, "POST", "/solve", dict(small_doc, b_seed=4))
            res.append(_rel_res(A, b_of(4, A.shape[0]), r["x"]))
        finally:
            rc, text = _ended(sup)
        check(crashed and parts == [NPARTS, NPARTS // 2, NPARTS]
              and st["warm_restored"] >= 1 and warm >= 1,
              f"path bd: the crash relaunched on {parts[1:2]} parts, "
              f"warm-restored, then regrew ({parts})")
        check(len(res) == 4 and max(res) <= 1e-8,
              f"path bd: every answer verified ({res})")
        check(rc == 0 and "relaunches: 1" in text and "regrows: 1" in text,
              "path bd: the supervisor exits 0 after one relaunch and one "
              "regrow")
        counts = _sum_counts(launch_lines(text))
        say(f"path bd: parts {parts}, relaunch to serving {mttr:.1f} s, "
            f"true residuals {[f'{v:.2e}' for v in res]}, launches "
            f"{counts}; {time.perf_counter() - t_job:.1f} s")
        return {"bd": counts}

    def chaos() -> dict:
        t_job = time.perf_counter()
        hist = os.path.join(tmp, "be-hist")
        rc, text, _, wall = proc_cli([
            SERVE_SMALL, "--serve", "--serve-faults", "--chaos",
            f"{CHAOS_SERVE_SEED}:4", "--ckpt", os.path.join(tmp, "be-ck"),
            "--relaunch-backoff", "0", "--max-iterations", "3000",
            "--residual-rtol", "1e-8", "--history", hist], "be-chaos-serve")
        from acg_tpu_torch import observatory
        rows = [e["doc"]["chaos"] for e in observatory.history_scan(hist)
                if e["doc"].get("schema") == "acg-tpu-chaos-serve/1"]
        verdicts = [r["verdict"] for r in rows]
        check(rc == 0 and len(rows) == 4 and "crash-relaunched" in verdicts
              and set(verdicts) <= {"verified", "typed-error",
                                    "crash-relaunched"}
              and "final probe: verified" in text
              and "warm-restored" in text,
              f"path be: the live campaign exits 0, every green answer "
              f"verified, serving at the end ({verdicts})")
        counts = _sum_counts(launch_lines(text))
        say(f"path be: {list(zip([r['fault'] for r in rows], verdicts))}, "
            f"launches {counts}; {time.perf_counter() - t_job:.1f} s")
        return {"be": counts}

    return [single, four_parts, queue_full, supervised, chaos]


def k6_peer_checks(torch, K, tmp, inputs):
    """K6's cross-process form on the card, NPROC processes: on path
    (h)'s irregular plan and the flagship's band plan, in f64, f32 and
    bf16, each rank's receive plane against the plain version (gloo
    all_to_all of host copies) and the stacked halo_put, bitwise; twice
    to the same bits; nothing written outside the gated rows; then the
    median of 50 lockstep exchanges with their stages apart (acks, put,
    flag waits), of 20 pre-signalled exchanges (every other rank has put
    and gone idle) beside the plain version and one all_to_all_single of
    the plane (the library call); once, the one-flag ping-pong floor
    between the contexts, and a stopped peer, which must make rank 0
    raise within its timeout.  Returns rank 0's results by (plan, kind),
    the floor on the band plan's f64 entry."""
    arrays = {}
    for plan in ("halo", "halo_irr"):
        for kind in ("f64", "f32", "bf16"):
            send, cnt = inputs[(plan, kind)]
            raw = send.contiguous().view(
                {8: torch.int64, 4: torch.int32, 2: torch.int16}[
                    send.element_size()])
            arrays[f"{plan}-{kind}-send"] = raw.cpu().numpy()
            arrays[f"{plan}-{kind}-counts"] = cnt.cpu().numpy()
    npz = os.path.join(tmp, "k6peer.npz")
    np.savez(npz, **arrays)
    t0 = time.perf_counter()
    res = run_pair(lambda r, port: [os.path.join(HERE, "chip_smoke.py"),
                                    "--k6-peer-child", npz, str(port),
                                    str(r)], "k6-peer")
    for r, (rc, out, err) in enumerate(res):
        check(rc == 0, f"K6 peer child {r} exit 0 (its stderr ends: "
                       f"{err[-800:]!r})")
    doc = json.loads(res[0][1].strip().splitlines()[-1])
    got = doc["k6_peer"]
    for key, v in got.items():
        say(f"K6 halo_put_peer {key} on {NPROC} processes: bitwise plain / "
            f"stacked / twice / ungated rows untouched = {v['checks']}; "
            f"median {v['ms']:.4f} ms a lockstep exchange (acks "
            f"{v['ack_ms']:.4f}, put {v['put_ms']:.4f}, flag waits "
            f"{v['wait_ms']:.4f}; pre-signalled {v['presignalled_ms']:.4f} "
            f"ms, its acks / put / flags / flag waits "
            f"{' / '.join(f'{x:.4f}' for x in v['presignalled_stages_ms'])}"
            f", {v['presignalled_host_ms']:.4f} ms to enqueue on the host; "
            f"remote-write flush {v['can_flush']}; plain "
            f"{v['plain_ms']:.4f} ms, all_to_all_single "
            f"{v['library_ms']:.4f} ms), {v['gated']} gated pairs of "
            f"{v['maxcnt']}; one card, {NPROC} contexts")
        check(all(v["checks"].values()), f"K6 peer {key}")
    got["halo-f64"]["floor_ms"] = doc["floor_ms"]
    say(f"K6 peer one-flag ping-pong between the {NPROC} contexts (stream "
        f"memory operations): {doc['floor_ms']:.4f} ms a round")
    st = doc["stopped"]
    say(f"K6 peer with a stopped peer: rank 0 raised after {st['s']:.3f} s "
        f"(timeout {STOP_TIMEOUT_S} s): {st['message']!r}")
    check("a sender's flag" in st["message"]
          and STOP_TIMEOUT_S <= st["s"] < STOP_TIMEOUT_S + 4,
          "K6 peer: a stopped peer makes rank 0 raise within its timeout")
    os.remove(npz)
    say(f"K6 peer checks passed in {time.perf_counter() - t0:.1f} s")
    return got


def k6_peer_entry(k6peer, paths, card):
    """The ``kernels`` line's entry of K6's cross-process form: rank 0's
    median lockstep exchange on the flagship's band plan in f64 (one
    card, NPROC contexts), its bound (every gated window read once and
    written once at the HBM rate), the plain version (gloo all_to_all of
    host copies) and one all_to_all_single of the plane; launches from
    the multi-process paths' children."""
    v = k6peer["halo-f64"]
    nbytes = 2 * v["gated"] * v["maxcnt"] * v["itemsize"]
    bms, by = bound_ms(nbytes, 0, "f64")
    launches = sum(p.get("halo_put_peer", 0) for p in paths.values())
    say(f"time halo_put_peer f64 band plan on {NPROC} processes: kernel "
        f"{v['ms']:.4f} ms a lockstep exchange (put {v['put_ms']:.4f}, "
        f"flag waits {v['wait_ms']:.4f}, pre-signalled "
        f"{v['presignalled_ms']:.4f}, ping-pong floor {v['floor_ms']:.4f}), "
        f"bound {bms:.4f} ms ({by}), "
        f"plain {v['plain_ms']:.4f} ms, library {v['library_ms']:.4f} ms; "
        f"launches on the paths {launches}; one card, {NPROC} contexts "
        f"time-slicing it; {card}")
    return {"name": "halo_put_peer", "route": "cuda",
            "source": "acg_tpu_torch/csrc/halo_put.cu",
            "replaces": "acg_tpu/parallel/halo_dma.py:248", "dtype": "f64",
            "launches": launches,
            "launches_by_path": {k: p["halo_put_peer"]
                                 for k, p in paths.items()
                                 if p.get("halo_put_peer")},
            "check": "pass: receive planes bitwise-equal to the plain "
                     "version and to the stacked halo_put",
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "put_ms": v["put_ms"], "wait_ms": v["wait_ms"],
            "presignalled_ms": v["presignalled_ms"],
            "floor_ms": v["floor_ms"],
            "plain_ms": v["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": v["library_ms"],
            "contexts": f"{NPROC} processes on one card"}


def k6_peer_child(npz: str, port: int, rank: int) -> int:
    """One rank of :func:`k6_peer_checks`; prints one JSON line."""
    import torch
    import torch.distributed as dist

    from acg_tpu_torch.ops import kernels as K
    from acg_tpu_torch.parallel import mesh, multihost
    from acg_tpu_torch.parallel.halo_dma import PeerPlanes

    multihost.initialize(f"127.0.0.1:{port}", NPROC, rank, device="cuda")
    dev = multihost.world().device
    data = np.load(npz)
    dts = {"f64": torch.float64, "f32": torch.float32,
           "bf16": torch.bfloat16}
    out = {}
    for plan in ("halo", "halo_irr"):
        for kind, dt in dts.items():
            full = torch.from_numpy(data[f"{plan}-{kind}-send"]).to(
                dev).view(dt)
            cnt = torch.from_numpy(data[f"{plan}-{kind}-counts"]).to(dev)
            P, _, m = full.shape
            ranges = mesh.part_ranges(P, NPROC)
            lo, hi = ranges[rank]
            send = full[lo:hi].contiguous()
            stacked = K.halo_put(full, cnt, torch.zeros_like(full))[lo:hi]
            plain = K.halo_put_peer_plain(
                send.cpu(), cnt.cpu(), torch.zeros((hi - lo, P, m), dtype=dt),
                ranges, rank)
            peer = PeerPlanes(P, ranges, rank, m, dt, cnt.cpu().numpy(), dev)
            first = K.halo_put_peer(send, cnt, None, ranges, rank,
                                    peer=peer).clone()
            again = K.halo_put_peer(send, cnt, None, ranges, rank,
                                    peer=peer).clone()
            # exchange 2 wrote the other plane: each plane holds one
            # exchange, and the rows no put writes are still zero
            torch.cuda.synchronize()
            q = torch.arange(P, device=dev)
            gated = ((torch.arange(lo, hi, device=dev)[:, None] != q)
                     & (cnt.T[lo:hi] > 0))
            untouched = all(bool((pl[~gated] == 0).all())
                            for pl in (peer.plane(0), peer.plane(1)))
            checks = {"plain": torch.equal(first.cpu(), plain),
                      "stacked": torch.equal(first, stacked),
                      "twice": torch.equal(first, again),
                      "untouched": untouched}
            peer.check()
            # 50 lockstep exchanges, each timed by CUDA events, with its
            # stages apart: a | acks | put | flags | their waits
            times, stages = [], []
            for i in range(55):
                a = torch.cuda.Event(enable_timing=True)
                a.record()
                marks = [a]
                K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer,
                                marks=marks)
                marks[-1].synchronize()
                if i >= 5:
                    times.append(a.elapsed_time(marks[-1]))
                    stages.append([marks[j].elapsed_time(marks[j + 1])
                                   for j in range(4)])
            pres = _presignalled(torch, dist, K, send, cnt, ranges, rank,
                                 peer) or [None] * 6
            if plan == "halo" and kind == "f64":
                floor = _pingpong(torch, dist, peer, rank)
            peer.check()
            ptimes, ltimes = [], []
            scpu, rcpu = send.cpu(), torch.zeros((hi - lo, P, m), dtype=dt)
            flat = send.reshape(-1).view(torch.uint8)
            splits = [(b_ - a_) * (hi - lo) * m * send.element_size()
                      for a_, b_ in ranges]
            for i in range(13):
                t0 = time.perf_counter()
                K.halo_put_peer_plain(scpu, cnt.cpu(), rcpu, ranges, rank)
                t1 = time.perf_counter()
                multihost.all_to_all_bytes(flat, splits, splits)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if i >= 3:
                    ptimes.append((t1 - t0) * 1e3)
                    ltimes.append((t2 - t1) * 1e3)
            peer.close()
            c = cnt.cpu().numpy()
            ack_ms, put_ms, _, wait_ms = np.median(stages, axis=0)
            out[f"{plan}-{kind}"] = {
                "checks": checks, "ms": float(np.median(times)),
                "put_ms": float(put_ms), "wait_ms": float(wait_ms),
                "ack_ms": float(ack_ms), "presignalled_ms": pres[0],
                "presignalled_stages_ms": pres[1:5],
                "presignalled_host_ms": pres[5],
                "can_flush": peer.can_flush,
                "plain_ms": float(np.median(ptimes)),
                "library_ms": float(np.median(ltimes)),
                "gated": int(((c > 0) & ~np.eye(P, dtype=bool)).sum()),
                "maxcnt": int(m), "itemsize": send.element_size(),
                "max_abs_err": float((first.cpu().float()
                                      - plain.float()).abs().max())}
    stopped = _stopped_peer(torch, dist, K, dev, rank)
    dist.barrier()
    print(json.dumps({"k6_peer": out, "floor_ms": floor,
                      "stopped": stopped}))
    multihost.shutdown()
    return 0


def _presignalled(torch, dist, K, send, cnt, ranges, rank, peer,
                  n: int = 20) -> list | None:
    """Rank 0's exchange after every other rank has put, flagged and
    finished (its context idle): the exchange without the context
    switch.  The medians of the whole exchange, of its stages (acks,
    put, flags, flag waits) and of the host's time to enqueue it, on
    rank 0; None on the other ranks."""
    times = []
    for i in range(n + 3):
        if rank != 0:
            K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer,
                            wait=False)
            torch.cuda.synchronize()
        dist.barrier()
        if rank == 0:
            marks = [torch.cuda.Event(enable_timing=True)]
            marks[0].record()
            t0 = time.perf_counter()
            K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer,
                            marks=marks)
            host = (time.perf_counter() - t0) * 1e3
            marks[-1].synchronize()
            if i >= 3:
                times.append([marks[0].elapsed_time(marks[-1])] + [
                    marks[j].elapsed_time(marks[j + 1]) for j in range(4)]
                    + [host])
        else:
            peer.wait()
            torch.cuda.synchronize()
        dist.barrier()
    return np.median(times, axis=0).tolist() if times else None


def _pingpong(torch, dist, peer, rank, n: int = 50) -> float:
    """The one-flag ping-pong between the ranks' contexts: each round a
    rank writes the round's number into the next rank's word and waits
    for its own, both by stream memory operations (the diagonal flag
    words, which no exchange uses).  The median round: the least a
    lockstep exchange on this card can take."""
    nxt = peer.ranges[(rank + 1) % NPROC][0]
    lo = peer.ranges[rank][0]
    mine = peer.arrays([("write", ("flag", nxt, nxt), 0)], 0)
    theirs = peer.arrays([("wait", ("flag", lo, lo), 0)], 0)
    dist.barrier()
    times = []
    for k in range(1, n + 6):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        peer.enqueue(mine, k)
        peer.enqueue(theirs, k)
        b.record()
        b.synchronize()
        if k > 5:
            times.append(a.elapsed_time(b))
    dist.barrier()
    return float(np.median(times))


def _stopped_peer(torch, dist, K, dev, rank) -> dict | None:
    """Every rank but 0 stops after its first exchange; rank 0's second
    exchange waits for flags that never come.  Its watchdog must release
    the wait after STOP_TIMEOUT_S and the next exchange raise.  Returns
    rank 0's outcome (None elsewhere); every rank closes after."""
    from acg_tpu_torch.parallel import mesh
    from acg_tpu_torch.parallel.halo_dma import PeerPlanes

    P, m = 2 * NPROC, 257
    cnt = torch.ones((P, P), dtype=torch.int32)
    ranges = mesh.part_ranges(P, NPROC)
    lo, hi = ranges[rank]
    send = torch.ones((hi - lo, P, m), dtype=torch.float64, device=dev)
    peer = PeerPlanes(P, ranges, rank, m, torch.float64, cnt.numpy(), dev,
                      timeout=STOP_TIMEOUT_S)
    K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer)
    torch.cuda.synchronize()
    res = None
    if rank == 0:
        t0 = time.monotonic()
        K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer)
        torch.cuda.synchronize()
        try:
            K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer)
            msg = ""
        except RuntimeError as e:
            msg = str(e)
        res = {"s": time.monotonic() - t0, "message": msg}
    dist.barrier()
    peer.close()
    return res


# -- phase 4: times --------------------------------------------------------

def rate_runs(s, n: int, nruns: int = 3, nits: int = 1000,
              counts: list | None = None) -> list:
    """iters/s of ``nruns`` fixed ``nits``-iteration solves of solver
    ``s`` on b = ones, after a 50-iteration warm-up solve.  With a
    ``counts`` list, each timed solve appends its kernel launches and
    its restarts (the launch counters only add, so timing is
    unchanged)."""
    from acg_tpu_torch.ops import kernels as K
    from acg_tpu_torch.solvers import StoppingCriteria

    b = np.ones(n)
    s.solve(b, criteria=StoppingCriteria(maxits=50))
    runs = []
    for _ in range(nruns):
        s.stats.tsolve = 0.0
        K.reset_launches()
        nrs = s.stats.nrestarts
        s.solve(b, criteria=StoppingCriteria(maxits=nits))
        runs.append(nits / s.stats.tsolve)
        if counts is not None:
            counts.append((dict(K.launches), s.stats.nrestarts - nrs))
    return runs


def rate_solver(torch, dev, name: str):
    """The flagship solver of a solve_rates row: "classic f64", "classic
    f64 --operator stencil", "classic f32", "pipelined f64", "classic f64
    plain torch", or "fused f32" / "fused mixed" / "fused bf16" (--kernels
    fused; mixed = bf16 planes under f32 vectors)."""
    from acg_tpu_torch.io.generators import poisson_dia
    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
    from acg_tpu_torch.solvers import TorchCGSolver

    dtype = {"f64": torch.float64, "f32": torch.float32,
             "mixed": torch.bfloat16, "bf16": torch.bfloat16}[
                 name.split()[1]]
    vdt = torch.float32 if "mixed" in name else None
    kernels = ("xla" if "plain torch" in name
               else "fused" if name.startswith("fused") else "auto")
    if "operator" in name:
        A = poisson_stencil(FLAGSHIP, 2, dtype=dtype, device=dev)
    else:
        planes, offsets, N = poisson_dia(FLAGSHIP, 2)
        A = device_matrix_from_arrays("dia", planes, {
            "offsets": offsets, "nrows": N, "ncols_padded": N}, dtype=dtype,
            device=dev)
    return TorchCGSolver(A, pipelined=name.startswith("pipelined"),
                         kernels=kernels, vector_dtype=vdt, device=dev)


RATE_ROWS = ("classic f64", "classic f64 --operator stencil", "classic f32",
             "fused f32", "fused mixed", "fused bf16", "pipelined f64",
             "classic f64 plain torch")


def solve_rates(torch, dev, card):
    """Fixed-iteration rates of the flagship solvers of RATE_ROWS, three
    timed solves each (the median printed)."""
    rates = {}
    for name in RATE_ROWS:
        s = rate_solver(torch, dev, name)
        runs = rate_runs(s, FLAGSHIP ** 2)
        rates[name] = runs
        say(f"solve rate {name} (kernels={s.kernels}): "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s "
            f"(median {np.median(runs):.1f}; 1000 iterations after a 50-"
            f"iteration warm-up; {card})")
        del s
        torch.cuda.empty_cache()
    return rates


PRECISION_ROWS = (("classic f64 --precond jacobi", "f64",
                   dict(precond="jacobi")),
                  ("classic f64 --precond cheby:4", "f64",
                   dict(precond="cheby:4")),
                  ("classic f32", "f32", {}),
                  ("classic f32 --precise-dots", "f32",
                   dict(precise_dots=True)))


def precision_rates(torch, dev, card):
    """Fixed-iteration rates of the preconditioned and precise-dot
    flagship solvers (rate_runs' protocol; the preconditioner state is
    built in the warm-up solve), plain f32 beside --precise-dots in the
    same call; then the jacobi solve under torch.profiler."""
    from acg_tpu_torch.io.generators import poisson_dia
    from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
    from acg_tpu_torch.solvers import TorchCGSolver

    planes, offsets, N = poisson_dia(FLAGSHIP, 2)
    meta = {"offsets": offsets, "nrows": N, "ncols_padded": N}
    dts = {"f64": torch.float64, "f32": torch.float32}
    for name, kind, kw in PRECISION_ROWS:
        A = device_matrix_from_arrays("dia", planes, meta, dtype=dts[kind],
                                      device=dev)
        s = TorchCGSolver(A, device=dev, **kw)
        # the compensated dots run at ~1 % of the plain rate: 200
        # iterations measure it as well as 1000 and keep the script short
        nits = 200 if kw.get("precise_dots") else 1000
        runs = rate_runs(s, N, nits=nits)
        med = float(np.median(runs))
        spmvs = (f"; {5 * med:.1f} SpMVs/s (5 an iteration)"
                 if "cheby:4" in name else "")
        say(f"solve rate {name} (kernels={s.kernels}): "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s (median "
            f"{med:.1f}{spmvs}; {nits} iterations after a 50-iteration "
            f"warm-up; {card})")
        if "jacobi" in name:
            profile_solve(torch, card, "single part classic f64 --precond "
                          "jacobi (K1)", s, N)
        del s, A
        torch.cuda.empty_cache()


def batched_rates(torch, dev, card):
    """Fixed-iteration rates of --nrhs 8 on the flagship, f64: the
    batched classic and pipelined modes and block CG, 300 iterations
    after a 50-iteration warm-up, BATCHED_RUNS timed solves each, as loop
    iterations/s and column-iterations/s (x 8); then one batched classic
    solve under torch.profiler."""
    from acg_tpu_torch.io.generators import batched_rhs, poisson_dia
    from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
    from acg_tpu_torch.solvers import StoppingCriteria
    from acg_tpu_torch.solvers.batched import BatchedCGSolver

    planes, offsets, N = poisson_dia(FLAGSHIP, 2)
    A = device_matrix_from_arrays("dia", planes, {
        "offsets": offsets, "nrows": N, "ncols_padded": N},
        dtype=torch.float64, device=dev)
    B = batched_rhs(N, NRHS, seed=42)
    nits = 300
    for mode in ("batched", "pipelined", "block"):
        s = BatchedCGSolver(A, mode=mode, device=dev)
        s.solve(B, criteria=StoppingCriteria(maxits=50))
        runs = []
        for _ in range(BATCHED_RUNS):
            s.stats.tsolve = 0.0
            s.solve(B, criteria=StoppingCriteria(maxits=nits))
            runs.append(nits / s.stats.tsolve)
        med = float(np.median(runs))
        say(f"solve rate --nrhs {NRHS} {mode} f64: "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s (median "
            f"{med:.1f}: {NRHS * med:.1f} column-iterations/s; {nits} "
            f"iterations after a 50-iteration warm-up; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card})")
        if mode == "batched":
            profile_solve(torch, card, f"--nrhs {NRHS} batched classic "
                          f"f64 (plain PyTorch)", s, N, b=B)
        del s
        torch.cuda.empty_cache()


# timed solves of each --nrhs 8 rate: one, since the three of each row
# agreed to 0.1 % in every run that recorded them (PERF.md)
BATCHED_RUNS = 1

CA_ROWS = ("sstep:4", "sstep:8", "pipelined:2")


def _ca_steps(name: str, counts: list, k1: str, nits: int = 1000) -> str:
    """What the timed solves of a CA row ran, from their SpMV launches
    (kernel ``k1``) and restarts: a solve's attempts each make one setup
    SpMV; the rest are the loop's SpMVs.  p(l) makes one SpMV a step,
    its first l steps an attempt advance nothing, and the steps run
    beyond those and the advances are frozen ones (a breakdown's chunk
    run out, or past maxits); an s-step block makes 2S - 1."""
    parts = []
    for c, nrs in counts:
        attempts = 1 + nrs
        loop = c.get(k1, 0) - attempts
        if name.startswith("pipelined:"):
            fill = int(name.split(":")[1]) * attempts
            frozen = loop - nits - fill
            parts.append(f"{loop} steps for {nits} advances in {attempts} "
                         f"attempts ({fill} fill, {frozen} frozen: "
                         f"{frozen / loop:.3f} of the steps)")
        else:
            s = int(name.split(":")[1])
            parts.append(f"{loop} loop SpMVs = {loop / (2 * s - 1):.0f} "
                         f"blocks for {nits} iterations")
    return "; ".join(parts)


def ca_rates(torch, dev, card, prob):
    """Fixed-iteration rates of the communication-avoiding recurrences
    on the flagship f64, beside solve_rates' classic f64 in the same run
    (rate_runs' protocol; p(l)'s breakdowns restart inside the timed
    solves and are counted, with the steps each timed solve ran against
    its advances), one sstep:4 solve under torch.profiler; sstep:4 on
    the 4 stacked band parts (--comm dma) beside the 4-part classic by
    the same protocol, and one profile of it; then --nrhs 8 on the 4
    parts, classic and pipelined, 300 iterations after a 50-iteration
    warm-up, as column-iterations/s."""
    from acg_tpu_torch.io.generators import batched_rhs, poisson_dia
    from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.parallel.dist_batched import BatchedDistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

    planes, offsets, N = poisson_dia(FLAGSHIP, 2)
    A = device_matrix_from_arrays("dia", planes, {
        "offsets": offsets, "nrows": N, "ncols_padded": N},
        dtype=torch.float64, device=dev)
    for name in CA_ROWS:
        s = TorchCGSolver(A, device=dev, algorithm=name)
        counts = []
        runs = rate_runs(s, N, counts=counts)
        say(f"solve rate {name} f64 (kernels={s.kernels}): "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s (median "
            f"{np.median(runs):.1f}; 1000 iterations after a 50-iteration "
            f"warm-up; restarts in the 4 solves {s.stats.nrestarts}; timed "
            f"solves: {_ca_steps(name, counts, 'dia_spmv')}; {card})")
        if name == "sstep:4":
            profile_solve(torch, card, "single part sstep:4 f64 (K1)", s, N)
        del s
        torch.cuda.empty_cache()
    del A
    for name in ("classic", "sstep:4"):
        s = DistCGSolver(prob, comm="dma", device=dev, algorithm=name)
        counts = []
        runs = rate_runs(s, prob.n, counts=counts)
        steps = ("" if name == "classic" else "; timed solves: "
                 + _ca_steps(name, counts, "dia_spmv_batched"))
        say(f"solve rate {name} f64 {prob.nparts} parts --comm dma "
            f"(kernels={s.kernels}): "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s (median "
            f"{np.median(runs):.1f}; 1000 iterations after a 50-iteration "
            f"warm-up{steps}; {card})")
        if name == "sstep:4":
            profile_solve(torch, card, f"{prob.nparts}-part dma sstep:4 f64 "
                          "(batched K1, K6)", s, prob.n)
        del s
        torch.cuda.empty_cache()
    B = batched_rhs(prob.n, NRHS, seed=42)
    nits = 300
    for pipelined in (False, True):
        s = BatchedDistCGSolver(prob, pipelined=pipelined, device=dev)
        s.solve(B, criteria=StoppingCriteria(maxits=50))
        runs = []
        for _ in range(BATCHED_RUNS):
            s.stats.tsolve = 0.0
            s.solve(B, criteria=StoppingCriteria(maxits=nits))
            runs.append(nits / s.stats.tsolve)
        med = float(np.median(runs))
        say(f"solve rate --nparts {prob.nparts} --nrhs {NRHS} "
            f"{'pipelined' if pipelined else 'batched'} f64: "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s (median "
            f"{med:.1f}: {NRHS * med:.1f} column-iterations/s; {nits} "
            f"iterations after a 50-iteration warm-up; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card})")
        del s
        torch.cuda.empty_cache()


def direct_rates(torch, dev, card, nits: int = 100):
    """Classic f64 at 512^3 (the gen-direct size): the device-built
    assembled planes (K1) against the operator (K7) and the sharded tier
    on 4 parts (path (ad): K1 on the whole planes), ``nits`` fixed
    iterations after a 10-iteration warm-up, three timed solves each, in
    turns."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.ops.spmv import DiaMatrix
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

    planes, offs, N = poisson_dia_device(DIRECT_N, 3, dtype=torch.float64,
                                         device=dev)
    sharded = build_sharded_poisson_solver(DIRECT_N, 3, nparts=NPARTS,
                                           dtype=torch.float64, device=dev)
    solvers = {"assembled (K1)": TorchCGSolver(DiaMatrix(planes, offs, N, N),
                                               device=dev),
               "--operator stencil (K7)": TorchCGSolver(poisson_stencil(
                   DIRECT_N, 3, dtype=torch.float64, device=dev),
                   device=dev),
               f"--nparts {NPARTS} sharded ({sharded.kernels})": sharded}
    b = torch.ones(N, dtype=torch.float64, device=dev)
    runs = {k: [] for k in solvers}
    for s in solvers.values():
        s.solve(b, criteria=StoppingCriteria(maxits=10), host_result=False)
    for _ in range(3):
        for k, s in solvers.items():
            s.stats.tsolve = 0.0
            s.solve(b, criteria=StoppingCriteria(maxits=nits),
                    host_result=False)
            runs[k].append(nits / s.stats.tsolve)
    for k, r in runs.items():
        say(f"solve rate classic f64 gen:poisson3d:{DIRECT_N} {k}: "
            f"{', '.join(f'{v:.2f}' for v in r)} iters/s (median "
            f"{np.median(r):.2f}; {nits} iterations after a 10-iteration "
            f"warm-up, in turns; {card})")
    del solvers, sharded, planes, b
    torch.cuda.empty_cache()


def dist_rates(torch, dev, card, prob):
    """Rates of the 4-part stacked classic f64 solve on each transport,
    unsplit (paths (e)/(f)) and fused (path (ac): the halo on its own
    stream), with the protocol of solve_rates, in turns."""
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria

    b = np.ones(prob.n)
    rows = {(comm, kern): DistCGSolver(prob, comm=comm, kernels=kern,
                                       device=dev)
            for comm in ("dma", "xla") for kern in ("auto", "fused")}
    runs = {k: [] for k in rows}
    for s in rows.values():
        s.solve(b, criteria=StoppingCriteria(maxits=50))
    for _ in range(3):
        for k, s in rows.items():
            s.stats.tsolve = 0.0
            s.solve(b, criteria=StoppingCriteria(maxits=1000))
            runs[k].append(1000.0 / s.stats.tsolve)
    for (comm, kern), r in runs.items():
        say(f"solve rate classic f64 {prob.nparts} parts --comm {comm} "
            f"(kernels={rows[comm, kern].kernels}): "
            f"{', '.join(f'{v:.1f}' for v in r)} iters/s (median "
            f"{np.median(r):.1f}; 1000 iterations after a 50-iteration "
            f"warm-up, in turns; {card})")
    fused = rows["dma", "fused"]
    del rows
    torch.cuda.empty_cache()
    return fused


def _intervals_ms(events):
    """Sorted, merged (start, end) intervals of trace events, in us."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    out = []
    for a, z in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], z))
        else:
            out.append((a, z))
    return out


def _overlap_us(spans, cover) -> float:
    """Time of ``spans`` that lies under the merged intervals ``cover``."""
    tot = 0.0
    for a, z in spans:
        for c0, c1 in cover:
            if c1 <= a:
                continue
            if c0 >= z:
                break
            tot += min(z, c1) - max(a, c0)
    return tot


def profile_streams(torch, card, label, s, n, nits: int = 100):
    """The fused solve's streams: torch.profiler's trace of ``nits``
    iterations (after a warm-up), each device event by stream.  Prints
    the device's busy share, the streams K1 and K6 ran on, the device
    time of the halo chain (every event on K6's stream: pack, K6,
    unpack) and how much of it lies under K1.  A trace with no K1 or no
    K6 on a stream of its own fails the check: it is the card's proof of
    the overlap."""
    from torch.profiler import ProfilerActivity, profile

    from acg_tpu_torch.solvers import StoppingCriteria

    b = np.ones(n)
    s.solve(b, criteria=StoppingCriteria(maxits=50))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.solve(b, criteria=StoppingCriteria(maxits=nits))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    except (RuntimeError, OSError, ValueError) as e:
        say(f"profile {label}: the trace could not be read ({e})")
        trace = {}
    finally:
        os.remove(path)
    dev_ev = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in (
                  "kernel", "gpu_memcpy", "gpu_memset")
              and "stream" in e.get("args", {})]
    check(bool(dev_ev), f"profile {label}: device events in the trace")
    by_stream = {}
    for e in dev_ev:
        by_stream.setdefault(e["args"]["stream"], []).append(e)
    k1 = [e for e in dev_ev if "dia_spmv_kernel" in e["name"]
          or "stencil_spmv_kernel" in e["name"]]
    k6 = [e for e in dev_ev if "halo_put_kernel" in e["name"]]
    k1_streams = sorted({e["args"]["stream"] for e in k1})
    k6_streams = sorted({e["args"]["stream"] for e in k6})
    busy = sum(z - a for a, z in _intervals_ms(dev_ev))
    say(f"profile {label}, {nits} iterations: wall {wall * 1e6 / nits:.1f} "
        f"us/iteration, device busy {busy / nits:.1f} us/iteration "
        f"({busy / (wall * 1e6):.1%} of the wall); streams (device "
        f"us/iteration, events): "
        + ", ".join(f"{st}: {sum(e['dur'] for e in ev) / nits:.1f}, "
                    f"{len(ev)}" for st, ev in sorted(by_stream.items()))
        + f"; K1/K7 on streams {k1_streams}, K6 on {k6_streams}; {card}")
    check(bool(k1_streams) and bool(k6_streams),
          f"profile {label}: K1/K7 and K6 in the trace")
    check(set(k6_streams).isdisjoint(k1_streams),
          f"profile {label}: K6 on another stream than K1")
    halo = [e for e in dev_ev if e["args"]["stream"] in k6_streams]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in halo]
    under = _overlap_us(spans, _intervals_ms(k1))
    chain = sum(z - a for a, z in spans)
    names = sorted({e["name"][:40] for e in halo})
    say(f"  halo chain on stream(s) {k6_streams}: {chain / nits:.2f} "
        f"us/iteration in {len(halo) / nits:.1f} events/iteration "
        f"({names}); {under / nits:.2f} us/iteration of it under K1 "
        f"({under / chain:.1%} hidden)")


def irregular_spmv_times(torch, dev, card, irr):
    """Where path (h)'s SpMV goes: the binned-ELL local block, the halo
    exchange (K6) and the ghost block, each timed alone (medians, L2
    flushed), and the whole distributed SpMV."""
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.parallel.halo_dma import halo_exchange_dma

    _, iprob = irr
    s = DistCGSolver(iprob, comm="dma", device=dev)
    spmv = s._spmv()
    h = s._halo
    x = torch.randn((iprob.nparts, iprob.nmax_owned), dtype=torch.float64,
                    device=dev)
    recv = torch.zeros((h.nparts, h.nparts, h.maxcnt), dtype=x.dtype,
                       device=dev)

    def exchange():
        return halo_exchange_dma(x, h.send_idx, h.ghost_src, h.ghost_valid,
                                 s._scnt, recv)

    xg = exchange()
    y = iprob.local.mv(s._la, x, True)
    t = {"local block": median_ms(torch, lambda: iprob.local.mv(
             s._la, x, True)),
         "halo exchange": median_ms(torch, exchange),
         "ghost block": median_ms(torch, lambda: iprob.ghost.add_to(
             s._ga, y, xg)),
         "whole SpMV": median_ms(torch, lambda: spmv(x))}
    g = iprob.ghost
    say(f"time {IRREGULAR_SPEC} {iprob.nparts}-part SpMV: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; ghost block {g.data.shape} slots for "
        f"{int(np.count_nonzero(g.data)):,} nonzeros; {card}")
    del s, spmv, recv
    torch.cuda.empty_cache()


def profile_solve(torch, card, label, s, n, nits: int = 100, b=None):
    """Where the time of solver ``s``'s solve goes: torch.profiler over
    ``nits`` iterations (after a 50-iteration warm-up) of the solve of
    ``b`` (default: ones), the ops by device time, and the device's busy
    share of the profiled wall time.  Reports "not measured" when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    from acg_tpu_torch.solvers import StoppingCriteria

    b = np.ones(n) if b is None else b
    s.solve(b, criteria=StoppingCriteria(maxits=50))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.solve(b, criteria=StoppingCriteria(maxits=nits))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    except RuntimeError as e:   # a profiler that cannot trace the card
        say(f"profile {label}: the profiler failed ({e}); not measured")
        return
    # device-side events only (kernels and copies; a CPU op's device
    # time repeats its kernels'), without the profiler's own buffers
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU or \
                ev.key.startswith("Activity Buffer"):
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0:
            rows.append((dt, ev.count, ev.key))
    busy_us = sum(r[0] for r in rows)
    if not rows:
        say(f"profile {label}: no device time recorded (not measured)")
        return
    say(f"profile {label}, {nits} iterations "
        f"(setup included): wall under the profiler "
        f"{wall * 1e6 / nits:.1f} us/iteration, device busy "
        f"{busy_us / nits:.1f} us/iteration ({busy_us / (wall * 1e6):.1%} "
        f"of that wall), {sum(r[1] for r in rows) / nits:.1f} device "
        f"launches/iteration; {card}")
    for dt, count, key in sorted(rows, reverse=True)[:12]:
        say(f"  {dt / nits:8.1f} us/iteration  {count / nits:5.1f} "
            f"launches/iteration  {key[:100]}")


def kernel_times(torch, K, inputs, errs, paths, csr, card, prob, mf):
    N = FLAGSHIP ** 2
    out = []

    def entry(name, source, replaces, kind, ms, plain_ms, nbytes, nops,
              library_ms, shape=f"N={N}", **extra):
        bms, by = bound_ms(nbytes, nops, kind)
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "dtype": kind,
             "launches": sum(p.get(name, 0) for p in paths.values()),
             "launches_by_path": {k: p[name] for k, p in paths.items()
                                  if p.get(name)},
             "check": "pass: vectors bitwise-equal to the plain version",
             "max_abs_err": errs[(name, kind)], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": library_ms}
        e.update(extra)
        say(f"time {name} {kind} {shape}: kernel {ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), plain {plain_ms:.4f} ms, library "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}"
            f"{''.join(f', {k} {v}' for k, v in extra.items())}; {card}")
        return e

    # K1 (+ K2 epilogue) in every dtype; the JSON entry is f64, the
    # default path's dtype
    item = {"f64": 8, "f32": 4, "bf16": 2}
    k1 = {}
    for kind in ("f64", "f32", "mixed", "bf16"):
        P, offsets, x = inputs[("dia", kind)]
        D = P.shape[0]
        pb = item["bf16"] if kind in ("mixed", "bf16") else item[kind]
        xb = item["f32"] if kind == "mixed" else pb
        nbytes = D * N * pb + 2 * N * xb
        ms = median_ms(torch, lambda: K.dia_spmv(P, offsets, x))
        clean_ms = median_ms(torch, lambda: K.dia_spmv(P, offsets, x),
                             clean=True)
        dot_ms = median_ms(torch, lambda: K.dia_spmv(
            P, offsets, x, with_dot=True))
        plain = median_ms(torch, lambda: K.dia_spmv_plain(P, offsets, x))
        lib = None
        lib_note = {}
        if kind != "mixed":   # no one call takes bf16 planes with f32 x
            dt = {"f64": torch.float64, "f32": torch.float32,
                  "bf16": torch.bfloat16}[kind]
            At = csr_tensor(torch, csr, dt, x.device)
            try:
                lib = median_ms(torch, lambda: torch.mv(At, x))
            except RuntimeError as err:   # bf16 CSR: recorded, not timed
                lib_note = {"library_error": str(err).splitlines()[0][:160]}
            del At
        dbms, _ = bound_ms(nbytes, (2 * D + 2) * N, kind)
        e = entry("dia_spmv", "acg_tpu_torch/csrc/dia_spmv.cu",
                  "acg_tpu/ops/pallas_kernels.py:379", kind, ms, plain,
                  nbytes, 2 * D * N, lib, dot_ms=round(dot_ms, 6),
                  dot_bound_ms=round(dbms, 6), clean_l2_ms=round(clean_ms, 6),
                  **lib_note)
        k1[kind] = e
    out.append(k1["f64"])
    fused = {}
    for kind in ("f32", "mixed", "bf16"):
        P, offsets, ot, r, po, xx, gm, gp, pdt_ = inputs[("fused", kind)]
        D = P.shape[0]
        vb = item["bf16"] if kind == "bf16" else item["f32"]
        pb = item["f32"] if kind == "f32" else item["bf16"]
        a_ms = median_ms(torch, lambda: K.cg_phase_a(
            P, offsets, r, po, gm, gp, offsets_t=ot))
        a_clean = median_ms(torch, lambda: K.cg_phase_a(
            P, offsets, r, po, gm, gp, offsets_t=ot), clean=True)
        a_plain = median_ms(torch, lambda: K.cg_phase_a_plain(
            P, offsets, r, po, gm, gp))
        pa, ta, _ = K.cg_phase_a(P, offsets, r, po, gm, gp, offsets_t=ot)
        xb, rb = xx.clone(), r.clone()
        tiny = torch.tensor(1e30, device=r.device)  # alpha ~ 0: no drift
        b_ms = median_ms(torch, lambda: K.cg_phase_b(xb, pa, rb, ta, gm,
                                                     tiny))
        b_clean = median_ms(torch, lambda: K.cg_phase_b(xb, pa, rb, ta, gm,
                                                        tiny), clean=True)
        b_plain = median_ms(torch, lambda: K.cg_phase_b_plain(
            xb, pa, rb, ta, gm, tiny))
        # a copy of 3 N values moves K4's bytes and nothing else
        src = torch.empty(3 * N, dtype=r.dtype, device=r.device)
        dst = torch.empty_like(src)
        b_copy = {f"copy{'_clean_l2' if c else ''}_ms": round(median_ms(
            torch, lambda: dst.copy_(src), clean=c), 6) for c in (False, True)}
        del src, dst
        fused[kind] = (
            entry("cg_phase_a", "acg_tpu_torch/csrc/cg_fused.cu",
                  "acg_tpu/ops/pallas_kernels.py:572", kind, a_ms, a_plain,
                  D * N * pb + 4 * N * vb, (2 * D + 4) * N, None,
                  clean_l2_ms=round(a_clean, 6)),
            entry("cg_phase_b", "acg_tpu_torch/csrc/cg_fused.cu",
                  "acg_tpu/ops/pallas_kernels.py:627", kind, b_ms, b_plain,
                  6 * N * vb, 6 * N, None, clean_l2_ms=round(b_clean, 6),
                  **b_copy))
    out.extend(fused["f32"])
    pipe = {}
    for kind in ("f64", "f32", "bf16"):
        vs, al, be = inputs[("pipe", kind)]
        ws = [v.clone() for v in vs]
        a0 = torch.zeros_like(al)  # alpha = 0: repeated calls stay bounded
        ms = median_ms(torch, lambda: K.pipelined_update(*ws, a0, be))
        plain = median_ms(torch, lambda: K.pipelined_update_plain(
            *vs, al, be))
        # the flagged form of a detecting loop: the flag clear (every
        # step but a breakdown's) and set
        flagged = {}
        for bad in (False, True):
            flag = torch.tensor(bad, device=al.device)
            flagged[bad] = median_ms(torch, lambda: K.pipelined_update(
                *ws, a0, be, bad=flag))
        pipe[kind] = entry("pipelined_update",
                           "acg_tpu_torch/csrc/pipelined_update.cu",
                           "acg_tpu/ops/pallas_kernels.py:676", kind, ms,
                           plain, 13 * N * item[kind], 12 * N, None,
                           flagged_clear_ms=round(flagged[False], 6),
                           flagged_set_ms=round(flagged[True], 6))
    out.append(pipe["f64"])
    out.extend(dist_kernel_times(torch, K, inputs, prob, entry, item))
    out.extend(stencil_times(torch, K, csr, mf, entry))
    return out


def csr_tensor(torch, csr, dtype, device):
    """A scipy CSR as a PyTorch sparse CSR tensor (the cuSPARSE
    yardstick; the port never multiplies with one)."""
    with warnings.catch_warnings():
        # PyTorch flags its sparse CSR layout as beta on creation
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int64)),
            torch.from_numpy(csr.indices.astype(np.int64)),
            torch.from_numpy(csr.data).to(dtype), size=csr.shape
        ).to(device)


def stencil_times(torch, K, csr, mf, entry):
    """K7 against its bound, its plain version and one library call: at
    2048^2 (cuSPARSE through torch.mv on the assembled CSR, as for K1)
    and 512^3 (K1 on the device-built planes beside it; no CSR of 940M
    nonzeros is built), in f64 and f32; stacked K7 on the 4-part plan
    (cuSPARSE on the block-diagonal CSR of the local blocks, as for
    batched K1).  Beside each, a PyTorch copy of x into y (``copy_ms``):
    the bytes K7 must move and nothing else.  Returns the f64 entries of
    the single and stacked forms."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(99)
    src = "acg_tpu_torch/csrc/stencil_spmv.cu"
    rep = "acg_tpu/ops/pallas_kernels.py:759"
    out = []
    for label, n, dim in (("2d-2048", FLAGSHIP, 2), ("3d-512", DIRECT_N, 3)):
        for kind, dt in (("f64", torch.float64), ("f32", torch.float32)):
            op = poisson_stencil(n, dim, dtype=dt, device=dev)
            N = op.nrows
            item = torch.empty((), dtype=dt).element_size()
            x = torch.randn(N, generator=g, dtype=dt, device=dev)
            ms = median_ms(torch, lambda: K.stencil_spmv(op, x))
            clean = median_ms(torch, lambda: K.stencil_spmv(op, x),
                              clean=True)
            plain = median_ms(torch, lambda: K.stencil_spmv_plain(op, x))
            extra, lib = {"clean_l2_ms": round(clean, 6)}, None
            # a copy of x into y moves K7's bytes and nothing else
            y = torch.empty_like(x)
            extra["copy_ms"] = round(median_ms(torch, lambda: y.copy_(x)), 6)
            extra["copy_clean_l2_ms"] = round(median_ms(
                torch, lambda: y.copy_(x), clean=True), 6)
            del y
            planes, offs, _ = poisson_dia_device(n, dim, dtype=dt,
                                                 device=dev)
            D = len(offs)
            extra["k1_ms"] = round(median_ms(torch, lambda: K.dia_spmv(
                planes, offs, x)), 6)
            extra["k1_bound_ms"] = round(bound_ms((D + 2) * N * item,
                                                  2 * D * N, kind)[0], 6)
            del planes
            torch.cuda.empty_cache()
            if label == "2d-2048":
                At = csr_tensor(torch, csr, dt, dev)
                lib = median_ms(torch, lambda: torch.mv(At, x))
                del At
            e = entry("stencil_spmv", src, rep, kind, ms, plain,
                      2 * N * item, 2 * (2 * dim + 1) * N, lib,
                      shape=f"{label} N={N}", **extra)
            if label == "2d-2048" and kind == "f64":
                out.append(e)
            del x
            torch.cuda.empty_cache()
    k1_direct_low_precision(torch, K)
    row0, nowned = (torch.from_numpy(a).to(dev) for a in mf.local.arrays[:2])
    bd = _block_diag_csr(mf)
    NP = mf.nparts * mf.nmax_owned
    for kind, dt in (("f64", torch.float64), ("f32", torch.float32)):
        op = poisson_stencil(FLAGSHIP, 2, dtype=dt, device=dev)
        item = torch.empty((), dtype=dt).element_size()
        x = torch.randn((mf.nparts, mf.nmax_owned), generator=g, dtype=dt,
                        device=dev)
        ms = median_ms(torch, lambda: K.stencil_spmv(op, x, row0=row0,
                                                     nowned=nowned))
        clean = median_ms(torch, lambda: K.stencil_spmv(
            op, x, row0=row0, nowned=nowned), clean=True)
        plain = median_ms(torch, lambda: K.stencil_spmv_plain(
            op, x, row0, nowned))
        y = torch.empty_like(x)
        copy = median_ms(torch, lambda: y.copy_(x))
        del y
        At = csr_tensor(torch, bd, dt, dev)
        xf = x.reshape(-1)
        lib = median_ms(torch, lambda: torch.mv(At, xf))
        del At
        e = entry("stencil_spmv_batched", src, rep, kind, ms, plain,
                  2 * NP * item + 2 * mf.nparts * 8, 2 * 5 * NP, lib,
                  shape=f"{mf.nparts}x{mf.nmax_owned}",
                  clean_l2_ms=round(clean, 6), copy_ms=round(copy, 6))
        if kind == "f64":
            out.append(e)
    return out


def k1_direct_low_precision(torch, K):
    """K1 on the 512^3 device-built planes in bf16, with f32 x (mixed)
    and bf16 x: logged beside its bound (22 and 18 bytes a row), not in
    the JSON line (its K1 entry is f64)."""
    from acg_tpu_torch.io.generators import poisson_dia_device

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(98)
    planes, offs, N = poisson_dia_device(DIRECT_N, 3, dtype=torch.bfloat16,
                                         device=dev)
    D = len(offs)
    for kind, xdt, xb in (("mixed", torch.float32, 4),
                          ("bf16", torch.bfloat16, 2)):
        x = torch.randn(N, generator=g, dtype=torch.float32,
                        device=dev).to(xdt)
        ms = median_ms(torch, lambda: K.dia_spmv(planes, offs, x))
        clean = median_ms(torch, lambda: K.dia_spmv(planes, offs, x),
                          clean=True)
        bms, by = bound_ms((D * 2 + 2 * xb) * N, 2 * D * N, kind)
        say(f"time dia_spmv {kind} 3d-{DIRECT_N} device planes N={N}: "
            f"kernel {ms:.4f} ms (clean L2 {clean:.4f} ms), bound "
            f"{bms:.4f} ms ({by}); {device_line(torch)}")
        del x
    del planes
    torch.cuda.empty_cache()


def _block_diag_csr(prob):
    """The stacked local blocks as one block-diagonal CSR (each block
    padded to nmax_owned rows), for the batched K1's library yardstick."""
    import scipy.sparse as sp

    m = prob.nmax_owned
    blocks = []
    for s in prob.subs:
        a = s.A_local
        blocks.append(sp.csr_matrix(
            (a.data, a.indices, np.concatenate(
                [a.indptr, np.full(m - a.shape[0], a.indptr[-1])])),
            shape=(m, m)))
    return sp.block_diag(blocks, format="csr")


def dist_kernel_times(torch, K, inputs, prob, entry, item):
    """Batched K1 and K6 at the flagship's 4-part shapes."""
    out = []
    NP = prob.nparts * prob.nmax_owned
    kb = {}
    bd = _block_diag_csr(prob)
    for kind in ("f64", "f32", "mixed", "bf16"):
        P, offsets, x = inputs[("dia_b", kind)]
        D = P.shape[0]
        pb = item["bf16"] if kind in ("mixed", "bf16") else item[kind]
        xb = item["f32"] if kind == "mixed" else pb
        ms = median_ms(torch, lambda: K.dia_spmv(P, offsets, x))
        clean_ms = median_ms(torch, lambda: K.dia_spmv(P, offsets, x),
                             clean=True)
        plain = median_ms(torch, lambda: K.dia_spmv_plain(P, offsets, x))
        lib, lib_note = None, {}
        if kind != "mixed":   # no one call takes bf16 planes with f32 x
            At = csr_tensor(torch, bd, x.dtype, x.device)
            xf = x.reshape(-1)
            try:
                lib = median_ms(torch, lambda: torch.mv(At, xf))
            except RuntimeError as err:   # recorded, not timed
                lib_note = {"library_error": str(err).splitlines()[0][:160]}
            del At
        kb[kind] = entry("dia_spmv_batched", "acg_tpu_torch/csrc/dia_spmv.cu",
                         "acg_tpu/ops/pallas_kernels.py:379", kind, ms, plain,
                         D * NP * pb + 2 * NP * xb, 2 * D * NP, lib,
                         shape=f"{prob.nparts}x{prob.nmax_owned}",
                         clean_l2_ms=round(clean_ms, 6), **lib_note)
    out.append(kb["f64"])
    k6 = {}
    # the flagship's band plan (the JSON entry) and, logged only, the
    # irregular matrix's graph plan of path (h)
    for plan in ("halo", "halo_irr"):
        for kind in ("f64", "f32", "bf16"):
            send, scnt = inputs[(plan, kind)]
            c = scnt.cpu().numpy()
            gated = int(((c > 0) & ~np.eye(c.shape[0], dtype=bool)).sum())
            maxcnt = send.shape[2]
            recv = torch.zeros_like(send)
            ms = median_ms(torch, lambda: K.halo_put(send, scnt, recv))
            plain = median_ms(torch, lambda: K.halo_put_plain(send, scnt,
                                                              recv))
            lib = median_ms(torch, lambda: send.transpose(0, 1).contiguous())
            clean_ms = median_ms(torch, lambda: K.halo_put(send, scnt, recv),
                                 clean=True)
            clean_lib = median_ms(
                torch, lambda: send.transpose(0, 1).contiguous(), clean=True)
            e = entry("halo_put", "acg_tpu_torch/csrc/halo_put.cu",
                      "acg_tpu/parallel/halo_dma.py:248", kind, ms, plain,
                      2 * gated * maxcnt * item[kind], 0, lib,
                      shape=f"{plan} plane {tuple(send.shape)}",
                      gated_pairs=gated, clean_l2_ms=round(clean_ms, 6),
                      clean_l2_library_ms=round(clean_lib, 6))
            if plan == "halo":
                k6[kind] = e
    out.append(k6["f64"])
    dots = {}
    for kind in ("f64", "f32", "bf16"):
        a, c, sdt = inputs[("dot", kind)]
        P, n = a.shape
        ms = median_ms(torch, lambda: K.part_dot(a, c, sdt))
        plain = median_ms(torch, lambda: K.part_dot_plain(a, c, sdt))
        lib = (median_ms(torch, lambda: torch.linalg.vecdot(a, c))
               if a.dtype == sdt else None)   # bf16 in, f32 out: no one call
        sb = 8 if sdt == torch.float64 else 4
        dots[kind] = entry(
            "part_dot", "acg_tpu_torch/csrc/part_dot.cu",
            "acg_tpu/parallel/dist.py:1413 (an XLA dot; no pallas_call)",
            kind, ms, plain, 2 * P * n * item[kind] + P * sb, 2 * P * n,
            lib, shape=f"{P}x{n}",
            check=f"pass: within {DOT_REL[kind]:g} of sum |a c| of the "
                  f"plain version; a part's bits independent of the stack")
    out.append(dots["f64"])
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs the "
                         "port on the card only\n")
        return 1
    # this process just found the card: its CLI children skip the bounded
    # liveness probe (a child of their own, seconds each); path (ax) runs
    # one with it
    os.environ["ACG_TPU_SKIP_BACKEND_PROBE"] = "1"
    # the checkout's package; outside a checkout this import fails
    from acg_tpu_torch import faults
    from acg_tpu_torch.ops import _build
    from acg_tpu_torch.ops import kernels as K

    CHILD_ENV.update((k, v) for k, v in os.environ.items()
                     if k != faults.ENV_VAR)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = device_line(torch)
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    ptxas = ptxas_lines((lib.parent / "build.log").read_text())
    for src, lines in ptxas.items():
        LOG.append(f"ptxas -v of {src}:")
        LOG.extend(lines)
    groups = {src: ptxas.get(src, []) for src in (
        "dia_spmv.cu", "halo_put.cu", "stencil_spmv.cu", "cg_fused.cu",
        "part_dot.cu")}
    groups["cg_fused.cu K4"] = [ln for e in ptxas_entries(
        ptxas.get("cg_fused.cu", [])) if "cg_phase_b_kernel" in e[0]
        for ln in e]
    for src, lines in groups.items():
        text = "\n".join(lines)
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                               text))
        smem = [int(v) for v in re.findall(r"(\d+) bytes smem", text)]
        say(f"ptxas {src}: {len(regs)} kernels, registers {min(regs)}-"
            f"{max(regs)}, static smem <= {max(smem, default=0)} bytes, "
            f"spill stores {spill} bytes (full log: chip_smoke.log)")

    t0 = time.perf_counter()
    inputs, errs = kernel_checks(torch, K, dev)
    from acg_tpu_torch.cli import synthesize_host_matrix
    csr = synthesize_host_matrix(MAIN_SPEC).to_csr()
    prob = flagship_parts(csr)
    irr = irregular_parts()
    dist_kernel_checks(torch, K, dev, prob, irr, inputs, errs)
    k1_edge_checks(torch, K, dev, errs)
    k6_edge_checks(torch, K, dev, errs)
    k3_edge_checks(torch, K, dev, errs)
    k4_edge_checks(torch, K, dev, errs)
    mf = armed_parts(torch, prob)
    stencil_checks(torch, K, dev, mf, errs)
    torch.cuda.synchronize()
    say(f"phase 2 (kernels vs plain) passed in "
        f"{time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_ROOT)
    try:
        t0 = time.perf_counter()
        paths = main_path(torch, K, tmp, csr, irr, prob)
        say(f"phase 3 (main path) passed in {time.perf_counter() - t0:.1f} s")
        k6peer = k6_peer_checks(torch, K, tmp, inputs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    robustness_rates(torch)
    solve_rates(torch, dev, card)
    precision_rates(torch, dev, card)
    fused = dist_rates(torch, dev, card, prob)
    batched_rates(torch, dev, card)
    ca_rates(torch, dev, card, prob)
    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import TorchCGSolver

    profile_solve(torch, card, f"{prob.nparts}-part dma classic f64",
                  DistCGSolver(prob, comm="dma", device=dev), prob.n)
    profile_streams(torch, card, f"{prob.nparts}-part dma classic f64 "
                    f"--kernels fused", fused, prob.n)
    del fused
    for kind, dt in (("f64", torch.float64), ("f32", torch.float32)):
        profile_solve(torch, card, f"single part classic {kind} --operator "
                      "stencil (K7)", TorchCGSolver(poisson_stencil(
                          FLAGSHIP, 2, dtype=dt, device=dev),
                          device=dev), FLAGSHIP ** 2)
    profile_solve(torch, card, "single part classic f64 --operator "
                  f"stencil (K7) gen:poisson3d:{DIRECT_N}",
                  TorchCGSolver(poisson_stencil(DIRECT_N, 3,
                                                dtype=torch.float64,
                                                device=dev), device=dev),
                  DIRECT_N ** 3, nits=20)
    for kind in ("f32", "mixed", "bf16"):
        profile_solve(torch, card, f"single part --kernels fused {kind} (K3, "
                      "K4)", rate_solver(torch, dev, f"fused {kind}"),
                      FLAGSHIP ** 2)
    irregular_spmv_times(torch, dev, card, irr)
    say(f"clocks after the solve rates (sm, max sm, draw, limit): "
        f"{clocks_line()}")
    direct_rates(torch, dev, card)
    kernels = kernel_times(torch, K, inputs, errs, paths, csr, card, prob,
                           mf)
    kernels.append(k6_peer_entry(k6peer, paths, card))
    say(f"clocks after the kernel times (sm, max sm, draw, limit): "
        f"{clocks_line()}")
    say(f"phase 4 (times) done in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on the main path")

    say(f"chip_smoke took {time.perf_counter() - t_start:.1f} s in all")
    (_build.BUILD_ROOT / "chip_smoke.log").write_text("\n".join(LOG) + "\n")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--k6-peer-child":
        sys.exit(k6_peer_child(sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4])))
    sys.exit(main())
