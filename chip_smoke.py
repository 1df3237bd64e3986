#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (acg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and the
checkout it sits in.  Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi), and the kernel build
   from the sources in acg_tpu_torch/csrc/;
2. every kernel of the paths against its plain PyTorch version on the
   card, at the paths' shapes: vectors bitwise-equal (the kernels are
   built with --fmad=false), dots within the stated relative error;
   K1 batched over the flagship's 4 band parts in every dtype, K5 on
   their flat stack (with and without the live flag), and K6 gated and
   dense on that 4-part halo plan, on the irregular matrix's 4-part
   graph plan and on an 8-part all-pairs plane; K7 (the matrix-free
   Poisson stencil) in f64 and f32 on 2D n = 2048, 3D n = 512, a ragged
   3D n = 37 and 1D, bitwise against its plain version and against K1
   on the same operator's assembled planes, and K7 stacked over the
   flagship's 4 band parts against the generated planes through dia_mv;
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
   gen:irregular:65536, each solved twice to the same bits;
4. times: solve rates (1000 iterations after a 50-iteration warm-up),
   single-device and 4-part with each transport, and per-kernel medians
   of 50 CUDA-event-timed launches (after 50 ms of warm-up launches, L2
   flushed before each) beside each kernel's bound, its plain version
   and, where one PyTorch call computes the same function, that call
   (cuSPARSE through torch.mv on a CSR tensor for the SpMVs, a
   transposing copy for K6, also timed on the irregular graph plan; the
   port never calls them); nvidia-smi's SM clock and power draw beside
   them; torch.profiler breakdowns of the 4-part --comm dma solve and of
   the single-part --operator stencil solve by op, with the device's
   busy share; path
   (h)'s SpMV split into local block, halo exchange and ghost block;
   K7 at 2048^2 and 512^3 in f64 and f32 beside K1 on the assembled
   planes, and stacked K7 on the 4-part plan; classic f64 rates with
   --operator stencil against assembled at 2048^2 and 512^3.

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
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

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


def median_ms(torch, fn, reps: int = 50, warm_s: float = 0.05) -> float:
    """Median time of one call of ``fn`` over ``reps`` launches, each
    bracketed by CUDA events, after at least ``warm_s`` seconds of
    back-to-back calls (short kernels otherwise time the card's clock
    ramp, not the kernel).  The 50 MB L2 is flushed before each timed
    launch, as a CG iteration's other vector passes evict it: the bf16
    flagship planes (42 MB) would otherwise be timed from cache."""
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


def kernel_checks(torch, K, dev):
    from acg_tpu_torch.io.generators import poisson_dia

    dt = {"f64": (torch.float64, torch.float64),
          "f32": (torch.float32, torch.float32),
          "mixed": (torch.bfloat16, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16)}
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
            y = K.dia_spmv(P, offsets, x, offsets_t=ot)
            yd, d = K.dia_spmv(P, offsets, x, offsets_t=ot, with_dot=True)
            yr, dr = K.dia_spmv_plain(P, offsets, x, with_dot=True)
            torch.cuda.synchronize()
            rel = abs(float(d) - float(dr)) / abs(float(dr))
            say(f"K1 dia_spmv {label} {kind}: y bitwise={torch.equal(y, yr)}"
                f" (dot form {torch.equal(yd, yr)}), dot rel err {rel:.3e}"
                f" (limit {DOT_REL[kind]:g})")
            check(torch.equal(y, yr) and torch.equal(yd, yr),
                  f"K1 {label} {kind} y")
            check(rel <= DOT_REL[kind], f"K1 {label} {kind} dot")
            if label == "2d-2048":
                errs[("dia_spmv", kind)] = max(max_abs(y, yr),
                                               max_abs(yd, yr))
                inputs[("dia", kind)] = (P, offsets, ot, x)
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
    return inputs, errs


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
    dt = {"f64": (torch.float64, torch.float64),
          "f32": (torch.float32, torch.float32),
          "mixed": (torch.bfloat16, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16)}
    P64 = torch.from_numpy(prob.local.arrays[0]).to(dev)
    offs = prob.local.offsets
    ot = torch.tensor(offs, dtype=torch.int64, device=dev)
    x64 = torch.randn((prob.nparts, prob.nmax_owned), generator=g,
                      dtype=torch.float64, device=dev)
    for kind, (pdt, xdt) in dt.items():
        P, x = P64.to(pdt).contiguous(), x64.to(xdt)
        y = K.dia_spmv(P, offs, x, offsets_t=ot)
        yr = K.dia_spmv_plain(P, offs, x)
        torch.cuda.synchronize()
        say(f"K1 dia_spmv batched {prob.nparts}x{prob.nmax_owned} {kind}: "
            f"y bitwise={torch.equal(y, yr)}")
        check(torch.equal(y, yr), f"K1 batched {kind}")
        errs[("dia_spmv_batched", kind)] = max_abs(y, yr)
        inputs[("dia_b", kind)] = (P, offs, ot, x)
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


def armed_parts(torch, prob):
    """The flagship's 4-part band problem with the f64 Poisson stencil
    armed (a copy: ``prob`` keeps its assembled local planes)."""
    import dataclasses

    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.parallel.dist import arm_matfree

    return arm_matfree(dataclasses.replace(prob), poisson_stencil(
        FLAGSHIP, 2, dtype=torch.float64, device="cuda"))


def stencil_checks(torch, K, dev, mf, errs):
    """K7 against its plain version (the shifted-view apply) and against
    K1 on the same operator's device-built assembled planes, bitwise, in
    f64 and f32 on the paths' grids (2D 2048, 3D 512) and on ragged ones
    (3D 37, 1D); stacked K7 against the generated planes through dia_mv
    on the flagship's 4-part band plan (real row0/nowned)."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil

    g = torch.Generator(device=dev).manual_seed(777)
    for label, n, dim in (("2d-2048", FLAGSHIP, 2), ("3d-512", DIRECT_N, 3),
                          ("3d-37", 37, 3), ("1d-1000003", 1000003, 1)):
        for kind, dt in (("f64", torch.float64), ("f32", torch.float32)):
            op = poisson_stencil(n, dim, dtype=dt, device=dev)
            x = torch.randn(op.nrows, generator=g, dtype=dt, device=dev)
            y = K.stencil_spmv(op, x)
            yr = K.stencil_spmv_plain(op, x)
            torch.cuda.synchronize()
            same = torch.equal(y, yr)
            err = max_abs(y, yr)
            del yr
            planes, offs, _ = poisson_dia_device(n, dim, dtype=dt,
                                                 device=dev)
            y1 = K.dia_spmv(planes, offs, x, offsets_t=torch.tensor(
                offs, device=dev))
            torch.cuda.synchronize()
            same_k1 = torch.equal(y, y1)
            say(f"K7 stencil_spmv {label} {kind} (N={op.nrows}): y bitwise="
                f"{same} vs plain, bitwise={same_k1} vs K1 on the "
                f"assembled planes")
            check(same and same_k1, f"K7 {label} {kind}")
            errs[("stencil_spmv", kind)] = max(
                err, errs.get(("stencil_spmv", kind), 0.0))
            del x, y, y1, planes
            torch.cuda.empty_cache()
    row0, nowned = (torch.from_numpy(a).to(dev) for a in mf.local.arrays[:2])
    for kind, dt in (("f64", torch.float64), ("f32", torch.float32)):
        op = poisson_stencil(FLAGSHIP, 2, dtype=dt, device=dev)
        x = torch.randn((mf.nparts, mf.nmax_owned), generator=g, dtype=dt,
                        device=dev)
        y = K.stencil_spmv(op, x, row0=row0, nowned=nowned)
        yr = K.stencil_spmv_plain(op, x, row0, nowned)
        torch.cuda.synchronize()
        say(f"K7 stencil_spmv batched {mf.nparts}x{mf.nmax_owned} {kind} "
            f"(row0 {row0.tolist()}, nowned {nowned.tolist()}): y bitwise="
            f"{torch.equal(y, yr)}")
        check(torch.equal(y, yr), f"K7 batched {kind}")
        errs[("stencil_spmv_batched", kind)] = max_abs(y, yr)


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
    return rc, text, counts


def stat(text: str, key: str) -> str:
    for line in text.splitlines():
        if line.strip().startswith(key + ":"):
            return line.split(":", 1)[1].strip()
    raise AssertionError(f"chip_smoke: no '{key}' line in the stats block")


def read_x(path):
    from acg_tpu_torch.io.mtxfile import read_mtx
    return np.asarray(read_mtx(path, binary=True).vals, np.float64)


def main_path(torch, K, tmp, csr, irr):
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
    its_a = int(stat_of["a"])
    paths.update(multipart_paths(torch, K, tmp, base, b, csr, its_a, irr))
    paths.update(matfree_paths(torch, K, tmp, base, paths))
    paths.update(gen_direct_paths(torch, K, tmp))
    paths.update(reproducible_gather_paths(torch, K, tmp, irr))
    return paths


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
        os.remove(x_out)
        check(x.shape == (DIRECT_N ** 3,) and bool(np.isfinite(x).all()),
              f"path {tag}: a finite x of N rows")
        xs.append(x)
        counts[tag] = c
    same = np.array_equal(xs[0], xs[1])
    say(f"path l: operator x bitwise equal to assembled x = {same}")
    check(same, "path l: operator == assembled, bitwise")
    return {"l": {k: counts["l-assembled"][k] + counts["l-operator"][k]
                  for k in counts["l-assembled"]}}


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
    # blocks (plain PyTorch gathers), K6 for the halo; run twice, and the
    # two solutions must be the same bits
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
    out2 = os.path.join(tmp, "h2.bin")
    rc2, text2, c2 = run_cli(torch, K, argv_h + ["-o", out2],
                             "h-irregular-graph-f64-again")
    its2 = int(stat(text2, "iterations").replace(",", ""))
    same = np.array_equal(read_x(out), read_x(out2))
    say(f"path h again: {its2} iterations, x bitwise equal to the first "
        f"run = {same}")
    check(rc2 == 0 and its2 == its and same,
          "path h reproducible: the same iterations and bits twice")
    paths["h"] = c
    return paths


# -- phase 4: times --------------------------------------------------------

def solve_rates(torch, dev, card):
    from acg_tpu_torch.io.generators import poisson_dia
    from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

    from acg_tpu_torch.ops.operator import poisson_stencil

    planes, offsets, N = poisson_dia(FLAGSHIP, 2)
    meta = {"offsets": offsets, "nrows": N, "ncols_padded": N}
    rates = {}
    for name, dtype, pipelined, kernels in (
            ("classic f64", torch.float64, False, "auto"),
            ("classic f64 --operator stencil", torch.float64, False, "auto"),
            ("classic f32", torch.float32, False, "auto"),
            ("pipelined f64", torch.float64, True, "auto"),
            ("classic f64 plain torch", torch.float64, False, "xla")):
        if "operator" in name:
            A = poisson_stencil(FLAGSHIP, 2, dtype=dtype, device=dev)
        else:
            A = device_matrix_from_arrays("dia", planes, meta, dtype=dtype,
                                          device=dev)
        s = TorchCGSolver(A, pipelined=pipelined, kernels=kernels,
                          device=dev)
        b = np.ones(N)
        s.solve(b, criteria=StoppingCriteria(maxits=50))
        runs = []
        for _ in range(3):
            s.stats.tsolve = 0.0
            s.solve(b, criteria=StoppingCriteria(maxits=1000))
            runs.append(1000.0 / s.stats.tsolve)
        rates[name] = runs
        say(f"solve rate {name} (kernels={s.kernels}): "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s "
            f"(median {np.median(runs):.1f}; 1000 iterations after a 50-"
            f"iteration warm-up; {card})")
        del A, s
        torch.cuda.empty_cache()
    return rates


def direct_rates(torch, dev, card, nits: int = 100):
    """Classic f64 at 512^3 (the gen-direct size): the device-built
    assembled planes (K1) against the operator (K7), ``nits`` fixed
    iterations after a 10-iteration warm-up, three timed solves each,
    in turns."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.ops.spmv import DiaMatrix
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

    planes, offs, N = poisson_dia_device(DIRECT_N, 3, dtype=torch.float64,
                                         device=dev)
    solvers = {"assembled (K1)": TorchCGSolver(DiaMatrix(planes, offs, N, N),
                                               device=dev),
               "--operator stencil (K7)": TorchCGSolver(poisson_stencil(
                   DIRECT_N, 3, dtype=torch.float64, device=dev),
                   device=dev)}
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
    del solvers, planes, b
    torch.cuda.empty_cache()


def dist_rates(torch, dev, card, prob):
    """Rates of the 4-part stacked classic f64 solve on each transport,
    with the protocol of solve_rates."""
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria

    rates = {}
    b = np.ones(prob.n)
    for comm in ("dma", "xla"):
        s = DistCGSolver(prob, comm=comm, device=dev)
        s.solve(b, criteria=StoppingCriteria(maxits=50))
        runs = []
        for _ in range(3):
            s.stats.tsolve = 0.0
            s.solve(b, criteria=StoppingCriteria(maxits=1000))
            runs.append(1000.0 / s.stats.tsolve)
        rates[comm] = runs
        say(f"solve rate classic f64 {prob.nparts} parts --comm {comm} "
            f"(kernels={s.kernels}): "
            f"{', '.join(f'{r:.1f}' for r in runs)} iters/s (median "
            f"{np.median(runs):.1f}; 1000 iterations after a 50-iteration "
            f"warm-up; {card})")
        del s
        torch.cuda.empty_cache()
    return rates


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


def profile_solve(torch, card, label, s, n, nits: int = 100):
    """Where the time of solver ``s``'s solve goes: torch.profiler over
    ``nits`` iterations (after a 50-iteration warm-up), the ops by
    device time, and the device's busy share of the profiled wall time.
    Reports "not measured" when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    from acg_tpu_torch.solvers import StoppingCriteria

    b = np.ones(n)
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
             "launches": sum(p[name] for p in paths.values()),
             "launches_by_path": {k: p[name] for k, p in paths.items()
                                  if p[name]},
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
        P, offsets, ot, x = inputs[("dia", kind)]
        D = P.shape[0]
        pb = item["bf16"] if kind in ("mixed", "bf16") else item[kind]
        xb = item["f32"] if kind == "mixed" else pb
        nbytes = D * N * pb + 2 * N * xb
        ms = median_ms(torch, lambda: K.dia_spmv(P, offsets, x,
                                                 offsets_t=ot))
        dot_ms = median_ms(torch, lambda: K.dia_spmv(
            P, offsets, x, offsets_t=ot, with_dot=True))
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
                  dot_bound_ms=round(dbms, 6), **lib_note)
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
        a_plain = median_ms(torch, lambda: K.cg_phase_a_plain(
            P, offsets, r, po, gm, gp))
        pa, ta, _ = K.cg_phase_a(P, offsets, r, po, gm, gp, offsets_t=ot)
        xb, rb = xx.clone(), r.clone()
        tiny = torch.tensor(1e30, device=r.device)  # alpha ~ 0: no drift
        b_ms = median_ms(torch, lambda: K.cg_phase_b(xb, pa, rb, ta, gm,
                                                     tiny))
        b_plain = median_ms(torch, lambda: K.cg_phase_b_plain(
            xb, pa, rb, ta, gm, tiny))
        fused[kind] = (
            entry("cg_phase_a", "acg_tpu_torch/csrc/cg_fused.cu",
                  "acg_tpu/ops/pallas_kernels.py:572", kind, a_ms, a_plain,
                  D * N * pb + 4 * N * vb, (2 * D + 4) * N, None),
            entry("cg_phase_b", "acg_tpu_torch/csrc/cg_fused.cu",
                  "acg_tpu/ops/pallas_kernels.py:627", kind, b_ms, b_plain,
                  6 * N * vb, 6 * N, None))
    out.extend(fused["f32"])
    pipe = {}
    for kind in ("f64", "f32", "bf16"):
        vs, al, be = inputs[("pipe", kind)]
        ws = [v.clone() for v in vs]
        a0 = torch.zeros_like(al)  # alpha = 0: repeated calls stay bounded
        ms = median_ms(torch, lambda: K.pipelined_update(*ws, a0, be))
        plain = median_ms(torch, lambda: K.pipelined_update_plain(
            *vs, al, be))
        pipe[kind] = entry("pipelined_update",
                           "acg_tpu_torch/csrc/pipelined_update.cu",
                           "acg_tpu/ops/pallas_kernels.py:676", kind, ms,
                           plain, 13 * N * item[kind], 12 * N, None)
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
    batched K1).  Returns the f64 entries of the single and stacked
    forms."""
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
            plain = median_ms(torch, lambda: K.stencil_spmv_plain(op, x))
            extra, lib = {}, None
            planes, offs, _ = poisson_dia_device(n, dim, dtype=dt,
                                                 device=dev)
            ot = torch.tensor(offs, device=dev)
            D = len(offs)
            extra["k1_ms"] = round(median_ms(torch, lambda: K.dia_spmv(
                planes, offs, x, offsets_t=ot)), 6)
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
        plain = median_ms(torch, lambda: K.stencil_spmv_plain(
            op, x, row0, nowned))
        At = csr_tensor(torch, bd, dt, dev)
        xf = x.reshape(-1)
        lib = median_ms(torch, lambda: torch.mv(At, xf))
        del At
        e = entry("stencil_spmv_batched", src, rep, kind, ms, plain,
                  2 * NP * item + 2 * mf.nparts * 8, 2 * 5 * NP, lib,
                  shape=f"{mf.nparts}x{mf.nmax_owned}")
        if kind == "f64":
            out.append(e)
    return out


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
        P, offsets, ot, x = inputs[("dia_b", kind)]
        D = P.shape[0]
        pb = item["bf16"] if kind in ("mixed", "bf16") else item[kind]
        xb = item["f32"] if kind == "mixed" else pb
        ms = median_ms(torch, lambda: K.dia_spmv(P, offsets, x,
                                                 offsets_t=ot))
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
                         shape=f"{prob.nparts}x{prob.nmax_owned}", **lib_note)
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
            e = entry("halo_put", "acg_tpu_torch/csrc/halo_put.cu",
                      "acg_tpu/parallel/halo_dma.py:248", kind, ms, plain,
                      2 * gated * maxcnt * item[kind], 0, lib,
                      shape=f"{plan} plane {tuple(send.shape)}",
                      gated_pairs=gated)
            if plan == "halo":
                k6[kind] = e
    out.append(k6["f64"])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs the "
                         "port on the card only\n")
        return 1
    # the checkout's package; outside a checkout this import fails
    from acg_tpu_torch.ops import _build
    from acg_tpu_torch.ops import kernels as K

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
    regs = [ln.strip() for ln in
            (lib.parent / "build.log").read_text().splitlines()
            if "registers" in ln]
    LOG.extend(regs)

    t0 = time.perf_counter()
    inputs, errs = kernel_checks(torch, K, dev)
    from acg_tpu_torch.cli import synthesize_host_matrix
    csr = synthesize_host_matrix(MAIN_SPEC).to_csr()
    prob = flagship_parts(csr)
    irr = irregular_parts()
    dist_kernel_checks(torch, K, dev, prob, irr, inputs, errs)
    mf = armed_parts(torch, prob)
    stencil_checks(torch, K, dev, mf, errs)
    torch.cuda.synchronize()
    say(f"phase 2 (kernels vs plain) passed in "
        f"{time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_ROOT)
    try:
        t0 = time.perf_counter()
        paths = main_path(torch, K, tmp, csr, irr)
        say(f"phase 3 (main path) passed in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    solve_rates(torch, dev, card)
    dist_rates(torch, dev, card, prob)
    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import TorchCGSolver

    profile_solve(torch, card, f"{prob.nparts}-part dma classic f64",
                  DistCGSolver(prob, comm="dma", device=dev), prob.n)
    profile_solve(torch, card, "single part classic f64 --operator "
                  "stencil (K7)", TorchCGSolver(poisson_stencil(
                      FLAGSHIP, 2, dtype=torch.float64, device=dev),
                      device=dev), FLAGSHIP ** 2)
    irregular_spmv_times(torch, dev, card, irr)
    say(f"clocks after the solve rates (sm, max sm, draw, limit): "
        f"{clocks_line()}")
    direct_rates(torch, dev, card)
    kernels = kernel_times(torch, K, inputs, errs, paths, csr, card, prob,
                           mf)
    say(f"clocks after the kernel times (sm, max sm, draw, limit): "
        f"{clocks_line()}")
    say(f"phase 4 (times) done in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on the main path")

    (_build.BUILD_ROOT / "chip_smoke.log").write_text("\n".join(LOG) + "\n")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
