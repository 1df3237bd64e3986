#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (acg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and the
checkout it sits in.  Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi), and the kernel build
   from the sources in acg_tpu_torch/csrc/;
2. every kernel of the path against its plain PyTorch version on the
   card, at the main path's shapes: vectors bitwise-equal (the kernels
   are built with --fmad=false), dots within the stated relative error;
3. the main path through acg_tpu_torch.cli.main on gen:poisson2d:2048,
   with the kernels' launch counters reset before and read after each
   run: (a) classic f64 --kernels auto, (b) pipelined f64, (c) --kernels
   fused f32 against --kernels xla, (d) --dtype mixed against f32 at a
   fixed 500 iterations (bitwise-equal iterates);
4. times: solve rates (1000 iterations after a 50-iteration warm-up) and
   per-kernel medians of 50 CUDA-event-timed launches (after 50 ms of
   warm-up launches, L2 flushed before each) beside each kernel's bound, its plain version and,
   for the SpMV, one cuSPARSE call on the same matrix (torch.mv on a CSR
   tensor, which the port never calls); nvidia-smi's SM clock and power
   draw beside them.

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
LOG = []


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


def main_path(torch, K, tmp):
    from acg_tpu_torch.cli import synthesize_host_matrix

    base = [MAIN_SPEC, "--warmup", "0", "-q"]
    A = synthesize_host_matrix(MAIN_SPEC)
    csr = A.to_csr()
    xsol = np.random.default_rng(42).standard_normal(A.nrows)
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
    return paths, csr


# -- phase 4: times --------------------------------------------------------

def solve_rates(torch, dev, card):
    from acg_tpu_torch.io.generators import poisson_dia
    from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
    from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

    planes, offsets, N = poisson_dia(FLAGSHIP, 2)
    meta = {"offsets": offsets, "nrows": N, "ncols_padded": N}
    rates = {}
    for name, dtype, pipelined, kernels in (
            ("classic f64", torch.float64, False, "auto"),
            ("classic f32", torch.float32, False, "auto"),
            ("pipelined f64", torch.float64, True, "auto"),
            ("classic f64 plain torch", torch.float64, False, "xla")):
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


def kernel_times(torch, K, inputs, errs, paths, csr, card):
    N = FLAGSHIP ** 2
    out = []

    def entry(name, source, replaces, kind, ms, plain_ms, nbytes, nops,
              library_ms, **extra):
        bms, by = bound_ms(nbytes, nops, kind)
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "dtype": kind,
             "launches": sum(p[name] for p in paths.values()),
             "launches_by_path": {k: p[name] for k, p in paths.items()},
             "check": "pass: vectors bitwise-equal to the plain version",
             "max_abs_err": errs[(name, kind)], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": library_ms}
        e.update(extra)
        say(f"time {name} {kind} N={N}: kernel {ms:.4f} ms, bound "
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
        if kind in ("f64", "f32"):
            dt = torch.float64 if kind == "f64" else torch.float32
            with warnings.catch_warnings():
                # PyTorch flags its sparse CSR layout as beta on creation
                warnings.simplefilter("ignore", UserWarning)
                At = torch.sparse_csr_tensor(
                    torch.from_numpy(csr.indptr.astype(np.int64)),
                    torch.from_numpy(csr.indices.astype(np.int64)),
                    torch.from_numpy(csr.data).to(dt), size=csr.shape
                ).to(x.device)
            lib = median_ms(torch, lambda: torch.mv(At, x))
            del At
        dbms, _ = bound_ms(nbytes, (2 * D + 2) * N, kind)
        e = entry("dia_spmv", "acg_tpu_torch/csrc/dia_spmv.cu",
                  "acg_tpu/ops/pallas_kernels.py:379", kind, ms, plain,
                  nbytes, 2 * D * N, lib, dot_ms=round(dot_ms, 6),
                  dot_bound_ms=round(dbms, 6))
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
    torch.cuda.synchronize()
    say(f"phase 2 (kernels vs plain) passed in "
        f"{time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_ROOT)
    try:
        t0 = time.perf_counter()
        paths, csr = main_path(torch, K, tmp)
        say(f"phase 3 (main path) passed in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    solve_rates(torch, dev, card)
    say(f"clocks after the solve rates (sm, max sm, draw, limit): "
        f"{clocks_line()}")
    kernels = kernel_times(torch, K, inputs, errs, paths, csr, card)
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
