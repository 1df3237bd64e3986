#!/usr/bin/env python3
"""A/B of K4 (phase B of the port's fused classic-CG iteration,
``acg_tpu_torch/csrc/cg_fused.cu``) on one CUDA card: builds of the
port's kernel library that differ only in ``cg_fused.cu``, timed in
turns in one process.

    python3 scripts/torch_k4_ab.py OLD_TREE

OLD_TREE is an unpacked checkout of an earlier commit (``git archive``).
The builds:

* ``old``: OLD_TREE's ``cg_fused.cu`` with its own ``common.cuh``;
* ``new``: this checkout's (the library the port loads);
* ``new, t read-only``: the new source with t read through the read-only
  path instead of the streaming hint;
* ``new, fold in K4``: the new source with phase A's partial sums of
  (p, t) left unfolded and folded by every block of phase B in its
  prologue (in one fixed order, so alpha is the same in every block),
  which takes phase A's one-block fold launch out of each iteration.

For each build, in the turns A B C D D C B A: K4 alone at 2048^2 in f32
and bf16 (median of 50 launches, L2 flushed by writing and by reading;
the fold build reads phase A's 4,096 or 2,048 partials instead of one
(p, t)), and the rates of the fused tier on the flagship matrix in f32,
mixed and bf16 (``chip_smoke.rate_runs``: 1000 iterations after a
50-iteration warm-up, five solves a turn).  Before timing, each build's
K4 is held bitwise against the plain version.  Prints one line a
measurement and, last, one JSON object of them all.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repository root, inserted above)

# (old, new) source edits of each probe build; each old text occurs once
T_READ_ONLY = (("ldv<true>(t + i, tv);", "ldv<false>(t + i, tv);"),)
FOLD_IN_K4 = (
    # phase A leaves its partials unfolded when given no output
    ("static_cast<VT*>(t), static_cast<float*>(part), vec_ok);\n"
     "  reduce_partials<float>(",
     "static_cast<VT*>(t), static_cast<float*>(part), vec_ok);\n"
     "  if (out != nullptr) reduce_partials<float>("),
    # phase B folds them (npd of them, in pdott) before its rows
    ("float* __restrict__ part, int vec_ok) {\n"
     "  constexpr int R = 16 / static_cast<int>(sizeof(VT));\n"
     "  constexpr long long T = kBlock * R;\n"
     "  const bool on = live == nullptr || live[0] != 0;\n"
     "  const float alpha = *gamma / *pdott;",
     "float* __restrict__ part, int vec_ok, int npd) {\n"
     "  constexpr int R = 16 / static_cast<int>(sizeof(VT));\n"
     "  constexpr long long T = kBlock * R;\n"
     "  const bool on = live == nullptr || live[0] != 0;\n"
     "  __shared__ float s_alpha;\n"
     "  float pt = 0.0f;\n"
     "  for (int k = threadIdx.x; k < npd; k += kBlock) pt = pt + pdott[k];\n"
     "  pt = block_sum(pt);\n"
     "  if (threadIdx.x == 0) s_alpha = *gamma / pt;\n"
     "  __syncthreads();\n"
     "  const float alpha = s_alpha;"),
    ("int launch_b(int rows,", "int launch_b(int npd, int rows,"),
    ("static_cast<float*>(part),\n      vec_ok);",
     "static_cast<float*>(part),\n      vec_ok, npd);"),
    ("const void* live, void* part, void* out,\n"
     "                              void* stream) {",
     "const void* live, void* part, void* out,\n"
     "                              void* stream, int npd) {"),
    ("launch_b<float>(rows,", "launch_b<float>(npd, rows,"),
    ("launch_b<__nv_bfloat16>(rows,", "launch_b<__nv_bfloat16>(npd, rows,"),
)
F = chip_smoke.FLAGSHIP
N = F ** 2


def patched(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"torch_k4_ab: the edit {old[:60]!r} does not "
                             f"match cg_fused.cu exactly once")
        text = text.replace(old, new)
    return text


def build(builds: dict, out: Path) -> dict:
    """Compile every other kernel source once and each build's
    cg_fused.cu (beside its common.cuh), all nvcc processes started
    together; link one library a build.  Returns {name: path}."""
    from acg_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    out.mkdir(parents=True, exist_ok=True)
    jobs = {f"common-{s.stem}": s for s in _build._sources()
            if s.name != "cg_fused.cu"}
    jobs.update({f"build-{i}": src for i, src in enumerate(builds.values())})
    procs = {k: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", str(src), "-o", str(out / f"{k}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, src in jobs.items()}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode != 0:
            raise SystemExit(f"torch_k4_ab: {jobs[k]} failed to build:\n"
                             f"{logs[k]}")
    common = [str(out / f"{k}.o") for k in jobs if k.startswith("common-")]
    libs = {}
    for i, name in enumerate(builds):
        lib = out / f"lib{i}.so"
        subprocess.run([nvcc, _build.ARCH, "-shared", "-o", str(lib),
                        str(out / f"build-{i}.o"), *common], check=True)
        spill = [ln.strip() for ln in logs[f"build-{i}"].splitlines()
                 if int(re.search(r"(\d+) bytes spill stores", ln).group(1)
                        if "bytes spill stores" in ln else 0)]
        chip_smoke.say(f"built {name}: {lib.name}; spilling entries: "
                       f"{spill or 'none'}")
        libs[name] = lib
    return libs


def loader(name: str, path: Path):
    """(library, phase-A wrapper, phase-B wrapper) of one build, in the
    wrappers' calling convention."""
    import torch

    from acg_tpu_torch.ops import _build
    from acg_tpu_torch.ops import kernels as K

    lib = ctypes.CDLL(str(path))
    sig = dict(_build._SIGNATURES)
    if name == "old":
        # before the redesign: no rows argument, a partial per 256 rows
        sig["acg_cg_phase_b"] = sig["acg_cg_phase_b"][:2] + \
            sig["acg_cg_phase_b"][3:]
    if name == "new, fold in K4":
        sig["acg_cg_phase_b"] = sig["acg_cg_phase_b"] + (ctypes.c_int,)
    for fn, argtypes in sig.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    f32 = torch.float32
    codes = _build.DTYPE_CODES
    phase_a, phase_b = K.cg_phase_a, K.cg_phase_b
    kinds = (f32, torch.bfloat16)

    # the probe wrappers check their arguments as the port's wrappers
    # do, so that every build costs the host the same
    def checks_a(planes, offsets, r, p_old, gamma, gamma_prev, offsets_t,
                 live):
        dev, n = K._check_vectors("cg_phase_a", kinds, r, p_old)
        K._check_planes("cg_phase_a", planes, n, dev, kinds)
        K._check_offsets_t("cg_phase_a", offsets_t, planes.shape[0], dev)
        if (planes.dtype, r.dtype) not in K.FUSED_TYPES:
            raise ValueError("cg_phase_a: no kernel for these dtypes")
        K._check_scalars("cg_phase_a", f32, dev, gamma, gamma_prev)
        return n, K._live_flag("cg_phase_a", live, dev)

    def checks_b(x, p, r, t, gamma, pdott, live):
        dev, n = K._check_vectors("cg_phase_b", kinds, x, p, r, t)
        if len({v.dtype for v in (x, p, r, t)}) != 1:
            raise ValueError("cg_phase_b: x, p, r, t must share a dtype")
        K._check_scalars("cg_phase_b", f32, dev, gamma,
                         pdott if pdott.numel() == 1 else None)
        return n, K._live_flag("cg_phase_b", live, dev)

    if name == "old":
        def phase_b(x, p, r, t, gamma, pdott, *, live=None):
            n, live = checks_b(x, p, r, t, gamma, pdott, live)
            part = torch.empty(-(-n // 256), dtype=f32, device=x.device)
            g = torch.empty((), dtype=f32, device=x.device)
            _build.check("cg_phase_b", lib.acg_cg_phase_b(
                codes[x.dtype], n, x.data_ptr(), p.data_ptr(), r.data_ptr(),
                t.data_ptr(), gamma.data_ptr(), pdott.data_ptr(),
                K._ptr(live), part.data_ptr(), g.data_ptr(), K._stream()))
            K.launches["cg_phase_b"] += 1
            return x, r, g

    if name == "new, fold in K4":
        # "pdott" is phase A's (nblocks,) partials from here on
        def phase_a(planes, offsets, r, p_old, gamma, gamma_prev, *,
                    offsets_t=None, live=None):
            n, live = checks_a(planes, offsets, r, p_old, gamma, gamma_prev,
                               offsets_t, live)
            plan = K.dia_tile_plan(tuple(offsets), n, planes.dtype)
            p, t = torch.empty_like(r), torch.empty_like(r)
            part = torch.empty(plan.nblocks, dtype=f32, device=r.device)
            _build.check("cg_phase_a", lib.acg_cg_phase_a(
                codes[planes.dtype], codes[r.dtype], planes.data_ptr(),
                offsets_t.data_ptr(), planes.shape[0], n,
                plan.rows_per_thread, plan.index_bits, r.data_ptr(),
                p_old.data_ptr(), gamma.data_ptr(), gamma_prev.data_ptr(),
                K._ptr(live), p.data_ptr(), t.data_ptr(), part.data_ptr(),
                None, K._stream()))
            K.launches["cg_phase_a"] += 1
            return p, t, part

        def phase_b(x, p, r, t, gamma, pdott, *, live=None):
            n, live = checks_b(x, p, r, t, gamma, pdott, live)
            rows, nblocks = K.cg_phase_b_plan(n, x.dtype)
            part = torch.empty(nblocks, dtype=f32, device=x.device)
            g = torch.empty((), dtype=f32, device=x.device)
            _build.check("cg_phase_b", lib.acg_cg_phase_b(
                codes[x.dtype], n, rows, x.data_ptr(), p.data_ptr(),
                r.data_ptr(), t.data_ptr(), gamma.data_ptr(),
                pdott.data_ptr(), K._ptr(live), part.data_ptr(),
                g.data_ptr(), K._stream(), pdott.numel()))
            K.launches["cg_phase_b"] += 1
            return x, r, g

    return lib, phase_a, phase_b


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.stderr.write(__doc__)
        return 1
    from acg_tpu_torch.ops import _build
    from acg_tpu_torch.ops import kernels as K

    old_src = Path(sys.argv[1]) / "acg_tpu_torch" / "csrc" / "cg_fused.cu"
    new_src = _build.CSRC / "cg_fused.cu"
    work = _build.BUILD_ROOT / "k4_ab"
    builds = {"old": old_src, "new": new_src}
    for name, edits in (("new, t read-only", T_READ_ONLY),
                        ("new, fold in K4", FOLD_IN_K4)):
        d = work / name.replace(", ", "-").replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
        (d / "cg_fused.cu").write_text(patched(new_src.read_text(), edits))
        builds[name] = d / "cg_fused.cu"
    card = chip_smoke.device_line(torch)
    chip_smoke.say(card)
    _build.lib()   # the committed build, for everything but the swap
    variants = {name: loader(name, path)
                for name, path in build(builds, work).items()}
    saved = (_build._lib, K.cg_phase_a, K.cg_phase_b)

    def use(name):
        _build._lib, K.cg_phase_a, K.cg_phase_b = variants[name]

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5150)
    gm = torch.tensor(2.0, device=dev)
    inputs = {kind: [torch.randn(N, generator=g, device=dev).to(
        chip_smoke.kinds(torch)[kind][1]) for _ in range(4)]
        for kind in ("f32", "bf16")}

    def pdott(name, kind, value):
        # (p, t) as phase B reads it: one f32, or for the fold build
        # phase A's partials (as many as its plan has), summing to value
        if name != "new, fold in K4":
            return torch.tensor(value, device=dev)
        vdt = chip_smoke.kinds(torch)[kind][1]
        parts = torch.zeros(K.dia_tile_plan(
            (-F, -1, 0, 1, F), N, vdt).nblocks, device=dev)
        parts[0] = value
        return parts
    solvers = {kind: chip_smoke.rate_solver(torch, dev, f"fused {kind}")
               for kind in ("f32", "mixed", "bf16")}
    res = {name: {"k4_ms": {}, "k4_clean_l2_ms": {}, "rates": {}}
           for name in variants}
    for name in variants:
        use(name)
        for kind, (x, p, r, t) in inputs.items():
            want = K.cg_phase_b_plain(x, p, r, t, gm, torch.tensor(
                6.0, device=dev))
            xb, rb = x.clone(), r.clone()
            K.cg_phase_b(xb, p, rb, t, gm, pdott(name, kind, 6.0))
            torch.cuda.synchronize()
            ok = torch.equal(xb, want[0]) and torch.equal(rb, want[1])
            chip_smoke.say(f"{name} K4 {kind}: x, r bitwise={ok}")
            chip_smoke.check(ok, f"{name} K4 {kind} vectors")
    order = list(variants) + list(reversed(variants))
    for name in order:
        use(name)
        for kind, vecs in inputs.items():
            x, p, r, t = (v.clone() for v in vecs)
            # alpha ~ 0 keeps repeated launches bounded, as in
            # chip_smoke's kernel times
            pt = pdott(name, kind, 1e30)
            for key, clean in (("k4_ms", False), ("k4_clean_l2_ms", True)):
                res[name][key].setdefault(kind, []).append(chip_smoke.median_ms(
                    torch, lambda: K.cg_phase_b(x, p, r, t, gm, pt),
                    clean=clean))
        for kind, s in solvers.items():
            runs = chip_smoke.rate_runs(s, N, nruns=5)
            res[name]["rates"].setdefault(kind, []).extend(runs)
            chip_smoke.say(f"{name}: fused {kind} "
                           f"{', '.join(f'{v:.1f}' for v in runs)} iters/s")
    _build._lib, K.cg_phase_a, K.cg_phase_b = saved
    for name, r in res.items():
        for key in ("k4_ms", "k4_clean_l2_ms"):
            for kind, v in r[key].items():
                chip_smoke.say(f"{name}: K4 {kind} {key} turns "
                               f"{', '.join(f'{u:.4f}' for u in v)}")
        for kind, v in r["rates"].items():
            chip_smoke.say(f"{name}: fused {kind} median {np.median(v):.1f} "
                           f"iters/s, range {min(v):.1f}-{max(v):.1f} over "
                           f"{len(v)} solves")
    chip_smoke.say(f"clocks (sm, max sm, draw, limit): "
                   f"{chip_smoke.clocks_line()}")
    print(json.dumps({"card": card, "builds": res}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
