"""Performance observability: the counted and analytic cost of an
iteration, the static communication ledger, the roofline ``--explain``
tier, and the case keying of the bench regression gate.

The counterpart of ``acg_tpu/perfmodel.py``.  The reference reads the
cost of its compiled whole-solve program from XLA; the port runs eager
PyTorch with hand kernels and has no compiled program to ask, so its
counts come from two other sources, each named in the report:

* **analytic**: the stats block's flop and byte census an iteration
  (:func:`analytic_bytes_per_iteration`, ``cg_flops_per_iteration``),
  the same numbers the reference's analytic counters give;
* **counted**: what one iteration dispatches -- the PyTorch operations
  (a ``TorchDispatchMode`` over two short solves, on the CPU and on the
  card alike) and the hand-kernel launches
  (:data:`acg_tpu_torch.ops.kernels.launches`) -- and the device
  footprint (``torch.cuda.max_memory_allocated`` around a solve on the
  card; the bytes of the solver's tensors everywhere).

The port pays its launches on every iteration, where the reference pays
one program dispatch a solve, so the verdict's dispatch term is a
per-iteration one: launches an iteration times the measured latency of a
chain of small launches, plus the host flag read amortised over a chunk
(:data:`acg_tpu_torch.solvers.cg.CHUNK`).  Without a calibration the
parts' communication is priced from the device's own figures: stacked
parts move their halos through device memory, at the probed triad
bandwidth (:data:`HBM_BYTES_S` when the probe failed); such verdicts
say they are uncalibrated.  With a ``--commbench`` calibration the comm
component comes from its fitted alpha-beta model and the measured
segments replace the analytic stand-in, as in the reference.

Nothing here changes a solve: the counting and timing solves run the
solver's ordinary programs, and the solver's statistics are restored
after the counting solves.  The case keying (:func:`load_cases`,
:func:`compare_cases`, :func:`check_regression`) is plain JSON work and
imports no torch, so ``scripts/torch_bench_diff.py --help`` answers at
once.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import numpy as np

# the H100's HBM3 rate (bytes/s), the bound of chip_smoke.py: the price
# of device-memory traffic when the triad probe failed
HBM_BYTES_S = 3.35e12

UNAVAILABLE = "analysis unavailable for this solver"

# the counting solves' lengths: two chunks' difference, so the per-chunk
# flag read and the setup cancel
COUNT_CHUNKS = (1, 2)


# -- counted cost: the operations and launches of an iteration -----------

def _dispatch_counter():
    """A ``TorchDispatchMode`` that counts the operations that reach a
    device: views and allocations launch nothing and are left out, and
    the scalar reads to the host (``_local_scalar_dense``) are counted
    apart."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0
            self.reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            if name.startswith("_local_scalar_dense"):
                self.reads += 1
            elif not (getattr(func, "is_view", False)
                      or name.startswith("empty")
                      or func in (torch.ops.aten.detach.default,
                                  torch.ops.aten.alias.default)):
                self.ops += 1
            return func(*args, **(kwargs or {}))

    return Counter()


def count_dispatches(solver, b, chunks=COUNT_CHUNKS) -> dict:
    """The operations, host reads and hand-kernel launches ONE iteration
    of ``solver``'s loop dispatches: two unbounded solves of
    ``chunks[0]`` and ``chunks[1]`` chunks, counted, and their
    difference over the extra iterations.  The solver's statistics are
    restored afterwards; on the card the second solve's peak device
    memory is recorded too."""
    import torch

    from acg_tpu_torch._device import device_sync
    from acg_tpu_torch.ops import kernels as K
    from acg_tpu_torch.solvers.cg import CHUNK
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    saved = copy.deepcopy(solver.stats)
    dev = solver.device
    counts = []
    peak = None
    try:
        for c in chunks:
            k = int(c) * CHUNK
            before = dict(K.launches)
            if dev.type == "cuda":
                device_sync(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            with _dispatch_counter() as m:
                solver.solve(b, criteria=StoppingCriteria(maxits=k),
                             host_result=False, raise_on_divergence=False)
            device_sync(dev)
            if dev.type == "cuda":
                peak = int(torch.cuda.max_memory_allocated(dev))
            counts.append((k, m.ops, m.reads,
                           {n: v - before.get(n, 0)
                            for n, v in K.launches.items()}))
    finally:
        solver.stats = saved
    (k1, o1, r1, l1), (k2, o2, r2, l2) = counts
    dk = float(k2 - k1)
    kern = {n: (l2[n] - l1[n]) / dk for n in l2 if l2[n] - l1[n]}
    out = {"source": "counted", "iterations": [k1, k2],
           "ops_per_iteration": (o2 - o1) / dk,
           "host_reads_per_iteration": max((r2 - r1) / dk, 0.0),
           "kernel_launches_per_iteration": kern}
    out["dispatches_per_iteration"] = (out["ops_per_iteration"]
                                       + sum(kern.values()))
    if peak is not None:
        out["peak_device_bytes"] = peak
    return out


def launch_latency_seconds(device, n: int = 200, repeats: int = 3) -> float:
    """Seconds a launch of a chain of small launches takes (``n``
    in-place adds on an 8-element tensor between two synchronizes, the
    min of ``repeats``): what each of an iteration's launches costs the
    host-bound loop."""
    import torch

    from acg_tpu_torch._device import device_sync

    x = torch.zeros(8, dtype=torch.float32, device=device)
    x.add_(1.0)
    device_sync(x.device)
    best = float("inf")
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        for _ in range(int(n)):
            x.add_(1.0)
        device_sync(x.device)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def flag_read_seconds(device, repeats: int = 20) -> float:
    """Seconds of one host read of a device flag (the loop's once-a-chunk
    convergence read), min of ``repeats``."""
    import torch

    from acg_tpu_torch._device import device_sync

    x = torch.zeros(8, dtype=torch.float32, device=device)
    device_sync(x.device)
    best = float("inf")
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        bool(x[0] > 0)
        best = min(best, time.perf_counter() - t0)
    return best


def dispatch_seconds(counted: dict, launch_s: float, flag_s: float) -> float:
    """The per-iteration dispatch term: dispatches an iteration times the
    launch latency, plus the flag read amortised over a chunk."""
    from acg_tpu_torch.solvers.cg import CHUNK
    return (float(counted.get("dispatches_per_iteration", 0.0)) * launch_s
            + flag_s / CHUNK)


def _tensor_bytes(obj, seen: set, depth: int = 0) -> int:
    """Bytes of the distinct tensors reachable from ``obj`` (attributes,
    containers, dataclass fields), a few levels deep."""
    import torch

    if isinstance(obj, torch.Tensor):
        key = (obj.device, obj.untyped_storage().data_ptr())
        if key in seen:
            return 0
        seen.add(key)
        return int(obj.untyped_storage().nbytes())
    if depth > 4 or isinstance(obj, (str, bytes, int, float, bool,
                                     np.ndarray, type(None))):
        return 0
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__dict__") and not callable(obj):
        items = vars(obj).values()
    else:
        return 0
    return sum(_tensor_bytes(v, seen, depth + 1) for v in items)


def solver_tensor_bytes(solver) -> int:
    """Bytes of the device tensors the solver holds (matrix, halo plan,
    preconditioner state): the resident part of its footprint."""
    return _tensor_bytes(vars(solver), set())


def analyze_solver(solver, b) -> dict:
    """The counted cost of ``solver``'s iteration
    (:func:`count_dispatches`) and its device footprint.  Returns
    ``{"available": True, "dispatch": {...}, "memory": {...}}`` or
    ``{"available": False, "why": ...}``: the analysis degrades, it
    never raises into an explain pass."""
    try:
        counted = count_dispatches(solver, b)
        resident = solver_tensor_bytes(solver)
    except Exception as e:  # noqa: BLE001 -- observability degrades
        return {"available": False,
                "why": f"counting failed: {type(e).__name__}: {e}"}
    mem = {"source": "counted", "argument_bytes": int(resident)}
    peak = counted.pop("peak_device_bytes", None)
    mem["total_hbm_bytes"] = int(peak if peak is not None else resident)
    if peak is not None:
        mem["peak_allocated_bytes"] = int(peak)
    return {"available": True, "dispatch": counted, "memory": mem}


# -- communication ledger -------------------------------------------------

def comm_ledger(solver) -> dict | None:
    """The solver's static per-iteration communication ledger (its
    ``comm_profile``); None for single-device solvers.  Pure host
    arithmetic."""
    prof = getattr(solver, "comm_profile", None)
    if prof is None:
        return None
    try:
        return prof()
    except Exception as e:  # noqa: BLE001 -- a ledger bug must not sink a solve
        return {"error": f"{type(e).__name__}: {e}"}


def attach(stats, analysis: dict | None, ledger: dict | None = None,
           per_iteration: dict | None = None) -> None:
    """Record an analysis on ``stats``: the ``costmodel:`` and
    ``memory:`` sections of the block and its ``--stats-json`` twin."""
    cm: dict = {}
    if analysis is not None:
        if analysis.get("available"):
            cm.update(analysis.get("cost", {}))
        else:
            cm["unavailable"] = analysis.get("why", UNAVAILABLE)
    if per_iteration:
        cm["per_iteration"] = dict(per_iteration)
    if ledger is not None:
        cm["comm"] = ledger
    if cm:
        stats.costmodel.update(cm)
    if analysis is not None and analysis.get("available"):
        mem = analysis.get("memory")
        if mem:
            stats.memory.update(mem)


# -- analytic traffic model -----------------------------------------------

def analytic_bytes_per_iteration(nnz: int, n: int, idx_bytes: float,
                                 mat_itemsize: int, vec_itemsize: int,
                                 pipelined: bool) -> float:
    """The analytic device-memory traffic of a CG iteration
    (``acg_tpu/perfmodel.py:291``): the matrix read in its storage dtype
    plus per-nonzero index bytes, and the loop's 15 (classic) or 21
    (pipelined) vector passes in the vector dtype."""
    passes = 21 if pipelined else 15
    return nnz * (mat_itemsize + idx_bytes) + passes * n * vec_itemsize


# device-memory passes of one triad step: c and a read, the result written
TRIAD_PASSES = 3


def triad_chain(a, c, out, k: int):
    """``k`` chained triad steps ``out = c + s * a`` (``s`` just above 1),
    each ONE kernel (``torch.add`` with ``alpha``): :data:`TRIAD_PASSES`
    passes over memory a step, the two buffers ``a`` and ``out`` taking
    turns.  Returns the last step's result."""
    import torch

    bufs = (a, out)
    for i in range(int(k)):
        torch.add(c, bufs[i % 2], alpha=1.0000001, out=bufs[(i + 1) % 2])
    return bufs[int(k) % 2]


def triad_probe_gbs(nelems: int = 1 << 26, reps: int = 3,
                    attempts: int = 4, lo: float = 20.0,
                    hi: float = 4000.0, device="cpu") -> float:
    """Two-point chained triad bandwidth (GB/s) on ``device``
    (:func:`triad_chain`: :data:`TRIAD_PASSES` f32 passes a step), 16
    steps against 4, so the launches cancel.  Raises RuntimeError when
    the estimate stays outside ``[lo, hi]`` for ``attempts`` tries."""
    import torch

    from acg_tpu_torch._device import device_sync

    n = int(nelems)
    dev = torch.device(device)
    c = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    a = torch.ones((n,), dtype=torch.float32, device=dev)
    out = torch.empty_like(a)

    def best(k):
        device_sync(dev)
        triad_chain(a, c, out, k)
        device_sync(dev)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            triad_chain(a, c, out, k)
            device_sync(dev)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    for _ in range(attempts):
        dt = best(16) - best(4)
        if dt > 0:
            bw = TRIAD_PASSES * n * 4.0 * 12 / dt / 1e9
            if lo <= bw <= hi:
                return bw
    raise RuntimeError("bandwidth probe unstable (two-point estimate "
                       f"implausible after {attempts} attempts)")


def _probe_cache_path() -> str:
    """The triad probe's sidecar (``ACG_TPU_PROBE_CACHE`` overrides; by
    default under the XDG cache directory).  The port's entries have
    keys of their own (:func:`probe_cache_key`)."""
    p = os.environ.get("ACG_TPU_PROBE_CACHE")
    if p:
        return p
    base = (os.environ.get("XDG_CACHE_HOME")
            or os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "acg-tpu", "probe_cache.json")


def probe_cache_key(device, nelems: int) -> str:
    """``torch:<device name>:n<nelems>``: a value the reference measured
    (its keys start with the JAX platform) never prices the port, a CPU
    figure never the card's, and the small explain probe never the
    full-size one."""
    from acg_tpu_torch.commbench import device_name
    return f"torch:{device_name(device)}:n{int(nelems)}"


def cached_triad_probe_gbs(nelems: int = 1 << 26, use_cache: bool = True,
                           refresh: bool = False, device="cpu",
                           **kw) -> float:
    """:func:`triad_probe_gbs` behind the on-disk sidecar, so repeated
    ``--explain`` runs skip the re-probe (``--no-probe-cache``:
    ``use_cache=False`` measures afresh and leaves the sidecar alone;
    ``refresh`` measures afresh and updates it)."""
    key = probe_cache_key(device, nelems)
    path = _probe_cache_path()
    if use_cache and not refresh:
        try:
            with open(path) as f:
                entry = (json.load(f) or {}).get(key)
            if isinstance(entry, dict) and float(entry.get("gbs", 0)) > 0:
                return float(entry["gbs"])
        except (OSError, ValueError, TypeError):
            pass
    bw = triad_probe_gbs(nelems, device=device, **kw)
    if use_cache:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                with open(path) as f:
                    cache = json.load(f)
            except (OSError, ValueError):
                cache = {}
            if not isinstance(cache, dict):
                cache = {}
            cache[key] = {"gbs": float(bw), "unix_time": time.time()}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(cache, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            pass
    return bw


def predicted_overlap_seconds(led: dict, bw_gbs: float | None,
                              ici_gbs: float | None,
                              halo_s: float | None = None) -> dict | None:
    """The fused tier's overlap verdict from its ledger
    (``acg_tpu/perfmodel.py:433``): ``exposed = max(0, halo - interior
    SpMV)``, with the halo priced over ``ici_gbs`` or given as
    ``halo_s`` (a calibration's measured exchange)."""
    ov = led.get("overlap") or {}
    if not bw_gbs or (halo_s is None and not ici_gbs):
        return None
    t_halo = (halo_s if halo_s is not None else
              led.get("halo_bytes_per_iteration", 0) / (ici_gbs * 1e9))
    t_int = ov.get("interior_matrix_bytes", 0) / (bw_gbs * 1e9)
    exposed = max(0.0, t_halo - t_int)
    out = {"halo_s": t_halo, "interior_spmv_s": t_int,
           "exposed_halo_s": exposed,
           "hidden_frac": (1.0 - exposed / t_halo) if t_halo > 0
           else None}
    if halo_s is not None:
        out["halo_source"] = "commbench calibration"
    return out


def classify_bound(measured_s: float, hbm_s: float, comm_s: float,
                   dispatch_s: float) -> tuple[str, dict]:
    """``(verdict, components)``: the largest modelled component of a
    measured iteration; what the model does not explain goes to
    compute."""
    comp = {"HBM-bound": max(hbm_s, 0.0),
            "comm-bound": max(comm_s, 0.0),
            "dispatch-bound": max(dispatch_s, 0.0)}
    comp["compute-bound"] = max(measured_s - sum(comp.values()), 0.0)
    verdict = max(comp, key=lambda k: comp[k])
    return verdict, comp


# -- the CLI --explain tier ----------------------------------------------

def explain_matrix(args):
    """The host CSR of the explain pass: a ``gen:`` spec synthesized, a
    file read.  Refuses sizes only the gen-direct tier could hold."""
    from acg_tpu_torch.cli import (_gen_direct_min, _parse_gen_spec,
                                   synthesize_host_matrix)
    from acg_tpu_torch.errors import AcgError
    from acg_tpu_torch.matrix import SymCsrMatrix

    if args.A.startswith("gen:"):
        _kind, _dim, _n, N, _avg = _parse_gen_spec(args.A)
        if N > _gen_direct_min():
            raise SystemExit(
                f"acg-tpu-torch: --explain analyses host-assembled tiers "
                f"(N={N:,} rows needs the gen-direct path); use a smaller "
                f"gen: spec")
        A = synthesize_host_matrix(args.A, aniso=args.aniso,
                                   seed=args.seed)
    else:
        from acg_tpu_torch.io.mtxfile import read_mtx
        try:
            A = SymCsrMatrix.from_mtx(read_mtx(args.A, binary=args.binary))
        except AcgError as e:
            raise SystemExit(f"acg-tpu-torch: {args.A}: {e}")
    return A.to_csr(epsilon=args.epsilon)


def _fmt_bytes(n: float) -> str:
    return f"{n:,.0f} B" if n < 1 << 20 else f"{n / 2**20:,.1f} MiB"


def _analytic_costs(solver, csr):
    """``(flops, bytes, matfree_tables, nnz, mat_b, idx_b)`` an
    iteration, billed as ``acg_tpu/perfmodel.py:554-595`` bills them."""
    import torch

    from acg_tpu_torch.ops.spmv import matrix_dtype, matrix_index_bytes
    from acg_tpu_torch.solvers.stats import cg_flops_per_iteration

    def isz(dt):
        return torch.empty((), dtype=dt).element_size()

    prob = getattr(solver, "problem", None)
    tables = None
    if prob is not None:
        nnz, n = int(prob.nnz_total), int(prob.n)
        mat_b, vec_b = isz(prob.dtype), isz(prob.vdtype)
        idx_b = 0.0 if prob.local.format in ("dia", "matfree") else 4.0
        if prob.operator is not None:
            tables = int(prob.operator.table_bytes())
    else:
        A = solver.A
        nnz, n = int(csr.nnz), int(csr.shape[0])
        mat_b = isz(matrix_dtype(A))
        vec_b = isz(solver._solve_dtype())
        idx_b = matrix_index_bytes(A)
        if hasattr(A, "table_bytes"):
            tables = int(A.table_bytes())
    flops = cg_flops_per_iteration(nnz, n, solver.pipelined)
    if tables is not None:
        byts = (analytic_bytes_per_iteration(0, n, 0.0, 0, vec_b,
                                             solver.pipelined) + tables)
    else:
        byts = analytic_bytes_per_iteration(nnz, n, idx_b, mat_b, vec_b,
                                            solver.pipelined)
    spec = getattr(solver, "precond_spec", None)
    if spec is not None:
        from acg_tpu_torch.precond import (bytes_per_apply,
                                           flops_per_apply, state_bytes)
        mst = getattr(solver, "_mstate", None)
        sb = state_bytes(mst) if mst is not None else 0
        flops += flops_per_apply(spec, n, 3.0 * nnz)
        byts += bytes_per_apply(spec, n, vec_b,
                                nnz * (mat_b + idx_b) + 2 * n * vec_b, sb)
    return flops, byts, tables, nnz, mat_b, idx_b


def _explain_tier(name, solver, b, csr, K, bw_gbs, launch_s, flag_s,
                  err, cal: dict | None = None) -> dict | None:
    """Count, time and price one tier and print its explain block;
    returns the verdict row.  With a calibration the comm component is
    the fitted alpha-beta model's and the measured segments replace the
    analytic stand-in, and both predictions are reported; without one,
    the stacked parts' comm bytes move at the probed bandwidth (the
    card's memory rate when the probe failed)."""
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    comm_gbs = bw_gbs or HBM_BYTES_S / 1e9

    an = analyze_solver(solver, b)
    led = comm_ledger(solver)

    # the timed short solve: one warm-up, K iterations unbounded
    from acg_tpu_torch.ops import kernels as Kn
    before = dict(Kn.launches)
    solver.stats.tsolve = 0.0
    solver.solve(b, criteria=StoppingCriteria(maxits=K), warmup=1,
                 host_result=False, raise_on_divergence=False)
    t_iter = solver.stats.tsolve / K
    timed_launches = {n: v - before.get(n, 0) for n, v in
                      Kn.launches.items() if v - before.get(n, 0)}

    flops_it, bytes_it, tables, nnz, mat_b, idx_b = _analytic_costs(
        solver, csr)
    counted = an.get("dispatch") if an.get("available") else None
    if an.get("available"):
        an["cost"] = {"source": "analytic",
                      "flops_per_iteration": float(flops_it),
                      "bytes_per_iteration": float(bytes_it)}
    attach(solver.stats, an, ledger=led, per_iteration=counted)

    comm_bytes = 0
    if led and "error" not in led:
        comm_bytes = (led.get("halo_bytes_per_iteration", 0)
                      + led.get("allreduce_bytes_per_iteration", 0))
    t_hbm = bytes_it / (bw_gbs * 1e9) if bw_gbs else 0.0
    t_comm = comm_bytes / (comm_gbs * 1e9)
    t_disp = (dispatch_seconds(counted, launch_s, flag_s)
              if counted is not None else 0.0)
    overlap = None
    if led and "error" not in led and led.get("overlap"):
        overlap = predicted_overlap_seconds(led, bw_gbs, comm_gbs)
        if overlap is not None:
            t_comm = (overlap["exposed_halo_s"]
                      + led.get("allreduce_bytes_per_iteration", 0)
                      / (comm_gbs * 1e9))
    t_comm_uncal = t_comm
    predicted_uncal = t_hbm + t_comm_uncal + t_disp

    cal_comm = segs = None
    cal_id = None
    if cal is not None:
        from acg_tpu_torch import commbench
        cal_id = str(cal.get("calibration_id", ""))
        if led and "error" not in led:
            cal_comm = commbench.comm_seconds(cal, led)
            if led.get("overlap"):
                halo_meas = commbench.halo_exchange_seconds(cal, led)
                ov_cal = predicted_overlap_seconds(led, bw_gbs, comm_gbs,
                                                   halo_s=halo_meas)
                if ov_cal is not None:
                    overlap = ov_cal
        segs = commbench.segment_decomposition(solver, b)
        if cal_comm is not None:
            t_comm = (cal_comm["allreduce_s"]
                      + (overlap["exposed_halo_s"]
                         if overlap is not None else cal_comm["halo_s"]))
    verdict, comp = classify_bound(t_iter, t_hbm, t_comm, t_disp)
    predicted = t_hbm + t_comm + t_disp
    if cal is not None and segs and segs.get("available"):
        # the measured segments hold their own launches: the dispatch
        # term keeps only the iteration's other launches
        sseg = segs["segments"]
        spmv = sseg.get("spmv", {})
        red = sseg.get("reduction", {})
        in_segs = [spmv]
        if cal_comm is not None:
            red_seg = cal_comm["allreduce_s"]
        else:
            red_seg = red.get("s_per_iteration", 0.0)
            in_segs.append(red)
        rest = t_disp
        if counted is not None:
            seg_disp = sum(g.get("dispatches_per_call", 0.0)
                           * g.get("calls_per_iteration", 0.0)
                           for g in in_segs)
            rest = dispatch_seconds(
                {"dispatches_per_iteration": max(
                    counted["dispatches_per_iteration"] - seg_disp, 0.0)},
                launch_s, flag_s)
        predicted = spmv.get("s_per_iteration", 0.0) + red_seg + rest
    attained = (t_hbm / t_iter) if t_iter > 0 else 0.0

    err.write(f"== explain: {name} ==\n")
    solver.stats.fwrite(err, indent=2)
    if counted is not None:
        kern = counted["kernel_launches_per_iteration"]
        ktxt = ", ".join(f"{k} x {v:g}" for k, v in sorted(kern.items()))
        err.write(f"  counted: {counted['ops_per_iteration']:g} ops + "
                  f"{sum(kern.values()):g} hand-kernel launches an "
                  f"iteration ({ktxt or 'no hand kernel'}); "
                  f"{counted['host_reads_per_iteration']:g} host reads "
                  f"(TorchDispatchMode over {counted['iterations'][0]} "
                  f"and {counted['iterations'][1]} iterations)\n")
    else:
        err.write(f"  counted: {an.get('why', UNAVAILABLE)}\n")
    err.write(f"  per-iteration (analytic): flops {flops_it:,.4g}, bytes "
              f"{bytes_it:,.4g}\n")
    if tables is not None:
        err.write(f"  matrix-free operator: matrix bytes/SpMV {tables:,} "
                  f"(generated planes read only the coefficient tables; "
                  f"the assembled twin reads "
                  f"{nnz * (mat_b + idx_b):,.0f})\n")
    mem = an.get("memory") if an.get("available") else None
    if mem:
        peak = mem.get("peak_allocated_bytes")
        err.write(f"  memory (device footprint, counted): resident "
                  f"{_fmt_bytes(mem.get('argument_bytes', 0))}"
                  + (f"; peak allocated in a solve {_fmt_bytes(peak)}"
                     if peak is not None else " (the solver's tensors)")
                  + "\n")
    if led and "error" not in led:
        err.write(f"  comm ledger: halo "
                  f"{led.get('halo_bytes_per_iteration', 0):,} B/iter, "
                  f"allreduce {led.get('allreduce_per_iteration', 0)} x "
                  f"{led.get('allreduce_scalars', 0)} scalars "
                  f"({led.get('allreduce_bytes_per_iteration', 0)} B/iter),"
                  f" max {led.get('max_hops', 0)} hop(s) "
                  f"[{led.get('transport', '?')}]\n")
    if overlap is not None:
        ov = led["overlap"]
        hid = overlap.get("hidden_frac")
        err.write(f"  overlap model (interior|border split, "
                  f"{ov.get('interior_rows', 0):,} interior / "
                  f"{ov.get('border_rows', 0):,} border rows): halo "
                  f"{overlap['halo_s']:.3e} s vs interior SpMV "
                  f"{overlap['interior_spmv_s']:.3e} s -> predicted "
                  f"exposed {overlap['exposed_halo_s']:.3e} s/iter"
                  + (f" ({hid:.0%} hidden)" if hid is not None else "")
                  + "\n")
    if segs is not None:
        if segs.get("available"):
            sseg = segs["segments"]
            parts_txt = " + ".join(
                f"{k} {v['s_per_iteration']:.3e}"
                for k, v in sseg.items() if k != "halo")
            halo_txt = (f" (halo {sseg['halo']['s_per_iteration']:.3e}"
                        f" inside spmv)" if "halo" in sseg else "")
            err.write(f"  segments (measured, {segs['reps']} chained "
                      f"rounds/probe): {parts_txt} ="
                      f" {segs['explained_s_per_iteration']:.3e} "
                      f"s/iter explained{halo_txt}\n")
        else:
            err.write(f"  segments: unavailable "
                      f"({segs.get('why', '?')})\n")
    if cal is not None:
        if cal_comm is not None:
            err.write(f"  calibrated comm (alpha-beta, {cal_id}): "
                      f"allreduce {cal_comm['allreduce_s']:.3e} + "
                      f"halo[{cal_comm['halo_kind']}] "
                      f"{cal_comm['halo_s']:.3e} s/iter (replaces the "
                      f"uncalibrated bytes-over-bandwidth price)\n")
        elif led is None:
            err.write(f"  calibrated comm ({cal_id}): no comm ledger on "
                      f"this tier (single device) -- segments carry the "
                      f"calibration\n")
    if counted is not None:
        err.write(f"  dispatch: {counted['dispatches_per_iteration']:g} "
                  f"launches/iter x {launch_s:.3e} s + flag read "
                  f"{flag_s:.3e} s / chunk = {t_disp:.3e} s/iter\n")
    bw_txt = f"{bw_gbs:,.1f} GB/s" if bw_gbs else "unavailable"
    err.write(f"  roofline: probe {bw_txt}"
              + (f", comm uncalibrated at {comm_gbs:,.0f} GB/s"
                 if comm_bytes and cal_comm is None else "")
              + f"; predicted {predicted:.3e} s/iter"
              + (f" (measured segments + fitted comm + the rest of "
                 f"the dispatch; uncalibrated model "
                 f"{predicted_uncal:.3e})"
                 if cal is not None and predicted != predicted_uncal
                 else f" (hbm {t_hbm:.3e} + comm {t_comm:.3e} + "
                      f"dispatch {t_disp:.3e})") + "\n")
    ratio = (predicted / t_iter) if t_iter > 0 else 0.0
    ratio_uncal = (predicted_uncal / t_iter) if t_iter > 0 else 0.0
    err.write(f"  measured {t_iter:.3e} s/iter over {K} iterations; "
              f"attained {attained:.2f}x of HBM roofline; "
              f"predicted/measured {ratio:.2f}x"
              + (f" (uncalibrated {ratio_uncal:.2f}x; calibration "
                 f"{cal_id})" if cal is not None else "")
              + f"; verdict: {verdict}\n\n")

    row = {"tier": name, "measured_s_per_iter": t_iter,
           "predicted_s_per_iter": predicted,
           "attained_roofline_frac": attained, "bound": verdict,
           "components_s": comp, "timed_iterations": K,
           "timed_kernel_launches": timed_launches}
    if counted is not None:
        row["dispatches_per_iteration"] = counted["dispatches_per_iteration"]
        row["kernel_launches_per_iteration"] = dict(
            counted["kernel_launches_per_iteration"])
    if cal is None:
        row["uncalibrated"] = True
    if tables is not None:
        row["matrix_free"] = True
        row["matrix_bytes_per_spmv"] = tables
    if overlap is not None:
        row["overlap_model"] = overlap
    if cal is not None:
        row["calibration"] = cal_id
        row["uncalibrated_predicted_s_per_iter"] = predicted_uncal
        solver.stats.costmodel["calibration"] = cal_id
        if cal_comm is not None:
            row["calibrated_comm_s"] = cal_comm
    if segs is not None and segs.get("available"):
        row["segments"] = segs
        solver.stats.costmodel["segments"] = segs
    return row


def build_explain_dist_solver(args, csr, nparts, dtype, vec_dtype, device,
                              operator=None, **solver_kw):
    """The dist tier's construction, shared by :func:`run_explain` and
    the commbench observatory (one copy: a calibration describes the
    stacked parts the verdict prices).  ``operator`` forces the band
    partition and arms the matrix-free local block."""
    from acg_tpu_torch.ops.spmv import prefers_dia
    from acg_tpu_torch.parallel.dist import (DistCGSolver,
                                             DistributedProblem,
                                             arm_matfree, resolve_comm)
    from acg_tpu_torch.partition import partition_rows

    method = "band" if operator is not None or prefers_dia(csr) \
        else "graph"
    part = partition_rows(csr, nparts, seed=args.seed, method=method)
    prob = DistributedProblem.build(csr, part, nparts, dtype=dtype,
                                    vector_dtype=vec_dtype)
    if operator is not None:
        arm_matfree(prob, operator)
    comm = resolve_comm(args.comm) if args.comm != "none" else "xla"
    return DistCGSolver(prob, pipelined=False, comm=comm,
                        precise_dots=args.precise_dots,
                        kernels=args.kernels, device=device, **solver_kw)


def _calibration_header(args, cal, nparts, device, err):
    """The ``== explain: calibration ==`` header; returns the structured
    ``calibration-mismatch`` event when the calibration was taken with
    another part count, backend or device (None otherwise)."""
    from acg_tpu_torch.commbench import KINDS, device_name

    src = getattr(args, "_calibration_source", None) \
        or "live --commbench run"
    fitted = [k for k in KINDS
              if isinstance(cal.get("collectives", {}).get(k), dict)
              and "alpha_s" in cal["collectives"][k]]
    err.write(f"== explain: calibration ==\n"
              f"  id {cal.get('calibration_id')} ({src}); fitted "
              f"kinds: {', '.join(fitted) or 'none'}; benchmarked "
              f"on {cal.get('nparts')} parts"
              + (f" on {cal['device']}" if cal.get("device") else "")
              + "\n")
    mismatches = []
    if int(cal.get("nparts", 0)) != int(nparts):
        mismatches.append(f"mesh {cal.get('nparts')} parts vs this run's "
                          f"{nparts}")
    if cal.get("backend") and str(cal["backend"]) != device.type:
        mismatches.append(f"backend {cal['backend']} vs this run's "
                          f"{device.type}")
    name = device_name(device)
    if cal.get("device") and str(cal["device"]) != name:
        mismatches.append(f"device {cal['device']} vs this run's {name}")
    event = None
    if mismatches:
        detail = (f"calibration {cal.get('calibration_id')}: "
                  + "; ".join(mismatches)
                  + " -- fitted latencies may not transfer")
        err.write(f"  WARNING: {detail}\n")
        event = {"t": time.time(), "kind": "calibration-mismatch",
                 "detail": detail}
        from acg_tpu_torch import metrics, observatory
        metrics.record_event_kind("calibration-mismatch")
        observatory.note_event("calibration-mismatch", detail)
    err.write("\n")
    return event


def run_explain(args, dtype, vec_dtype, device) -> int:
    """``--explain``: build the system once, then for the
    classic, pipelined and stacked multi-part tiers count an iteration's
    dispatches, build the comm ledger, time a short solve and print the
    roofline verdict.  Exits 0 when a tier reported."""
    import torch

    from acg_tpu_torch import tracing
    from acg_tpu_torch.commbench import UNCALIBRATED, visible_parts
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers.cg import TorchCGSolver

    err = sys.stderr
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    csr = explain_matrix(args)
    n = csr.shape[0]
    b = np.ones(n)
    K = max(8, min(args.max_iterations, 60))
    nparts = args.nparts or visible_parts(device, 4)
    cal = getattr(args, "_calibration", None)
    cal_event = (_calibration_header(args, cal, nparts, device, err)
                 if cal is not None else None)
    bw = None
    use_cache = not getattr(args, "no_probe_cache", False)
    try:
        # the full-size probe on the card, a 16 MiB one on the CPU
        bw = (cached_triad_probe_gbs(use_cache=use_cache, device=device)
              if on_cuda else
              cached_triad_probe_gbs(1 << 22, use_cache=use_cache,
                                     lo=0.5, device=device))
    except Exception as e:  # noqa: BLE001
        err.write(f"acg-tpu-torch: bandwidth probe failed ({e}); roofline "
                  f"fractions unavailable\n")
    launch_s = launch_latency_seconds(device)
    flag_s = flag_read_seconds(device)

    op = None
    if getattr(args, "_operator_spec", None) is not None:
        from acg_tpu_torch.cli import _build_cli_operator
        op = _build_cli_operator(args, n, dtype, device)
    op_id = op.identity() if op is not None else None
    op_tag = f", operator {op_id}" if op_id else ""
    pc = getattr(args, "_precond", None)
    pc_tag = f", precond {pc}" if pc is not None else ""

    rows = []
    with tracing.profiler_trace(args.trace):
        A = op if op is not None else device_matrix_from_csr(
            csr, dtype=dtype, format=args.spmv_format, device=device)
        def tier(name, build, label):
            # the tier's refusal to build (a ValueError) skips it; on the
            # card any error of its run raises (a kernel wrapper's
            # ValueError among them), on the CPU it is reported
            try:
                solver = build()
            except ValueError as e:
                err.write(f"acg-tpu-torch: explain tier {name} refused: "
                          f"{e}\n")
                return
            try:
                row = _explain_tier(label(solver), solver, b, csr, K, bw,
                                    launch_s, flag_s, err, cal=cal)
            except Exception as e:  # noqa: BLE001 -- one tier must not sink the rest
                if on_cuda:
                    raise
                err.write(f"acg-tpu-torch: explain tier {name} failed: "
                          f"{type(e).__name__}: {e}\n")
                return
            if row:
                rows.append((row, solver))

        for name, pipelined in (("cg", False), ("cg-pipelined", True)):
            tier(name, lambda: TorchCGSolver(
                A, pipelined=pipelined, precise_dots=args.precise_dots,
                kernels=args.kernels, vector_dtype=vec_dtype,
                device=device, host_matrix=csr, precond=pc),
                lambda s: f"{name} ({s.kernels} kernels, {args.dtype}"
                + pc_tag + op_tag + ")")
        tier("dist-cg", lambda: build_explain_dist_solver(
            args, csr, nparts, dtype, vec_dtype, device, operator=op,
            precond=pc),
            lambda s: f"dist-cg (nparts={nparts}, {s.kernels} kernels, "
            f"{args.dtype}" + pc_tag + op_tag + ")")

    if cal_event is not None:
        for _row, solver in rows:
            solver.stats.events.append(dict(cal_event))
    if args.trace:
        _explain_measured(args, rows, K, err)
    _explain_convergence(args, csr, rows, err)

    if args.stats_json:
        from acg_tpu_torch import telemetry
        try:
            for row, solver in rows:
                man = telemetry.run_manifest(
                    metric=f"explain:{row['tier']}", matrix=str(args.A),
                    dtype=args.dtype, explain=row, operator=op_id,
                    calibration=(cal.get("calibration_id")
                                 if cal is not None else UNCALIBRATED))
                telemetry.write_stats_json(args.stats_json, solver.stats,
                                           manifest=man, append=True)
        except OSError as e:
            err.write(f"acg-tpu-torch: {args.stats_json}: {e}\n")
    return 0 if rows else 1


def _explain_measured(args, rows, K: int, err) -> dict | None:
    """The measured section under ``--trace``: the capture's device
    seconds by op class, confronted with each tier's comm component over
    its K timed iterations (and with the calibrated kinds apart)."""
    from acg_tpu_torch import tracing

    analysis = tracing.analyze_trace(args.trace)
    err.write("== explain: measured (profiler trace) ==\n")
    for line in tracing.format_analysis(analysis):
        err.write(line + "\n")
    if analysis.get("available"):
        predicted = sum(row["components_s"].get("comm-bound", 0.0) * K
                        for row, _ in rows)
        err.write(tracing.measured_comm_line(
            analysis, predicted,
            label=f"comm ledger x {K} iters/tier") + "\n")
        kinds = (analysis.get("collective_kind_seconds_in_solve")
                 or analysis.get("collective_kind_seconds") or {})
        cal_rows = [row for row, _ in rows
                    if row.get("calibrated_comm_s")]
        if kinds and cal_rows:
            pred_ar = sum(r["calibrated_comm_s"]["allreduce_s"] * K
                          for r in cal_rows)
            pred_halo = sum(r["calibrated_comm_s"]["halo_s"] * K
                            for r in cal_rows)
            meas_ar = kinds.get("all_reduce", 0.0)
            meas_halo = sum(v for k, v in kinds.items()
                            if k != "all_reduce")
            err.write(f"  per-kind (commbench fit x {K} iters/"
                      f"calibrated tier): allreduce predicted "
                      f"{pred_ar:.3e} s vs measured {meas_ar:.3e} s; "
                      f"halo predicted {pred_halo:.3e} s vs measured "
                      f"{meas_halo:.3e} s\n")
        eff = analysis.get("overlap_efficiency")
        for row, _ in rows:
            ov = row.get("overlap_model")
            if ov is None or ov.get("hidden_frac") is None:
                continue
            err.write(f"  overlap verdict [{row['tier']}]: ledger "
                      f"predicts {ov['hidden_frac']:.0%} of halo "
                      f"latency hidden"
                      + (f"; measured solve-windowed "
                         f"overlap-efficiency {eff:.2%}"
                         if eff is not None else
                         "; no measured overlap in this capture")
                      + "\n")
        compact = {k: analysis[k] for k in
                   ("available", "nfiles", "op_seconds",
                    "collective_seconds", "collective_kind_seconds",
                    "exposed_collective_seconds",
                    "overlap_efficiency", "straggler")
                   if analysis.get(k) is not None}
        for _, solver in rows:
            solver.stats.tracing.update(compact)
    err.write("\n")
    return analysis


def _explain_convergence(args, csr, rows, err) -> dict | None:
    """The ``convergence`` section: kappa from the Lanczos tridiagonal
    of a traced host-oracle solve and the CG bound's iterations against
    the measured ones (``acg_tpu/perfmodel.py:1062``)."""
    from acg_tpu_torch import health as health_mod
    from acg_tpu_torch.solvers.host_cg import HostCGSolver
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    if csr.shape[0] > 200_000 or csr.nnz > 2_000_000:
        err.write("== explain: convergence ==\n  (skipped: matrix too "
                  "large for the host-oracle Lanczos estimate; run a "
                  "normal solve with --audit-every + --convergence-log "
                  "for the device-side spectrum report)\n\n")
        return None
    rtol = (args.residual_rtol
            if 0 < args.residual_rtol < 1 else 1e-9)
    crit = StoppingCriteria(maxits=min(max(args.max_iterations, 200),
                                       2000),
                            residual_rtol=rtol)
    b = np.ones(csr.shape[0])
    pc = getattr(args, "_precond", None)
    try:
        kappa_ref = None
        if pc is not None:
            plain = HostCGSolver(csr, trace=4096)
            plain.solve(b, criteria=crit, raise_on_divergence=False)
            ref = health_mod.spectrum_estimate(plain.last_trace)
            kappa_ref = (ref or {}).get("kappa")
        hs = HostCGSolver(csr, trace=4096, precond=pc)
        hs.solve(b, criteria=crit, raise_on_divergence=False)
        rep = health_mod.convergence_report(
            hs.last_trace, hs.stats.niterations, rtol,
            precond=str(pc) if pc is not None else None,
            kappa_ref=kappa_ref)
    except Exception as e:  # noqa: BLE001 -- the verdict must not sink
        err.write(f"acg-tpu-torch: explain convergence verdict failed: "
                  f"{type(e).__name__}: {e}\n")
        return None
    if rep is None:
        err.write("== explain: convergence ==\n  (window too short for a "
                  "Lanczos estimate)\n\n")
        return None
    err.write("== explain: convergence (host-oracle Lanczos "
              "estimate) ==\n")
    err.write(f"  operator {rep['operator']}: lambda "
              f"{rep['lambda_min']:.4g} .. {rep['lambda_max']:.4g}"
              + (f", kappa {rep['kappa']:.4g}" if rep.get("kappa")
                 else ", kappa unavailable (non-positive Ritz value)")
              + f" (m={rep['m']})\n")
    if rep.get("precond_effectiveness") is not None:
        err.write(f"  preconditioner effectiveness: kappa(A) "
                  f"{rep['kappa_unpreconditioned']:.4g} / "
                  f"kappa(M^-1 A) {rep['kappa']:.4g} = "
                  f"{rep['precond_effectiveness']:.2f}x spectrum "
                  f"compression\n")
    pred = rep.get("predicted_iterations")
    if pred is not None:
        meas = rep["measured_iterations"]
        verdict = ("within-bound" if meas <= pred
                   else "OVER-bound (measured exceeds the worst-case "
                        "CG bound: suspect the estimate window or "
                        "numerical trouble)")
        err.write(f"  CG bound at rtol {rep['rtol']:g}: predicted "
                  f"<= {pred} iterations; measured {meas} "
                  f"({meas / pred:.2f}x); verdict: {verdict}\n")
    err.write("\n")
    for _row, solver in rows:
        solver.stats.health.setdefault("spectrum", rep)
    return rep


# -- bench regression gate ------------------------------------------------

# the sentinel row of a bench run whose backend probe failed: never a
# performance case (acg_tpu/perfmodel.py:1150)
UNAVAILABLE_METRIC = "bench_backend_unavailable"


def split_unavailable(cases: dict) -> tuple[dict, bool]:
    """Drop the backend-unavailable sentinel: ``(real_cases,
    sentinel_was_present)``."""
    had = any(k == UNAVAILABLE_METRIC or
              k.startswith(UNAVAILABLE_METRIC + "|") for k in cases)
    return {k: v for k, v in cases.items()
            if not (k == UNAVAILABLE_METRIC
                    or k.startswith(UNAVAILABLE_METRIC + "|"))}, had


def refuse_unavailable(old: dict, new: dict, old_name: str,
                       new_name: str) -> tuple[dict, dict, bool]:
    """Strip the sentinel from both captures; when a side carried only
    the sentinel print the re-baseline refusal and flag exit 2."""
    old, old_unavail = split_unavailable(old)
    new, new_unavail = split_unavailable(new)
    refused = (old_unavail and not old) or (new_unavail and not new)
    if refused:
        which = old_name if old_unavail and not old else new_name
        print(f"bench-diff: {which} records {UNAVAILABLE_METRIC} (the "
              f"backend was down): no comparable cases -- re-baseline "
              f"before trusting --fail-on-regress", file=sys.stderr)
    return old, new, refused


def _doc_case(doc: dict):
    """``(key, value)`` for one ``--stats-json`` document
    (``acg_tpu/perfmodel.py:1184``): the key is the manifest metric or
    ``solver:matrix`` with the precond, batch, operator and calibration
    selections folded in, the value iterations/second (a soak capture at
    its p50s)."""
    man = doc.get("manifest") or {}
    st = doc.get("stats") or {}
    metric = man.get("metric")
    if metric is None:
        metric = f"{man.get('solver', 'solve')}:{man.get('matrix', '?')}"
    metric = _precond_keyed(metric, man.get("precond"))
    metric = _batch_keyed(metric, man.get("nrhs"), man.get("block_cg"))
    metric = _operator_keyed(metric, man.get("operator"))
    metric = _calibration_keyed(metric, man.get("calibration"))
    soak = st.get("soak") or {}
    if soak:
        try:
            lat = float((soak.get("latency") or {}).get("p50") or 0.0)
            its = float((soak.get("iterations") or {}).get("p50") or 0.0)
        except (TypeError, ValueError):
            return None
        if lat <= 0 or its <= 0:
            return None
        return str(metric), its / lat
    try:
        tsolve = float(st.get("tsolve", 0.0))
        niter = float(st.get("niterations", 0))
    except (TypeError, ValueError):
        return None
    if tsolve <= 0 or niter <= 0:
        return None
    return str(metric), niter / tsolve


def _precond_keyed(metric, precond) -> str:
    """A preconditioned capture never diffs against a plain one."""
    metric = str(metric)
    if precond and str(precond) != "none":
        return f"{metric}|precond={precond}"
    return metric


def _batch_keyed(metric, nrhs, block=None) -> str:
    """A B-wide batched (or block-CG) capture never diffs against a
    single-RHS one."""
    metric = str(metric)
    try:
        b = int(nrhs or 0)
    except (TypeError, ValueError):
        b = 0
    if b > 1:
        metric = f"{metric}|nrhs={b}"
        if block:
            metric = f"{metric}|block"
    return metric


def _operator_keyed(metric, operator) -> str:
    """A matrix-free capture never diffs against an assembled one."""
    metric = str(metric)
    op = str(operator or "")
    if op and op != "none":
        return f"{metric}|operator={op}"
    return metric


def _calibration_keyed(metric, calibration) -> str:
    """Captures priced under different calibrations are distinct cases;
    ``uncalibrated`` adds nothing."""
    metric = str(metric)
    cal = str(calibration or "")
    if cal and cal != "uncalibrated":
        return f"{metric}|cal={cal}"
    return metric


def _row_case(row: dict):
    """``(key, value)`` of one bench summary row."""
    metric, value = row.get("metric"), row.get("value")
    if metric is None or not isinstance(value, (int, float)):
        return None
    key = _precond_keyed(metric, row.get("precond"))
    key = _batch_keyed(key, row.get("nrhs"), row.get("block"))
    key = _operator_keyed(key, row.get("operator"))
    key = _calibration_keyed(key, row.get("calibration"))
    return key, float(value)


def rows_to_cases(rows) -> dict:
    """Best value per metric over a list of bench row dicts."""
    cases: dict = {}
    for row in rows:
        c = _row_case(row)
        if c is not None:
            cases[c[0]] = max(cases.get(c[0], float("-inf")), c[1])
    return cases


def load_cases(path) -> dict:
    """``{metric: best_value}`` of a capture file: ``--stats-json``
    documents (one indented, or JSONL), bench row JSONL, ledger lines;
    non-JSON lines are skipped."""
    with open(path) as f:
        text = f.read()
    objs = []
    try:
        whole = json.loads(text)
        objs = whole if isinstance(whole, list) else [whole]
    except ValueError:
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                objs.append(json.loads(line))
            except ValueError:
                continue
    cases: dict = {}
    for obj in objs:
        if not isinstance(obj, dict):
            continue
        if isinstance(obj.get("parsed"), dict):
            obj = obj["parsed"]
        if isinstance(obj.get("doc"), dict) and "ledger" in obj:
            obj = obj["doc"]
        c = _doc_case(obj) if "stats" in obj else _row_case(obj)
        if c is not None:
            cases[c[0]] = max(cases.get(c[0], float("-inf")), c[1])
    return cases


def compare_cases(old: dict, new: dict, pct: float
                  ) -> tuple[list[str], int, int]:
    """``(report_lines, nregressed, ncompared)``: a case regresses when
    its new value falls more than ``pct`` percent below the baseline;
    one-sided cases are reported and never gate."""
    lines: list[str] = []
    nreg = ncmp = 0
    for key in sorted(set(old) | set(new)):
        if key not in old:
            lines.append(f"bench-diff: {key}: (new case) {new[key]:,.2f}")
            continue
        if key not in new:
            lines.append(f"bench-diff: {key}: baseline-only "
                         f"({old[key]:,.2f}); not gated")
            continue
        ncmp += 1
        o, v = old[key], new[key]
        delta = (v - o) / o * 100.0 if o else 0.0
        if o > 0 and v < o * (1.0 - pct / 100.0):
            nreg += 1
            lines.append(f"bench-diff: {key}: {o:,.2f} -> {v:,.2f} "
                         f"({delta:+.1f}% REGRESSION, threshold "
                         f"-{pct:g}%)")
        else:
            lines.append(f"bench-diff: {key}: {o:,.2f} -> {v:,.2f} "
                         f"({delta:+.1f}%)")
    return lines, nreg, ncmp


def load_baseline_cases(baseline_path) -> dict | None:
    """The gate's baseline cases: a file, or a ``--history`` ledger
    directory (the best usable value per case).  Prints the refusal and
    returns None (exit 2) for an empty or all-unavailable ledger."""
    if not os.path.isdir(baseline_path):
        return load_cases(baseline_path)
    from acg_tpu_torch.observatory import load_history_baseline
    cases, all_unavailable, nentries = \
        load_history_baseline(baseline_path)
    if all_unavailable:
        print(f"bench-diff: every capture in {baseline_path} records "
              f"{UNAVAILABLE_METRIC} (the backend was down for all "
              f"{nentries} entr{'y' if nentries == 1 else 'ies'}): no "
              f"usable baseline -- re-baseline before trusting "
              f"--fail-on-regress", file=sys.stderr)
        return None
    if not cases:
        print(f"bench-diff: {baseline_path}: no usable ledger entries "
              f"(empty history directory?)", file=sys.stderr)
        return None
    return cases


def check_regression(rows, baseline_path, pct: float) -> int:
    """Compare rows against a baseline capture (a file or a ledger
    directory).  0 = no regression, 1 = regression past ``pct``, 2 =
    nothing comparable."""
    try:
        old = load_baseline_cases(baseline_path)
    except OSError as e:
        print(f"bench-diff: {baseline_path}: {e}", file=sys.stderr)
        return 2
    if old is None:
        return 2
    old, new, refused = refuse_unavailable(old, rows_to_cases(rows),
                                           str(baseline_path), "this run")
    if refused:
        return 2
    lines, nreg, ncmp = compare_cases(old, new, pct)
    for ln in lines:
        print(ln, file=sys.stderr)
    if ncmp == 0:
        print("bench-diff: no comparable cases between this run and "
              f"{baseline_path}", file=sys.stderr)
        return 2
    return 1 if nreg else 0
