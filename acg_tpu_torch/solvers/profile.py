"""Per-op device timing: the reference's ``ACG_ENABLE_PROFILING`` tier.

The counterpart of ``acg_tpu/solvers/profile.py`` (``--profile-ops``).
The reference brackets every GPU op with CUDA event pairs
(``cgcuda.c:73-76``, summed post-solve ``:1057-1095``); this tier
*replays* each op class standalone on the solver's own device tensors
and kernels -- ``gemv`` (K1/K7 or the stacked, halo'd SpMV), ``dot``,
``nrm2``, ``axpy``, ``copy``, ``precond`` and, on stacked parts,
``halo`` (K6 under ``--comm dma``) and ``allreduce`` -- and scales by
the op counts the solve's census already holds.

Each op is measured as the DIFFERENCE between two chains of launches,
``4 * INNER`` against ``INNER`` applications, each op feeding the next
(the reference's two-point estimate), so per-chain costs cancel.  On the
card the chains are timed by CUDA events on the current stream; on the
CPU by the host clock.  The JAX package's chains run inside one compiled
program, where dispatch cancels; the port's are eager launches, so an op
shorter than the host's per-launch cost measures that cost, not the
op.  ``dispatch`` (the seconds the host takes to issue one launch) is
reported beside the ops for that reason: an op whose per-call time sits
near it is launch-bound in the replay.  Chaining a scalar-result op
(dot, nrm2, allreduce, halo) folds its scalar back into the carried
vector, about one axpy more per call: ``chain_overhead`` (= the axpy
time) says by how much those entries are upper bounds.  A ``--trace``
capture supersedes the replay where it resolved an op class
(:func:`acg_tpu_torch.tracing.apply_measured_ops`).
"""

from __future__ import annotations

import math
import time

import torch

# applications of an op in the short chain; the long chain runs 4x
INNER = 64


def _chain_seconds(op, x, extra, n: int, reps: int) -> float:
    """The best of ``reps`` timings of ``n`` chained applications of
    ``op`` (after one untimed chain): CUDA events on the card, the host
    clock on the CPU."""
    def run():
        y = x
        for _ in range(n):
            y = op(y, *extra)
        return y

    cuda = x.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(x.device)

    run()
    sync()
    best = math.inf
    for _ in range(max(int(reps), 1)):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            t = e0.elapsed_time(e1) * 1e-3
        else:
            t0 = time.perf_counter()
            run()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def _time_op(op, x, *extra, reps: int = 10) -> float:
    """Two-point estimate of one application's seconds.  Where host
    noise hides the difference (the long chain's best not above the
    short one's: a loaded host's CPU timings), both chains take more
    samples, up to three more rounds, since no op takes zero seconds;
    on the card the first round's events settle it."""
    lo = hi = math.inf
    for _ in range(4):
        lo = min(lo, _chain_seconds(op, x, extra, INNER, reps))
        hi = min(hi, _chain_seconds(op, x, extra, 4 * INNER, reps))
        if hi > lo:
            break
    return max(hi - lo, 0.0) / (3 * INNER)


def _dispatch_seconds(device, dtype, reps: int) -> float:
    """The host's seconds to issue one launch: ``INNER`` launches of a
    one-element add, timed on the host clock up to the last launch
    (before any synchronisation)."""
    v = torch.zeros(1, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    best = math.inf
    for _ in range(max(int(reps), 1) + 1):
        t0 = time.perf_counter()
        for _ in range(INNER):
            v = v + one
        best = min(best, (time.perf_counter() - t0) / INNER)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return best


def profile_ops(solver, b, reps: int = 10) -> dict[str, float]:
    """Fill ``solver.stats.ops[*].t`` with replayed per-op seconds.

    Returns ``{op: seconds_per_call}`` for the replayed op classes plus
    ``chain_overhead`` and ``dispatch``.  The refinement driver is
    unwrapped down to the device solver; host solvers time their ops
    for real and are returned unchanged (``{}``)."""
    while hasattr(solver, "inner"):
        solver = solver.inner

    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers.cg import TorchCGSolver

    if isinstance(solver, TorchCGSolver):
        per_call = _profile_single(solver, b, reps)
    elif isinstance(solver, DistCGSolver):
        per_call = _profile_dist(solver, b, reps)
    else:
        return {}
    for op, t in per_call.items():
        s = solver.stats.ops[op]
        s.t = t * s.n
    per_call["chain_overhead"] = per_call.get("axpy", 0.0)
    dtype = solver._solve_dtype()
    per_call["dispatch"] = _dispatch_seconds(solver.device, dtype, reps)
    return per_call


def _vector_ops(x, dot, dtype, reps: int) -> dict[str, float]:
    """dot, nrm2, axpy and copy on vector ``x`` (any shape): ``dot``
    carries a fixed second operand, ``nrm2`` reads one vector, the
    scalar folds back through ``tiny``; copy is a scale by ~1 (a plain
    copy would carry no data dependence)."""
    tiny = torch.tensor(1e-30, dtype=dtype, device=x.device)
    alpha = torch.tensor(0.5, dtype=dtype, device=x.device)
    c = x + 1
    return {
        "dot": _time_op(lambda v, c: v + tiny * dot(v, c), x, c,
                        reps=reps),
        "nrm2": _time_op(lambda v: v + tiny * dot(v, v), x, reps=reps),
        "axpy": _time_op(lambda y, a, p: y + a * p, x, alpha, x,
                         reps=reps),
        "copy": _time_op(lambda y, a: y * a, x,
                         torch.tensor(1.0000001, dtype=dtype,
                                      device=x.device), reps=reps),
    }


def _profile_single(solver, b, reps: int) -> dict[str, float]:
    """The single-device replay on the solver's own SpMV: K1 on square
    DIA (the fused tier's closest standalone kernel), K7 on the Poisson
    operator, the plain formulation otherwise."""
    from acg_tpu_torch.solvers.cg import _spmv_fn

    A = solver.A
    dtype = solver._solve_dtype()
    x = solver._to_device(b, dtype)
    kernels = solver.kernels
    spmv_f = (_spmv_fn("pallas") if str(kernels).startswith("fused")
              else solver._spmv_of())
    dot, _ = solver._dot_setup(dtype, solver.precise_dots)
    out = {"gemv": _time_op(lambda v: spmv_f(A, v), x, reps=reps)}
    out.update(_vector_ops(x, dot, dtype, reps))
    spec = getattr(solver, "precond_spec", None)
    if spec is not None:
        from acg_tpu_torch.precond import make_apply

        mstate = solver._ensure_precond_state()
        papply = make_apply(spec, solver._spmv_of())
        per = spec.degree if spec.kind == "cheby" else 1
        out["precond"] = _time_op(
            lambda v: papply(mstate, A, v).to(dtype), x, reps=reps) / per
    return out


def _profile_dist(solver, b, reps: int) -> dict[str, float]:
    """The stacked replay: the solve's halo'd SpMV, the halo exchange
    alone (K6 under dma), the per-part dot without its reduction, the
    reduction alone on a (parts, 2) pair, and the vector ops."""
    from acg_tpu_torch.ops.spmv import acc_dtype
    from acg_tpu_torch.parallel.halo import halo_exchange
    from acg_tpu_torch.parallel.halo_dma import halo_exchange_dma
    from acg_tpu_torch.parallel.reductions import make_ldot

    prob = solver.problem
    dtype = solver._solve_dtype()
    sdt = acc_dtype(dtype)
    x, _ = solver.device_args(b)
    spmv = solver._spmv()
    out = {"gemv": _time_op(lambda v: spmv(v), x, reps=reps)}
    tiny = torch.tensor(1e-30, dtype=dtype, device=x.device)
    if prob.halo.has_ghosts:
        if solver._ranks is not None:
            exchange = solver._rank_exchange()
        elif solver.comm == "dma":
            h = solver._halo
            recv = torch.zeros((prob.nparts, prob.nparts,
                                max(prob.halo.maxcnt, 1)), dtype=dtype,
                               device=x.device)

            def exchange(v):
                return halo_exchange_dma(v, h.send_idx, h.ghost_src,
                                         h.ghost_valid, solver._scnt, recv)
        else:
            h = solver._halo

            def exchange(v):
                return halo_exchange(v, h.send_idx, h.ghost_src)
        out["halo"] = _time_op(
            lambda v: v + tiny * exchange(v).sum(), x, reps=reps)
    ldot = make_ldot(sdt)
    out.update(_vector_ops(
        x, lambda a, c: ldot(a, c)[:, None].to(dtype), dtype, reps))
    pair = torch.zeros((x.shape[0], 2), dtype=sdt, device=x.device)
    psum = solver._psum
    tiny_s = torch.tensor(1e-30, dtype=sdt, device=x.device)
    out["allreduce"] = _time_op(lambda s: s + tiny_s * psum(s), pair,
                                reps=reps)
    spec = getattr(solver, "precond_spec", None)
    if spec is not None:
        from acg_tpu_torch.precond import make_apply

        mstate = solver._ensure_precond_state()
        apply = make_apply(spec, lambda _A, v: spmv(v))
        per = spec.degree if spec.kind == "cheby" else 1
        out["precond"] = _time_op(
            lambda v: apply(mstate, None, v).to(dtype), x, reps=reps) / per
    return out
