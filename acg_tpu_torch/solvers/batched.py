"""Batched multi-RHS CG and block CG on one device.

The counterpart of ``acg_tpu/solvers/batched.py``: B right-hand sides
against one device matrix, every vector an ``(n, B)`` column block
(row-major, as in the JAX package).  Three modes:

* **batched** -- classic CG with a trailing batch axis: one multi-column
  SpMV an iteration (:func:`spmv_multi`: the matrix is read once for all
  B columns), every per-RHS dot one column reduction, and per-RHS
  convergence masks: a converged column freezes (its x, r, p and
  iteration count never move again) while the loop runs to the slowest
  column.
* **pipelined** -- the Ghysels-Vanroose recurrence with the same masks.
* **block** -- O'Leary's block CG: one shared Krylov block, two B x B
  Gram solves an iteration, rank deflation by a relative Tikhonov jitter
  so the solves stay defined through rank collapse.

Everything is plain PyTorch, as the JAX package leaves this tier to XLA:
its batched solver takes only ``kernels="auto"/"xla"``.  The JAX
``while_loop`` becomes the port's chunked loop (:data:`~acg_tpu_torch.
solvers.cg.CHUNK` iterations between two host reads of the masks); the
masks and every scalar stay on the device, and once every column has
converged the whole state is frozen, so the extra iterations of a chunk
change nothing.  Every row of every SpMV is written once (the padded-row
layout of :mod:`acg_tpu_torch.ops.spmv`), so a run on the card gives the
same bits twice.  Block CG solves its Gram systems with
``torch.linalg.solve_ex`` and reads the factorisation flags once a
chunk.

A batch of one delegates to the single-RHS
:class:`~acg_tpu_torch.solvers.cg.TorchCGSolver` (``kernels="xla"``, as
the JAX package delegates to ``JaxCGSolver``).  ``trace`` arms the
per-RHS residual ring (:class:`~acg_tpu_torch.telemetry.
BatchedLoopTelemetry`, ``acg_tpu/solvers/batched.py:855``) and
``progress`` a worst-column heartbeat.  ``ckpt`` arms the batched
checkpoint chunks (``acg_tpu/solvers/batched.py:894-1070``) of the
batched classic recurrence: the per-RHS carry (:func:`acg_tpu_torch.
checkpoint.batched_carry_names`: the r/p columns and the gamma/done/
iters vectors) threads through chunks of ``ckpt.every`` iterations, so
a whole batch survives preemption with every column's progress and
tolerance intact.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from acg_tpu_torch._device import device_sync, resolve_device
from acg_tpu_torch.errors import (AcgError, BreakdownError, ErrorCode,
                                  NotConvergedError)
from acg_tpu_torch.ops.precision import dot2
from acg_tpu_torch.ops.spmv import (BinnedEllMatrix, CooMatrix, DeviceMatrix,
                                    DiaMatrix, EllMatrix, acc_dtype,
                                    matrix_dtype, matrix_index_bytes, spmv,
                                    spmv_flops)
from acg_tpu_torch.solvers.cg import CHUNK
from acg_tpu_torch import telemetry
from acg_tpu_torch.telemetry import add_timing as _add_timing
from acg_tpu_torch.solvers.stats import (SolverStats, StoppingCriteria,
                                         cg_flops_per_iteration)

__all__ = ["spmv_multi", "BatchedCGResult", "ChunkedBatchedSolver",
           "BatchedCGSolver"]


def _padded_mv_multi(groups, Y, X, adt):
    """``Y[dst] = sum_k data[:, k] * X[cols[:, k]]`` per padded-row group,
    in place: each row written once, no scatter-add."""
    for dst, data, cols in groups:
        Y.index_copy_(0, dst, (data[..., None].to(adt)
                               * X[cols].to(adt)).sum(1))
    return Y


def spmv_multi(A: DeviceMatrix, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for an ``(n, B)`` column block: one pass over the
    matrix for all B columns.  Every device format and the matrix-free
    operators; the DIA path stays gather-free (shifted row slices)."""
    adt = acc_dtype(X.dtype)
    if hasattr(A, "matfree_apply_multi"):
        return A.matfree_apply_multi(X)
    if hasattr(A, "matfree_apply"):
        # user operators without a multi-column form: column by column
        return torch.stack([A.matfree_apply(X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)
    if isinstance(A, DiaMatrix):
        L = max(0, -min(A.offsets))
        R = max(0, max(A.offsets) + A.nrows - X.shape[0])
        Xp = torch.nn.functional.pad(X, (0, 0, L, R))
        Y = torch.zeros((A.nrows, X.shape[1]), dtype=adt, device=X.device)
        for plane, off in zip(A.data, A.offsets):
            sl = Xp[L + off:L + off + A.nrows]
            Y = Y + plane[:, None].to(adt) * sl.to(adt)
        return Y.to(X.dtype)
    if isinstance(A, EllMatrix):
        return (A.data[..., None].to(adt) * X[A.cols].to(adt)
                ).sum(1).to(X.dtype)
    Y = torch.zeros((A.nrows, X.shape[1]), dtype=adt, device=X.device)
    if isinstance(A, CooMatrix):
        return _padded_mv_multi(A.groups, Y, X, adt).to(X.dtype)
    if isinstance(A, BinnedEllMatrix):
        # each row lives in exactly one bin or in the hub tail
        _padded_mv_multi(zip(A.bin_rows, A.bin_data, A.bin_cols), Y, X, adt)
        return _padded_mv_multi(A.tail_groups, Y, X, adt).to(X.dtype)
    raise TypeError(f"unsupported device matrix {type(A)}")


def _coldot_setup(dtype, precise: bool, per_column: bool = False):
    """``(coldot, sdt)``: the per-column dot ``(n, B), (n, B) -> (B,)``
    (every per-RHS dot in one column reduction) and the scalar dtype;
    ``precise`` takes the compensated dot2 of each column.
    ``per_column`` takes instead the single-RHS solver's ``torch.dot``
    of each column, copied contiguous: a column reduction adds in
    another order than ``torch.dot``, and in another again for another
    B, so only this form gives each column its single-RHS solve's bits
    (B dots and 2B copies a call)."""
    sdt = acc_dtype(dtype)
    if per_column:
        def coldot(a, c):
            return torch.stack([torch.dot(a[:, j].to(sdt).contiguous(),
                                          c[:, j].to(sdt).contiguous())
                                for j in range(a.shape[-1])])
        return coldot, sdt
    if precise:
        def coldot(a, c):
            return dot2(a.to(sdt).mT, c.to(sdt).mT)
        return coldot, sdt

    def coldot(a, c):
        return (a.to(sdt) * c.to(sdt)).sum(0)
    return coldot, sdt


@dataclasses.dataclass
class BatchedCGResult:
    """Device-resident batched result: every field but ``k_total`` (the
    loop's trip count, the slowest column's iteration number) has one
    entry per right-hand side."""

    x: torch.Tensor            # (n, B)
    niterations: torch.Tensor  # (B,) int64: per-RHS frozen-at count
    k_total: torch.Tensor      # () int64
    rnrm2: torch.Tensor        # (B,)
    r0nrm2: torch.Tensor       # (B,)
    bnrm2: torch.Tensor        # (B,)
    x0nrm2: torch.Tensor       # (B,)
    converged: torch.Tensor    # (B,) bool
    telem: object = None       # the run's BatchedLoopTelemetry, if armed
    # the final per-RHS carry of a state_io run (batched_carry_names
    # order, without x)
    carry: object = None


class _State:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _res_tols(crit: StoppingCriteria, r0nrm2):
    return torch.clamp(crit.residual_rtol * r0nrm2, min=crit.residual_atol)


def _col_where(mask, new, old):
    """Column-masked select: ``mask`` (B,), arrays ``(n, B)``."""
    return torch.where(mask[None, :], new, old)


def _safe_div(num, den, active):
    """Masked per-column division: inactive columns get exactly 0 (a
    frozen column's update scale), and a 0 denominator on an active
    column -- progress exhausted at the precision floor -- freezes that
    column's step instead of poisoning it with inf."""
    ok = active & (den != 0)
    return torch.where(ok, num / torch.where(den != 0, den, 1.0),
                       torch.zeros_like(num))


def _run(step, maxits: int, unbounded: bool, s, check=None,
         telem=None) -> None:
    """Run ``step()`` until ``maxits`` iterations or every column has
    converged, reading ``s.done`` (B,) on the host once per
    :data:`CHUNK` iterations (and calling ``check()`` there); unbounded
    solves run exactly ``maxits`` steps with no reads.  ``step`` freezes
    what has converged, so the chunk's extra iterations change
    nothing.  An armed heartbeat (``telem.progress``) prints where the
    flag is read (once a chunk on unbounded solves)."""
    beats = telem is not None and telem.progress > 0
    if unbounded:
        for ran in range(0, maxits, CHUNK):
            for _ in range(min(CHUNK, maxits - ran)):
                step()
            if beats:
                telem.flush()
        return
    ran = 0
    while ran < maxits:
        done = bool(s.done.all())
        if beats:
            telem.flush()
        if done:
            break
        for _ in range(min(CHUNK, maxits - ran)):
            step()
        ran += CHUNK
        if check is not None:
            check()
    if beats:
        telem.flush()


def _finish(s, crit: StoppingCriteria, nrhs: int, dev, rnrm2, r0nrm2,
            bnrm2, x0nrm2, done, telem=None) -> BatchedCGResult:
    if crit.unbounded:
        k = torch.tensor(crit.maxits, device=dev)
        done = torch.ones((nrhs,), dtype=torch.bool, device=dev)
    else:
        k = s.k
    return BatchedCGResult(x=s.x, niterations=s.iters, k_total=k,
                           rnrm2=rnrm2, r0nrm2=r0nrm2, bnrm2=bnrm2,
                           x0nrm2=x0nrm2, converged=done, telem=telem)


def _ring_step(telem, s, active, unbounded: bool, cols) -> None:
    """One batched step's ring row and heartbeat (``telem`` armed): the
    slot of the loop's device count, masked by its any-column-live
    flag (the host step count on unbounded loops)."""
    if telem is not None:
        telem.step(s.k, None if unbounded else active.any(), cols)


def _batched_cg_program(spmv, coldot, Bm, X0, crit: StoppingCriteria,
                        papply=None, telem=None, carry=None,
                        state_io: bool = False,
                        atol_cols=None) -> BatchedCGResult:
    """Batched classic CG (``acg_tpu.solvers.batched._batched_cg_program``):
    the single-RHS classic recurrence per column, its dots one column
    reduction, converged columns frozen by the masks.  ``spmv(X)`` and
    ``coldot(A, C) -> (B,)`` are the tier's: :func:`spmv_multi` and one
    column reduction on one device, or the stacked multi-part tier's
    halo'd SpMV and psum'd column dots (:mod:`acg_tpu_torch.parallel.
    dist_batched`).  ``papply(R)`` makes it preconditioned (gamma =
    (r, z); the carried rr = (r, r) keeps the convergence test
    unpreconditioned).  ``telem`` (a :class:`~acg_tpu_torch.telemetry.
    BatchedLoopTelemetry`) records each iteration's per-RHS (r, r).

    The checkpoint hooks (``acg_tpu/solvers/batched.py:177-262``):
    ``carry`` (:func:`acg_tpu_torch.checkpoint.batched_carry_names`
    order, without x) re-enters a batch mid-solve with no setup SpMV,
    ``state_io`` returns the final carry in ``res.carry``, and
    ``atol_cols`` (B,) replaces the criteria's tolerances by per-RHS
    absolute targets (a later chunk keeps every column's first ones)."""
    dtype = Bm.dtype
    dev = Bm.device
    sdt = acc_dtype(dtype)

    def store(v):
        return v.to(dtype)

    nrhs = Bm.shape[-1]
    unbounded = crit.unbounded
    bnrm2 = torch.sqrt(coldot(Bm, Bm))
    x0nrm2 = torch.sqrt(coldot(X0, X0))
    if carry is not None:
        if papply is not None:
            R, P, gamma, rr, done0, iters0 = carry
        else:
            R, P, gamma, done0, iters0 = carry
            rr = gamma
    else:
        R = Bm - spmv(X0)
        if papply is not None:
            Z0 = papply(R)
            P = store(Z0)
            gamma = coldot(R, Z0)
            rr = coldot(R, R)
        else:
            P = R
            gamma = rr = coldot(R, R)
    r0nrm2 = torch.sqrt(rr)
    res_tol = _res_tols(crit, r0nrm2) if atol_cols is None else atol_cols
    tol2 = res_tol * res_tol
    s = _State(x=X0, r=R, p=P, gamma=gamma, rr=rr,
               iters=torch.zeros((nrhs,), dtype=torch.int64, device=dev),
               k=torch.zeros((), dtype=torch.int64, device=dev))
    s.done = (torch.zeros((nrhs,), dtype=torch.bool, device=dev)
              if unbounded else rr < tol2)
    if carry is not None:
        s.done = done0.to(torch.bool)
        s.iters = iters0.to(torch.int64)

    def step():
        active = ~s.done
        T = spmv(s.p)
        pdott = coldot(s.p, T)
        alpha = _safe_div(s.gamma, pdott, active)
        s.x = _col_where(active, store(s.x.to(sdt) + alpha * s.p.to(sdt)),
                         s.x)
        s.r = _col_where(active, store(s.r.to(sdt) - alpha * T.to(sdt)),
                         s.r)
        if papply is not None:
            Z = papply(s.r)
            gamma_next = coldot(s.r, Z)
            rr_next = coldot(s.r, s.r)
        else:
            Z = s.r
            gamma_next = rr_next = coldot(s.r, s.r)
        beta = _safe_div(gamma_next, s.gamma, active)
        s.p = _col_where(active, store(Z.to(sdt) + beta * s.p.to(sdt)), s.p)
        _ring_step(telem, s, active, unbounded, rr_next)
        s.iters = s.iters + active.to(torch.int64)
        s.k = s.k + active.any().to(torch.int64)
        s.gamma = torch.where(active, gamma_next, s.gamma)
        s.rr = torch.where(active, rr_next, s.rr)
        if not unbounded:
            s.done = s.done | (active & (rr_next < tol2))

    _run(step, crit.maxits, unbounded, s, telem=telem)
    res = _finish(s, crit, nrhs, dev, torch.sqrt(s.rr), r0nrm2, bnrm2,
                  x0nrm2, s.done, telem)
    if state_io:
        res.carry = ((s.r, s.p, s.gamma)
                     + ((s.rr,) if papply is not None else ())
                     + (s.done, s.iters))
    return res


def _batched_cg_pipelined_program(spmv, coldot, coldotk, Bm, X0,
                                  crit: StoppingCriteria, papply=None,
                                  telem=None) -> BatchedCGResult:
    """Batched Ghysels-Vanroose CG (``acg_tpu.solvers.batched.
    _batched_cg_pipelined_program``): the pipelined recurrences with a
    trailing batch axis, both reduction families of an iteration taken
    at one point, ``coldotk`` (one fused psum on stacked parts); the
    convergence test is one iteration stale, and a fresh final residual
    at tolerance counts as converged.  ``spmv``/``coldot`` as for
    :func:`_batched_cg_program`; ``telem`` records each iteration's
    fused per-RHS (r, r), stale by one like the test."""
    dtype = Bm.dtype
    dev = Bm.device
    sdt = acc_dtype(dtype)

    def store(v):
        return v.to(dtype)

    nrhs = Bm.shape[-1]
    unbounded = crit.unbounded
    bnrm2 = torch.sqrt(coldot(Bm, Bm))
    x0nrm2 = torch.sqrt(coldot(X0, X0))
    R = Bm - spmv(X0)
    if papply is not None:
        U0 = store(papply(R))
        W = spmv(U0)
    else:
        W = spmv(R)
    rr0 = coldot(R, R)
    r0nrm2 = torch.sqrt(rr0)
    res_tol = _res_tols(crit, r0nrm2)
    tol2 = res_tol * res_tol
    inf = torch.full((nrhs,), math.inf, dtype=sdt, device=dev)
    zeros = torch.zeros_like(Bm)
    s = _State(x=X0, r=R, w=W, p=zeros, t=zeros, z=zeros,
               gamma_prev=inf, alpha_prev=inf, rr=rr0,
               iters=torch.zeros((nrhs,), dtype=torch.int64, device=dev),
               k=torch.zeros((), dtype=torch.int64, device=dev))
    if papply is not None:
        s.u, s.s, s.q = U0, zeros, zeros
    s.done = (torch.zeros((nrhs,), dtype=torch.bool, device=dev)
              if unbounded else rr0 < tol2)

    def upd(active, a, scale, b, old):
        """``store(a + scale * b)`` on the active columns."""
        return _col_where(active, store(a.to(sdt) + scale * b.to(sdt)), old)

    def pstep():
        active = ~s.done
        gamma, delta, rr_new = coldotk((s.r, s.u), (s.w, s.u), (s.r, s.r))
        M_ = papply(s.w)
        Nv = spmv(M_)
        beta = _safe_div(gamma, s.gamma_prev, active)
        denom = delta - beta * _safe_div(gamma, s.alpha_prev, active)
        alpha = _safe_div(gamma, denom, active)
        s.z = upd(active, Nv, beta, s.z, s.z)
        s.q = upd(active, M_, beta, s.q, s.q)
        s.s = upd(active, s.w, beta, s.s, s.s)
        s.p = upd(active, s.u, beta, s.p, s.p)
        s.x = upd(active, s.x, alpha, s.p, s.x)
        s.r = upd(active, s.r, -alpha, s.s, s.r)
        s.u = upd(active, s.u, -alpha, s.q, s.u)
        s.w = upd(active, s.w, -alpha, s.z, s.w)
        finish_step(active, gamma, alpha, rr_new)

    def step():
        active = ~s.done
        # both reduction families at one point
        gamma, delta = coldotk((s.r, s.r), (s.w, s.r))
        Q = spmv(s.w)
        beta = _safe_div(gamma, s.gamma_prev, active)
        denom = delta - beta * _safe_div(gamma, s.alpha_prev, active)
        alpha = _safe_div(gamma, denom, active)
        s.z = upd(active, Q, beta, s.z, s.z)
        s.t = upd(active, s.w, beta, s.t, s.t)
        s.p = upd(active, s.r, beta, s.p, s.p)
        s.x = upd(active, s.x, alpha, s.p, s.x)
        s.r = upd(active, s.r, -alpha, s.t, s.r)
        s.w = upd(active, s.w, -alpha, s.z, s.w)
        finish_step(active, gamma, alpha, gamma)

    def finish_step(active, gamma, alpha, rr_new):
        _ring_step(telem, s, active, unbounded, rr_new)
        s.iters = s.iters + active.to(torch.int64)
        s.k = s.k + active.any().to(torch.int64)
        if not unbounded:
            # the stale test: rr_new is this step's pre-update ||r||^2
            s.done = s.done | (active & (rr_new < tol2))
        s.gamma_prev = torch.where(active, gamma, s.gamma_prev)
        s.alpha_prev = torch.where(active, alpha, s.alpha_prev)

    _run(pstep if papply is not None else step, crit.maxits, unbounded, s,
         telem=telem)
    rnrm2 = torch.sqrt(coldot(s.r, s.r))
    done = s.done if unbounded else s.done | (rnrm2 <= res_tol)
    return _finish(s, crit, nrhs, dev, rnrm2, r0nrm2, bnrm2, x0nrm2, done,
                   telem)


def _block_cg_program(A, Bm, X0, crit: StoppingCriteria, papply=None,
                      telem=None) -> BatchedCGResult:
    """Block CG (O'Leary 1980; ``acg_tpu.solvers.batched.
    _block_cg_program``): one shared Krylov block, an iteration is one
    multi-column SpMV and two B x B Gram solves (``W alpha = G``, ``G
    beta = G_new``).  A converged column keeps riding the block (the
    coupling buys the iteration win); its crossing iteration is recorded
    in the per-RHS counter.  A rank-deficient Gram matrix is deflated by
    a relative Tikhonov jitter sized to the scalar precision.  All B x B
    arithmetic runs in the scalar dtype; the whole state freezes once
    every column has converged (the JAX ``while_loop`` stops there)."""
    dtype = Bm.dtype
    dev = Bm.device
    coldot, sdt = _coldot_setup(dtype, False)

    def store(v):
        return v.to(dtype)

    nrhs = Bm.shape[1]
    unbounded = crit.unbounded
    eps = torch.finfo(sdt).eps
    eye = torch.eye(nrhs, dtype=sdt, device=dev)
    bnrm2 = torch.sqrt(coldot(Bm, Bm))
    x0nrm2 = torch.sqrt(coldot(X0, X0))

    def gram(Aa, Bb):
        return Aa.to(sdt).mT @ Bb.to(sdt)

    info = [torch.zeros((), dtype=torch.int32, device=dev)]

    def deflated_solve(M, G):
        """Solve ``M a = G`` through a relative Tikhonov jitter; the LU
        flag is kept on the device and read once a chunk."""
        tr = torch.trace(M) / M.shape[0]
        jitter = 64.0 * eps * torch.clamp(torch.abs(tr), min=eps)
        a, inf_ = torch.linalg.solve_ex(M + jitter * eye, G)
        info[0] = torch.maximum(info[0], inf_.to(torch.int32))
        return a

    R = (Bm - spmv_multi(A, X0)).to(sdt)
    rr0 = coldot(R, R)
    r0nrm2 = torch.sqrt(rr0)
    res_tol = _res_tols(crit, r0nrm2)
    tol2 = res_tol * res_tol
    Z = papply(R).to(sdt) if papply is not None else R
    s = _State(x=X0.to(sdt), r=R, p=Z, g=gram(Z, R),
               iters=torch.zeros((nrhs,), dtype=torch.int64, device=dev),
               k=torch.zeros((), dtype=torch.int64, device=dev))
    s.done = (torch.zeros((nrhs,), dtype=torch.bool, device=dev)
              if unbounded else rr0 < tol2)

    def check():
        if int(info[0]):
            raise BreakdownError(
                "block CG: a deflated B x B Gram solve met an exactly "
                "singular factor")

    def step():
        active = ~s.done
        live = active.any() if not unbounded else None
        Q = spmv_multi(A, store(s.p)).to(sdt)
        W = gram(s.p, Q)
        alpha = deflated_solve(W, s.g)
        X = s.x + s.p @ alpha
        R = s.r - Q @ alpha
        rr = coldot(R, R)
        Zn = papply(store(R)).to(sdt) if papply is not None else R
        G_new = gram(Zn, R)
        beta = deflated_solve(s.g, G_new)
        P = Zn + s.p @ beta
        _ring_step(telem, s, active, unbounded, rr)
        iters = s.iters + active.to(torch.int64)
        if live is None:
            s.x, s.r, s.p, s.g, s.iters = X, R, P, G_new, iters
            return
        s.done = s.done | (active & (rr < tol2))
        s.x = torch.where(live, X, s.x)
        s.r = torch.where(live, R, s.r)
        s.p = torch.where(live, P, s.p)
        s.g = torch.where(live, G_new, s.g)
        s.iters = iters
        s.k = s.k + live.to(torch.int64)

    _run(step, crit.maxits, unbounded, s, check, telem)
    check()
    s.x = store(s.x)
    return _finish(s, crit, nrhs, dev, torch.sqrt(coldot(s.r, s.r)),
                   r0nrm2, bnrm2, x0nrm2, s.done, telem)


class ChunkedBatchedSolver:
    """The timed batched solve and its per-RHS statistics, shared by the
    single-device batched solver and the stacked multi-part one
    (``acg_tpu_torch.parallel.dist_batched.BatchedDistCGSolver``), as
    :class:`~acg_tpu_torch.solvers.cg.ChunkedCGSolver` is by the
    single-RHS tiers.  A subclass sets ``device``, ``stats`` and ``mode``
    and provides ``_inner()`` (the single-RHS solver a batch of one
    delegates to), ``_program(crit)`` (a callable of the device ``(B,
    X0)`` blocks returning a :class:`BatchedCGResult`), ``device_args(b,
    x0)``, ``_host_x(X)`` (the host ``(n, B)`` array the caller gets)
    and ``_account_ops(st, k_total, nrhs)``.

    ``trace`` (ring slots) and ``progress`` (heartbeat period) arm the
    per-RHS ring and the worst-column heartbeat of the batched loops
    (:class:`~acg_tpu_torch.telemetry.BatchedLoopTelemetry`); the ring
    is fetched once per solve into ``last_trace``/``stats.trace``."""

    trace = 0
    progress = 0
    last_trace = None
    _warming = False
    _trace_name = "cg-batched"
    ckpt = None
    precond_spec = None
    _ckpt_tier = "jax-cg-batched"

    def _check_ckpt(self, ckpt, classic: bool) -> None:
        """Keep ``ckpt`` (a :class:`~acg_tpu_torch.checkpoint.
        CheckpointConfig`), refused where the reference refuses: only
        the batched classic recurrence exposes its carry."""
        if ckpt is not None:
            from acg_tpu_torch.checkpoint import CheckpointConfig
            if not isinstance(ckpt, CheckpointConfig):
                raise ValueError("ckpt must be an acg_tpu_torch."
                                 "checkpoint.CheckpointConfig or None")
            if not classic:
                raise ValueError(
                    "batched checkpointing threads the batched-classic "
                    "carry (r/p columns + gamma/done/iters); the "
                    "pipelined/block modes do not expose state_io -- "
                    "use mode='batched'")
        self.ckpt = ckpt

    def _check_batched_telemetry(self, trace: int, progress: int) -> None:
        self.trace, self.progress = int(trace), int(progress)
        if self.trace < 0 or self.progress < 0:
            raise ValueError("trace/progress must be >= 0 (iteration "
                             "counts; 0 disables)")
        if self.mode == "block" and self.progress:
            raise ValueError("progress: block CG's columns share one "
                             "Krylov block; its heartbeat is not "
                             "ported (use trace for the per-RHS ring)")

    def _batched_telemetry(self, nrhs: int, sdt):
        """A fresh ring/heartbeat for one batched run, or None."""
        if not (self.trace or self.progress):
            return None
        from acg_tpu_torch.parallel import multihost
        return telemetry.BatchedLoopTelemetry(
            self.trace, 0 if self._warming else self.progress, nrhs, sdt,
            self.device, what=self._trace_name,
            leader=multihost.is_primary())

    def solve(self, b, x0=None, criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True, warmup: int = 0,
              host_result: bool = True):
        """Solve ``A X = B`` for the ``(n, B)`` column block ``b``.
        Returns the ``(n, B)`` solution block (host numpy unless
        ``host_result=False``, then the device block); per-RHS evidence
        lands in ``stats.batch``."""
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        nrhs = int(b.shape[1]) if b.ndim == 2 else 1
        if nrhs == 1:
            inner = self._inner()
            x = inner.solve(b.reshape(-1),
                            x0=None if x0 is None else x0.reshape(-1),
                            criteria=crit,
                            raise_on_divergence=raise_on_divergence,
                            warmup=warmup, host_result=host_result)
            self.stats = st = inner.stats
            st.batch = {"nrhs": 1, "mode": self.mode,
                        "iterations": [int(st.niterations)],
                        "rnrm2": [float(st.rnrm2)],
                        "converged": [bool(st.converged)],
                        "iterations_max": int(st.niterations),
                        "iterations_sum": int(st.niterations)}
            if host_result:
                return np.asarray(x).reshape(-1, 1)
            return x[..., None]
        if self.ckpt is not None:
            return self._solve_ckpt(b, x0, crit, raise_on_divergence,
                                    host_result)
        program = self._program(crit)
        t_xfer = time.perf_counter()
        Bm, X0 = self.device_args(b, x0)
        device_sync(self.device)
        _add_timing(st, "transfer", time.perf_counter() - t_xfer)
        t_warm = time.perf_counter()
        self._warming = True
        try:
            for _ in range(max(warmup, 0)):
                program(Bm, X0)
            device_sync(self.device)
        finally:
            self._warming = False
        if warmup > 0:
            _add_timing(st, "compile", time.perf_counter() - t_warm)
        t0 = time.perf_counter()
        res = program(Bm, X0)
        device_sync(self.device)
        t_solve = time.perf_counter() - t0
        st.tsolve += t_solve
        _add_timing(st, "solve", t_solve)
        self._finish_stats(res, nrhs)
        if res.telem is not None and res.telem.buf is not None:
            # the one extra device fetch of a traced batched solve
            st.trace = self.last_trace = \
                telemetry.BatchedConvergenceTrace.from_ring(
                    res.telem.ring(), int(res.k_total),
                    solver=self._trace_name)
        x = self._finish_x(res, host_result)
        if not st.converged and raise_on_divergence:
            rn = np.asarray(st.batch["rnrm2"])
            worst = int(np.argmax(rn))
            raise NotConvergedError(
                f"{st.niterations} iterations, {st.batch['unconverged']}"
                f" of {nrhs} RHS unconverged (worst rhs {worst}, "
                f"residual {float(rn[worst]):.3e})")
        return x

    def _finish_x(self, res, host_result: bool):
        st = self.stats
        if host_result:
            xv = (res.x.to(torch.float32) if res.x.dtype == torch.bfloat16
                  else res.x)
            x = self._host_x(xv.cpu().numpy())
            st.fexcept_arrays = [x]
            return x
        x = res.x
        has_nan = bool(torch.isnan(x).any())
        has_inf = bool(torch.isinf(x).any())
        st.fexcept_arrays = [np.asarray([np.nan if has_nan else 0.0,
                                         np.inf if has_inf else 0.0])]
        return x

    # -- the survivability tier: the checkpoint-chunked batched solve -------

    def _ckpt_meta_extra(self, meta: dict, arrs: dict) -> None:
        """Tier additions to a snapshot (the stacked tier's partition
        count and row-permutation sidecar)."""

    def _resume_arrays(self, snap) -> tuple:
        """``(arrays, repartitioned)`` of a validated snapshot in this
        tier's layout."""
        return snap.arrays, None

    def _validate_snapshot(self, snap, nrhs: int, dtype, b_crc) -> None:
        from acg_tpu_torch import checkpoint as ckpt_mod
        ckpt_mod.validate_resume(
            snap, tier=self._ckpt_tier, pipelined=False,
            precond=(str(self.precond_spec)
                     if self.precond_spec is not None else None),
            n=int(self.stats.unknowns), dtype=dtype, b_crc=b_crc,
            nrhs=nrhs)

    def _leaf_to_dev(self, a, name: str, sdt):
        a = np.asarray(a)
        if name == "done":
            dt = torch.bool
        elif name == "iters":
            dt = torch.int64
        elif name in ("gamma", "rr"):
            dt = sdt
        else:
            dt = self._solve_dtype()
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dt)

    def _solve_ckpt(self, b, x0, crit: StoppingCriteria,
                    raise_on_divergence: bool, host_result: bool):
        """The checkpoint-armed batched solve (``acg_tpu/solvers/
        batched.py:894-1070``, ``acg_tpu/parallel/dist_batched.py:
        649-849``): the unchanged batched classic program in chunks of
        ``ckpt.every`` iterations, the per-RHS carry threaded through (a
        chunked solve is the uninterrupted one bit for bit), a snapshot
        committed between chunks, and a resume that keeps every
        column's first absolute target."""
        from acg_tpu_torch import checkpoint as ckpt_mod
        from acg_tpu_torch import metrics, observatory
        from acg_tpu_torch.solvers.cg import _np_dtype

        cfg = self.ckpt
        st = self.stats
        dtype = self._solve_dtype()
        sdt = acc_dtype(dtype)
        names = ckpt_mod.batched_carry_names(self.precond_spec is not None)
        t_xfer = time.perf_counter()
        Bm, X0 = self.device_args(b, x0)
        device_sync(self.device)
        _add_timing(st, "transfer", time.perf_counter() - t_xfer)
        nrhs = int(Bm.shape[-1])
        bh = np.asarray(b, np.float64)
        b_crc = ckpt_mod.vector_checksum(
            bh.reshape(bh.shape[0], -1).astype(_np_dtype(dtype)))

        def carry_of(arrs):
            return tuple(self._leaf_to_dev(arrs[nm], nm, sdt)
                         for nm in names[1:])

        consumed = executed = 0
        resumed_from = repartitioned = None
        carry = None
        x_cur = X0
        abs_tol = first_r0 = None
        snap = cfg.resume
        if snap is not None:
            self._validate_snapshot(snap, nrhs, _np_dtype(dtype), b_crc)
            ckpt_mod.check_resume_env(snap, st)
            arrs, repartitioned = self._resume_arrays(snap)
            consumed = resumed_from = snap.iteration
            sm = snap.meta
            abs_tol = np.asarray(sm["abs_tol"], dtype=np.float64)
            first_r0 = np.asarray(sm["r0nrm2"], dtype=np.float64)
            x_cur = self._leaf_to_dev(arrs["x"], "x", sdt)
            carry = carry_of(arrs)
            metrics.record_resume()
            telemetry.record_event(
                st, "resume",
                f"resumed batched solve ({nrhs} RHS) from snapshot at "
                f"iteration {consumed}")
        seq = nsnaps = 0
        ck_secs = 0.0
        res = None
        t0 = time.perf_counter()
        while True:
            remaining = crit.maxits - consumed
            if remaining <= 0:
                break
            m = min(cfg.chunk_for(None), remaining)
            atol_cols = (None if abs_tol is None else torch.as_tensor(
                abs_tol, dtype=sdt, device=self.device))
            program = self._program(dataclasses.replace(crit, maxits=m),
                                    carry=carry, state_io=True,
                                    atol_cols=atol_cols)
            res = program(Bm, x_cur)
            device_sync(self.device)
            k_chunk = int(res.k_total)
            consumed += k_chunk
            executed += k_chunk
            if first_r0 is None:
                first_r0 = res.r0nrm2.double().cpu().numpy()
                abs_tol = np.maximum(crit.residual_atol,
                                     crit.residual_rtol * first_r0)
            if res.telem is not None and res.telem.buf is not None:
                st.trace = self.last_trace = \
                    telemetry.BatchedConvergenceTrace.from_ring(
                        res.telem.ring(), k_chunk, solver=self._trace_name,
                        offset=consumed - k_chunk)
            rn = res.rnrm2.double().cpu().numpy()
            conv = res.converged.cpu().numpy()
            observatory.note_chunk(
                self._ckpt_tier, consumed,
                float(np.max(rn[~conv])) if (~conv).any()
                else float(np.max(rn)),
                abs_tol=float(np.max(abs_tol)), rtol=crit.residual_rtol)
            finished = (consumed >= crit.maxits if crit.unbounded
                        else bool(conv.all()))
            x_cur = res.x
            carry = res.carry
            if cfg.path is not None and not finished:
                t_ck = time.perf_counter()
                arrs = {"x": res.x.cpu().numpy()}
                for nm, leaf in zip(names[1:], res.carry):
                    arrs[nm] = leaf.cpu().numpy()
                seq += 1
                meta = {
                    "tier": self._ckpt_tier,
                    "pipelined": False,
                    "precond": (str(self.precond_spec)
                                if self.precond_spec is not None
                                else None),
                    "n": int(self.stats.unknowns),
                    "nrhs": nrhs,
                    "dtype": str(_np_dtype(dtype)),
                    "iteration": consumed,
                    "seq": seq,
                    "abs_tol": [float(v) for v in abs_tol],
                    "bnrm2": [float(v) for v in
                              res.bnrm2.double().cpu().numpy()],
                    "x0nrm2": [float(v) for v in
                               res.x0nrm2.double().cpu().numpy()],
                    "r0nrm2": [float(v) for v in first_r0],
                    "b_crc": b_crc,
                    "trace_tail": [],
                }
                self._ckpt_meta_extra(meta, arrs)
                nbytes = ckpt_mod.save_snapshot(cfg.path, meta, arrs)
                dt = time.perf_counter() - t_ck
                ck_secs += dt
                _add_timing(st, "ckpt", dt)
                metrics.record_snapshot(nbytes, dt)
                nsnaps += 1
            if finished:
                break
        if res is None:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"snapshot iteration {consumed} already meets the "
                f"iteration cap {crit.maxits}; raise --max-iterations "
                f"to continue this solve")
        t_solve = time.perf_counter() - t0 - ck_secs
        st.tsolve += t_solve
        _add_timing(st, "solve", t_solve)
        self._finish_stats(res, nrhs, k_total=executed)
        st.ckpt = {"path": cfg.path, "every": int(cfg.every),
                   "snapshots": nsnaps, "iteration": consumed,
                   "rollbacks": 0}
        if resumed_from is not None:
            st.ckpt["resumed_from"] = resumed_from
        if repartitioned is not None:
            st.ckpt["repartitioned_from"] = repartitioned
        x = self._finish_x(res, host_result)
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{executed} iterations, {st.batch['unconverged']} of "
                f"{nrhs} RHS unconverged")
        return x

    def _finish_stats(self, res: BatchedCGResult, nrhs: int,
                      k_total: int | None = None) -> None:
        """Per-RHS evidence -> ``stats.batch``; the aggregate fields keep
        their single-RHS meaning through the slowest/worst column
        (``k_total``: the iterations this process ran, when chunked)."""
        st = self.stats
        iters = res.niterations.cpu().numpy().astype(int).tolist()
        rn = [float(v) for v in res.rnrm2.double().cpu().numpy()]
        conv = [bool(v) for v in res.converged.cpu().numpy()]
        k_total = int(res.k_total) if k_total is None else int(k_total)
        st.nsolves += 1
        st.niterations = k_total
        st.ntotaliterations += k_total
        st.bnrm2 = float(res.bnrm2.max())
        st.x0nrm2 = float(res.x0nrm2.max())
        st.r0nrm2 = float(res.r0nrm2.max())
        st.rnrm2 = float(max(rn))
        st.dxnrm2 = float("inf")
        st.converged = all(conv)
        st.batch = {
            "nrhs": nrhs,
            "mode": self.mode,
            "iterations": iters,
            "iterations_max": int(max(iters) if iters else 0),
            "iterations_sum": int(sum(iters)),
            "rnrm2": rn,
            "converged": conv,
            "unconverged": int(sum(1 for c in conv if not c)),
        }
        if self.mode == "block":
            # each block iteration advances all B columns: the
            # comparable "total iterations" figure is trips x B
            st.batch["block_iterations"] = k_total
            st.batch["total_iterations"] = k_total * nrhs
        self._account_ops(st, k_total, nrhs)


class BatchedCGSolver(ChunkedBatchedSolver):
    """Multi-RHS CG over one device matrix (``acg_tpu.solvers.batched.
    BatchedCGSolver``): B systems sharing the operator, solved by the
    batched (default), batched-pipelined or block recurrence.

    ``mode``: ``"batched"``, ``"pipelined"`` or ``"block"``; ``precond``
    broadcasts over the batch axis (:func:`acg_tpu_torch.precond.
    make_apply_batched`); ``device`` as for :class:`~acg_tpu_torch.
    solvers.cg.TorchCGSolver` (the matrix must live there).  Only
    ``kernels="auto"/"xla"``: the batched tier is plain PyTorch.  A
    single-column ``b`` delegates to a :class:`~acg_tpu_torch.solvers.cg.
    TorchCGSolver` with the same configuration.  ``column_dots="single"``
    (the solver service's coalesced batches) computes each column's dots
    as that solver's ``torch.dot`` does, so every column of the batched
    classic recurrence is bitwise its ``kernels="xla"`` single-RHS solve
    (``"reduce"``, the default: one column reduction a dot)."""

    def __init__(self, A: DeviceMatrix, mode: str = "batched",
                 precise_dots: bool = False, kernels: str = "auto",
                 vector_dtype=None, precond=None, trace: int = 0,
                 ckpt=None, device=None, progress: int = 0,
                 column_dots: str = "reduce"):
        if mode not in ("batched", "pipelined", "block"):
            raise ValueError(f"unknown batched mode {mode!r} "
                             f"(batched, pipelined, block)")
        if kernels not in ("auto", "xla"):
            raise ValueError(
                "the batched tiers run the plain multi-vector SpMV "
                "(one matrix pass over all B columns); kernels="
                f"{kernels!r} is single-RHS only -- use 'auto'/'xla'")
        if mode == "block" and precise_dots:
            raise ValueError("block-CG's scalars are B x B Gram solves "
                             "in the scalar dtype; precise_dots applies "
                             "to the batched/pipelined modes")
        if column_dots not in ("reduce", "single"):
            raise ValueError(f"unknown column_dots {column_dots!r} "
                             f"(reduce, single)")
        if column_dots == "single" and precise_dots:
            raise ValueError("column_dots='single' is the single-RHS "
                             "solver's plain dot; precise_dots takes "
                             "the compensated dot2 instead")
        self.column_dots = column_dots
        self._check_ckpt(ckpt, mode == "batched")
        self.device = resolve_device(device)
        if A.device != self.device:
            raise ValueError(f"the matrix lives on {A.device}, the solver "
                             f"runs on {self.device}; build the matrix with "
                             f"device={str(self.device)!r}")
        self.A = A
        self.mode = mode
        self._trace_name = f"cg-{mode}"
        self._check_batched_telemetry(trace, progress)
        self.precise_dots = bool(precise_dots)
        self.vector_dtype = vector_dtype
        from acg_tpu_torch.precond import parse_precond
        self.precond_spec = parse_precond(precond)
        self._mstate = None
        self.stats = SolverStats(unknowns=A.nrows)
        self._inner1 = None
        self._spmv_flops_cache = None

    def _solve_dtype(self):
        if self.vector_dtype is not None:
            return self.vector_dtype
        return matrix_dtype(self.A)

    def _inner(self):
        if self._inner1 is None:
            from acg_tpu_torch.solvers.cg import TorchCGSolver
            self._inner1 = TorchCGSolver(
                self.A, pipelined=(self.mode == "pipelined"),
                precise_dots=self.precise_dots, kernels="xla",
                vector_dtype=self.vector_dtype, device=self.device,
                precond=self.precond_spec, ckpt=self.ckpt)
        return self._inner1

    def _ensure_precond_state(self):
        if self.precond_spec is None or self._mstate is not None:
            return self._mstate
        from acg_tpu_torch.precond import setup_single
        self._mstate = setup_single(self.precond_spec, self.A, spmv,
                                    acc_dtype(self._solve_dtype()))
        return self._mstate

    def _as_columns(self, v, dtype) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        v = v.to(device=self.device, dtype=dtype)
        if v.dim() == 1:
            v = v[:, None]
        if v.dim() != 2 or v.shape[0] != self.A.nrows:
            raise ValueError(
                f"batched right-hand sides are (n, B) columns; got "
                f"shape {tuple(v.shape)} for n={self.A.nrows}")
        return v.contiguous()

    def device_args(self, b, x0=None):
        dtype = self._solve_dtype()
        Bm = self._as_columns(b, dtype)
        X0 = (torch.zeros_like(Bm) if x0 is None
              else self._as_columns(x0, dtype))
        return Bm, X0

    def _host_x(self, X: np.ndarray) -> np.ndarray:
        return X

    def _program(self, crit: StoppingCriteria, **ckpt_kw):
        """``run(Bm, X0)`` of the armed mode; ``ckpt_kw`` (the chunk
        driver's carry, state_io and atol_cols) reach the batched
        classic program."""
        if crit.needs_diff:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "the batched tiers support residual criteria only "
                "(a per-RHS diff criterion is not part of the batched "
                "carry)")
        papply = None
        if self.precond_spec is not None:
            from acg_tpu_torch.precond import make_apply_batched
            mstate = self._ensure_precond_state()
            apply = make_apply_batched(self.precond_spec)

            def papply(R):
                return apply(mstate, self.A, R)
        A = self.A
        sdt = acc_dtype(self._solve_dtype())

        def telem(Bm):
            return self._batched_telemetry(Bm.shape[-1], sdt)

        if self.mode == "block":
            return lambda Bm, X0: _block_cg_program(A, Bm, X0, crit, papply,
                                                    telem(Bm))
        coldot, _ = _coldot_setup(self._solve_dtype(), self.precise_dots,
                                  self.column_dots == "single")

        def spmv(X):
            return spmv_multi(A, X)

        if self.mode == "pipelined":
            def coldotk(*pairs):
                return tuple(coldot(a, c) for a, c in pairs)

            return lambda Bm, X0: _batched_cg_pipelined_program(
                spmv, coldot, coldotk, Bm, X0, crit, papply, telem(Bm))
        return lambda Bm, X0: _batched_cg_program(spmv, coldot, Bm, X0,
                                                  crit, papply, telem(Bm),
                                                  **ckpt_kw)

    def _account_ops(self, st, k_total: int, nrhs: int) -> None:
        """Analytic census: matrix bytes are read once an iteration for
        the whole batch; vector traffic and flops scale with B."""
        if self._spmv_flops_cache is None:
            self._spmv_flops_cache = spmv_flops(self.A)
        n = self.A.nrows
        nnz3 = self._spmv_flops_cache / 3.0
        per_it = cg_flops_per_iteration(nnz3, n, self.mode == "pipelined")
        st.nflops += (per_it * k_total + self._spmv_flops_cache
                      + 2.0 * n) * nrhs
        dbl = torch.empty((), dtype=self._solve_dtype()).element_size()
        mat_dbl = torch.empty((), dtype=matrix_dtype(self.A)).element_size()
        idx_b = matrix_index_bytes(self.A)
        mat_bytes = int(nnz3 * (mat_dbl + idx_b))
        st.ops["gemv"].add(k_total + 1, 0.0,
                           (mat_bytes + 2 * n * dbl * nrhs) * (k_total + 1))
        st.ops["dot"].add(k_total, 0.0, 2 * n * dbl * nrhs * k_total)
        st.ops["nrm2"].add(k_total + 1, 0.0,
                           n * dbl * nrhs * (k_total + 1))
        st.ops["axpy"].add(3 * k_total, 0.0,
                           3 * n * dbl * nrhs * 3 * k_total)
