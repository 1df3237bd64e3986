"""Single-device CG solvers on PyTorch tensors.

The counterpart of ``acg_tpu/solvers/jax_cg.py``'s single-device tier:
classic CG, Ghysels-Vanroose pipelined CG, and the fused two-phase
classic iteration.  The JAX package compiles each solve into one XLA
program with a ``while_loop``; here the loop is eager Python over device
tensors with the same semantics:

* Every CG scalar stays on the device as a one-element tensor.  The loop
  makes no per-iteration host read: the convergence flag is read once per
  chunk of :data:`CHUNK` iterations.
* Once converged, the state FREEZES on the device -- device-side selects
  (and the kernels' ``live`` flag) leave x, r, p and the scalars as they
  were for the rest of the chunk -- so the iteration count and ``x``
  equal those of the JAX ``while_loop``.
* A solve with no tolerance (``criteria.unbounded``) runs exactly
  ``maxits`` iterations with no flag reads at all, like the JAX
  ``fori_loop`` path.
* bf16 vector storage computes every scalar in f32 and rounds each
  updated vector once, on store (``jax_cg.py:91-111,307``).
* ``trace``/``progress`` (the observability tier, :mod:`acg_tpu_torch.
  telemetry`) add a device ring of each iteration's scalars, written
  in place and masked by the convergence flag, and a heartbeat printed
  where the flag is read; disarmed, the loops build and launch nothing
  more.

The classic and pipelined programs take the SpMV and the global dot as
callables, so the stacked multi-part tier (:mod:`acg_tpu_torch.parallel.
dist`) runs the same loops over its halo-exchanging SpMV and psum'd
dots, and :class:`ChunkedCGSolver` holds the solve both tiers share.

``kernels`` picks the SpMV and update implementations: ``"xla"`` is the
plain PyTorch formulation (what the JAX package leaves to XLA);
``"pallas"`` the hand-written CUDA kernels of :mod:`acg_tpu_torch.ops.
kernels` (their plain versions for CPU tensors); ``"fused"`` the
two-phase iteration on kernels K3/K4.  A matrix-free operator
(:mod:`acg_tpu_torch.ops.operator`) takes the place of the device matrix
in the classic and pipelined loops: kernel K7 for the constant-
coefficient Poisson stencil, its own torch apply for other operators.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from acg_tpu_torch import telemetry
from acg_tpu_torch._device import device_sync, resolve_device
from acg_tpu_torch.errors import AcgError, ErrorCode, NotConvergedError
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.ops.operator import is_matrix_free
from acg_tpu_torch.ops.precision import dot2
from acg_tpu_torch.ops.spmv import (DeviceMatrix, DiaMatrix, acc_dtype,
                                    matrix_dtype, matrix_index_bytes, spmv,
                                    spmv_flops)
from acg_tpu_torch.precond import (bytes_per_apply, flops_per_apply,
                                   make_apply, parse_precond, setup_single,
                                   state_bytes)
from acg_tpu_torch.solvers.resilience import RecoveryDriver
from acg_tpu_torch.solvers.stats import (SolverStats, StoppingCriteria,
                                         cg_flops_per_iteration)

# iterations run between two host reads of the convergence flag
CHUNK = 32


@dataclasses.dataclass
class CGResult:
    """Device-resident solve result; every field but ``x`` is a
    one-element tensor (read by the host once, after the solve)."""

    x: torch.Tensor
    niterations: torch.Tensor
    rnrm2: torch.Tensor
    r0nrm2: torch.Tensor
    bnrm2: torch.Tensor
    x0nrm2: torch.Tensor
    dxnrm2: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor
    # the run's in-loop telemetry (a telemetry.LoopTelemetry), if armed
    telem: object = None


def _scalar_setup(dtype, precise: bool = False):
    """``(dot, sdt)``: the CG-scalar dot product and scalar dtype for
    ``dtype`` vector storage (``jax_cg.py:91-111``).  bf16 storage
    computes every scalar in f32: ``torch.dot`` on bf16 tensors would
    return bf16, so both operands are widened first.  ``precise`` takes
    the compensated :func:`~acg_tpu_torch.ops.precision.dot2` (over the
    f32-widened reads for bf16 storage)."""
    sdt = acc_dtype(dtype)
    if precise:
        def dot(a, b):
            return dot2(a.to(sdt), b.to(sdt))
        return dot, sdt
    if sdt != dtype:
        def dot(a, b):
            return torch.dot(a.to(sdt), b.to(sdt))
        return dot, sdt
    return torch.dot, sdt


def _tolerances(crit: StoppingCriteria, r0nrm2, x0nrm2, sdt):
    """Device-side residual/diff thresholds; 0 disables (cf. cg.c:844-848)."""
    dev = r0nrm2.device
    res_tol = torch.maximum(torch.tensor(crit.residual_atol, dtype=sdt,
                                         device=dev),
                            crit.residual_rtol * r0nrm2)
    diff_tol = torch.maximum(torch.tensor(crit.diff_atol, dtype=sdt,
                                          device=dev),
                             crit.diff_rtol * x0nrm2)
    return res_tol, diff_tol


def _converged(rnrm2sqr, dxnrm2sqr, res_tol, diff_tol):
    """The device-side convergence predicate (a one-element bool)."""
    return (((res_tol > 0) & (rnrm2sqr < res_tol * res_tol))
            | ((diff_tol > 0) & (dxnrm2sqr < diff_tol * diff_tol)))


def _iterate(step, maxits: int, unbounded: bool, state,
             telem=None) -> None:
    """Run ``step(live)`` until ``maxits`` iterations or convergence.

    ``state.done`` is the device convergence flag that ``step`` updates;
    ``live`` is ``~state.done`` on entry to the step, which the step
    uses to freeze its state once converged.  The host reads the flag
    once per :data:`CHUNK` iterations.  Unbounded solves run exactly
    ``maxits`` steps with ``live = None`` and no reads.  An armed
    heartbeat (``telem.progress``) prints its lines right after each
    flag read and after the last chunk; unbounded solves then read once
    per chunk for it.
    """
    beats = telem is not None and telem.progress > 0
    if unbounded:
        if not beats:
            for _ in range(maxits):
                step(None)
            return
        for ran in range(0, maxits, CHUNK):
            for _ in range(min(CHUNK, maxits - ran)):
                step(None)
            telem.flush()
        return
    ran = 0
    while ran < maxits:
        done = bool(state.done)
        if beats:
            telem.flush()
        if done:
            break
        for _ in range(min(CHUNK, maxits - ran)):
            step(~state.done)
        ran += CHUNK
    if beats:
        telem.flush()


class _State:
    """Mutable loop state of one program run (tensors rebound per step)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _stencil_kernel_ok(A) -> bool:
    """A constant-coefficient Poisson operator: kernel K7 computes it."""
    return is_matrix_free(A) and getattr(A, "kind", None) == "poisson"


def _spmv_fn(kernels: str):
    """The SpMV of a kernel choice: under "pallas"/"fused" the hand-written
    DIA kernel K1 for square DIA matrices and the stencil kernel K7 for
    constant-coefficient Poisson operators (plain versions for CPU
    tensors), the plain PyTorch formulation otherwise (other operators:
    their own apply, ``acg_tpu/ops/pallas_kernels.py:798-800``).  A
    callable ``kernels`` is the SpMV ``f(A, x)`` itself (the sharded
    tier's windowed or roll SpMV)."""
    if callable(kernels):
        return kernels
    if kernels == "xla":
        return spmv

    def f(A, x):
        if isinstance(A, DiaMatrix) and A.ncols_padded == A.nrows:
            return K.dia_spmv(A.data, A.offsets, x)
        if _stencil_kernel_ok(A):
            return K.stencil_spmv(A, x)
        return spmv(A, x)

    return f


def _dotk(dot):
    """``dotk((a1, c1), ...)`` -> the k dots, one after another: the
    single-device counterpart of the fused psum of the stacked tier."""
    def dotk(*pairs):
        return tuple(dot(a, c) for a, c in pairs)
    return dotk


def _cg_program(spmv, dot, b, x0, crit: StoppingCriteria, papply=None,
                dotk=None, telem=None) -> CGResult:
    """Classic CG (``acg_tpu.solvers.jax_cg._cg_program``) over the
    caller's ``spmv(x)`` and global ``dot(a, c)``: one vector on one
    device, or stacked parts with psum'd dots (``acg_tpu/parallel/
    dist.py:1585-1694``).  The updates are plain PyTorch; the SpMV
    carries the kernel choice.

    ``papply(r) -> z`` (M^-1 r) makes it preconditioned CG: the CG scalar
    is gamma = (r, z), and the carried true residual rr = (r, r) keeps the
    convergence test and the reported rnrm2 unpreconditioned.  Both come
    from ``dotk((r, z), (r, r))``: two dots on one device, one fused psum
    on stacked parts (``dist.py:1608-1615``).

    ``telem`` (a :class:`~acg_tpu_torch.telemetry.LoopTelemetry`) records
    each iteration's ``(gamma_next, alpha, beta, (p, t))`` -- under
    ``papply`` gamma is the preconditioned ``(r, z)``, as the reference's
    ring records it (``jax_cg.py:453-463``)."""
    dtype = b.dtype
    sdt = acc_dtype(dtype)
    dev = b.device
    needs_diff = crit.needs_diff
    unbounded = crit.unbounded
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    r = b - spmv(x0)
    if papply is None:
        p = r
        gamma = rr = dot(r, r)
    else:
        z0 = papply(r)
        p = z0.to(dtype)
        gamma, rr = dotk((r, z0), (r, r))
    r0nrm2 = torch.sqrt(rr)
    res_tol, diff_tol = _tolerances(crit, r0nrm2, x0nrm2, sdt)
    inf = torch.tensor(math.inf, dtype=sdt, device=dev)
    zero = torch.zeros((), dtype=sdt, device=dev)
    s = _State(x=x0, r=r, p=p, gamma=gamma, rr=rr, dx=inf,
               k=torch.zeros((), dtype=torch.int64, device=dev))
    s.done = (_converged(rr, inf, res_tol, diff_tol) if not unbounded
              else None)

    def step(live):
        t = spmv(s.p)
        pdott = dot(s.p, t)
        alpha = s.gamma / pdott
        if live is not None:
            alpha = torch.where(live, alpha, zero)
        # vectors computed in the scalar dtype, rounded once on store
        s.x = (s.x.to(sdt) + alpha * s.p.to(sdt)).to(dtype)
        r = (s.r.to(sdt) - alpha * t.to(sdt)).to(dtype)
        if papply is None:
            z = r
            gamma_next = rr_next = dot(r, r)
        else:
            z = papply(r)
            gamma_next, rr_next = dotk((r, z), (r, r))
        beta = gamma_next / s.gamma
        p_next = (z.to(sdt) + beta * s.p.to(sdt)).to(dtype)
        dx = alpha * alpha * dot(s.p, s.p) if needs_diff else inf
        s.r = r
        if telem is not None:
            telem.step(s.k, live, gamma_next, alpha, beta, pdott)
        if live is None:
            s.p, s.gamma, s.rr, s.dx = p_next, gamma_next, rr_next, dx
            return
        s.p = torch.where(live, p_next, s.p)
        s.gamma = torch.where(live, gamma_next, s.gamma)
        # unpreconditioned, rr is gamma: no second select
        s.rr = (s.gamma if papply is None
                else torch.where(live, rr_next, s.rr))
        s.dx = torch.where(live, dx, s.dx)
        s.k = s.k + live.to(torch.int64)
        s.done = s.done | _converged(s.rr, s.dx, res_tol, diff_tol)

    _iterate(step, crit.maxits, unbounded, s, telem)
    k = torch.tensor(crit.maxits, device=dev) if unbounded else s.k
    done = torch.tensor(True, device=dev) if unbounded else s.done
    return CGResult(x=s.x, niterations=k, rnrm2=torch.sqrt(s.rr),
                    r0nrm2=r0nrm2, bnrm2=bnrm2, x0nrm2=x0nrm2,
                    dxnrm2=torch.sqrt(s.dx), converged=done,
                    breakdown=torch.tensor(False, device=dev), telem=telem)


def _cg_pipelined_program(spmv, dot, dotk, b, x0, crit: StoppingCriteria,
                          use_kernel: bool, telem=None) -> CGResult:
    """Pipelined (Ghysels-Vanroose) CG (``acg_tpu.solvers.jax_cg.
    _cg_pipelined_program``, plain body ``:925-1012``; stacked parts:
    ``acg_tpu/parallel/dist.py:1833-1956``), both scalars of an iteration
    from one ``dotk`` (one fused psum on stacked parts).  gamma_prev =
    alpha_prev = inf on entry gives beta = 0 on the first iteration;
    convergence tests the carried gamma = ||r||^2 from before the update
    (one iteration stale, ``cgcuda.c:1798-1810``).  With ``use_kernel``
    the 6-vector update is kernel K5, in place, on the flat view of the
    vectors (the whole stack at once).  ``telem`` records the carried
    gamma (stale by one) and the alpha denominator in the pAp slot
    (``jax_cg.py:1004-1013``)."""
    dtype = b.dtype
    sdt = acc_dtype(dtype)
    dev = b.device
    needs_diff = crit.needs_diff
    unbounded = crit.unbounded
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    r = b - spmv(x0)
    w = spmv(r)
    r0nrm2 = torch.sqrt(dot(r, r))
    res_tol, diff_tol = _tolerances(crit, r0nrm2, x0nrm2, sdt)
    inf = torch.tensor(math.inf, dtype=sdt, device=dev)
    # separate buffers: K5 updates all six vectors in place
    s = _State(x=x0.clone(), r=r, w=w, p=torch.zeros_like(b),
               t=torch.zeros_like(b), z=torch.zeros_like(b),
               gamma_prev=inf, alpha_prev=inf, dx=inf,
               k=torch.zeros((), dtype=torch.int64, device=dev))
    # an already-converged start (r0 = 0) returns x0 in 0 iterations
    s.done = (_converged(r0nrm2 * r0nrm2, inf, res_tol, diff_tol)
              if not unbounded else None)

    def step(live):
        gamma, delta = dotk((s.r, s.r), (s.w, s.r))
        q = spmv(s.w)
        beta = gamma / s.gamma_prev             # inf -> 0 on first iteration
        denom = delta - beta * (gamma / s.alpha_prev)
        alpha = gamma / denom
        vecs = (s.x, s.r, s.w, s.p, s.t, s.z)
        if use_kernel:
            K.pipelined_update(*(v.view(-1) for v in vecs), q.view(-1),
                               alpha, beta, live=live)
        else:
            new = K.pipelined_update_plain(*vecs, q, alpha, beta)
            if live is not None:
                new = tuple(torch.where(live, nv, old)
                            for nv, old in zip(new, vecs))
            s.x, s.r, s.w, s.p, s.t, s.z = new
        dx = alpha * alpha * dot(s.p, s.p) if needs_diff else inf
        if telem is not None:
            telem.step(s.k, live, gamma, alpha, beta, denom)
        if live is None:
            s.gamma_prev, s.alpha_prev, s.dx = gamma, alpha, dx
            return
        s.gamma_prev = torch.where(live, gamma, s.gamma_prev)
        s.alpha_prev = torch.where(live, alpha, s.alpha_prev)
        s.dx = torch.where(live, dx, s.dx)
        s.k = s.k + live.to(torch.int64)
        s.done = s.done | _converged(s.gamma_prev, s.dx, res_tol, diff_tol)

    _iterate(step, crit.maxits, unbounded, s, telem)
    rnrm2 = torch.sqrt(dot(s.r, s.r))
    if unbounded:
        k = torch.tensor(crit.maxits, device=dev)
        done = torch.tensor(True, device=dev)
    else:
        k = s.k
        # the in-loop test is one iteration stale: a final fresh residual
        # that meets the tolerance is convergence
        done = s.done | (rnrm2 <= res_tol)
    return CGResult(x=s.x, niterations=k, rnrm2=rnrm2, r0nrm2=r0nrm2,
                    bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=torch.sqrt(s.dx),
                    converged=done,
                    breakdown=torch.tensor(False, device=dev), telem=telem)


def _pcg_pipelined_program(spmv, dot, dotk, b, x0, crit: StoppingCriteria,
                           papply, telem=None) -> CGResult:
    """Preconditioned pipelined CG (``acg_tpu.solvers.jax_cg.
    _cg_pipelined_program``'s ``pbody``, ``:832-924``; stacked parts:
    ``acg_tpu/parallel/dist.py:1715-1835``): the carry adds u = M^-1 r
    and q = M^-1 s; each iteration applies m = M^-1 w and n = A m, and
    takes its three scalars gamma = (r, u), delta = (w, u) and rr = (r, r)
    from one ``dotk`` (one fused psum on stacked parts).  Convergence
    tests the carried rr (the true residual, stale by one, like the
    unpreconditioned loop's gamma).  The 8-vector update is plain torch
    (K5 computes only the unpreconditioned six-vector update).
    ``telem`` records the preconditioned gamma (stale by one) and the
    alpha denominator (``jax_cg.py:913-922``)."""
    dtype = b.dtype
    sdt = acc_dtype(dtype)
    dev = b.device
    needs_diff = crit.needs_diff
    unbounded = crit.unbounded
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    r = b - spmv(x0)
    u0 = papply(r).to(dtype)
    w = spmv(u0)
    rr0 = dot(r, r)
    r0nrm2 = torch.sqrt(rr0)
    res_tol, diff_tol = _tolerances(crit, r0nrm2, x0nrm2, sdt)
    inf = torch.tensor(math.inf, dtype=sdt, device=dev)
    zeros = torch.zeros_like(b)
    s = _State(x=x0, r=r, u=u0, w=w, p=zeros, s=zeros, q=zeros, z=zeros,
               gamma_prev=inf, alpha_prev=inf, rr=rr0, dx=inf,
               k=torch.zeros((), dtype=torch.int64, device=dev))
    # an already-converged start (r0 = 0) returns x0 in 0 iterations
    s.done = (_converged(rr0, inf, res_tol, diff_tol) if not unbounded
              else None)

    def store(v):
        return v.to(dtype)

    def step(live):
        gamma, delta, rr = dotk((s.r, s.u), (s.w, s.u), (s.r, s.r))
        m = papply(s.w)
        nvec = spmv(m)
        beta = gamma / s.gamma_prev             # inf -> 0 on first iteration
        denom = delta - beta * (gamma / s.alpha_prev)
        alpha = gamma / denom
        z = store(nvec.to(sdt) + beta * s.z.to(sdt))
        q = store(m.to(sdt) + beta * s.q.to(sdt))
        sv = store(s.w.to(sdt) + beta * s.s.to(sdt))
        p = store(s.u.to(sdt) + beta * s.p.to(sdt))
        new = (store(s.x.to(sdt) + alpha * p.to(sdt)),
               store(s.r.to(sdt) - alpha * sv.to(sdt)),
               store(s.u.to(sdt) - alpha * q.to(sdt)),
               store(s.w.to(sdt) - alpha * z.to(sdt)), p, sv, q, z)
        dx = alpha * alpha * dot(p, p) if needs_diff else inf
        if telem is not None:
            telem.step(s.k, live, gamma, alpha, beta, denom)
        names = ("x", "r", "u", "w", "p", "s", "q", "z")
        if live is None:
            for name, v in zip(names, new):
                setattr(s, name, v)
            s.gamma_prev, s.alpha_prev, s.rr, s.dx = gamma, alpha, rr, dx
            return
        for name, v in zip(names, new):
            setattr(s, name, torch.where(live, v, getattr(s, name)))
        s.gamma_prev = torch.where(live, gamma, s.gamma_prev)
        s.alpha_prev = torch.where(live, alpha, s.alpha_prev)
        s.rr = torch.where(live, rr, s.rr)
        s.dx = torch.where(live, dx, s.dx)
        s.k = s.k + live.to(torch.int64)
        s.done = s.done | _converged(s.rr, s.dx, res_tol, diff_tol)

    _iterate(step, crit.maxits, unbounded, s, telem)
    rnrm2 = torch.sqrt(dot(s.r, s.r))
    if unbounded:
        k = torch.tensor(crit.maxits, device=dev)
        done = torch.tensor(True, device=dev)
    else:
        k = s.k
        done = s.done | (rnrm2 <= res_tol)
    return CGResult(x=s.x, niterations=k, rnrm2=rnrm2, r0nrm2=r0nrm2,
                    bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=torch.sqrt(s.dx),
                    converged=done,
                    breakdown=torch.tensor(False, device=dev), telem=telem)


def _cg_replaced_program(spmv, dot, b, x0, crit: StoppingCriteria, K: int,
                         restart: bool) -> CGResult:
    """Classic CG over bf16 vectors with an f32 true-residual replacement
    every ``K`` iterations (``acg_tpu.solvers.jax_cg._cg_replaced_program``;
    stacked parts: ``acg_tpu/parallel/dist.py:1491-1578``): the accuracy
    contract of the bf16 tier.

    ``b``/``x0`` arrive in f32 and x accumulates in f32; each segment
    solves A d = r from d = 0 with bf16 CG (f32 scalars), adds d to x once
    and recomputes r = b - A x with the mixed SpMV (bf16 matrix, f32
    vector).  ``restart`` resets p = r at each replacement; otherwise p
    carries over (reset to r when it has blown up) and the step takes the
    line-search numerator (r, p).  Convergence is tested on the
    recomputed residual once per segment (one host read a segment), so
    a converged report rests on the true f32 residual.  The last segment
    runs only the iterations left, so ``maxits`` is honoured exactly."""
    sdt = torch.float32
    vdt = torch.bfloat16
    dev = b.device
    b = b.to(sdt)
    x0 = x0.to(sdt)
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    r32 = b - spmv(x0)
    gamma32 = dot(r32, r32)
    r0nrm2 = torch.sqrt(gamma32)
    res_tol, _ = _tolerances(crit, r0nrm2, x0nrm2, sdt)
    tol2 = res_tol * res_tol
    inf = torch.tensor(math.inf, dtype=sdt, device=dev)
    zero = torch.zeros((), dtype=sdt, device=dev)
    big = torch.tensor(1e24, dtype=sdt, device=dev)
    maxits = crit.maxits

    def segment(x32, r32, p, nin):
        r = r32.to(vdt)
        g = dot(r, r)
        if restart:
            p = r
        else:
            # the carried direction can blow up across segments at high
            # condition numbers; reset it to r where it has
            pn = dot(p, p)
            bad = (~torch.isfinite(pn)) | (pn > big * g)
            p = torch.where(bad, r, p)
        d = torch.zeros_like(r)
        for _ in range(nin):
            t = spmv(p)
            pdott = dot(p, t)
            num = g if restart else dot(r, p)
            # (p, Ap) <= 0 once bf16 rounding has used up the segment's
            # progress: freeze the updates rather than poison d
            alpha = torch.where(pdott > 0, num / pdott, zero)
            d = (d.to(sdt) + alpha * p.to(sdt)).to(vdt)
            r = (r.to(sdt) - alpha * t.to(sdt)).to(vdt)
            g_next = dot(r, r)
            beta = torch.where(g > 0, g_next / g, zero)
            p = (r.to(sdt) + beta * p.to(sdt)).to(vdt)
            g = g_next
        x32 = x32 + d.to(sdt)
        r32 = b - spmv(x32)
        return x32, r32, p, dot(r32, r32)

    x32, p, its, gamma = x0, r32.to(vdt), 0, gamma32
    if crit.unbounded:
        while its < maxits:
            nin = min(K, maxits - its)
            x32, r32, p, gamma = segment(x32, r32, p, nin)
            its += nin
        done = torch.isfinite(gamma)
    else:
        # NaN >= tol2 is False: a non-finite recomputed residual ends the
        # loop, and the segment boundary is the breakdown detector
        while its < maxits and bool(gamma >= tol2):
            nin = min(K, maxits - its)
            x32, r32, p, gamma = segment(x32, r32, p, nin)
            its += nin
        done = gamma < tol2
    return CGResult(x=x32, niterations=torch.tensor(its, device=dev),
                    rnrm2=torch.sqrt(gamma), r0nrm2=r0nrm2, bnrm2=bnrm2,
                    x0nrm2=x0nrm2, dxnrm2=inf, converged=done,
                    breakdown=~torch.isfinite(gamma))


def _cg_fused_program(A: DiaMatrix, b, x0, crit: StoppingCriteria,
                      kernels: str) -> CGResult:
    """Classic CG with the two-phase fused iteration
    (``acg_tpu.solvers.jax_cg._cg_fused_program``): each iteration is
    kernel K3 (p update, t = A p, (p, t)) then kernel K4 (x, r update and
    the next gamma).  Scalars are f32; residual criteria only."""
    f32 = torch.float32
    dev = b.device

    def dot(a, c):
        return torch.dot(a.to(f32), c.to(f32))

    unbounded = crit.unbounded
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    r = b - _spmv_fn(kernels)(A, x0)
    gamma = dot(r, r)
    r0nrm2 = torch.sqrt(gamma)
    res_tol = torch.maximum(torch.tensor(crit.residual_atol, dtype=f32,
                                         device=dev),
                            crit.residual_rtol * r0nrm2)
    tol2 = res_tol * res_tol
    inf = torch.tensor(math.inf, dtype=f32, device=dev)
    # x is updated in place by K4: never alias the caller's x0
    s = _State(x=x0.clone(), r=r, p=torch.zeros_like(b), gamma=gamma,
               gamma_prev=inf,
               k=torch.zeros((), dtype=torch.int64, device=dev))
    s.done = gamma < tol2 if not unbounded else None

    def step(live):
        s.p, t, pdott = K.cg_phase_a(A.data, A.offsets, s.r, s.p, s.gamma,
                                     s.gamma_prev, offsets_t=A.offsets_t,
                                     live=live)
        s.x, s.r, gamma_next = K.cg_phase_b(s.x, s.p, s.r, t, s.gamma,
                                            pdott, live=live)
        if live is None:
            s.gamma_prev, s.gamma = s.gamma, gamma_next
            return
        s.gamma_prev = torch.where(live, s.gamma, s.gamma_prev)
        s.gamma = torch.where(live, gamma_next, s.gamma)
        s.k = s.k + live.to(torch.int64)
        s.done = s.done | (s.gamma < tol2)

    _iterate(step, crit.maxits, unbounded, s)
    k = torch.tensor(crit.maxits, device=dev) if unbounded else s.k
    done = torch.tensor(True, device=dev) if unbounded else s.done
    return CGResult(x=s.x, niterations=k, rnrm2=torch.sqrt(s.gamma),
                    r0nrm2=r0nrm2, bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=inf,
                    converged=done,
                    breakdown=torch.tensor(False, device=dev))


class ChunkedCGSolver:
    """The timed solve and its statistics, shared by the single-device
    solver and the stacked multi-part one (``acg_tpu_torch.parallel.
    dist.DistCGSolver``).  A subclass sets ``device`` and ``stats`` and
    provides ``_program(crit)`` (a callable of the device ``(b, x0)``
    returning a :class:`CGResult`), ``device_args(b, x0)``,
    ``_host_x(x)`` (the host array the caller gets),
    ``_account_ops(st, niter)`` and ``_solver_name()``.

    ``trace`` (ring slots) and ``progress`` (heartbeat period) arm the
    in-loop telemetry of the programs that take a :meth:`_telemetry`;
    the solve then fetches the ring once, into ``self.last_trace`` and
    ``stats.trace``.  Warm-up solves run the ring but print no
    heartbeat."""

    max_restarts = None   # a restart budget arms the restart loop
    _what = "cg"      # the tier's name in recovery events
    _beat_name = "cg"     # the tier's name on heartbeat lines
    trace = 0
    progress = 0
    last_trace = None
    _warming = False

    def _host_x(self, x: np.ndarray) -> np.ndarray:
        return x

    def _solver_name(self) -> str:
        return "cg"

    def _telemetry(self, sdt):
        """A fresh :class:`~acg_tpu_torch.telemetry.LoopTelemetry` for
        one program run in scalar dtype ``sdt``, or None disarmed.  The
        heartbeat prints from the first process only, and not during
        warm-up solves."""
        if not (self.trace or self.progress):
            return None
        from acg_tpu_torch.parallel import multihost
        return telemetry.LoopTelemetry(
            self.trace, 0 if self._warming else self.progress, sdt,
            self.device, what=self._beat_name,
            leader=multihost.is_primary())

    def _check_telemetry(self, trace: int, progress: int) -> None:
        """Validate and keep ``trace``/``progress`` (iteration counts; 0
        disables)."""
        self.trace, self.progress = int(trace), int(progress)
        if self.trace < 0 or self.progress < 0:
            raise ValueError("trace/progress must be >= 0 (iteration "
                             "counts; 0 disables)")
        if (self.trace or self.progress) and self.algo is not None:
            raise ValueError(
                f"trace/progress: the ring and heartbeat of the "
                f"communication-avoiding recurrences (--algorithm "
                f"{self.algo}) are not ported yet; use --algorithm "
                f"classic|pipelined")

    def _refuse_telemetry(self, what: str) -> None:
        """The reference's refusal of in-loop telemetry on a program
        that has no hook for it (``jax_cg.py:1524-1534,1566-1571``)."""
        if self.trace or self.progress:
            raise AcgError(ErrorCode.INVALID_VALUE, what)

    def _restart(self, res, niter: int, b, x0, crit, t0):
        """The restart loop of a solve whose program flagged a breakdown
        (``jax_cg.py:1816-1914``): each restart runs from the last
        iterate (x0 when it is not finite) with the first attempt's
        absolute tolerance and the iterations left, its setup
        recomputing the true residual; iterations add up.  Returns the
        last attempt's result and the total iterations, or raises once
        the budget's restarts are spent."""
        ladder = RecoveryDriver(self.max_restarts, self.stats, self._what)
        abs_tol = max(crit.residual_atol,
                      crit.residual_rtol * float(res.r0nrm2))
        while bool(res.breakdown):
            if not ladder.on_breakdown(int(res.niterations)):
                st = self.stats
                st.tsolve += time.perf_counter() - t0
                st.converged = False
                raise ladder.give_up(niter, float(res.rnrm2))
            x_next = res.x
            if not bool(torch.isfinite(x_next).all()):
                ladder.record("iterate non-finite; restarting from the "
                              "initial guess")
                x_next = x0
            program = self._program(StoppingCriteria(
                maxits=max(crit.maxits - niter, 1), residual_atol=abs_tol,
                residual_rtol=0.0, diff_atol=crit.diff_atol,
                diff_rtol=crit.diff_rtol))
            res = program(b, x_next)
            device_sync(self.device)
            niter += int(res.niterations)
        return res, niter

    def solve(self, b, x0=None, criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True, warmup: int = 0,
              host_result: bool = True):
        """Solve Ax=b.  Returns x as a numpy array (bf16 solves as f32),
        or the device tensor with ``host_result=False``.  ``warmup``
        solves run first, outside the timed region; the timed solve is
        bracketed by device synchronisations (and, while a profiler
        runs, by ``acg:compile``/``acg:solve`` annotations)."""
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        program = self._program(crit)
        t_xfer = time.perf_counter()
        b, x0 = self.device_args(b, x0)
        device_sync(self.device)
        telemetry.add_timing(st, "transfer", time.perf_counter() - t_xfer)
        t_warm = time.perf_counter()
        with telemetry.annotate("compile"):
            self._warming = True
            try:
                for _ in range(max(warmup, 0)):
                    program(b, x0)
                device_sync(self.device)
            finally:
                self._warming = False
        if warmup > 0:
            telemetry.add_timing(st, "compile", time.perf_counter() - t_warm)
        t0 = time.perf_counter()
        with telemetry.annotate("solve"):
            res = program(b, x0)
            device_sync(self.device)
        niter = int(res.niterations)
        # the norms of the first attempt are the solve's, restarts or not
        norms = (float(res.bnrm2), float(res.x0nrm2), float(res.r0nrm2))
        if self.max_restarts is not None and bool(res.breakdown):
            res, niter = self._restart(res, niter, b, x0, crit, t0)
        t_solve = time.perf_counter() - t0
        st.tsolve += t_solve
        telemetry.add_timing(st, "solve", t_solve)
        if res.telem is not None and res.telem.buf is not None:
            # the one extra device fetch of a traced solve
            st.trace = self.last_trace = \
                telemetry.ConvergenceTrace.from_ring(
                    res.telem.ring(), int(res.niterations),
                    solver=self._solver_name())
        st.nsolves += 1
        st.niterations = niter
        st.ntotaliterations += niter
        st.bnrm2, st.x0nrm2, st.r0nrm2 = norms
        st.rnrm2 = float(res.rnrm2)
        st.dxnrm2 = float(res.dxnrm2)
        st.converged = bool(res.converged) or crit.unbounded
        from acg_tpu_torch import metrics
        metrics.record_solve(t_solve, niter, st.converged,
                             solver=self._solver_name())
        self._account_ops(st, niter)
        if host_result:
            xv = res.x.to(torch.float32) if res.x.dtype == torch.bfloat16 \
                else res.x
            x = self._host_x(xv.cpu().numpy())
            st.fexcept_arrays = [x]
        else:
            x = res.x
            has_nan = bool(torch.isnan(x).any())
            has_inf = bool(torch.isinf(x).any())
            st.fexcept_arrays = [np.asarray([np.nan if has_nan else 0.0,
                                             np.inf if has_inf else 0.0])]
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{niter} iterations, residual {st.rnrm2:.3e}")
        return x


class TorchCGSolver(ChunkedCGSolver):
    """Single-device CG solver over a device matrix -- the counterpart
    of ``acg_tpu.solvers.jax_cg.JaxCGSolver``: keeps the matrix on the
    device across solves and accumulates statistics.

    ``device`` is where the solver runs: the CUDA card unless the caller
    asks for ``"cpu"``; the matrix must live there.  ``vector_dtype``
    decouples vector storage from the matrix dtype (``--dtype mixed`` =
    bf16 planes with f32 vectors).  ``kernels``:

    * ``"auto"``: the hand-written kernels for square DIA matrices on CUDA,
      in every dtype (f64 included: the H100 has native f64, unlike the
      TPU whose ``auto`` gate this drops), and K7 for constant-coefficient
      Poisson operators; plain PyTorch otherwise.
    * ``"xla"``: plain PyTorch (what the JAX package leaves to XLA).
    * ``"pallas"``: the hand kernels (on the CPU their plain versions,
      resolved as ``"pallas-plain"``).
    * ``"fused"``: classic CG on the two-phase kernels K3/K4, with the
      JAX package's refusals (``"fused-plain"`` on the CPU).

    ``algorithm`` (``"sstep:S"``, ``"pipelined:L"``, or ``"classic"`` /
    ``"pipelined"``, which pick the programs above) runs a
    communication-avoiding recurrence of :mod:`acg_tpu_torch.recurrence`
    over this solver's SpMV, unpreconditioned, over f32/f64 vectors;
    p(l)'s square-root breakdowns restart from the current iterate
    (the stats block's ``resilience:`` line counts them).

    ``precise_dots`` computes the CG scalars with the compensated dot2;
    ``replace_every`` (bf16 vectors) runs the f32 residual-replacement
    program every that many iterations (``replace_restart``: reset p at
    each replacement); ``precond`` (a :class:`~acg_tpu_torch.precond.
    PrecondSpec` or its text) makes the classic and pipelined loops
    preconditioned, with its state built at the first solve, or taken
    from ``mstate`` (:func:`~acg_tpu_torch.precond.state_from_numpy`).
    Each refuses the combinations ``JaxCGSolver`` refuses, with its
    messages.

    ``trace`` (ring slots; 0 = off) records each iteration's ``(||r||^2,
    alpha, beta, pAp)`` on the device, fetched once per solve into
    ``last_trace``/``stats.trace``; ``progress`` (iterations; 0 = off)
    prints a heartbeat to stderr.  The classic, pipelined and
    preconditioned programs carry them; the fused and replacement
    programs refuse them at solve time with the reference's messages,
    and the CA recurrences at construction.
    """

    _what = "torch-cg"

    def __init__(self, A: DeviceMatrix, pipelined: bool = False,
                 kernels: str = "auto", vector_dtype=None, device=None,
                 precise_dots: bool = False, replace_every: int = 0,
                 replace_restart: bool = True, precond=None, mstate=None,
                 algorithm=None, trace: int = 0, progress: int = 0):
        self.device = resolve_device(device)
        if A.device != self.device:
            raise ValueError(f"the matrix lives on {A.device}, the solver "
                             f"runs on {self.device}; build the matrix with "
                             f"device={str(self.device)!r}")
        self.A = A
        # classic/pipelined resolve onto the programs above; sstep:S and
        # pipelined:L dispatch the recurrences of acg_tpu_torch.recurrence
        from acg_tpu_torch.recurrence import parse_algorithm
        self.algo = parse_algorithm(algorithm)
        if self.algo is not None and not self.algo.communication_avoiding:
            pipelined = self.algo.kind == "pipelined"
            self.algo = None
        self._lam = None  # the (lmin, lmax) estimate, cached
        self.pipelined = pipelined
        self.vector_dtype = vector_dtype
        self.precise_dots = bool(precise_dots)
        self.replace_every = int(replace_every)
        self.replace_restart = bool(replace_restart)
        vdt = self._vector_dtype()
        if is_matrix_free(A) and vdt == torch.bfloat16:
            raise ValueError(
                "matrix-free operators generate their plane values in the "
                "storage dtype and have no matrix HBM traffic for bf16 to "
                "halve; use f32/f64 vectors (the assembled tiers keep the "
                "bf16 contract)")
        square_dia = isinstance(A, DiaMatrix) and A.ncols_padded == A.nrows
        on_cuda = self.device.type == "cuda"
        dia_ok = square_dia and (A.dtype, vdt) in K.DIA_SPMV_TYPES
        stencil_ok = (_stencil_kernel_ok(A) and vdt == A.dtype
                      and vdt in K.STENCIL_TYPES)
        if kernels == "auto":
            kernels = "pallas" if on_cuda and (dia_ok or stencil_ok) \
                else "xla"
        elif kernels == "pallas":
            if square_dia and not dia_ok:
                raise ValueError(f"kernels='pallas': no DIA kernel for "
                                 f"{A.dtype} planes with {vdt} vectors")
            if _stencil_kernel_ok(A) and not stencil_ok:
                raise ValueError(f"kernels='pallas': no stencil kernel for "
                                 f"a {A.dtype} operator with {vdt} vectors")
            if not on_cuda:
                kernels = "pallas-plain"
        elif kernels == "fused":
            if pipelined:
                raise ValueError("kernels='fused' implements classic CG "
                                 "on the single-device tier (use the "
                                 "pipelined variant with kernels="
                                 "'pallas'/'xla')")
            if self.precise_dots:
                raise ValueError("kernels='fused' accumulates its dots "
                                 "in plain f32 SMEM; compensated dots "
                                 "(precise_dots) need kernels='xla'/"
                                 "'pallas'")
            if not (square_dia and (A.dtype, vdt) in K.FUSED_TYPES
                    and K.fused_cg_route(A.offsets, A.nrows, vdt)
                    is not None):
                raise ValueError("kernels='fused' needs a square DIA "
                                 "matrix on the single-window kernel "
                                 "route (f32/bf16/mixed storage)")
            if not on_cuda:
                kernels = "fused-plain"
        if kernels not in ("xla", "pallas", "pallas-plain", "fused",
                           "fused-plain"):
            raise ValueError(f"unknown kernels choice {kernels!r}")
        if self.replace_every < 0:
            raise ValueError("replace_every must be >= 0 (a negative "
                             "period would compile a non-terminating "
                             "segment loop)")
        if self.replace_every:
            if vdt != torch.bfloat16:
                raise ValueError(
                    "replace_every is the bf16 tier's accuracy contract "
                    "(periodic f32 residual replacement); f32/f64 vector "
                    "storage has no replacement drift to correct -- use "
                    "precise_dots or a RefinedSolver there")
            if pipelined:
                raise ValueError("replace_every implements classic CG "
                                 "(the pipelined recurrence carries w=Ar, "
                                 "which replacement would invalidate)")
            if self.precise_dots:
                raise ValueError("replace_every computes its scalars in "
                                 "plain f32 (the bf16 tier's scalar "
                                 "path); precise_dots needs the direct "
                                 "programs")
            if kernels.startswith("fused"):
                raise ValueError("replace_every composes with "
                                 "kernels='xla'/'pallas' (the fused "
                                 "two-phase iteration has no replacement "
                                 "hook)")
        self.precond_spec = parse_precond(precond)
        if self.precond_spec is not None:
            if self.replace_every:
                raise ValueError(
                    "precond does not compose with replace_every: the "
                    "replacement segments restructure the recurrences "
                    "the preconditioner threads through (use the direct "
                    "classic/pipelined PCG programs)")
            if kernels.startswith("fused"):
                raise ValueError(
                    "kernels='fused' folds the whole iteration into two "
                    "streamed kernels and has no preconditioner hook; "
                    "precond needs kernels='xla'/'pallas'")
        if mstate is not None and self.precond_spec is None:
            raise ValueError("mstate is the state of a preconditioner; "
                             "pass precond too")
        if self.algo is not None:
            _refuse_ca(self.algo, pipelined, self.replace_every,
                       self.precise_dots, self.precond_spec, kernels, vdt)
            if self.algo.kind == "pl":
                # the square-root breakdown of the deep pipeline is
                # expected: it restarts from the current iterate
                from acg_tpu_torch.recurrence import PL_RESTART_BUDGET
                self.max_restarts = PL_RESTART_BUDGET
        self._mstate = None if mstate is None else tuple(mstate)
        self._check_telemetry(trace, progress)
        self.kernels = kernels
        self.stats = SolverStats(unknowns=A.nrows)
        self._spmv_flops_cache: float | None = None

    def _solver_name(self) -> str:
        """The telemetry and metrics label (the reference's)."""
        if self.algo is not None:
            return self.algo.solver_name("cg")
        return "cg-pipelined" if self.pipelined else "cg"

    @property
    def _spmv_flops(self) -> float:
        if self._spmv_flops_cache is None:
            self._spmv_flops_cache = spmv_flops(self.A)
        return self._spmv_flops_cache

    def _spmv_of(self):
        """The SpMV ``f(A, x)`` of this solver's programs."""
        return _spmv_fn(self.kernels)

    def _dot_setup(self, dtype, precise: bool = False):
        """``(dot, sdt)`` of this solver's programs (:func:`_scalar_setup`;
        the multi-process sharded tier folds the ranks' partials)."""
        return _scalar_setup(dtype, precise)

    def _vector_dtype(self):
        """The vector storage dtype: the matrix dtype unless
        ``vector_dtype`` overrides it."""
        if self.vector_dtype is not None:
            return self.vector_dtype
        return matrix_dtype(self.A)

    def _solve_dtype(self):
        """The dtype of a solve's b and x0: the vector dtype, except f32
        for the replacement program, whose outer iteration owns x in f32
        (rounding b to bf16 would bake a bf16-sized error into every
        replaced residual)."""
        if self.replace_every:
            return torch.float32
        return self._vector_dtype()

    def _ensure_precond_state(self):
        """The preconditioner state, built once at the first solve: the
        diagonal or the block factors from the matrix, or the Chebyshev
        interval from a power iteration through this solver's SpMV."""
        if self.precond_spec is None or self._mstate is not None:
            return self._mstate
        self._mstate = setup_single(self.precond_spec, self.A,
                                    self._spmv_of(),
                                    acc_dtype(self._solve_dtype()))
        return self._mstate

    def _ensure_lam(self):
        """The (lmin, lmax) interval of the Chebyshev s-step basis and
        the p(l) shifts, from one power iteration through this solver's
        own SpMV at the first solve; (0, 0) when the recurrence does not
        read it (``jax_cg.py:1450-1466``)."""
        if self._lam is None:
            from acg_tpu_torch.recurrence import estimate_lam
            if self.algo is not None and self.algo.needs_lam:
                spmv_ = self._spmv_of()
                self._lam = estimate_lam(
                    lambda v: spmv_(self.A, v), self.A.nrows,
                    acc_dtype(self._solve_dtype()), self.device)
            else:
                self._lam = (0.0, 0.0)
        return self._lam

    def _program(self, crit: StoppingCriteria):
        A, kernels = self.A, self.kernels
        if self.algo is not None:
            from acg_tpu_torch import recurrence as rec
            if crit.needs_diff:
                raise ValueError(
                    f"{self.algo} supports residual criteria only (the "
                    f"coefficient-space/pipelined updates carry no "
                    f"||dx|| scalar)")
            lam = self._ensure_lam()
            dot, sdt = self._dot_setup(self._solve_dtype())
            ops = rec.single_ops(A, self._spmv_of(), dot, sdt)
            algo = self.algo
            if algo.kind == "sstep":
                return lambda b, x0: rec._cg_sstep_program(
                    ops, b, x0, crit, algo.param, algo.basis, lam)
            return lambda b, x0: rec._cg_pl_program(ops, b, x0, crit,
                                                    algo.param, lam)
        if kernels.startswith("fused"):
            if crit.needs_diff:
                raise ValueError("kernels='fused' supports residual "
                                 "criteria only")
            self._refuse_telemetry(
                "kernels='fused' keeps its scalars in SMEM inside "
                "the two streamed kernels; convergence telemetry "
                "(trace/progress) needs kernels='xla'/'pallas'")
            return lambda b, x0: _cg_fused_program(A, b, x0, crit, kernels)
        spmv_ = self._spmv_of()

        def spmv(x):
            return spmv_(A, x)

        if self.replace_every:
            if crit.needs_diff:
                raise ValueError("replace_every supports residual "
                                 "criteria only (the diff criterion has "
                                 "no meaning across replacement segments)")
            self._refuse_telemetry(
                "convergence telemetry (trace/progress) does not "
                "reach the replacement-segment program "
                "(replace_every); use the direct classic/pipelined "
                "programs")
            dot, _ = self._dot_setup(torch.bfloat16)
            return lambda b, x0: _cg_replaced_program(
                spmv, dot, b, x0, crit, self.replace_every,
                self.replace_restart)
        dot, sdt = self._dot_setup(self._solve_dtype(), self.precise_dots)
        papply = None
        if self.precond_spec is not None:
            mstate = self._ensure_precond_state()
            apply = make_apply(self.precond_spec, spmv_)

            def papply(r):
                return apply(mstate, A, r)
        if self.pipelined and papply is not None:
            return lambda b, x0: _pcg_pipelined_program(
                spmv, dot, _dotk(dot), b, x0, crit, papply,
                self._telemetry(sdt))
        if self.pipelined:
            return lambda b, x0: _cg_pipelined_program(
                spmv, dot, _dotk(dot), b, x0, crit,
                not kernels.startswith("xla"), self._telemetry(sdt))
        return lambda b, x0: _cg_program(spmv, dot, b, x0, crit, papply,
                                         _dotk(dot), self._telemetry(sdt))

    def _to_device(self, v, dtype) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(device=self.device, dtype=dtype).reshape(-1)

    def device_args(self, b, x0=None):
        """``(b, x0)`` as vectors in the solve dtype on the solver's
        device (x0 = 0 when not given)."""
        dtype = self._solve_dtype()
        b = self._to_device(b, dtype)
        x0 = (torch.zeros_like(b) if x0 is None
              else self._to_device(x0, dtype))
        return b, x0

    def _account_ops(self, st, niter: int) -> None:
        """Analytic flop/byte census of ``niter`` iterations, as
        ``JaxCGSolver._account_ops`` bills the same configuration."""
        n = self.A.nrows
        dtype = self._solve_dtype()
        per_it = cg_flops_per_iteration(self._spmv_flops / 3.0, n,
                                        self.pipelined)
        st.nflops += per_it * niter + self._spmv_flops + 2.0 * n
        dbl = torch.empty((), dtype=dtype).element_size()
        mat_dbl = torch.empty((), dtype=matrix_dtype(self.A)).element_size()
        idx_b = matrix_index_bytes(self.A)
        mat_bytes = int((self._spmv_flops / 3.0) * (mat_dbl + idx_b))
        if self.replace_every:
            # inner vectors are bf16 whatever the (f32) outer dtype; each
            # segment adds one f32-vector replacement SpMV
            nseg = -(-niter // self.replace_every) if niter else 0
            st.nflops += self._spmv_flops * nseg
            vb = 2
            st.ops["gemv"].add(niter + nseg + 1, 0.0,
                               (mat_bytes + 2 * n * vb) * niter
                               + (mat_bytes + 2 * n * 4) * (nseg + 1))
            # carried-direction mode adds the (r, p) line-search dot per
            # iteration and a (p, p) check per segment
            ndot = (2 * niter if self.replace_restart
                    else 3 * niter + nseg)
            st.ops["dot"].add(ndot, 0.0, 2 * n * vb * ndot)
            st.ops["axpy"].add(3 * niter, 0.0, 3 * n * vb * 3 * niter)
            return
        if self.kernels.startswith("fused"):
            # phase A (planes + r/p windows + p/t writes) as gemv, phase B
            # (4 reads + 2 writes) as axpy; no vector is re-read for dots
            st.ops["gemv"].add(niter + 1, 0.0,
                               (mat_bytes + 4 * n * dbl) * (niter + 1))
            st.ops["axpy"].add(niter, 0.0, 6 * n * dbl * niter)
            return
        if self.algo is not None:
            # s-step runs (2s-1)/s SpMV-equivalents an iteration, p(l) one;
            # the block's Gram or the window matvec bills as dots, as the
            # reference bills them (jax_cg.py:2032-2051)
            from acg_tpu_torch.recurrence import reduction_schedule
            sched = reduction_schedule(self.algo, False)
            spmv_eq = sched["spmv_per_iteration"]
            st.nflops += self._spmv_flops * (spmv_eq - 1.0) * niter
            st.ops["gemv"].add(int(niter * spmv_eq) + 1, 0.0,
                               int((mat_bytes + 2 * n * dbl)
                                   * (niter * spmv_eq + 1)))
            wred = sched["allreduce_scalars"]
            ndot = max(int(niter * sched["allreduce_per_iteration"]), 1)
            st.ops["dot"].add(ndot, 0.0,
                              int(2 * n * dbl * wred ** 0.5 * ndot))
            st.ops["nrm2"].add(niter + 1, 0.0, n * dbl * (niter + 1))
            st.ops["axpy"].add(3 * niter, 0.0, 3 * n * dbl * 3 * niter)
            return
        st.ops["gemv"].add(niter + 1, 0.0,
                           (mat_bytes + 2 * n * dbl) * (niter + 1))
        st.ops["dot"].add(niter, 0.0, 2 * n * dbl * niter)
        st.ops["nrm2"].add(niter + 1, 0.0, n * dbl * (niter + 1))
        st.ops["axpy"].add(3 * niter, 0.0, 3 * n * dbl * 3 * niter)
        if not self.pipelined:
            st.ops["copy"].add(1, 0.0, 2 * n * dbl)
        if self.precond_spec is not None:
            _account_precond(st, self.precond_spec, self._mstate, niter, n,
                             dbl, self._spmv_flops,
                             mat_bytes + 2 * n * dbl)


def _refuse_ca(algo, pipelined: bool, replace_every: int,
               precise_dots: bool, precond_spec, kernels: str, vdt) -> None:
    """The options the communication-avoiding recurrences do not take,
    refused with the reference's messages (``jax_cg.py:1323-1394``):
    they run unpreconditioned over f32/f64 vectors with plain dots."""
    ca = str(algo)
    if pipelined:
        raise ValueError(
            f"--algorithm {ca} selects its own recurrence; it does not "
            f"compose with the pipelined flag (use --algorithm pipelined "
            f"for Ghysels-Vanroose)")
    if replace_every:
        raise ValueError(
            f"{ca} does not compose with replace_every (the replacement "
            f"segments restructure the recurrence)")
    if precise_dots:
        raise ValueError(
            f"{ca} accumulates its fused Gram/window reductions in the "
            f"scalar dtype; precise_dots composes with the "
            f"classic/pipelined programs")
    if precond_spec is not None:
        raise ValueError(
            f"{ca} runs unpreconditioned: the s-step basis and the p(l) "
            f"auxiliary basis have no M^-1 hook yet (use --algorithm "
            f"classic|pipelined with --precond)")
    if kernels.startswith("fused"):
        raise ValueError(
            f"{ca} needs kernels='xla'/'pallas' (the fused two-phase "
            f"iteration folds the classic recurrence)")
    if vdt == torch.bfloat16:
        raise ValueError(
            f"{ca} amplifies storage rounding through its basis products; "
            f"bf16 vectors need the classic/pipelined tiers "
            f"(replace_every is the bf16 contract)")


def _account_precond(st: SolverStats, spec, mstate, niter: int, n: int,
                     dbl: int, spmv_flops: float, spmv_bytes: float,
                     halo_bytes: int = 0) -> None:
    """The preconditioner's share of the census and the ``precond:``
    section (``jax_cg.py:2070-2106``; stacked parts: ``acg_tpu/parallel/
    dist.py:3003-3033``): niter + 1 applies (setup and one an
    iteration), cheby billing its degree-many SpMVs per apply (and on
    stacked parts their halo exchanges), and the (r, z) dot of each
    apply."""
    nappl = niter + 1
    per_apply_flops = flops_per_apply(spec, n, spmv_flops)
    st.nflops += per_apply_flops * nappl
    sb = state_bytes(mstate)
    per_apply_bytes = bytes_per_apply(spec, n, dbl, spmv_bytes, sb)
    nops = nappl * (spec.degree if spec.kind == "cheby" else 1)
    st.ops["precond"].add(nops, 0.0, int(per_apply_bytes * nappl))
    st.ops["dot"].add(nappl, 0.0, 2 * n * dbl * nappl)
    if spec.kind == "cheby" and halo_bytes:
        st.ops["halo"].add(spec.degree * nappl, 0.0,
                           halo_bytes * spec.degree * nappl)
    st.precond.update({"kind": str(spec), "applies": nappl,
                       "flops_per_apply": per_apply_flops,
                       "state_bytes": sb})
    from acg_tpu_torch import metrics
    metrics.record_precond(spec.kind, nops)
    if spec.kind == "cheby":
        st.precond["lambda_min"] = float(mstate[0].reshape(-1)[0])
        st.precond["lambda_max"] = float(mstate[1].reshape(-1)[0])

