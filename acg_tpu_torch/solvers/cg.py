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
* A :class:`LoopGuard` (the robustness tier) arms breakdown detection,
  the fault sites, the health audit and the checkpoint carry; the
  breakdown flag joins the convergence flag in ``live`` and in the one
  read a chunk.  :class:`ChunkedCGSolver` runs the recovery ladder and
  the checkpoint chunks; disarmed, the loops are as before.

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
import sys
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
    # the health tier's audit vector, if armed
    aud: object = None
    # the final loop carry of a state_io run (checkpoint.carry_names
    # order, without x)
    carry: object = None


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
    uses to freeze its state once converged.  A detecting loop also
    carries ``state.bad``, its breakdown flag, which joins ``done`` in
    ``live`` and in the read: no extra host read.  The host reads the
    flag once per :data:`CHUNK` iterations.  Unbounded solves run exactly
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
    detect = getattr(state, "bad", None) is not None

    def stop():
        return state.done | state.bad if detect else state.done

    ran = 0
    while ran < maxits:
        done = bool(stop())
        if beats:
            telem.flush()
        if done:
            break
        for _ in range(min(CHUNK, maxits - ran)):
            step(~stop())
        ran += CHUNK
    if beats:
        telem.flush()


class _State:
    """Mutable loop state of one program run (tensors rebound per step)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class LoopGuard:
    """What the robustness tier threads into one program run
    (``detect``/``fault``/``health``/``state_io``/``carry``/``k_offset``
    of ``acg_tpu.solvers.jax_cg._cg_program``).

    ``detect`` carries the breakdown flag; ``fault`` is a device-site
    :class:`~acg_tpu_torch.faults.FaultSpec` in the run's own iteration
    frame (the chunk drivers shift it); ``health`` a
    :class:`~acg_tpu_torch.health.HealthSpec` whose audit cadence is
    phased to trajectory iterations ``i + k_offset``; ``n`` the global
    row count (ABFT's scale); ``carry`` a loop carry in
    :func:`~acg_tpu_torch.checkpoint.carry_names` order (without x) that
    re-enters the recurrence exactly; ``state_io`` makes the run return
    its final carry.  The program marks its main SpMV with :meth:`at`,
    so a stacked SpMV poisons its received halo (:meth:`apply_halo`) at
    the armed iteration only -- setup, audit and preconditioner SpMVs
    never fire."""

    def __init__(self, detect: bool = False, fault=None, health=None,
                 n: int = 0, k_offset: int = 0, carry=None,
                 state_io: bool = False):
        self.detect = bool(detect)
        self.fault = fault
        self.health = health
        self.n = int(n)
        self.k_offset = int(k_offset)
        self.carry = carry
        self.state_io = bool(state_io)
        self._k = None
        self._live = None

    def at(self, k, live=None) -> None:
        """Mark the SpMV about to run as iteration ``k``'s (None: no
        iteration's)."""
        self._k, self._live = k, live

    def apply_halo(self, ghost):
        if self.fault is None:
            return ghost
        return self.fault.apply_halo(ghost, self._k, self._live)


def _guard_of(guard):
    """The guard of a run, or None when it arms nothing (the disarmed
    loop then runs exactly as without this tier)."""
    if guard is None:
        return None
    if not (guard.detect or guard.fault is not None
            or guard.health is not None or guard.carry is not None
            or guard.state_io):
        return None
    return guard


def _breakdown_guard(gamma, denom):
    """``(bad, alpha)``: the one breakdown predicate every detecting loop
    shares (``jax_cg.py:155-164``) -- non-finite gamma or denominator, or
    a non-positive denominator while progress remains -- and the guarded
    step size (a select, never a zeroed multiply: 0 * inf is NaN)."""
    bad = ((~(torch.isfinite(denom) & torch.isfinite(gamma)))
           | ((denom <= 0) & (gamma > 0)))
    return bad, torch.where(bad, 0.0, gamma / denom)


def _and_live(flag, live):
    return flag if live is None else flag & live


class _Health:
    """The health tier's per-run state: the audit vector, ABFT's column
    checksum ``c = A 1`` (one SpMV through the loop's own SpMV at setup)
    and the fused 3-dot, fed by the loops' steps."""

    def __init__(self, spec, spmv, dotk, b, sdt, n):
        from acg_tpu_torch import health as H
        self.H = H
        self.spec = spec
        self.sdt = sdt
        self.n = n
        self.aud = H.audit_init(sdt, spec, b.device)
        self.cvec = (spmv(torch.ones_like(b)).to(sdt) if spec.abft
                     else None)

        def dot3(a1, c1, a2, c2, a3, c3):
            return dotk((a1, c1), (a2, c2), (a3, c3))
        self.dot3 = dot3

    def audit(self, kk, compute_gap, live):
        self.aud, fire = self.H.audit_update(self.aud, self.spec, kk,
                                             compute_gap, live)
        return fire

    def stall(self, progressing, live):
        self.aud = self.H.stall_update(self.aud, self.spec, progressing,
                                       live)

    def abft(self, kk, y, x, live):
        if self.spec.abft:
            self.aud = self.H.abft_update(self.aud, self.spec, kk, y, x,
                                          self.cvec, self.dot3, self.sdt,
                                          self.n, live)

    def trip(self):
        return self.H.trip(self.aud, self.spec)

    def ring_gap(self, fire):
        return self.H.ring_gap(self.aud, fire, self.sdt)


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
                dotk=None, telem=None, guard=None) -> CGResult:
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
    ring records it (``jax_cg.py:453-463``).

    ``guard`` (a :class:`LoopGuard`) arms the robustness tier
    (``jax_cg.py:360-517``): the breakdown guard before the updates and
    x/r frozen by a select on a bad step, the deferred non-finite and
    sign flags, the fault sites after the SpMV, preconditioner apply and
    (p, Ap) dot, the audit and ABFT at trajectory iterations, and the
    loop carry in and out.  The breakdown flag joins the live flag; an
    unbounded detecting solve runs with live flags and no tolerance."""
    g = _guard_of(guard)
    detect = g is not None and g.detect
    fault = g.fault if g is not None else None
    dtype = b.dtype
    sdt = acc_dtype(dtype)
    dev = b.device
    needs_diff = crit.needs_diff
    unbounded = crit.unbounded and not detect
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    if g is not None and g.carry is not None:
        # resume: the carry IS the loop state; nothing is recomputed, so
        # the recurrence continues exactly
        if papply is None:
            r, p, gamma = g.carry
            rr = gamma
        else:
            r, p, gamma, rr = g.carry
    else:
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
               k=torch.zeros((), dtype=torch.int64, device=dev), i=0)
    s.done = (_converged(rr, inf, res_tol, diff_tol) if not unbounded
              else None)
    hl = None
    if g is not None and g.health is not None:
        hl = _Health(g.health, spmv, dotk or _dotk(dot), b, sdt, g.n)
    if detect:
        s.bad = torch.zeros((), dtype=torch.bool, device=dev)

    def step(live):
        i = s.i
        s.i += 1
        if g is not None:
            g.at(i, live)
        t = spmv(s.p)
        if g is not None:
            g.at(None)
        if fault is not None:
            t = fault.apply_spmv(t, i, live)
        pdott = dot(s.p, t)
        if fault is not None:
            pdott = fault.apply_dot(pdott, i, live)
        if detect:
            # breakdown BEFORE the updates: a non-finite t/pdott or an
            # indefiniteness signal must not reach x; the freeze is a
            # select on the live and breakdown flags, never a multiply
            bad, alpha = _breakdown_guard(s.gamma, pdott)
            go = _and_live(~bad, live)
            s.x = torch.where(go, (s.x.to(sdt) + alpha * s.p.to(sdt))
                              .to(dtype), s.x)
            r = torch.where(go, (s.r.to(sdt) - alpha * t.to(sdt))
                            .to(dtype), s.r)
        else:
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
            if fault is not None:
                z = fault.apply_precond(z, i, live)
            gamma_next, rr_next = dotk((r, z), (r, r))
        beta = gamma_next / s.gamma
        p_next = (z.to(sdt) + beta * s.p.to(sdt)).to(dtype)
        dx = alpha * alpha * dot(s.p, s.p) if needs_diff else inf
        if detect and needs_diff:
            # a zeroed alpha must not fake the diff criterion
            dx = torch.where(bad, s.dx, dx)
        fire = False
        if hl is not None:
            kk = i + g.k_offset
            x_now, r_now = s.x, r
            fire = hl.audit(kk, lambda: _health_gap(b, spmv, x_now, r_now,
                                                    dot, bnrm2, sdt), live)
            if papply is None:
                hl.stall(gamma_next < s.gamma, live)
            else:
                hl.stall(rr_next < s.rr, live)
            # Huang-Abraham checksum of this iteration's t = A p
            hl.abft(kk, t, s.p, live)
        if detect:
            # a poison that slipped past pdott lands in r: flagged one
            # iteration deferred; a negative (r, z) is the non-SPD-M
            # signal, a negative (r, r) under the health tier poison
            deferred = bad | (~torch.isfinite(gamma_next))
            if papply is not None or hl is not None:
                deferred = deferred | (gamma_next < 0)
            if hl is not None:
                tr = hl.trip()
                if tr is not None:
                    deferred = deferred | tr
            s.bad = s.bad | _and_live(deferred, live)
        s.r = r
        if telem is not None:
            telem.step(s.k, live, gamma_next, alpha, beta, pdott,
                       gap=hl.ring_gap(fire) if hl is not None else None)
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
        if not crit.unbounded:
            # an unbounded detecting loop has no tolerance to test
            s.done = s.done | _converged(s.rr, s.dx, res_tol, diff_tol)

    _iterate(step, crit.maxits, unbounded, s, telem)
    if unbounded:
        k = torch.tensor(crit.maxits, device=dev)
        done = torch.tensor(True, device=dev)
    else:
        k = s.k
        # an unbounded detecting solve "converges" by running its budget
        # without a breakdown
        done = ~s.bad if crit.unbounded else s.done
    breakdown = (s.bad & ~done if detect
                 else torch.tensor(False, device=dev))
    res = CGResult(x=s.x, niterations=k, rnrm2=torch.sqrt(s.rr),
                   r0nrm2=r0nrm2, bnrm2=bnrm2, x0nrm2=x0nrm2,
                   dxnrm2=torch.sqrt(s.dx), converged=done,
                   breakdown=breakdown, telem=telem)
    if hl is not None:
        res.aud = hl.aud
    if g is not None and g.state_io:
        res.carry = ((s.r, s.p, s.gamma) if papply is None
                     else (s.r, s.p, s.gamma, s.rr))
    return res


def _health_gap(b, spmv, x, r, dot, bnrm2, sdt):
    """The audit's relative gap ``||(b - A x) - r|| / ||b||`` through the
    loop's own SpMV (kernel K1 on DIA matrices)."""
    from acg_tpu_torch.health import relative_gap
    return relative_gap(b - spmv(x), r, dot, bnrm2, sdt)


def _cg_pipelined_program(spmv, dot, dotk, b, x0, crit: StoppingCriteria,
                          use_kernel: bool, telem=None,
                          guard=None) -> CGResult:
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
    (``jax_cg.py:1004-1013``).

    ``guard`` arms the robustness tier as in :func:`_cg_program`
    (``jax_cg.py:925-1000``): the alpha denominator plays (p, Ap)'s
    role, and a bad step keeps x/r/w -- K5 takes the breakdown flag and
    writes their old values back itself; the fault sites are q = A w
    and the (w, r) dot, ABFT checks q against the pre-update w."""
    g = _guard_of(guard)
    detect = g is not None and g.detect
    fault = g.fault if g is not None else None
    dtype = b.dtype
    sdt = acc_dtype(dtype)
    dev = b.device
    needs_diff = crit.needs_diff
    unbounded = crit.unbounded and not detect
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    inf = torch.tensor(math.inf, dtype=sdt, device=dev)
    if g is not None and g.carry is not None:
        # resume: the carried vectors (w = A r and the z/t/p scratch the
        # recurrence never rebuilds) replace the whole setup; separate
        # buffers, since K5 updates them in place
        r, w, p, t, z, gamma_c, alpha_c = g.carry
        r0nrm2 = torch.sqrt(torch.clamp(gamma_c, min=0))
        s = _State(x=x0.clone(), r=r.clone(), w=w.clone(), p=p.clone(),
                   t=t.clone(), z=z.clone(), gamma_prev=gamma_c,
                   alpha_prev=alpha_c, dx=inf)
    else:
        r = b - spmv(x0)
        w = spmv(r)
        r0nrm2 = torch.sqrt(dot(r, r))
        # separate buffers: K5 updates all six vectors in place
        s = _State(x=x0.clone(), r=r, w=w, p=torch.zeros_like(b),
                   t=torch.zeros_like(b), z=torch.zeros_like(b),
                   gamma_prev=inf, alpha_prev=inf, dx=inf)
    s.k = torch.zeros((), dtype=torch.int64, device=dev)
    s.i = 0
    res_tol, diff_tol = _tolerances(crit, r0nrm2, x0nrm2, sdt)
    # an already-converged start (r0 = 0) returns x0 in 0 iterations
    s.done = (_converged(r0nrm2 * r0nrm2, inf, res_tol, diff_tol)
              if not unbounded else None)
    hl = None
    if g is not None and g.health is not None:
        hl = _Health(g.health, spmv, dotk, b, sdt, g.n)
    if detect:
        s.bad = torch.zeros((), dtype=torch.bool, device=dev)

    def step(live):
        i = s.i
        s.i += 1
        gamma, delta = dotk((s.r, s.r), (s.w, s.r))
        if fault is not None:
            delta = fault.apply_dot(delta, i, live)
        if g is not None:
            g.at(i, live)
        q = spmv(s.w)
        if g is not None:
            g.at(None)
        if fault is not None:
            q = fault.apply_spmv(q, i, live)
        beta = gamma / s.gamma_prev             # inf -> 0 on first iteration
        denom = delta - beta * (gamma / s.alpha_prev)
        bad = None
        if detect:
            bad, alpha = _breakdown_guard(gamma, denom)
            if hl is not None:
                # a negative computed (r, r) is arithmetic poison
                bad = bad | (gamma < 0)
                alpha = torch.where(bad, torch.zeros_like(alpha), alpha)
        else:
            alpha = gamma / denom
        fire = False
        if hl is not None:
            kk = i + g.k_offset
            # checksum of this iteration's q = A w, before K5 rebinds w
            hl.abft(kk, q, s.w, live)
        vecs = (s.x, s.r, s.w, s.p, s.t, s.z)
        if use_kernel:
            K.pipelined_update(*(v.view(-1) for v in vecs), q.view(-1),
                               alpha, beta, live=live, bad=bad)
        else:
            new = K.pipelined_update_plain(*vecs, q, alpha, beta, bad)
            if live is not None:
                new = tuple(torch.where(live, nv, old)
                            for nv, old in zip(new, vecs))
            s.x, s.r, s.w, s.p, s.t, s.z = new
        dx = alpha * alpha * dot(s.p, s.p) if needs_diff else inf
        if detect and needs_diff:
            dx = torch.where(bad, s.dx, dx)
        if hl is not None:
            x_now, r_now = s.x, s.r
            fire = hl.audit(kk, lambda: _health_gap(b, spmv, x_now, r_now,
                                                    dot, bnrm2, sdt), live)
            hl.stall(gamma < s.gamma_prev, live)
        if detect:
            flag = bad
            if hl is not None:
                tr = hl.trip()
                if tr is not None:
                    flag = flag | tr
            s.bad = s.bad | _and_live(flag, live)
        if telem is not None:
            telem.step(s.k, live, gamma, alpha, beta, denom,
                       gap=hl.ring_gap(fire) if hl is not None else None)
        if live is None:
            s.gamma_prev, s.alpha_prev, s.dx = gamma, alpha, dx
            return
        s.gamma_prev = torch.where(live, gamma, s.gamma_prev)
        s.alpha_prev = torch.where(live, alpha, s.alpha_prev)
        s.dx = torch.where(live, dx, s.dx)
        s.k = s.k + live.to(torch.int64)
        if not crit.unbounded:
            s.done = s.done | _converged(s.gamma_prev, s.dx, res_tol,
                                         diff_tol)

    _iterate(step, crit.maxits, unbounded, s, telem)
    rnrm2 = torch.sqrt(dot(s.r, s.r))
    if unbounded:
        k = torch.tensor(crit.maxits, device=dev)
        done = torch.tensor(True, device=dev)
    elif crit.unbounded:
        k = s.k
        done = ~s.bad
    else:
        k = s.k
        # the in-loop test is one iteration stale: a final fresh residual
        # that meets the tolerance is convergence
        done = s.done | (rnrm2 <= res_tol)
    breakdown = (s.bad & ~done if detect
                 else torch.tensor(False, device=dev))
    res = CGResult(x=s.x, niterations=k, rnrm2=rnrm2, r0nrm2=r0nrm2,
                   bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=torch.sqrt(s.dx),
                   converged=done, breakdown=breakdown, telem=telem)
    if hl is not None:
        res.aud = hl.aud
    if g is not None and g.state_io:
        res.carry = (s.r, s.w, s.p, s.t, s.z, s.gamma_prev, s.alpha_prev)
    return res


def _pcg_pipelined_program(spmv, dot, dotk, b, x0, crit: StoppingCriteria,
                           papply, telem=None, guard=None) -> CGResult:
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
    alpha denominator (``jax_cg.py:913-922``).  ``guard`` as in
    :func:`_cg_program`: a negative (r, u) also flags a breakdown (the
    non-SPD-M signal); the fault sites are n = A m, m = M^-1 w and the
    (w, u) dot."""
    g = _guard_of(guard)
    detect = g is not None and g.detect
    fault = g.fault if g is not None else None
    dtype = b.dtype
    sdt = acc_dtype(dtype)
    dev = b.device
    needs_diff = crit.needs_diff
    unbounded = crit.unbounded and not detect
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    inf = torch.tensor(math.inf, dtype=sdt, device=dev)
    if g is not None and g.carry is not None:
        (r, u0, w, p0, sv0, q0, z0, gamma_c, alpha_c, rr0) = g.carry
    else:
        r = b - spmv(x0)
        u0 = papply(r).to(dtype)
        w = spmv(u0)
        rr0 = dot(r, r)
        zeros = torch.zeros_like(b)
        p0 = sv0 = q0 = z0 = zeros
        gamma_c = alpha_c = inf
    r0nrm2 = torch.sqrt(rr0)
    res_tol, diff_tol = _tolerances(crit, r0nrm2, x0nrm2, sdt)
    s = _State(x=x0, r=r, u=u0, w=w, p=p0, s=sv0, q=q0, z=z0,
               gamma_prev=gamma_c, alpha_prev=alpha_c, rr=rr0, dx=inf,
               k=torch.zeros((), dtype=torch.int64, device=dev), i=0)
    # an already-converged start (r0 = 0) returns x0 in 0 iterations
    s.done = (_converged(rr0, inf, res_tol, diff_tol) if not unbounded
              else None)
    hl = None
    if g is not None and g.health is not None:
        hl = _Health(g.health, spmv, dotk, b, sdt, g.n)
    if detect:
        s.bad = torch.zeros((), dtype=torch.bool, device=dev)

    def store(v):
        return v.to(dtype)

    def step(live):
        i = s.i
        s.i += 1
        gamma, delta, rr = dotk((s.r, s.u), (s.w, s.u), (s.r, s.r))
        if fault is not None:
            delta = fault.apply_dot(delta, i, live)
        m = papply(s.w)
        if fault is not None:
            m = fault.apply_precond(m, i, live)
        if g is not None:
            g.at(i, live)
        nvec = spmv(m)
        if g is not None:
            g.at(None)
        if fault is not None:
            nvec = fault.apply_spmv(nvec, i, live)
        beta = gamma / s.gamma_prev             # inf -> 0 on first iteration
        denom = delta - beta * (gamma / s.alpha_prev)
        if detect:
            bad, alpha = _breakdown_guard(gamma, denom)
            # a negative (r, u) is the non-SPD-M signal
            bad = bad | (gamma < 0)
            alpha = torch.where(bad, torch.zeros_like(alpha), alpha)
        else:
            alpha = gamma / denom
        z = store(nvec.to(sdt) + beta * s.z.to(sdt))
        q = store(m.to(sdt) + beta * s.q.to(sdt))
        sv = store(s.w.to(sdt) + beta * s.s.to(sdt))
        p = store(s.u.to(sdt) + beta * s.p.to(sdt))
        new = [store(s.x.to(sdt) + alpha * p.to(sdt)),
               store(s.r.to(sdt) - alpha * sv.to(sdt)),
               store(s.u.to(sdt) - alpha * q.to(sdt)),
               store(s.w.to(sdt) - alpha * z.to(sdt)), p, sv, q, z]
        if detect:
            new[:4] = [torch.where(bad, old, nv) for nv, old in
                       zip(new[:4], (s.x, s.r, s.u, s.w))]
        dx = alpha * alpha * dot(p, p) if needs_diff else inf
        if detect and needs_diff:
            dx = torch.where(bad, s.dx, dx)
        fire = False
        if hl is not None:
            kk = i + g.k_offset
            x_now, r_now = new[0], new[1]
            fire = hl.audit(kk, lambda: _health_gap(b, spmv, x_now, r_now,
                                                    dot, bnrm2, sdt), live)
            hl.stall(rr < s.rr, live)
            # checksum of this iteration's n = A m
            hl.abft(kk, nvec, m, live)
        if detect:
            flag = bad
            if hl is not None:
                tr = hl.trip()
                if tr is not None:
                    flag = flag | tr
            s.bad = s.bad | _and_live(flag, live)
        if telem is not None:
            telem.step(s.k, live, gamma, alpha, beta, denom,
                       gap=hl.ring_gap(fire) if hl is not None else None)
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
        if not crit.unbounded:
            # an unbounded detecting loop has no tolerance to test
            s.done = s.done | _converged(s.rr, s.dx, res_tol, diff_tol)

    _iterate(step, crit.maxits, unbounded, s, telem)
    rnrm2 = torch.sqrt(dot(s.r, s.r))
    if unbounded:
        k = torch.tensor(crit.maxits, device=dev)
        done = torch.tensor(True, device=dev)
    elif crit.unbounded:
        k = s.k
        done = ~s.bad
    else:
        k = s.k
        done = s.done | (rnrm2 <= res_tol)
    breakdown = (s.bad & ~done if detect
                 else torch.tensor(False, device=dev))
    res = CGResult(x=s.x, niterations=k, rnrm2=rnrm2, r0nrm2=r0nrm2,
                   bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=torch.sqrt(s.dx),
                   converged=done, breakdown=breakdown, telem=telem)
    if hl is not None:
        res.aud = hl.aud
    if g is not None and g.state_io:
        res.carry = (s.r, s.u, s.w, s.p, s.s, s.q, s.z, s.gamma_prev,
                     s.alpha_prev, s.rr)
    return res


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
    provides ``_program(crit)`` (a callable ``run(b, x0, guard=None)`` of
    the device ``(b, x0)`` returning a :class:`CGResult`),
    ``device_args(b, x0)``, ``_host_x(x)`` (the host array the caller
    gets), ``_account_ops(st, niter)`` and ``_solver_name()``.

    ``trace`` (ring slots) and ``progress`` (heartbeat period) arm the
    in-loop telemetry of the programs that take a :meth:`_telemetry`;
    the solve then fetches the ring once, into ``self.last_trace`` and
    ``stats.trace``.  Warm-up solves run the ring but print no
    heartbeat.

    The robustness tier (``jax_cg.py:1712-1986``, ``:2123``): ``recovery``
    (a :class:`~acg_tpu_torch.solvers.resilience.RecoveryPolicy`), an
    armed fault injector or a tripping ``health_spec`` make the loop
    detect breakdowns; the host ladder then restarts (with backoff),
    retires the dma transport (:meth:`_transport_rung`, stacked parts)
    and falls back to the host oracle (:meth:`_host_fallback`).
    ``ckpt`` (a :class:`~acg_tpu_torch.checkpoint.CheckpointConfig`)
    routes the solve through :meth:`_solve_ckpt`: the same loops in
    chunks of ``ckpt.every`` iterations, a snapshot between chunks, and
    the rollback rung first."""

    recovery = None       # a RecoveryPolicy arms detection and the ladder
    health_spec = None
    ckpt = None
    host_matrix = None    # scipy CSR: arms the host-fallback rung
    _what = "cg"      # the tier's name in recovery events
    _beat_name = "cg"     # the tier's name on heartbeat lines
    _ckpt_tier = "jax-cg"  # the snapshot's tier (the reference's names)
    trace = 0
    progress = 0
    last_trace = None
    _warming = False
    algo = None

    def _host_x(self, x: np.ndarray) -> np.ndarray:
        return x

    def _solver_name(self) -> str:
        return "cg"

    @property
    def max_restarts(self):
        """The restart budget of the armed recovery policy (None: no
        restart loop)."""
        return None if self.recovery is None else self.recovery.max_restarts

    def _telemetry(self, sdt):
        """A fresh :class:`~acg_tpu_torch.telemetry.LoopTelemetry` for
        one program run in scalar dtype ``sdt``, or None disarmed.  The
        heartbeat prints from the first process only, and not during
        warm-up solves; the ring grows the audit column when the health
        tier audits."""
        if not (self.trace or self.progress):
            return None
        from acg_tpu_torch.parallel import multihost
        hs = self.health_spec
        return telemetry.LoopTelemetry(
            self.trace, 0 if self._warming else self.progress, sdt,
            self.device, what=self._beat_name,
            leader=multihost.is_primary(),
            audit=hs is not None and hs.every > 0)

    def _check_telemetry(self, trace: int, progress: int) -> None:
        """Validate and keep ``trace``/``progress`` (iteration counts; 0
        disables)."""
        self.trace, self.progress = int(trace), int(progress)
        if self.trace < 0 or self.progress < 0:
            raise ValueError("trace/progress must be >= 0 (iteration "
                             "counts; 0 disables)")

    def _refuse_telemetry(self, what: str) -> None:
        """The reference's refusal of in-loop telemetry on a program
        that has no hook for it (``jax_cg.py:1524-1534,1566-1571``)."""
        if self.trace or self.progress:
            raise AcgError(ErrorCode.INVALID_VALUE, what)

    # -- the robustness tier ------------------------------------------------

    def _check_robustness(self, recovery, health, ckpt, host_matrix,
                          fused: bool, replace_every: int) -> None:
        """Validate and keep ``recovery``/``health``/``ckpt``, with the
        reference's refusals (``jax_cg.py:1274-1394``); the CA
        recurrences' hooks are the next slice's and refuse by name."""
        from acg_tpu_torch.checkpoint import CheckpointConfig
        from acg_tpu_torch.health import HealthSpec
        from acg_tpu_torch.solvers.resilience import RecoveryPolicy
        if recovery is not None and not isinstance(recovery,
                                                   RecoveryPolicy):
            raise ValueError("recovery must be an acg_tpu_torch.solvers."
                             "resilience.RecoveryPolicy or None")
        if health is not None:
            if not isinstance(health, HealthSpec):
                raise ValueError("health must be an "
                                 "acg_tpu_torch.health.HealthSpec or None")
            if not health.armed:
                health = None
        if health is not None:
            if replace_every:
                raise ValueError(
                    "the true-residual audit (health) does not compose "
                    "with replace_every: the replacement segments "
                    "already recompute b - A x every K iterations -- "
                    "the audit would measure its own mechanism")
            if fused:
                raise ValueError(
                    "kernels='fused' folds the whole iteration into "
                    "two streamed kernels and has no audit hook; the "
                    "health tier needs kernels='xla'/'pallas'")
        if ckpt is not None:
            if not isinstance(ckpt, CheckpointConfig):
                raise ValueError("ckpt must be an acg_tpu_torch."
                                 "checkpoint.CheckpointConfig or None")
            if replace_every:
                raise ValueError(
                    "checkpointing (ckpt) does not compose with "
                    "replace_every: the replacement segments' inner "
                    "state never leaves the program (use the direct "
                    "classic/pipelined programs)")
            if fused:
                raise ValueError(
                    "kernels='fused' folds the whole iteration into "
                    "two streamed kernels and exposes no loop carry; "
                    "checkpointing needs kernels='xla'/'pallas'")
        if self.algo is not None:
            for on, what in ((health is not None, "the health audit "
                              "(health)"),
                             (ckpt is not None, "checkpoints (ckpt)")):
                if on:
                    raise ValueError(
                        f"{self.algo}: {what} of the communication-"
                        f"avoiding recurrences is not ported yet; use "
                        f"--algorithm classic|pipelined")
        self.recovery = recovery
        if (self.algo is not None and self.algo.kind == "pl"
                and recovery is None):
            # the square-root breakdown of the deep pipeline is an
            # expected event: it restarts from the current iterate
            from acg_tpu_torch.recurrence import pl_restart_policy
            self.recovery = pl_restart_policy()
        self.health_spec = health
        self.ckpt = ckpt
        self.host_matrix = host_matrix

    def _detect(self, fault) -> bool:
        """Whether the loop carries the breakdown flag: recovery armed,
        an active injector, or a health spec whose detectors trip."""
        return (self.recovery is not None or fault is not None
                or (self.health_spec is not None
                    and self.health_spec.arms_detect))

    def _fault_refusals(self, fault) -> None:
        """Armed-injector configurations this tier can never fire
        (``jax_cg.py:1638-1710``): refuse instead of reporting a clean
        fault-tested solve."""
        from acg_tpu_torch import faults
        spec = faults.active_fault()
        if (spec is not None and spec.site == "crash"
                and (self.ckpt is None or self.ckpt.path is None)):
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "crash:exit fires from the checkpoint chunk driver "
                "between snapshots; arm --ckpt FILE --ckpt-every K "
                "(a crash with no snapshot to resume from proves "
                "nothing)")
        if fault is None:
            return
        if self.algo is not None:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"fault injection into the communication-avoiding "
                f"recurrences ({self.algo}) is not ported yet; use "
                f"--algorithm classic|pipelined")
        if getattr(self, "replace_every", 0):
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "fault injection does not reach the replacement-"
                "segment program (replace_every); inject into the "
                "direct classic/pipelined programs instead")
        if fault.site == "precond" and self.precond_spec is None:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "precond fault injection needs an armed preconditioner "
                "(--precond jacobi|bjacobi|cheby:K); this solve runs "
                "unpreconditioned CG")
        self._tier_fault_refusals(fault)

    def _tier_fault_refusals(self, fault) -> None:
        """The single-device tier's refusals: no halo, only part 0."""
        if fault.site == "halo":
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "halo fault injection needs a distributed problem with "
                "ghost exchange (DistCGSolver, nparts > 1); the "
                "single-device solver has no halo to poison")
        if fault.part > 0:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"fault spec targets part {fault.part}, but the "
                f"single-device solver has only part 0 -- the fault "
                f"could never fire")

    def _refuse_detect_tier(self, detect: bool) -> None:
        """The fused two-phase iteration has no breakdown hook."""
        if detect and self.kernels.startswith("fused") \
                and self.algo is None:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "kernels='fused' folds its scalars into the two streamed "
                "kernels and has no breakdown-detection hook; recovery/"
                "fault injection need kernels='xla'/'pallas'")

    def _n_global(self) -> int:
        return int(self.stats.unknowns)

    def _guard(self, fault, detect: bool, k_offset: int = 0, carry=None,
               state_io: bool = False):
        return LoopGuard(detect=detect, fault=fault,
                         health=self.health_spec, n=self._n_global(),
                         k_offset=k_offset, carry=carry,
                         state_io=state_io)

    def _transport_rung(self, driver) -> bool:
        """The stacked tier's transport fallback; none here."""
        return False

    def _host_fallback(self, b_host, crit, raise_on_divergence: bool,
                       host_result: bool):
        """The last recovery rung (``jax_cg.py:2102-2121``): re-solve on
        the host reference solver (f64 numpy) from the original b, with
        the injector suppressed; the last solve's stats are the host
        run's."""
        from acg_tpu_torch import faults
        from acg_tpu_torch.solvers.host_cg import HostCGSolver
        from acg_tpu_torch.solvers.resilience import adopt_host_stats
        hs = HostCGSolver(self.host_matrix)
        with faults.suppressed():
            x = hs.solve(np.asarray(b_host, np.float64), criteria=crit,
                         raise_on_divergence=raise_on_divergence)
        adopt_host_stats(self.stats, hs.stats)
        return x if host_result else torch.from_numpy(x).to(self.device)

    def _can_host_fallback(self) -> bool:
        return self.host_matrix is not None

    def _host_rung(self) -> bool:
        """Whether the host rung may take a breakdown the restarts did not
        cure.  It re-solves on the CPU, so it runs for a solver on the
        CPU only: on the card the solve raises instead, and a kernel
        that keeps failing never ends in a host-solved answer."""
        pol = self.recovery
        return (pol is not None and pol.fallback_host
                and self.device.type == "cpu" and self._can_host_fallback())

    def _finish_x(self, res, host_result: bool):
        st = self.stats
        if host_result:
            xv = res.x.to(torch.float32) if res.x.dtype == torch.bfloat16 \
                else res.x
            x = self._host_x(xv.cpu().numpy())
            st.fexcept_arrays = [x]
            return x
        x = res.x
        has_nan = bool(torch.isnan(x).any())
        has_inf = bool(torch.isinf(x).any())
        st.fexcept_arrays = [np.asarray([np.nan if has_nan else 0.0,
                                         np.inf if has_inf else 0.0])]
        return x

    def _note_audit(self, res, fresh: bool) -> bool:
        from acg_tpu_torch import health as health_mod
        return health_mod.note_audit(self.stats, res.aud.cpu().numpy(),
                                     self.health_spec, self._what,
                                     fresh=fresh)

    def _gap_error(self, niter: int, restarts: bool = True):
        from acg_tpu_torch.errors import BreakdownError
        hs = self.health_spec
        st = self.stats
        tail = (f"; {st.nrestarts} restart(s) exhausted and no fallback "
                f"available" if restarts else "")
        return BreakdownError(
            f"{self._what}: true-residual gap "
            f"{st.health.get('gap_max', 0.0):.3e} exceeds threshold "
            f"{hs.threshold:g} at iteration {niter} (--on-gap "
            f"{hs.action}){tail}")

    def _shift_fault(self, fault, k_done: int):
        """The fault as a restarted solve sees it: a fired one vanishes
        (``FaultSpec.shift``)."""
        return fault.shift(k_done) if fault is not None else None

    def _attempt_trace(self, res):
        if res.telem is None or res.telem.buf is None:
            return None
        return telemetry.ConvergenceTrace.from_ring(
            res.telem.ring(), int(res.niterations),
            solver=self._solver_name())

    def solve(self, b, x0=None, criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True, warmup: int = 0,
              host_result: bool = True):
        """Solve Ax=b.  Returns x as a numpy array (bf16 solves as f32),
        or the device tensor with ``host_result=False``.  ``warmup``
        solves run first, outside the timed region; the timed solve is
        bracketed by device synchronisations (and, while a profiler
        runs, by ``acg:compile``/``acg:solve`` annotations).  An armed
        ``ckpt`` routes through :meth:`_solve_ckpt`."""
        if self.ckpt is not None:
            return self._solve_ckpt(b, x0=x0, criteria=criteria,
                                    raise_on_divergence=raise_on_divergence,
                                    warmup=warmup, host_result=host_result)
        from acg_tpu_torch import faults
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        fault = faults.device_fault()
        self._fault_refusals(fault)
        detect = self._detect(fault)
        self._refuse_detect_tier(detect)
        if fault is not None:
            telemetry.record_event(st, "fault-armed",
                                   f"{fault.site}:{fault.mode}"
                                   f"@{fault.iteration}")
        program = self._program(crit)
        armed = detect or self.health_spec is not None

        def run(program, b, x0, fault):
            if not armed:
                return program(b, x0)
            return program(b, x0, guard=self._guard(fault, detect))

        b_host = b
        t_xfer = time.perf_counter()
        b, x0 = self.device_args(b, x0)
        device_sync(self.device)
        telemetry.add_timing(st, "transfer", time.perf_counter() - t_xfer)
        t_warm = time.perf_counter()
        with telemetry.annotate("compile"):
            self._warming = True
            try:
                for _ in range(max(warmup, 0)):
                    run(program, b, x0, fault)
                device_sync(self.device)
            finally:
                self._warming = False
        if warmup > 0:
            telemetry.add_timing(st, "compile", time.perf_counter() - t_warm)
        t0 = time.perf_counter()
        with telemetry.annotate("solve"):
            res = run(program, b, x0, fault)
            device_sync(self.device)
        niter = int(res.niterations)
        # the norms of the first attempt are the solve's, restarts or not
        norms = (float(res.bnrm2), float(res.x0nrm2), float(res.r0nrm2))
        aud_fresh = True
        if detect and bool(res.breakdown):
            from acg_tpu_torch.solvers.resilience import RecoveryDriver
            driver = RecoveryDriver(self.recovery, st, self._what)
            # restarts keep the FIRST attempt's residual target
            abs_tol = max(crit.residual_atol,
                          crit.residual_rtol * float(res.r0nrm2))
            gap_tripped = False
            while bool(res.breakdown):
                k_done = int(res.niterations)
                if self.health_spec is not None and res.aud is not None:
                    gap_tripped = self._note_audit(res, aud_fresh)
                    aud_fresh = False
                if res.telem is not None and res.telem.buf is not None:
                    # the trajectory that led INTO the breakdown
                    st.trace = self.last_trace = self._attempt_trace(res)
                    driver.log_trace_window(st.trace)
                if gap_tripped and self.health_spec.action == "abort":
                    st.tsolve += time.perf_counter() - t0
                    st.converged = False
                    raise self._gap_error(niter, restarts=False)
                rung = self._transport_rung(driver)
                if rung or driver.on_breakdown(k_done):
                    x_next = res.x
                    if not bool(torch.isfinite(x_next).all()):
                        driver.record("iterate non-finite; restarting "
                                      "from the initial guess")
                        x_next = x0
                    fault = self._shift_fault(fault, k_done)
                    if not rung and self.precond_spec is not None:
                        from acg_tpu_torch.precond import refresh_state
                        refresh_state(self, driver)
                    program = self._program(StoppingCriteria(
                        maxits=max(crit.maxits - niter, 1),
                        residual_atol=abs_tol, residual_rtol=0.0,
                        diff_atol=crit.diff_atol,
                        diff_rtol=crit.diff_rtol))
                    res = run(program, b, x_next, fault)
                    device_sync(self.device)
                    niter += int(res.niterations)
                    continue
                if self._host_rung():
                    driver.on_fallback(self._host_fallback_event)
                    st.tsolve += time.perf_counter() - t0
                    return self._host_fallback(b_host, crit,
                                               raise_on_divergence,
                                               host_result)
                st.tsolve += time.perf_counter() - t0
                st.converged = False
                if gap_tripped:
                    raise self._gap_error(niter)
                raise driver.give_up(niter, float(res.rnrm2))
        t_solve = time.perf_counter() - t0
        st.tsolve += t_solve
        telemetry.add_timing(st, "solve", t_solve)
        if res.telem is not None and res.telem.buf is not None:
            # the one extra device fetch of a traced solve
            st.trace = self.last_trace = self._attempt_trace(res)
        st.nsolves += 1
        st.niterations = niter
        st.ntotaliterations += niter
        st.bnrm2, st.x0nrm2, st.r0nrm2 = norms
        st.rnrm2 = float(res.rnrm2)
        st.dxnrm2 = float(res.dxnrm2)
        st.converged = bool(res.converged) or crit.unbounded
        if self.health_spec is not None and res.aud is not None:
            self._note_audit(res, aud_fresh)
        from acg_tpu_torch import metrics
        metrics.record_solve(t_solve, niter, st.converged,
                             solver=self._solver_name())
        self._account_ops(st, niter)
        x = self._finish_x(res, host_result)
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{niter} iterations, residual {st.rnrm2:.3e}")
        return x

    _host_fallback_event = "fallback: host reference solver"

    # -- the survivability tier: the checkpoint-chunked solve ---------------

    def _carry_names(self) -> tuple:
        from acg_tpu_torch.checkpoint import carry_names
        return carry_names(self.pipelined, self.precond_spec is not None)

    def _ckpt_meta_extra(self, meta: dict, arrs: dict) -> None:
        """Tier additions to a snapshot (the stacked tier's nparts and
        row-permutation sidecar)."""

    def _resume_arrays(self, snap):
        """A validated snapshot's arrays in this tier's layout (the
        repartitioned one reassembled and re-sliced)."""
        return snap.arrays

    def _to_dev(self, a, name: str, sdt):
        from acg_tpu_torch.checkpoint import SCALAR_LEAVES
        a = np.asarray(a)
        if name in SCALAR_LEAVES:
            return torch.tensor(a, dtype=sdt, device=self.device).reshape(())
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=self._solve_dtype())

    def _solve_ckpt(self, b, x0=None, criteria=None,
                    raise_on_divergence: bool = True, warmup: int = 0,
                    host_result: bool = True):
        """The checkpoint-armed solve (``jax_cg.py:2123-2420``;
        ``acg_tpu/parallel/dist.py:3072``): the unchanged loops run in
        host chunks of at most ``ckpt.every`` iterations (or sized to
        ``ckpt.secs`` from the measured rate), the full loop carry
        threaded through, so the chunked trajectory is the uninterrupted
        one bit for bit; a checksummed snapshot committed by atomic
        rename between chunks (its time billed to the ``ckpt`` phase);
        breakdowns answered by the rollback rung first, then the
        restart/fallback ladder.  ``crash:exit`` fires after a commit."""
        from acg_tpu_torch import checkpoint as ckpt_mod
        from acg_tpu_torch import faults, metrics, observatory, tracing
        from acg_tpu_torch.solvers.resilience import RecoveryDriver

        cfg = self.ckpt
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        if crit.needs_diff:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "checkpointing supports residual criteria only: the "
                "diff criterion's dx scalar is not part of the "
                "snapshot carry")
        fault0 = faults.device_fault()
        self._fault_refusals(fault0)
        detect = self._detect(fault0)
        dtype = self._solve_dtype()
        sdt = acc_dtype(dtype)
        if fault0 is not None:
            telemetry.record_event(st, "fault-armed",
                                   f"{fault0.site}:{fault0.mode}"
                                   f"@{fault0.iteration}")
        t_xfer = time.perf_counter()
        b_host = np.asarray(b, dtype=np.float64)
        b_dev, x0_dev = self.device_args(b, x0)
        device_sync(self.device)
        telemetry.add_timing(st, "transfer", time.perf_counter() - t_xfer)
        b_crc = ckpt_mod.vector_checksum(
            np.asarray(b, dtype=_np_dtype(dtype)))
        hl = self.health_spec is not None
        pc_kind = (str(self.precond_spec)
                   if self.precond_spec is not None else None)
        names = self._carry_names()
        solver_name = self._solver_name()

        def chunk(x_cur, atol, rtol, m, carry, k0, fault):
            program = self._program(StoppingCriteria(
                maxits=m, residual_atol=atol, residual_rtol=rtol))
            return program(b_dev, x_cur, guard=self._guard(
                fault, detect, k_offset=k0, carry=carry, state_io=True))

        def carry_of(arrs):
            return tuple(self._to_dev(arrs[nm], nm, sdt)
                         for nm in names[1:])

        # -- resume reconstruction ----------------------------------------
        consumed = 0          # trajectory iterations (incl. pre-crash)
        executed = 0          # iterations THIS process actually ran
        resumed_from = None
        carry = None
        x_cur = x0_dev
        abs_tol = None
        first_norms = None
        snap = cfg.resume
        repartitioned = None
        last_snap = None
        if snap is not None:
            ckpt_mod.validate_resume(
                snap, tier=self._ckpt_tier, pipelined=self.pipelined,
                precond=pc_kind, n=self._n_global(),
                dtype=_np_dtype(dtype), b_crc=b_crc,
                nparts=self._ckpt_nparts(), repartition=cfg.repartition)
            ckpt_mod.check_resume_env(snap, st)
            if cfg.repartition:
                snap, repartitioned = ckpt_mod.apply_repartition(
                    snap, tier=self._ckpt_tier,
                    nparts=self._ckpt_nparts() or 1, stats=st,
                    precond_spec=self.precond_spec)
            arrs = self._resume_arrays(snap)
            consumed = snap.iteration
            resumed_from = consumed
            sm = snap.meta
            abs_tol = float(sm["abs_tol"])
            first_norms = (float(sm["bnrm2"]), float(sm["x0nrm2"]),
                           float(sm["r0nrm2"]))
            x_cur = self._to_dev(arrs["x"], "x", sdt)
            carry = carry_of(arrs)
            last_snap = (consumed, dict(arrs))
            metrics.record_resume()
            telemetry.record_event(
                st, "resume",
                f"resumed from snapshot at iteration {consumed}")
            sys.stderr.write(f"acg-tpu-torch: {self._ckpt_tier}: resumed "
                             f"from snapshot at iteration {consumed}\n")

        driver = RecoveryDriver(self.recovery, st, self._ckpt_tier)
        if warmup > 0:
            # one zero-iteration chunk outside the timed window
            t_w = time.perf_counter()
            with telemetry.annotate("compile"):
                self._warming = True
                try:
                    chunk(x_cur, 0.0, 0.0, 0, carry, consumed, None)
                    device_sync(self.device)
                finally:
                    self._warming = False
            telemetry.add_timing(st, "compile", time.perf_counter() - t_w)

        unbounded = crit.unbounded
        fault = fault0
        seq = 0
        nsnaps = 0
        ck_secs = 0.0
        rate = None
        aud_fresh = True
        gap_tripped = False
        res = None
        t0 = time.perf_counter()
        with telemetry.annotate("solve"):
            while True:
                remaining = crit.maxits - consumed
                if remaining <= 0:
                    break
                m = min(cfg.chunk_for(rate), remaining)
                atol, rtol = ((crit.residual_atol, crit.residual_rtol)
                              if abs_tol is None else (abs_tol, 0.0))
                chunk_fault = (fault.shift(executed) if fault is not None
                               else None)
                t_chunk = time.time()
                res = chunk(x_cur, atol, rtol, m, carry, consumed,
                            chunk_fault)
                device_sync(self.device)
                t_end = time.time()
                k_chunk = int(res.niterations)
                if k_chunk > 0:
                    rate = (t_end - t_chunk) / k_chunk
                tracing.record_span(
                    f"chunk k{consumed}..{consumed + k_chunk}",
                    t_chunk, t_end, cat="chunk",
                    k_offset=consumed, iterations=k_chunk)
                consumed += k_chunk
                executed += k_chunk
                if first_norms is None:
                    first_norms = (float(res.bnrm2), float(res.x0nrm2),
                                   float(res.r0nrm2))
                    abs_tol = max(crit.residual_atol,
                                  crit.residual_rtol * first_norms[2])
                if res.telem is not None and res.telem.buf is not None:
                    st.trace = self.last_trace = \
                        telemetry.ConvergenceTrace.from_ring(
                            res.telem.ring(), k_chunk, solver=solver_name,
                            offset=consumed - k_chunk)
                observatory.note_chunk(
                    self._ckpt_tier, consumed, float(res.rnrm2),
                    abs_tol=abs_tol,
                    trace=(st.trace if self.trace else None),
                    rtol=crit.residual_rtol)
                if hl and res.aud is not None:
                    gap_tripped = self._note_audit(res, aud_fresh)
                    aud_fresh = False
                if detect and bool(res.breakdown):
                    if self.trace:
                        driver.log_trace_window(st.trace)
                    if (gap_tripped
                            and self.health_spec.action == "abort"):
                        st.tsolve += time.perf_counter() - t0 - ck_secs
                        st.converged = False
                        raise self._gap_error(consumed, restarts=False)
                    driver.note_breakdown(consumed)
                    # a fault that fired must not re-fire after the
                    # rollback/restart: it stays in the trajectory frame
                    # (the per-chunk shift rebases it), so vanish it
                    if (fault is not None and fault.device_site
                            and fault.iteration <= executed):
                        fault = None
                    # FIRST RUNG: roll the carry back to the last snapshot
                    if (last_snap is not None
                            and driver.on_rollback(consumed,
                                                   last_snap[0])):
                        arrs = last_snap[1]
                        x_cur = self._to_dev(arrs["x"], "x", sdt)
                        carry = carry_of(arrs)
                        consumed = last_snap[0]
                        continue
                    # second rung: restart from the recomputed residual
                    if driver.on_breakdown(consumed, noted=True):
                        x_next = res.x
                        if not bool(torch.isfinite(x_next).all()):
                            driver.record("iterate non-finite; "
                                          "restarting from the "
                                          "initial guess")
                            x_next = x0_dev
                        if self.precond_spec is not None:
                            from acg_tpu_torch.precond import \
                                refresh_state
                            refresh_state(self, driver)
                        x_cur = x_next
                        carry = None
                        continue
                    if self._host_rung():
                        driver.on_fallback(self._host_fallback_event)
                        st.tsolve += time.perf_counter() - t0 - ck_secs
                        return self._host_fallback(
                            b_host, crit, raise_on_divergence,
                            host_result)
                    st.tsolve += time.perf_counter() - t0 - ck_secs
                    st.converged = False
                    raise driver.give_up(
                        consumed, float(res.rnrm2),
                        snapshot=cfg.path if nsnaps else None)
                finished = (consumed >= crit.maxits if unbounded
                            else bool(res.converged))
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
                        "pipelined": bool(self.pipelined),
                        "algorithm": None,
                        "precond": pc_kind,
                        "n": self._n_global(),
                        "dtype": str(_np_dtype(dtype)),
                        "iteration": consumed,
                        "seq": seq,
                        "abs_tol": float(abs_tol),
                        "bnrm2": first_norms[0],
                        "x0nrm2": first_norms[1],
                        "r0nrm2": first_norms[2],
                        "b_crc": b_crc,
                        "fault": (str(faults.active_fault())
                                  if faults.active_fault() is not None
                                  else None),
                        "trace_tail": ckpt_mod.trace_tail(
                            st.trace if self.trace else None),
                    }
                    self._ckpt_meta_extra(meta, arrs)
                    ckpt_mod.agree_seq(seq, consumed)
                    nbytes = ckpt_mod.save_snapshot(cfg.path, meta, arrs)
                    dt = time.perf_counter() - t_ck
                    ck_secs += dt
                    telemetry.add_timing(st, "ckpt", dt)
                    metrics.record_snapshot(nbytes, dt)
                    nsnaps += 1
                    last_snap = (consumed, arrs)
                    # crash:exit models preemption between iterations,
                    # after the snapshot committed
                    faults.maybe_crash(consumed - k_chunk, consumed)
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
        telemetry.add_timing(st, "solve", t_solve)
        st.nsolves += 1
        st.niterations = executed
        st.ntotaliterations += executed
        st.bnrm2, st.x0nrm2, st.r0nrm2 = first_norms
        st.rnrm2 = float(res.rnrm2)
        st.dxnrm2 = float(res.dxnrm2)
        st.converged = bool(res.converged) or crit.unbounded
        st.ckpt = {
            "path": cfg.path,
            "every": int(cfg.every),
            "snapshots": nsnaps,
            "iteration": consumed,
            "rollbacks": driver.rollbacks,
        }
        if cfg.secs > 0:
            st.ckpt["secs"] = float(cfg.secs)
        if resumed_from is not None:
            st.ckpt["resumed_from"] = resumed_from
        if repartitioned is not None:
            st.ckpt["repartitioned_from"] = repartitioned
        metrics.record_solve(t_solve, executed, st.converged,
                             solver=solver_name)
        self._account_ops(st, executed)
        x = self._finish_x(res, host_result)
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{executed} iterations, residual {st.rnrm2:.3e}")
        return x

    def _ckpt_nparts(self):
        """The partition count a resume must match (None: unchecked)."""
        return None


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch vector dtype (bf16 has none: its
    snapshots record float32, the reference's ml_dtypes name aside)."""
    return np.dtype({torch.float64: np.float64, torch.float32: np.float32,
                     torch.bfloat16: np.float32}[dtype])


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
                 algorithm=None, trace: int = 0, progress: int = 0,
                 recovery=None, host_matrix=None, health=None, ckpt=None):
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
        self._mstate = None if mstate is None else tuple(mstate)
        self._check_telemetry(trace, progress)
        self.kernels = kernels
        self._check_robustness(recovery, health, ckpt, host_matrix,
                               kernels.startswith("fused"),
                               self.replace_every)
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
                return lambda b, x0, guard=None: rec._cg_sstep_program(
                    ops, b, x0, crit, algo.param, algo.basis, lam,
                    self._telemetry(sdt))
            return lambda b, x0, guard=None: rec._cg_pl_program(
                ops, b, x0, crit, algo.param, lam, self._telemetry(sdt))
        if kernels.startswith("fused"):
            if crit.needs_diff:
                raise ValueError("kernels='fused' supports residual "
                                 "criteria only")
            self._refuse_telemetry(
                "kernels='fused' keeps its scalars in SMEM inside "
                "the two streamed kernels; convergence telemetry "
                "(trace/progress) needs kernels='xla'/'pallas'")
            return lambda b, x0, guard=None: _cg_fused_program(
                A, b, x0, crit, kernels)
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
            return lambda b, x0, guard=None: _cg_replaced_program(
                spmv, dot, b, x0, crit, self.replace_every,
                self.replace_restart)
        dot, sdt = self._dot_setup(self._solve_dtype(), self.precise_dots)
        papply = None
        if self.precond_spec is not None:
            mstate = self._ensure_precond_state()
            apply = make_apply(self.precond_spec, spmv_)

            def papply(r):
                return apply(self._mstate, A, r)
        if self.pipelined and papply is not None:
            return lambda b, x0, guard=None: _pcg_pipelined_program(
                spmv, dot, _dotk(dot), b, x0, crit, papply,
                self._telemetry(sdt), guard)
        if self.pipelined:
            return lambda b, x0, guard=None: _cg_pipelined_program(
                spmv, dot, _dotk(dot), b, x0, crit,
                not kernels.startswith("xla"), self._telemetry(sdt), guard)
        return lambda b, x0, guard=None: _cg_program(
            spmv, dot, b, x0, crit, papply, _dotk(dot),
            self._telemetry(sdt), guard)

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

