"""Communication-avoiding CG recurrences on PyTorch tensors.

The counterpart of ``acg_tpu/recurrence.py`` (``--algorithm``): the
recurrence specs and their reduction schedules, and two recurrences
composed with any tier's SpMV and global reductions through a
:class:`TierOps` bundle, so one recurrence serves the single-device tier
(:func:`single_ops`) and the stacked multi-part tier
(:class:`acg_tpu_torch.parallel.dist.DistCGSolver`):

``sstep:S``
    s-step CG (Chronopoulos-Gear / Carson).  Each outer block builds the
    2S+1-column Krylov basis ``[p, th_1(A)p, .., th_S(A)p, r, ..,
    th_{S-1}(A)r]`` (2S-1 SpMVs), reduces its Gram matrix once, and runs
    S CG steps in coefficient space: one reduction per S iterations
    where classic CG makes two an iteration.  Monomial basis below
    S = 4, scaled Chebyshev (power-iteration lambda_max) from S = 4.
``pipelined:L``
    deep-pipelined p(l)-CG (Cornelis-Cools-Vanroose): a Lanczos-basis CG
    whose basis vector v_m is recovered with lag L from an auxiliary
    basis z_j = P_L(A) v_{j-L}; an iteration makes one SpMV and one fused
    (2L+2)-scalar window reduction whose result is consumed L iterations
    later.  The z-Gram is factored by a stream Cholesky; its square-root
    breakdown (the Gram loses positivity as convergence proceeds) ends
    the attempt, and the solver restarts from the current iterate, up to
    :data:`PL_RESTART_BUDGET` times a solve.

As in the reference these are plain tensor code around the tier's SpMV
(kernel K1, K7, or K1 batched over parts with the K6 halo exchange):
the Gram ``V V^T`` and the window matvec are ``torch.matmul`` products
(on stacked parts a per-part batched product, then the tier's
fixed-order psum).  TF32 must stay off for their f32 products, and
:meth:`TierOps.gram` refuses to run with it on.

The reference runs each recurrence inside one ``while_loop``; the port
runs eager Python over device tensors, reading a flag once a chunk
(:data:`~acg_tpu_torch.solvers.cg.CHUNK` iterations), so both loops make
the reference's stops exact with device-side selects:

* an s-step block that the reference would not have started (after
  convergence, after a breakdown, at ``k >= maxits``) changes nothing,
  and a block stops mid-way at ``k + j = maxits``;
* the p(l) carry freezes once converged, broken down or at ``maxits``
  advances: later steps keep building z but set no flag.  The p(l)
  step counter ``j`` is host-side (the reference increments it every
  trip), so its window indices are Python integers: the windows are
  ring buffers and lists of scalars, with no rolled copies.

A :class:`~acg_tpu_torch.solvers.cg.LoopGuard` arms the robustness
hooks (``acg_tpu/recurrence.py:325-440``, ``:627-735``): the fault
sites (every SpMV of an s-step block carries the block's first
iteration, as the reference's do, and (p, Ap) its own; a p(l) SpMV its
step counter), the s-step audit on crossing the cadence, and the
checkpoint carry in and out -- s-step's block-boundary ``(r, p,
gamma)``, p(l)'s whole working set in the reference's rolled layout
(:data:`acg_tpu_torch.checkpoint.ca_carry_names`), so a chunked solve
continues the recurrence exactly.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch

from acg_tpu_torch import telemetry
from acg_tpu_torch.ops.spmv import acc_dtype
from acg_tpu_torch.solvers.cg import CHUNK, CGResult, _spmv_fn, _State

POWER_ITERS = 24          # lambda_max power iteration length (setup)
LAM_SAFETY = 1.05         # spectral headroom on the estimated lambda_max
PL_RESTART_BUDGET = 64    # sqrt-breakdown restarts before giving up


# -- recurrence specs ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecurrenceSpec:
    """Recurrence selector: ``kind`` in {"classic", "pipelined", "sstep",
    "pl"}; ``param`` is s (block length) or l (pipeline depth)."""

    kind: str
    param: int = 0

    def __post_init__(self):
        if self.kind not in ("classic", "pipelined", "sstep", "pl"):
            raise ValueError(f"unknown recurrence kind {self.kind!r}")
        if self.kind == "sstep" and not 2 <= self.param <= 16:
            raise ValueError(
                f"sstep:S needs 2 <= S <= 16 (got {self.param}): S = 1 "
                f"is classic CG, and the 2S+1-column basis loses full "
                f"rank in floating point well before S = 16")
        if self.kind == "pl" and not 1 <= self.param <= 4:
            raise ValueError(
                f"pipelined:L needs 1 <= L <= 4 (got {self.param}): "
                f"the z-basis Gram conditioning degrades with the "
                f"polynomial degree")

    @property
    def communication_avoiding(self) -> bool:
        return self.kind in ("sstep", "pl")

    @property
    def basis(self) -> str:
        """s-step basis: monomial below S = 4, scaled Chebyshev from
        S = 4."""
        return "chebyshev" if self.kind == "sstep" and self.param >= 4 \
            else "monomial"

    @property
    def needs_lam(self) -> bool:
        """Whether the recurrence reads the (lmin, lmax) estimate: the
        Chebyshev s-step basis and every p(l) shift."""
        return self.kind == "pl" or (self.kind == "sstep"
                                     and self.basis == "chebyshev")

    def __str__(self):
        if self.kind == "sstep":
            return f"sstep:{self.param}"
        if self.kind == "pl":
            return f"pipelined:{self.param}"
        return self.kind

    def solver_name(self, tier: str = "cg") -> str:
        """Solver label; it does not contain "pipelined" (the reference
        keys its Lanczos re-alignment on that substring)."""
        if self.kind == "sstep":
            return f"{tier}-sstep{self.param}"
        if self.kind == "pl":
            return f"{tier}-pl{self.param}"
        return tier


def parse_algorithm(name) -> RecurrenceSpec | None:
    """``--algorithm``: classic | pipelined | sstep:S | pipelined:L.
    None/"auto" -> None (the --solver name decides)."""
    if name is None or isinstance(name, RecurrenceSpec):
        return name
    s = str(name).strip().lower()
    if s in ("", "auto"):
        return None
    if s == "classic":
        return RecurrenceSpec("classic")
    if s == "pipelined":
        return RecurrenceSpec("pipelined")
    m = re.fullmatch(r"sstep:(\d+)", s)
    if m:
        return RecurrenceSpec("sstep", int(m.group(1)))
    m = re.fullmatch(r"pipelined:(\d+)", s)
    if m:
        return RecurrenceSpec("pl", int(m.group(1)))
    raise ValueError(
        f"unknown --algorithm {name!r}: expected classic, pipelined, "
        f"sstep:S (2 <= S <= 16) or pipelined:L (1 <= L <= 4)")


def reduction_schedule(spec: RecurrenceSpec | None, pipelined: bool,
                       precond: bool = False) -> dict:
    """The recurrence's per-iteration reduction schedule (what the op
    census bills).  Fractional values are exact per-iteration averages
    of per-block quantities."""
    if spec is not None and spec.kind == "sstep":
        s = spec.param
        w = 2 * s + 1
        return {
            "allreduce_per_iteration": 1.0 / s,
            "allreduce_scalars": w * w,
            "spmv_per_iteration": (2 * s - 1) / s,
            "iterations_per_reduction": s,
        }
    if spec is not None and spec.kind == "pl":
        return {
            "allreduce_per_iteration": 1.0,
            "allreduce_scalars": 2 * spec.param + 2,
            "spmv_per_iteration": 1.0,
            "reduction_latency_hidden": spec.param,
        }
    if pipelined:
        return {"allreduce_per_iteration": 1.0,
                "allreduce_scalars": 3 if precond else 2,
                "spmv_per_iteration": 1.0}
    return {"allreduce_per_iteration": 2.0,
            "allreduce_scalars": 2 if precond else 1,
            "spmv_per_iteration": 1.0}


# -- tier ops --------------------------------------------------------------

def _check_no_tf32(t: torch.Tensor) -> None:
    if (t.is_cuda and t.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the recurrences' f32 Gram and window products need full f32 "
            "products: set torch.backends.cuda.matmul.allow_tf32 = False")


@dataclasses.dataclass
class TierOps:
    """What a tier contributes to the recurrences: its SpMV (halo
    exchange included), its global dot, and ``psum_stack``, the one
    reduction of a per-part payload (identity on one device, the
    parts-axis fold on stacked parts).  Vectors are ``(n,)`` on one
    device and ``(P, n)`` on stacked parts; a basis or window stacks
    them on the second-to-last axis."""

    spmv: callable
    dot: callable
    psum_stack: callable
    sdt: torch.dtype

    def gram(self, V):
        """The global Gram matrix of the basis ``V`` (``(m, n)`` or
        ``(P, m, n)``): one local product per part, one reduction."""
        _check_no_tf32(V)
        return self.psum_stack(_per_part(lambda v: v @ v.mT, V))

    def windots(self, Z, znew):
        """The p(l) window reduction: the dots of every stored window
        vector with ``znew``, one local matvec per part, one
        reduction."""
        _check_no_tf32(Z)
        return self.psum_stack(_per_part(
            lambda z, w: (z @ w.unsqueeze(-1)).squeeze(-1), Z, znew))


def _per_part(f, V, *rest):
    """``f`` of one basis or window, or of each part's on stacked parts,
    stacked.  The parts take separate products: on an H100, one batched
    f64 product of the (4, 9, 9) Grams of 4 parts of 2048^2 took 8.2 ms,
    four products 0.33 ms."""
    if V.dim() == 2:
        return f(V, *rest)
    return torch.stack([f(*a) for a in zip(V.unbind(0),
                                            *(r.unbind(0) for r in rest))])


def single_ops(A, kernels: str, dot, sdt) -> TierOps:
    """TierOps of the single-device tier over the device matrix or
    matrix-free operator ``A`` and the kernel choice (K1 for square DIA
    matrices, K7 for the Poisson stencil under "pallas")."""
    spmv_ = _spmv_fn(kernels)
    return TierOps(spmv=lambda v: spmv_(A, v), dot=dot,
                   psum_stack=lambda v: v, sdt=sdt)


# -- s-step CG -------------------------------------------------------------

def _interval(lam, sdt):
    """The basis interval's centre and half-width, in ``sdt`` on the
    host (the reference computes them from the sdt-rounded lam)."""
    lmin, lmax = (torch.tensor(float(v), dtype=sdt) for v in lam)
    return (lmax + lmin) / 2.0, (lmax - lmin) / 2.0


def sstep_basis_matrix(s: int, basis: str, lam, sdt=torch.float64):
    """(s+1, s+1) change of basis B with A V[:, j] = V B[:, j] for j < s
    (host tensor in ``sdt``)."""
    B = torch.zeros((s + 1, s + 1), dtype=sdt)
    if basis == "monomial":
        for j in range(s):
            B[j + 1, j] = 1.0
        return B
    d, c = _interval(lam, sdt)
    for j in range(s):
        if j == 0:
            B[0, 0] = d
            B[1, 0] = c
        else:
            B[j - 1, j] = c / 2.0
            B[j, j] = d
            B[j + 1, j] = c / 2.0
    return B


def sstep_combined_bmat(s: int, basis: str, lam, sdt=torch.float64):
    """(2s+1, 2s+1) block-diagonal change of basis of the combined
    [P-basis | R-basis] stack, its top-degree columns zeroed."""
    m = 2 * s + 1
    B = torch.zeros((m, m), dtype=sdt)
    B[:s + 1, :s + 1] = sstep_basis_matrix(s, basis, lam, sdt)
    if s > 1:
        B[s + 1:, s + 1:] = sstep_basis_matrix(s - 1, basis, lam, sdt)
    B[:, s] = 0.0
    B[:, m - 1] = 0.0
    return B


def sstep_build_basis(ops: TierOps, v, deg: int, basis: str, dc) -> list:
    """The matrix-powers rows ``[v, th_1(A)v, .., th_deg(A)v]``: deg
    SpMVs through the tier's own SpMV, no reduction.  ``dc`` is the
    Chebyshev interval's (centre, half-width) as device scalars."""
    rows = [v]
    if basis == "monomial":
        for _ in range(deg):
            rows.append(ops.spmv(rows[-1]))
        return rows
    d, c = dc
    for j in range(deg):
        w = ops.spmv(rows[-1]) - d * rows[-1]
        rows.append(w / c if j == 0 else 2.0 * w / c - rows[-2])
    return rows


def make_sstep_block(ops: TierOps, s: int, basis: str, dc, Bmat, tol2,
                     maxits: int, unbounded: bool, telem=None, guard=None,
                     b=None, bnrm2=None):
    """The s-step outer block as ``block(st)`` over the carry ``st``
    (``x, r, p, gamma, k, bad``; ``gamma`` the coefficient-space ||r||^2
    carried across blocks).  A block the reference's ``while_loop``
    would not have started leaves the carry as it was.

    ``telem`` (a :class:`~acg_tpu_torch.telemetry.LoopTelemetry`) records
    each inner step's plain CG scalars ``(gamma_next, alpha, beta,
    denom)`` in the ring slot of its trajectory iteration ``k + j``,
    masked by the step's own flag (``acg_tpu/recurrence.py:393-399``),
    and a heartbeat row after each block that crosses a multiple of the
    period, naming the block's end (the reference's test of ``k + 1``
    against the period rarely meets a block's end).

    ``guard`` arms the fault sites and the audit
    (``acg_tpu/recurrence.py:346-421``): the block's SpMVs carry its
    first iteration ``st.kh`` (host-known: a live block starts at a
    multiple of s), (p, Ap) of inner step j carries ``kh + j``, and the
    audit fires when the block crosses a multiple of the cadence in the
    trajectory frame (``k_offset``), through the tier's own SpMV of the
    mapped-back x against ``b``."""
    sdt = ops.sdt
    fault = guard.fault if guard is not None else None
    health = guard.health if guard is not None else None
    koff = guard.k_offset if guard is not None else 0
    if health is not None:
        from acg_tpu_torch import health as H
    w = 2 * s + 1
    dev = Bmat.device
    eye = torch.eye(w, dtype=sdt, device=dev)
    pc0, rc0 = eye[0], eye[s + 1]
    xc0 = torch.zeros((w,), dtype=sdt, device=dev)
    zero = torch.zeros((), dtype=sdt, device=dev)
    nsteps0 = torch.zeros((), dtype=torch.int64, device=dev)

    def block(st):
        live = (~st.bad) & (st.k < maxits)
        if not unbounded:
            live = live & (st.gamma >= tol2)
        kh = st.kh
        st.kh += s
        bops = ops
        if fault is not None and fault.site in ("spmv", "sdc"):
            bops = dataclasses.replace(ops, spmv=lambda v: fault.apply_spmv(
                ops.spmv(v), kh, live))
        # -- basis: 2s-1 SpMVs, no reduction ---------------------------
        if guard is not None:
            guard.at(kh, live)
        rows = sstep_build_basis(bops, st.p, s, basis, dc)
        if s > 1:
            rows += sstep_build_basis(bops, st.r, s - 1, basis, dc)
        else:
            rows.append(st.r)
        if guard is not None:
            guard.at(None)
        V = torch.stack(rows, dim=-2)
        # -- the block's one reduction ---------------------------------
        G = ops.gram(V)
        pc, rc, xc, nsteps, bad = pc0, rc0, xc0, nsteps0, st.bad
        # the fresh basis' gamma re-anchors the carried scalar
        gamma_blk = G[s + 1, s + 1]
        # -- s CG steps in coefficient space ---------------------------
        for j in range(s):
            wc = Bmat @ pc
            Gw = G @ wc
            denom = pc @ Gw
            if fault is not None:
                denom = fault.apply_dot(denom, kh + j, live)
            bad_j = ((~(torch.isfinite(denom) & torch.isfinite(gamma_blk)))
                     | ((denom <= 0) & (gamma_blk > 0)))
            going = (gamma_blk >= tol2) & (st.k < maxits - j)
            step = (~(bad | bad_j)) & going
            bad = bad | (bad_j & going)
            alpha = torch.where(step, gamma_blk / torch.where(
                denom == 0, 1.0, denom), zero)
            xc = xc + alpha * pc
            rc_new = rc - alpha * wc
            Gr = G @ rc_new
            gamma_next = rc_new @ Gr
            beta = torch.where(step, gamma_next / torch.where(
                gamma_blk == 0, 1.0, gamma_blk), zero)
            pc = torch.where(step, rc_new + beta * pc, pc)
            rc = torch.where(step, rc_new, rc)
            if telem is not None and telem.buf is not None:
                telemetry.ring_record(telem.buf, st.k + j, gamma_next,
                                      alpha, beta, denom,
                                      live=step & live)
            gamma_blk = torch.where(step, gamma_next, gamma_blk)
            nsteps = nsteps + step
        # -- map back: three small products, no reduction ---------------
        st.x = torch.where(live, st.x + xc @ V, st.x)
        st.r = torch.where(live, rc @ V, st.r)
        st.p = torch.where(live, pc @ V, st.p)
        gamma_old = st.gamma
        st.gamma = torch.where(live, gamma_blk, st.gamma)
        k_old = st.k
        st.k = st.k + torch.where(live, nsteps, 0)
        if health is not None:
            every = int(health.every)
            if every and (kh + koff + s) // every > (kh + koff) // every:
                # the block may cross the cadence: audit where it did
                fire = live & ((st.k + koff) // every
                               > (kh + koff) // every)
                gap = H.relative_gap(b - ops.spmv(st.x), st.r, ops.dot,
                                     bnrm2, sdt).reshape(()).to(
                                         st.aud.dtype)
                new = st.aud.clone()
                new[H.AUD_GAP] = gap
                new[H.AUD_GAP_MAX] = torch.maximum(st.aud[H.AUD_GAP_MAX],
                                                   gap)
                new[H.AUD_COUNT] = st.aud[H.AUD_COUNT] + 1
                st.aud = torch.where(fire, new, st.aud)
            st.aud = H.stall_update(st.aud, health, st.gamma < gamma_old,
                                    live)
            tr = H.trip(st.aud, health)
            if tr is not None:
                bad = bad | tr
        st.bad = torch.where(live, bad, st.bad)
        if telem is not None and telem.progress:
            # a block crossing a multiple of the period beats once
            every = telem.progress
            telem.beat(st.k, st.gamma,
                       live & (k_old // every < st.k // every))

    return block


def run_sstep_loop(ops: TierOps, s: int, basis: str, lam, x0, r, gamma,
                   res_tol, maxits: int, unbounded: bool, telem=None,
                   guard=None, p=None, b=None, bnrm2=None):
    """The s-step outer loop, shared by every tier.  The stop flag is
    read once every ``CHUNK // s`` blocks; an unbounded solve stops only
    on a breakdown and otherwise runs ``ceil(maxits / s)`` blocks, the
    last one stopping at ``maxits``.  Returns ``(x, k, gamma_f, bad,
    done, st)``: ``st`` holds the final ``r``, ``p`` (the checkpoint
    carry) and, audited, ``aud``.  ``p`` re-enters mid-trajectory at a
    block boundary (``p = r`` is the fresh start)."""
    sdt = ops.sdt
    dev = r.device
    tol2 = res_tol * res_tol
    dc = tuple(v.to(dev) for v in _interval(lam, sdt))
    Bmat = sstep_combined_bmat(s, basis, lam, sdt).to(dev)
    st = _State(x=x0, r=r, p=r if p is None else p, gamma=gamma,
                k=torch.zeros((), dtype=torch.int64, device=dev),
                bad=torch.zeros((), dtype=torch.bool, device=dev), kh=0)
    if guard is not None and guard.health is not None:
        from acg_tpu_torch import health as H
        st.aud = H.audit_init(sdt, guard.health, dev)
    block = make_sstep_block(ops, s, basis, dc, Bmat, tol2, maxits,
                             unbounded, telem, guard, b, bnrm2)
    nblocks = -(-maxits // s)
    per_chunk = max(1, CHUNK // s)
    beats = telem is not None and telem.progress > 0
    ran = 0
    while ran < nblocks:
        stop = bool(st.bad if unbounded
                    else st.bad | (st.k >= maxits) | (st.gamma < tol2))
        if beats:
            telem.flush()
        if stop:
            break
        for _ in range(min(per_chunk, nblocks - ran)):
            block(st)
        ran += per_chunk
    if beats:
        telem.flush()
    done = (~st.bad) if unbounded else (st.gamma < tol2)
    return st.x, st.k, st.gamma, st.bad, done, st


def _setup(ops: TierOps, b, x0, crit, carry_gamma=None):
    """The shared setup: ``(bnrm2, x0nrm2, r0, gamma0, r0nrm2, res_tol)``
    (one SpMV, three dots).  A carried ``gamma`` (a checkpoint re-entry)
    skips the residual: r0 is then None and r0nrm2 ``sqrt(gamma)``."""
    sdt = ops.sdt
    bnrm2 = torch.sqrt(ops.dot(b, b))
    x0nrm2 = torch.sqrt(ops.dot(x0, x0))
    if carry_gamma is None:
        r = b - ops.spmv(x0)
        gamma = ops.dot(r, r)
    else:
        r, gamma = None, carry_gamma
    r0nrm2 = torch.sqrt(gamma)
    res_tol = torch.maximum(
        torch.tensor(crit.residual_atol, dtype=sdt, device=b.device),
        crit.residual_rtol * r0nrm2)
    return bnrm2, x0nrm2, r, gamma, r0nrm2, res_tol


def _cg_sstep_program(ops: TierOps, b, x0, crit, s: int, basis: str,
                      lam, telem=None, guard=None) -> CGResult:
    """A whole s-step CG solve over ``ops`` (``acg_tpu.recurrence.
    _cg_sstep_program``; the stacked tier's body, ``acg_tpu/parallel/
    dist.py:2063-2185``, is the same code).  ``telem`` arms the ring and
    heartbeat (:func:`make_sstep_block`), ``guard`` the fault sites, the
    audit and the checkpoint carry: ``guard.carry`` re-enters from a
    block-boundary ``(r, p, gamma)`` (the setup SpMV is skipped),
    ``guard.state_io`` returns the final one in ``res.carry``."""
    from acg_tpu_torch.solvers.cg import _guard_of
    g = _guard_of(guard)
    carry = g.carry if g is not None else None
    p = None
    if carry is not None:
        r, p, gamma = carry
        bnrm2, x0nrm2, _, gamma, r0nrm2, res_tol = _setup(
            ops, b, x0, crit, carry_gamma=gamma)
    else:
        bnrm2, x0nrm2, r, gamma, r0nrm2, res_tol = _setup(ops, b, x0, crit)
    x, k, gamma_f, bad, done, st = run_sstep_loop(
        ops, s, basis, lam, x0, r, gamma, res_tol, crit.maxits,
        crit.unbounded, telem, g, p, b, bnrm2)
    inf = torch.tensor(math.inf, dtype=ops.sdt, device=b.device)
    res = CGResult(x=x, niterations=k,
                   rnrm2=torch.sqrt(torch.clamp(gamma_f, min=0.0)),
                   r0nrm2=r0nrm2, bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=inf,
                   converged=done, breakdown=bad & ~done, telem=telem)
    if g is not None and g.health is not None:
        res.aud = st.aud
    if g is not None and g.state_io:
        res.carry = (st.r, st.p, gamma_f)
    return res


# -- p(l)-CG ---------------------------------------------------------------

def pl_shifts(l: int, lam, sdt, device=None):
    """Chebyshev points of [lmin, lmax]: the shifts sigma_0..sigma_{l-1}
    of the auxiliary basis z = P_l(A) v."""
    d, c = _interval(lam, sdt)
    cosv = np.cos((2 * np.arange(l) + 1) * np.pi / (2 * l))
    return (d + c * torch.tensor(cosv, dtype=sdt)).to(device)


def run_pl_loop(ops: TierOps, l: int, lam, x0, z0, eta, eta2, res_tol,
                maxits: int, unbounded: bool, telem=None, guard=None):
    """The p(l) iteration loop, shared by every tier (``acg_tpu.
    recurrence.make_pl_step``/``run_pl_loop``).  Returns ``(x, adv, q,
    conv, bad)``: ``adv`` counts the solution advances (the reported
    iterations).

    The reference's rolled windows become, with the step counter ``j``
    on the host: the auxiliary basis ``Z`` as a ring of 2l+2 vectors
    (z_t in slot t mod (2l+2)), the recovered Lanczos vectors ``V`` as a
    ring of 2l (v_t in slot t mod 2l), and the reduction delay line,
    the stream-Cholesky columns and the Lanczos T entries as Python
    lists of device scalars.  The newest two z vectors are kept apart,
    contiguous, for the SpMV.

    ``telem`` records, at each solution advance, ``(q^2, 1/d, l^2, d)``
    in the ring slot of the advance count -- classic-aligned rows, as
    the reference's ring holds them (``acg_tpu/recurrence.py:558-566``)
    -- and a heartbeat row at each advance that lands on a multiple of
    the period.

    ``guard`` arms the ``spmv:``/``halo:`` fault sites at the step
    counter ``j`` and the checkpoint carry: ``guard.carry`` re-enters
    from the reference's rolled working set (:func:`pl_carry_in`), with
    ABSOLUTE ``j``/``adv`` and so an absolute ``maxits``;
    ``guard.state_io`` returns it as ``(x, adv, q, conv, bad, carry)``'s
    last element (:func:`pl_carry_out`)."""
    sdt = ops.sdt
    dev = x0.device
    tol2 = res_tol * res_tol
    W = 2 * l + 2
    sigma = pl_shifts(l, lam, sdt, dev).unbind()
    one = torch.ones((), dtype=sdt, device=dev)
    zero = torch.zeros((), dtype=sdt, device=dev)
    fault = guard.fault if guard is not None else None
    carry = guard.carry if guard is not None else None

    def safe(v):
        return torch.where(v == 0, one, v)

    lead = x0.shape[:-1]    # () on one device, (P,) on stacked parts
    n = x0.shape[-1]
    fals = torch.zeros((), dtype=torch.bool, device=dev)
    if carry is None:
        Zb = torch.zeros(lead + (W, n), dtype=sdt, device=dev)
        Zb.select(-2, 0).copy_(z0)
        Vb = torch.zeros(lead + (2 * l, n), dtype=sdt, device=dev)
        zlast, zprev = z0, torch.zeros_like(z0)
        # the delay line: window dots initiated at step t consumed at t + l
        zzq = [[zero] * W for _ in range(l)]
        zzq[-1][2 * l + 1] = one
        gb = [[zero] * (2 * l + 1) for _ in range(2 * l + 1)]
        gammas = [zero] * (l + 2)
        deltas = [zero] * (l + 1)
        j0 = 0
        st = _State(x=x0.to(sdt), q=eta, dprev=one,
                    ptilde=torch.zeros_like(z0),
                    adv=torch.zeros((), dtype=torch.int64, device=dev),
                    conv=eta2 < tol2, bad=fals)
    else:
        (j0, q, dprev, ptilde, Zb, Vb, zzq, gb, gammas, deltas,
         adv) = pl_carry_in(carry, l)
        zlast = Zb.select(-2, j0 % W).clone()
        zprev = Zb.select(-2, (j0 - 1) % W).clone()
        st = _State(x=x0.to(sdt), q=q, dprev=dprev, ptilde=ptilde,
                    adv=adv, conv=fals, bad=fals)

    def step(j: int):
        nonlocal zlast, zprev, zzq, gb, gammas, deltas
        m = j + 1 - l
        live = (~st.conv) & (~st.bad) & (st.adv < maxits)
        y = zzq[0]
        if m >= 0:
            # -- stream Cholesky: column m from the delayed z-dots ------
            newcol = []
            for rr in range(2 * l):
                if m - 2 * l + rr < 0:
                    newcol.append(zero)
                    continue
                acc = y[rr + 1]
                for tt in range(rr):
                    acc = acc - gb[rr + 1][tt - rr + 2 * l] * newcol[tt]
                newcol.append(acc / safe(gb[rr + 1][2 * l]))
            diag2 = y[2 * l + 1]
            for rr in range(2 * l):
                diag2 = diag2 - newcol[rr] * newcol[rr]
            bad_sqrt = (diag2 <= 0) | (~torch.isfinite(diag2))
            gmm = torch.sqrt(torch.where(diag2 > 0, diag2, one))
            newcol.append(gmm)
            # -- recover v_m (z_m sits in slot m mod W) ------------------
            acc_v = Zb.select(-2, m % W)
            for rr in range(2 * l):
                acc_v = acc_v - newcol[rr] * Vb.select(-2, (m + rr) % (2 * l))
            vm = acc_v / safe(gmm)
        if m >= 1:
            # -- Lanczos T entries at index m-1; at the step's start
            # gammas[i] = gamma_{m-3-l+i} and deltas[i] = delta_{m-2-l+i}
            gm1m1 = safe(gb[2 * l][2 * l])
            gm2m1 = gb[2 * l][2 * l - 1]
            gm1m = newcol[2 * l - 1]
            if m - 1 < l:
                gamma_m1 = gmm / gm1m1
                delta_m1 = (sigma[m - 1]
                            + (gm1m - gammas[l + 1] * gm2m1) / gm1m1)
            else:
                gamma_m1 = gammas[2] * gmm / gm1m1
                delta_m1 = ((gammas[2] * gm1m + deltas[1] * gm1m1
                             - gammas[l + 1] * gm2m1) / gm1m1)
            # -- advance the solution to trajectory index m-1 ------------
            vmm = Vb.select(-2, (m - 1) % (2 * l))
            if m == 1:
                dd, pt_new = delta_m1, vmm
            else:
                lprev = gammas[l + 1] / safe(st.dprev)
                dd = delta_m1 - gammas[l + 1] * lprev
                pt_new = vmm - lprev * st.ptilde
            do_adv = live & (~bad_sqrt)
            st.x = torch.where(do_adv, st.x + (st.q / safe(dd)) * pt_new,
                               st.x)
            q_next = -(gamma_m1 / safe(dd)) * st.q
            if telem is not None and telem.buf is not None:
                telemetry.ring_record(telem.buf, st.adv, q_next * q_next,
                                      1.0 / safe(dd),
                                      (q_next / safe(st.q)) ** 2, dd,
                                      live=do_adv)
            st.conv = st.conv | (do_adv & (q_next * q_next < tol2))
            st.adv = st.adv + do_adv.to(torch.int64)
            st.q = torch.where(do_adv, q_next, st.q)
            st.dprev = torch.where(do_adv, dd, st.dprev)
            st.ptilde = torch.where(do_adv, pt_new, st.ptilde)
        if m >= 0:
            # a frozen carry sets no flag (the reference has stopped)
            st.bad = st.bad | (bad_sqrt & live)
        if m >= 1 and telem is not None and telem.progress:
            # the advance that lands on a multiple of the period beats
            telem.beat(st.adv, st.q * st.q,
                       do_adv & (st.adv % telem.progress == 0))
        # -- build z_{j+1}: the step's one SpMV --------------------------
        if guard is not None:
            guard.at(j, live)
        Az = ops.spmv(zlast)
        if guard is not None:
            guard.at(None)
        if fault is not None:
            Az = fault.apply_spmv(Az, j, live)
        if j < l:
            znew = Az - sigma[j] * zlast
        else:
            znew = ((Az - delta_m1 * zlast - gammas[l + 1] * zprev)
                    / safe(gamma_m1))
        Zb.select(-2, (j + 1) % W).copy_(znew)
        zprev, zlast = zlast, znew
        # -- the one window reduction, consumed l steps later ------------
        local = ops.windots(Zb, znew).unbind()
        zzq = zzq[1:] + [[local[(j + 2 + i) % W] for i in range(W)]]
        if m >= 0:
            gb = gb[1:] + [newcol]
            Vb.select(-2, m % (2 * l)).copy_(vm)
        if m >= 1:
            gammas = gammas[1:] + [gamma_m1]
            deltas = deltas[1:] + [delta_m1]

    # an unbounded solve has no convergence stop: its maxits advances
    # take maxits + l steps, unless a breakdown ends it first
    jcap = maxits + 2 * l + 2
    nsteps = (maxits + l if maxits > 0 else 0) if unbounded else jcap
    beats = telem is not None and telem.progress > 0
    # a frozen step still advances the windows, so a run that returns
    # its working set reads the stop flag every step: it stops where
    # the reference's while_loop does
    per = 1 if guard is not None and guard.state_io else CHUNK
    j = j0
    while j < nsteps:
        stop = bool(st.bad if unbounded
                    else st.conv | st.bad | (st.adv >= maxits))
        if beats:
            telem.flush()
        if stop:
            break
        for _ in range(min(per, nsteps - j)):
            step(j)
            j += 1
    if beats:
        telem.flush()
    out = (st.x, st.adv, st.q, st.conv, st.bad)
    if guard is not None and guard.state_io:
        out = out + (pl_carry_out(l, j, st, Zb, Vb, zzq, gb, gammas,
                                  deltas),)
    return out


def pl_carry_out(l: int, j: int, st, Zb, Vb, zzq, gb, gammas,
                 deltas) -> tuple:
    """The p(l) working set at step ``j`` in the reference's rolled
    layout (``acg_tpu/recurrence.py:470-497``, the ``ca_carry_names``
    order less x): ``Z[i] = z_{j-2l-1+i}``, ``V[rr] = v_{m-2l+rr}`` with
    m = j + 1 - l, the delay line, the Cholesky columns and the T
    windows oldest first, and the absolute counters."""
    W = 2 * l + 2
    m = j + 1 - l
    Z = torch.stack([Zb.select(-2, (j - (W - 1) + i) % W)
                     for i in range(W)], dim=-2)
    V = torch.stack([Vb.select(-2, (m + rr) % (2 * l))
                     for rr in range(2 * l)], dim=-2)
    dev = st.adv.device
    return (st.q, st.dprev, st.ptilde, Z, V,
            torch.stack([torch.stack(row) for row in zzq]),
            torch.stack([torch.stack(col) for col in gb]),
            torch.stack(gammas), torch.stack(deltas),
            torch.tensor(j, dtype=torch.int64, device=dev), st.adv)


def pl_carry_in(carry, l: int) -> tuple:
    """:func:`pl_carry_out`'s inverse: ``(j, q, dprev, ptilde, Zb, Vb,
    zzq, gb, gammas, deltas, adv)`` with the windows back in their ring
    slots and the scalar windows as lists of device scalars."""
    q, dprev, ptilde, Z, V, zzq, gb, gammas, deltas, j, adv = carry
    W = 2 * l + 2
    j = int(j)
    m = j + 1 - l
    Zb = torch.empty_like(Z)
    for i in range(W):
        Zb.select(-2, (j - (W - 1) + i) % W).copy_(Z.select(-2, i))
    Vb = torch.empty_like(V)
    for rr in range(2 * l):
        Vb.select(-2, (m + rr) % (2 * l)).copy_(V.select(-2, rr))
    return (j, q.reshape(()), dprev.reshape(()), ptilde, Zb, Vb,
            [list(row.unbind()) for row in zzq.unbind()],
            [list(col.unbind()) for col in gb.unbind()],
            list(gammas.unbind()), list(deltas.unbind()),
            adv.reshape(()).to(torch.int64))


def _cg_pl_program(ops: TierOps, b, x0, crit, l: int, lam,
                   telem=None, guard=None) -> CGResult:
    """A whole p(l)-CG solve over ``ops`` (``acg_tpu.recurrence.
    _cg_pl_program``; the stacked tier's body is the same code).
    ``telem`` arms the ring and heartbeat (:func:`run_pl_loop`); each
    restart attempt records its own, as the reference's does.
    ``guard`` arms the fault sites and the checkpoint carry: a carried
    working set re-enters mid-pipeline with no setup SpMV, its ``j``/
    ``adv`` and ``crit.maxits`` absolute (``niterations`` then counts
    from the solve's start)."""
    from acg_tpu_torch.solvers.cg import _guard_of
    g = _guard_of(guard)
    if g is not None and g.carry is not None:
        q = g.carry[0]
        bnrm2, x0nrm2, _, eta2, eta, res_tol = _setup(
            ops, b, x0, crit, carry_gamma=q * q)
        z0 = None
    else:
        bnrm2, x0nrm2, r, eta2, eta, res_tol = _setup(ops, b, x0, crit)
        z0 = r / torch.where(eta == 0, 1.0, eta)
    out = run_pl_loop(ops, l, lam, x0, z0, eta, eta2, res_tol, crit.maxits,
                      crit.unbounded, telem, g)
    x, adv, q, conv, bad = out[:5]
    done = (~bad) if crit.unbounded else conv
    inf = torch.tensor(math.inf, dtype=ops.sdt, device=b.device)
    res = CGResult(x=x.to(b.dtype), niterations=adv, rnrm2=torch.abs(q),
                   r0nrm2=eta, bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=inf,
                   converged=done, breakdown=bad & ~done, telem=telem)
    if g is not None and g.state_io:
        res.carry = out[5]
    return res


# -- the spectral estimate -------------------------------------------------

def pl_restart_policy():
    """The recovery policy a p(l) solver arms when the caller gave none
    (``acg_tpu/recurrence.py:1326``): the square-root breakdown of the
    deep pipeline is an expected event, and its remedy is the ladder's
    restart from the current iterate, budgeted generously, with no
    transport or host fallback."""
    from acg_tpu_torch.solvers.resilience import RecoveryPolicy
    return RecoveryPolicy(max_restarts=PL_RESTART_BUDGET,
                          fallback_comm=False, fallback_host=False)


def _lmax(spmv, v0, iters: int = POWER_ITERS) -> float:
    """Power-iteration Rayleigh quotient through the tier's own SpMV
    (``acg_tpu.recurrence._lmax_program``): ``iters`` + 1 SpMVs."""
    sdt = acc_dtype(v0.dtype)

    def ldot(a, c):
        return torch.dot(a.to(sdt), c.to(sdt))

    v = v0
    for _ in range(iters):
        w = spmv(v)
        v = (w.to(sdt) / torch.sqrt(ldot(w, w))).to(v.dtype)
    w = spmv(v)
    return float(ldot(v, w) / ldot(v, v))


def estimate_lam(spmv, n: int, dtype, device) -> tuple:
    """``(lmin, lmax)`` host floats for the basis and shift interval: the
    power iteration from numpy's ``default_rng(0)`` start vector, times
    :data:`LAM_SAFETY`; lmin = 0 (SPD)."""
    rng = np.random.default_rng(0)
    v0 = torch.tensor(rng.standard_normal(n), dtype=dtype, device=device)
    return (0.0, _lmax(spmv, v0) * LAM_SAFETY)


# -- the host oracle -------------------------------------------------------

def host_sstep_cg(A, b, x0=None, rtol=1e-8, maxits=1000, s=4, basis=None,
                  lam=None):
    """Eager f64 s-step CG oracle on the host (scipy matvec), the
    reference's ``host_sstep_cg``: returns ``(x, iterations, relative
    residual, trajectory of (gamma, alpha, beta, denom))``."""
    import scipy.sparse as sp
    A = sp.csr_matrix(A)
    n = A.shape[0]
    b = np.asarray(b, np.float64)
    x = np.zeros(n) if x0 is None else np.asarray(x0, np.float64).copy()
    basis = basis or ("chebyshev" if s >= 4 else "monomial")
    if lam is None and basis == "chebyshev":
        v = np.random.default_rng(0).standard_normal(n)
        for _ in range(POWER_ITERS):
            v = A @ v
            v /= np.linalg.norm(v)
        lam = (0.0, float(v @ (A @ v)) * LAM_SAFETY)
    lam = lam or (0.0, 0.0)
    r = b - A @ x
    p = r.copy()
    gamma = float(r @ r)
    r0 = np.sqrt(gamma)
    tol2 = (rtol * r0) ** 2
    w = 2 * s + 1
    Bm = sstep_combined_bmat(s, basis, lam, torch.float64).numpy()
    traj = []
    k = 0

    def powers(v, deg):
        rows = [v]
        if basis == "monomial":
            for _ in range(deg):
                rows.append(A @ rows[-1])
            return rows
        d = (lam[0] + lam[1]) / 2.0
        c = (lam[1] - lam[0]) / 2.0
        for j in range(deg):
            wv = A @ rows[-1] - d * rows[-1]
            rows.append(wv / c if j == 0 else 2 * wv / c - rows[-2])
        return rows

    while k < maxits and gamma >= tol2:
        V = np.stack(powers(p, s) + powers(r, s - 1))
        G = V @ V.T
        pc = np.zeros(w)
        pc[0] = 1.0
        rc = np.zeros(w)
        rc[s + 1] = 1.0
        xc = np.zeros(w)
        gamma = float(G[s + 1, s + 1])
        for j in range(s):
            if gamma < tol2 or k >= maxits:
                break
            wc = Bm @ pc
            denom = float(pc @ (G @ wc))
            alpha = gamma / denom
            xc += alpha * pc
            rc = rc - alpha * wc
            gamma_next = float(rc @ (G @ rc))
            beta = gamma_next / gamma
            pc = rc + beta * pc
            traj.append((gamma_next, alpha, beta, denom))
            gamma = gamma_next
            k += 1
        x = x + xc @ V
        r = rc @ V
        p = pc @ V
    return x, k, np.sqrt(max(gamma, 0.0)) / r0, traj


# -- segment probes (acg_tpu/recurrence.py:1155-1325) ----------------------
#
# The commbench observatory's measured segment decomposition: SpMV-only,
# halo-only and reduction-only probes built from the same TierOps the
# solve loops run (the same SpMV selection, the same psum ladder).  The
# reference chains ``reps`` rounds inside one fori_loop dispatch; the
# port chains ``reps`` EAGER rounds between the caller's two
# synchronizes, so every round pays its launches as an iteration of the
# solve loop does.  Each round feeds the next: the SpMV chain through
# its output (clamped, so repeated A.v stays finite without a norm
# smuggling a reduction into the SpMV segment), the halo and reduction
# chains through the first element of each part of their own vector,
# updated in place by 1e-30 times the received value or the reduced
# scalar -- one small launch, where the reference's whole-vector update
# would add a vector pass to the segment.  Probes read the solver's
# device arrays and never write them: a solve after the probes launches
# the same kernels and returns the same bits.

def _probe_reduction_calls(pipelined: bool) -> tuple[str, float]:
    """(flavour, calls an iteration) of the reduction segment: classic
    CG reduces two single-scalar dots an iteration, pipelined one fused
    two-scalar reduction."""
    return ("pdotk2", 1.0) if pipelined else ("pdot", 2.0)


def _chain(round_, v, reps: int):
    """``reps`` rounds of ``round_`` from ``v``, one after another."""
    def run():
        w = v
        for _ in range(int(reps)):
            w = round_(w)
        return w
    return run


def _feed(v, g):
    """``v``'s first element of each part plus 1e-30 ``g``, in place:
    the dependence of the next round on this one."""
    v.select(-1, 0).add_((g * 1e-30).to(v.dtype))
    return v


def _red_round(dot, dotk, flavour: str):
    def rnd(v):
        if flavour == "pdotk2":
            g1, g2 = dotk((v, v), (v, v))
            return _feed(v, g1 + g2)
        return _feed(v, dot(v, v))
    return rnd


def build_single_segment_probes(solver, b, reps: int) -> list[tuple]:
    """``[(name, runner, calls_per_iteration), ...]`` for the
    single-device tier: the SpMV alone (K1 or K7 under the hand-kernel
    choice) and the reduction ladder (no halo on one device).  Each
    runner chains ``reps`` rounds and returns the last vector."""
    from acg_tpu_torch.solvers.cg import _dotk

    if getattr(solver, "algo", None) is not None:
        raise ValueError("segment probes cover the classic/pipelined "
                         "recurrences")
    if str(solver.kernels).startswith("fused"):
        raise ValueError("segment probes cover the unfused programs: the "
                         "fused kernels K3/K4 merge the SpMV with the "
                         "updates")
    dtype = solver._solve_dtype()
    dot, sdt = solver._dot_setup(dtype, solver.precise_dots)
    ops = single_ops(solver.A, solver._spmv_of(), dot, sdt)
    v0 = torch.ones(int(solver.A.nrows), dtype=dtype, device=solver.device)
    flavour, calls = _probe_reduction_calls(solver.pipelined)
    return [("spmv", _chain(lambda v: torch.clamp(ops.spmv(v), -1e3, 1e3),
                            v0, reps), 1.0),
            ("reduction", _chain(_red_round(ops.dot, _dotk(ops.dot),
                                            flavour), v0.clone(), reps),
             calls)]


def _dist_pieces(solver, b_global):
    """The stacked tier's probe pieces: ``(ops, dotk, halo, b)``, its
    SpMV, dots and halo exchange as the loop runs them (``halo`` None
    without ghosts) and the right-hand side on the device."""
    from acg_tpu_torch.parallel.halo import halo_exchange
    from acg_tpu_torch.parallel.halo_dma import halo_exchange_dma
    from acg_tpu_torch.parallel.reductions import (make_ldot, make_pdot,
                                                   make_pdotk)

    if getattr(solver, "algo", None) is not None:
        raise ValueError("segment probes cover the classic/pipelined "
                         "recurrences")
    if solver._ranks is not None:
        raise ValueError("segment probes run on one process (the "
                         "single-controller observatory)")
    prob = solver.problem
    sdt = acc_dtype(prob.vdtype)
    ldot = make_ldot(sdt)
    ops = TierOps(spmv=solver._spmv(),
                  dot=make_pdot(solver._psum, ldot, sdt,
                                solver.precise_dots),
                  psum_stack=solver._psum, sdt=sdt)
    dotk = make_pdotk(solver._psum, ldot, sdt, solver.precise_dots)
    b, _x0 = solver.device_args(np.asarray(b_global))
    h, scnt = solver._halo, solver._scnt
    recv = None
    if solver.comm == "dma":
        recv = torch.zeros((prob.nparts, prob.nparts,
                            max(prob.halo.maxcnt, 1)), dtype=b.dtype,
                           device=b.device)

    def halo(x):
        if solver.comm == "dma":
            return halo_exchange_dma(x, h.send_idx, h.ghost_src,
                                     h.ghost_valid, scnt, recv)
        return halo_exchange(x, h.send_idx, h.ghost_src)

    return ops, dotk, (halo if prob.halo.has_ghosts else None), b


def dist_comm_rounds(solver, b_global) -> tuple:
    """``(reduction, halo, v)`` of the stacked tier: one round of its
    reduction ladder (a dot: the per-part dot and the parts' sum), one
    halo exchange of its transport (None without ghosts), and a device
    vector to apply them to -- the pieces the segment probes chain,
    without the chaining or the probes' feed."""
    ops, _dotk, halo, b = _dist_pieces(solver, b_global)
    return (lambda v: ops.dot(v, v)), halo, b


def build_dist_segment_probes(solver, b_global, reps: int) -> list[tuple]:
    """``[(name, runner, calls_per_iteration), ...]`` for the stacked
    multi-part tier: the halo'd SpMV the solve runs (K1 batched over
    parts with the exchange of the solver's transport, or the
    overlapped SpMV under ``kernels="fused"``), the halo exchange alone
    (the pack gather, K6 ``halo_put`` under dma or the transpose under
    xla, the unpack gather) and the reduction ladder (the per-part dot
    and the parts' sum; one fused two-scalar psum for pipelined)."""
    ops, dotk, halo, b = _dist_pieces(solver, b_global)
    flavour, calls = _probe_reduction_calls(solver.pipelined)
    probes = [("spmv", _chain(lambda v: torch.clamp(ops.spmv(v), -1e3,
                                                    1e3), b, reps), 1.0)]
    if halo is not None:
        probes.append(("halo", _chain(lambda v: _feed(v, halo(v)[:, 0]),
                                      b.clone(), reps), 1.0))
    probes.append(("reduction", _chain(_red_round(ops.dot, dotk, flavour),
                                       b.clone(), reps), calls))
    return probes
