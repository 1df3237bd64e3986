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
                     maxits: int, unbounded: bool, telem=None):
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
    against the period rarely meets a block's end)."""
    sdt = ops.sdt
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
        # -- basis: 2s-1 SpMVs, no reduction ---------------------------
        rows = sstep_build_basis(ops, st.p, s, basis, dc)
        if s > 1:
            rows += sstep_build_basis(ops, st.r, s - 1, basis, dc)
        else:
            rows.append(st.r)
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
        st.gamma = torch.where(live, gamma_blk, st.gamma)
        k_old = st.k
        st.k = st.k + torch.where(live, nsteps, 0)
        st.bad = torch.where(live, bad, st.bad)
        if telem is not None and telem.progress:
            # a block crossing a multiple of the period beats once
            every = telem.progress
            telem.beat(st.k, st.gamma,
                       live & (k_old // every < st.k // every))

    return block


def run_sstep_loop(ops: TierOps, s: int, basis: str, lam, x0, r, gamma,
                   res_tol, maxits: int, unbounded: bool, telem=None):
    """The s-step outer loop, shared by every tier.  The stop flag is
    read once every ``CHUNK // s`` blocks; an unbounded solve stops only
    on a breakdown and otherwise runs ``ceil(maxits / s)`` blocks, the
    last one stopping at ``maxits``.  Returns ``(x, k, gamma_f, bad,
    done)``."""
    sdt = ops.sdt
    dev = r.device
    tol2 = res_tol * res_tol
    dc = tuple(v.to(dev) for v in _interval(lam, sdt))
    Bmat = sstep_combined_bmat(s, basis, lam, sdt).to(dev)
    st = _State(x=x0, r=r, p=r, gamma=gamma,
                k=torch.zeros((), dtype=torch.int64, device=dev),
                bad=torch.zeros((), dtype=torch.bool, device=dev))
    block = make_sstep_block(ops, s, basis, dc, Bmat, tol2, maxits,
                             unbounded, telem)
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
    return st.x, st.k, st.gamma, st.bad, done


def _setup(ops: TierOps, b, x0, crit):
    """The shared setup: ``(bnrm2, x0nrm2, r0, gamma0, r0nrm2, res_tol)``
    (one SpMV, three dots)."""
    sdt = ops.sdt
    bnrm2 = torch.sqrt(ops.dot(b, b))
    x0nrm2 = torch.sqrt(ops.dot(x0, x0))
    r = b - ops.spmv(x0)
    gamma = ops.dot(r, r)
    r0nrm2 = torch.sqrt(gamma)
    res_tol = torch.maximum(
        torch.tensor(crit.residual_atol, dtype=sdt, device=b.device),
        crit.residual_rtol * r0nrm2)
    return bnrm2, x0nrm2, r, gamma, r0nrm2, res_tol


def _cg_sstep_program(ops: TierOps, b, x0, crit, s: int, basis: str,
                      lam, telem=None) -> CGResult:
    """A whole s-step CG solve over ``ops`` (``acg_tpu.recurrence.
    _cg_sstep_program``; the stacked tier's body, ``acg_tpu/parallel/
    dist.py:2063-2185``, is the same code).  ``telem`` arms the ring and
    heartbeat (:func:`make_sstep_block`)."""
    bnrm2, x0nrm2, r, gamma, r0nrm2, res_tol = _setup(ops, b, x0, crit)
    x, k, gamma_f, bad, done = run_sstep_loop(
        ops, s, basis, lam, x0, r, gamma, res_tol, crit.maxits,
        crit.unbounded, telem)
    inf = torch.tensor(math.inf, dtype=ops.sdt, device=b.device)
    return CGResult(x=x, niterations=k,
                    rnrm2=torch.sqrt(torch.clamp(gamma_f, min=0.0)),
                    r0nrm2=r0nrm2, bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=inf,
                    converged=done, breakdown=bad & ~done, telem=telem)


# -- p(l)-CG ---------------------------------------------------------------

def pl_shifts(l: int, lam, sdt, device=None):
    """Chebyshev points of [lmin, lmax]: the shifts sigma_0..sigma_{l-1}
    of the auxiliary basis z = P_l(A) v."""
    d, c = _interval(lam, sdt)
    cosv = np.cos((2 * np.arange(l) + 1) * np.pi / (2 * l))
    return (d + c * torch.tensor(cosv, dtype=sdt)).to(device)


def run_pl_loop(ops: TierOps, l: int, lam, x0, z0, eta, eta2, res_tol,
                maxits: int, unbounded: bool, telem=None):
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
    the period."""
    sdt = ops.sdt
    dev = x0.device
    tol2 = res_tol * res_tol
    W = 2 * l + 2
    sigma = pl_shifts(l, lam, sdt, dev).unbind()
    one = torch.ones((), dtype=sdt, device=dev)
    zero = torch.zeros((), dtype=sdt, device=dev)

    def safe(v):
        return torch.where(v == 0, one, v)

    lead = x0.shape[:-1]    # () on one device, (P,) on stacked parts
    n = x0.shape[-1]
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
    st = _State(x=x0.to(sdt), q=eta, dprev=one,
                ptilde=torch.zeros_like(z0),
                adv=torch.zeros((), dtype=torch.int64, device=dev),
                conv=eta2 < tol2,
                bad=torch.zeros((), dtype=torch.bool, device=dev))

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
        Az = ops.spmv(zlast)
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
    j = 0
    while j < nsteps:
        stop = bool(st.bad if unbounded
                    else st.conv | st.bad | (st.adv >= maxits))
        if beats:
            telem.flush()
        if stop:
            break
        for _ in range(min(CHUNK, nsteps - j)):
            step(j)
            j += 1
    if beats:
        telem.flush()
    return st.x, st.adv, st.q, st.conv, st.bad


def _cg_pl_program(ops: TierOps, b, x0, crit, l: int, lam,
                   telem=None) -> CGResult:
    """A whole p(l)-CG solve over ``ops`` (``acg_tpu.recurrence.
    _cg_pl_program``; the stacked tier's body is the same code).
    ``telem`` arms the ring and heartbeat (:func:`run_pl_loop`); each
    restart attempt records its own, as the reference's does."""
    bnrm2, x0nrm2, r, eta2, eta, res_tol = _setup(ops, b, x0, crit)
    z0 = r / torch.where(eta == 0, 1.0, eta)
    x, adv, q, conv, bad = run_pl_loop(ops, l, lam, x0, z0, eta, eta2,
                                       res_tol, crit.maxits, crit.unbounded,
                                       telem)
    done = (~bad) if crit.unbounded else conv
    inf = torch.tensor(math.inf, dtype=ops.sdt, device=b.device)
    return CGResult(x=x.to(b.dtype), niterations=adv, rnrm2=torch.abs(q),
                    r0nrm2=eta, bnrm2=bnrm2, x0nrm2=x0nrm2, dxnrm2=inf,
                    converged=done, breakdown=bad & ~done, telem=telem)


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
