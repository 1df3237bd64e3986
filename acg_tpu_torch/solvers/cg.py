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

from acg_tpu_torch._device import device_sync, resolve_device
from acg_tpu_torch.errors import NotConvergedError
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.ops.operator import is_matrix_free
from acg_tpu_torch.ops.spmv import (DeviceMatrix, DiaMatrix, acc_dtype,
                                    matrix_dtype, matrix_index_bytes, spmv,
                                    spmv_flops)
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


def _scalar_setup(dtype):
    """``(dot, sdt)``: the CG-scalar dot product and scalar dtype for
    ``dtype`` vector storage.  bf16 storage computes every scalar in f32:
    ``torch.dot`` on bf16 tensors would return bf16, so both operands
    are widened first."""
    sdt = acc_dtype(dtype)
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


def _iterate(step, maxits: int, unbounded: bool, state) -> None:
    """Run ``step(live)`` until ``maxits`` iterations or convergence.

    ``state.done`` is the device convergence flag that ``step`` updates;
    ``live`` is ``~state.done`` on entry to the step, which the step
    uses to freeze its state once converged.  The host reads the flag
    once per :data:`CHUNK` iterations.  Unbounded solves run exactly
    ``maxits`` steps with ``live = None`` and no reads.
    """
    if unbounded:
        for _ in range(maxits):
            step(None)
        return
    ran = 0
    while ran < maxits and not bool(state.done):
        for _ in range(min(CHUNK, maxits - ran)):
            step(~state.done)
        ran += CHUNK


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
    their own apply, ``acg_tpu/ops/pallas_kernels.py:798-800``)."""
    if kernels == "xla":
        return spmv

    def f(A, x):
        if isinstance(A, DiaMatrix) and A.ncols_padded == A.nrows:
            return K.dia_spmv(A.data, A.offsets, x, offsets_t=A.offsets_t)
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


def _cg_program(spmv, dot, b, x0, crit: StoppingCriteria) -> CGResult:
    """Classic CG (``acg_tpu.solvers.jax_cg._cg_program``, plain path)
    over the caller's ``spmv(x)`` and global ``dot(a, c)``: one vector on
    one device, or stacked parts with psum'd dots (``acg_tpu/parallel/
    dist.py:1585-1694``, unpreconditioned).  The updates are plain
    PyTorch; the SpMV carries the kernel choice."""
    dtype = b.dtype
    sdt = acc_dtype(dtype)
    dev = b.device
    needs_diff = crit.needs_diff
    unbounded = crit.unbounded
    bnrm2 = torch.sqrt(dot(b, b))
    x0nrm2 = torch.sqrt(dot(x0, x0))
    r = b - spmv(x0)
    gamma = dot(r, r)
    r0nrm2 = torch.sqrt(gamma)
    res_tol, diff_tol = _tolerances(crit, r0nrm2, x0nrm2, sdt)
    inf = torch.tensor(math.inf, dtype=sdt, device=dev)
    zero = torch.zeros((), dtype=sdt, device=dev)
    s = _State(x=x0, r=r, p=r, gamma=gamma, dx=inf,
               k=torch.zeros((), dtype=torch.int64, device=dev))
    s.done = (_converged(gamma, inf, res_tol, diff_tol) if not unbounded
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
        gamma_next = dot(r, r)
        beta = gamma_next / s.gamma
        p_next = (r.to(sdt) + beta * s.p.to(sdt)).to(dtype)
        dx = alpha * alpha * dot(s.p, s.p) if needs_diff else inf
        s.r = r
        if live is None:
            s.p, s.gamma, s.dx = p_next, gamma_next, dx
            return
        s.p = torch.where(live, p_next, s.p)
        s.gamma = torch.where(live, gamma_next, s.gamma)
        s.dx = torch.where(live, dx, s.dx)
        s.k = s.k + live.to(torch.int64)
        s.done = s.done | _converged(s.gamma, s.dx, res_tol, diff_tol)

    _iterate(step, crit.maxits, unbounded, s)
    k = torch.tensor(crit.maxits, device=dev) if unbounded else s.k
    done = torch.tensor(True, device=dev) if unbounded else s.done
    return CGResult(x=s.x, niterations=k, rnrm2=torch.sqrt(s.gamma),
                    r0nrm2=r0nrm2, bnrm2=bnrm2, x0nrm2=x0nrm2,
                    dxnrm2=torch.sqrt(s.dx), converged=done,
                    breakdown=torch.tensor(False, device=dev))


def _cg_pipelined_program(spmv, dot, dotk, b, x0, crit: StoppingCriteria,
                          use_kernel: bool) -> CGResult:
    """Pipelined (Ghysels-Vanroose) CG (``acg_tpu.solvers.jax_cg.
    _cg_pipelined_program``, plain body ``:925-1012``; stacked parts:
    ``acg_tpu/parallel/dist.py:1833-1956``), both scalars of an iteration
    from one ``dotk`` (one fused psum on stacked parts).  gamma_prev =
    alpha_prev = inf on entry gives beta = 0 on the first iteration;
    convergence tests the carried gamma = ||r||^2 from before the update
    (one iteration stale, ``cgcuda.c:1798-1810``).  With ``use_kernel``
    the 6-vector update is kernel K5, in place, on the flat view of the
    vectors (the whole stack at once)."""
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
        if live is None:
            s.gamma_prev, s.alpha_prev, s.dx = gamma, alpha, dx
            return
        s.gamma_prev = torch.where(live, gamma, s.gamma_prev)
        s.alpha_prev = torch.where(live, alpha, s.alpha_prev)
        s.dx = torch.where(live, dx, s.dx)
        s.k = s.k + live.to(torch.int64)
        s.done = s.done | _converged(s.gamma_prev, s.dx, res_tol, diff_tol)

    _iterate(step, crit.maxits, unbounded, s)
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
                    breakdown=torch.tensor(False, device=dev))


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
    ``_host_x(x)`` (the host array the caller gets) and
    ``_account_ops(st, niter)``."""

    def _host_x(self, x: np.ndarray) -> np.ndarray:
        return x

    def solve(self, b, x0=None, criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True, warmup: int = 0,
              host_result: bool = True):
        """Solve Ax=b.  Returns x as a numpy array (bf16 solves as f32),
        or the device tensor with ``host_result=False``.  ``warmup``
        solves run first, outside the timed region; the timed solve is
        bracketed by device synchronisations."""
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        program = self._program(crit)
        t_xfer = time.perf_counter()
        b, x0 = self.device_args(b, x0)
        device_sync(self.device)
        _add_timing(st, "transfer", time.perf_counter() - t_xfer)
        t_warm = time.perf_counter()
        for _ in range(max(warmup, 0)):
            program(b, x0)
        device_sync(self.device)
        if warmup > 0:
            _add_timing(st, "compile", time.perf_counter() - t_warm)
        t0 = time.perf_counter()
        res = program(b, x0)
        device_sync(self.device)
        t_solve = time.perf_counter() - t0
        st.tsolve += t_solve
        _add_timing(st, "solve", t_solve)
        niter = int(res.niterations)
        st.nsolves += 1
        st.niterations = niter
        st.ntotaliterations += niter
        st.bnrm2 = float(res.bnrm2)
        st.x0nrm2 = float(res.x0nrm2)
        st.r0nrm2 = float(res.r0nrm2)
        st.rnrm2 = float(res.rnrm2)
        st.dxnrm2 = float(res.dxnrm2)
        st.converged = bool(res.converged) or crit.unbounded
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
    """

    def __init__(self, A: DeviceMatrix, pipelined: bool = False,
                 kernels: str = "auto", vector_dtype=None, device=None):
        self.device = resolve_device(device)
        if A.device != self.device:
            raise ValueError(f"the matrix lives on {A.device}, the solver "
                             f"runs on {self.device}; build the matrix with "
                             f"device={str(self.device)!r}")
        self.A = A
        self.pipelined = pipelined
        self.vector_dtype = vector_dtype
        vdt = self._solve_dtype()
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
        self.kernels = kernels
        self.stats = SolverStats(unknowns=A.nrows)
        self._spmv_flops_cache: float | None = None

    @property
    def _spmv_flops(self) -> float:
        if self._spmv_flops_cache is None:
            self._spmv_flops_cache = spmv_flops(self.A)
        return self._spmv_flops_cache

    def _solve_dtype(self):
        """The vector dtype: the matrix dtype unless ``vector_dtype``
        overrides it."""
        if self.vector_dtype is not None:
            return self.vector_dtype
        return matrix_dtype(self.A)

    def _program(self, crit: StoppingCriteria):
        A, kernels = self.A, self.kernels
        if kernels.startswith("fused"):
            if crit.needs_diff:
                raise ValueError("kernels='fused' supports residual "
                                 "criteria only")
            return lambda b, x0: _cg_fused_program(A, b, x0, crit, kernels)
        spmv_ = _spmv_fn(kernels)

        def spmv(x):
            return spmv_(A, x)

        dot, _ = _scalar_setup(self._solve_dtype())
        if self.pipelined:
            return lambda b, x0: _cg_pipelined_program(
                spmv, dot, _dotk(dot), b, x0, crit, kernels != "xla")
        return lambda b, x0: _cg_program(spmv, dot, b, x0, crit)

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
        if self.kernels.startswith("fused"):
            # phase A (planes + r/p windows + p/t writes) as gemv, phase B
            # (4 reads + 2 writes) as axpy; no vector is re-read for dots
            st.ops["gemv"].add(niter + 1, 0.0,
                               (mat_bytes + 4 * n * dbl) * (niter + 1))
            st.ops["axpy"].add(niter, 0.0, 6 * n * dbl * niter)
            return
        st.ops["gemv"].add(niter + 1, 0.0,
                           (mat_bytes + 2 * n * dbl) * (niter + 1))
        st.ops["dot"].add(niter, 0.0, 2 * n * dbl * niter)
        st.ops["nrm2"].add(niter + 1, 0.0, n * dbl * (niter + 1))
        st.ops["axpy"].add(3 * niter, 0.0, 3 * n * dbl * 3 * niter)
        if not self.pipelined:
            st.ops["copy"].add(1, 0.0, 2 * n * dbl)


def _add_timing(st: SolverStats, name: str, seconds: float) -> None:
    st.timings[name] = st.timings.get(name, 0.0) + float(seconds)
