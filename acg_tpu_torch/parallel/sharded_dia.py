"""The sharded gen-direct tier: Poisson DIA planes built on the device,
CG over parts, manufactured solutions and df64 refinement.

The counterpart of ``acg_tpu/parallel/sharded_dia.py``, the route of
the ``gen:`` specs too large for a host matrix under ``--nparts``,
``--manufactured-solution`` or ``--refine``.  The JAX package shards
every vector over a device mesh and lets the SPMD partitioner derive
the halo from the cyclic-shift SpMV; the port keeps the vectors whole on
one device, as ``(N,)`` tensors, so the dots, updates and kernels are
the single-device tier's:

* the counterpart of ``PallasRollSpmv`` is kernel K1 on the whole
  planes, for every ``nparts``: on one device the parts share one
  memory, and K1 over all rows gives the bits of K1 over each part's
  halo'd window without copying the windows;
* the roll SpMV (:func:`acg_tpu_torch.ops.spmv.dia_mv_roll`) is the
  plain version, and the CPU's;
* the df64 residual (:func:`dia_mv_roll_df`) makes the refinement's
  outer residual f64-class over f32 arrays.

The manufactured solution is the JAX package's draw,
``jax.random.normal(jax.random.key(seed))`` (:mod:`acg_tpu_torch.prng`:
threefry over the partitionable counters and XLA's erfinv, computed on
the device), normalised to unit norm; the solvers also take an explicit
x.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from acg_tpu_torch import prng
from acg_tpu_torch.errors import NotConvergedError
from acg_tpu_torch.io.generators import poisson_dia_device
from acg_tpu_torch.ops.precision import df_add, two_prod, two_sum
from acg_tpu_torch.ops.spmv import (DiaMatrix, acc_dtype, dia_mv_roll,
                                    spmv_flops)
from acg_tpu_torch.parallel.reductions import make_rank_psum
from acg_tpu_torch.solvers.cg import TorchCGSolver, _spmv_fn
from acg_tpu_torch.solvers.stats import StoppingCriteria

# options of acg_tpu's ShardedDiaCGSolver that the port does not carry
# yet, each refused by name: (keyword, value that means "off")
_REFUSED = (("health", None), ("ckpt", None), ("recovery", None))


def dia_mv_roll_df(planes, offsets, xh, xl):
    """``y = A x`` in double-float (df64) arithmetic over the roll
    formulation (``acg_tpu/parallel/sharded_dia.py:43-66``): x rides as
    an (hi, lo) f32 pair, every product is Dekker's two-product and every
    sum Knuth's two-sum, so ``(yh, yl)`` carries ~48 mantissa bits while
    every tensor stays f32.  The Poisson plane values (-1, 2d) are exact
    in f32 and bf16, so promoting the planes loses nothing."""
    sdt = torch.float32
    yh = torch.zeros(xh.shape, dtype=sdt, device=xh.device)
    yl = torch.zeros_like(yh)
    for plane, off in zip(planes, offsets):
        v = plane.to(sdt)
        ph, pe = two_prod(v, torch.roll(xh, -off).to(sdt))
        pe = pe + v * torch.roll(xl, -off).to(sdt)
        yh, yl = df_add((yh, yl), (ph, pe))
    return yh, yl


def _roll_spmv(A, x):
    return dia_mv_roll(A.data, A.offsets, x)


class ShardedDiaCGSolver(TorchCGSolver):
    """CG over square DIA planes on ``nparts`` row parts
    (``acg_tpu.parallel.sharded_dia.ShardedDiaCGSolver``): the
    single-device solver's programs over K1 on the whole planes
    (``kernels="auto"`` on CUDA, or ``"pallas-roll"``: its plain version
    for CPU tensors) or over the roll SpMV (``"auto"`` on the CPU, or
    ``"xla-roll"``).  ``precond``,
    ``replace_every`` and ``algorithm`` ride those programs as on one
    device.  ``stencil`` = ``(n, dim)`` of the generating Poisson grid
    arms :func:`spot_check_manufactured`.  ``trace``/``progress`` ride
    the single-device programs (the reference's ``:234-270``).  Not
    carried yet, each refused with a ValueError naming it: ``health``,
    ``ckpt`` and ``recovery``."""

    def __init__(self, A: DiaMatrix, nparts: int = 1,
                 pipelined: bool = False, precise_dots: bool = False,
                 vector_dtype=None, stencil=None, replace_every: int = 0,
                 replace_restart: bool = True, precond=None, algorithm=None,
                 kernels: str = "auto", device=None, trace: int = 0,
                 progress: int = 0, **options):
        if kernels not in ("auto", "xla-roll", "pallas-roll"):
            raise ValueError(f"unknown sharded kernels choice {kernels!r} "
                             f"(auto, xla-roll or pallas-roll)")
        for name, off in _REFUSED:
            if options.pop(name, off) not in (off,):
                raise ValueError(f"ShardedDiaCGSolver: {name} is not "
                                 f"ported to the sharded tier yet")
        if options:
            raise TypeError(f"ShardedDiaCGSolver: unexpected options "
                            f"{sorted(options)}")
        if A.ncols_padded != A.nrows:
            raise ValueError("sharded DIA solve needs a square matrix")
        super().__init__(A, pipelined=pipelined, kernels="xla",
                         vector_dtype=vector_dtype, device=device,
                         precise_dots=precise_dots,
                         replace_every=replace_every,
                         replace_restart=replace_restart, precond=precond,
                         algorithm=algorithm, trace=trace,
                         progress=progress)
        on_cuda = self.device.type == "cuda"
        if kernels == "auto":
            kernels = "pallas-roll" if on_cuda else "xla-roll"
        elif kernels == "pallas-roll" and not on_cuda:
            kernels = "pallas-roll-plain"
        self.kernels = kernels
        self.nparts = int(nparts)
        self.stencil = stencil
        # this process's rows of the N-row system (all of them here; a
        # rank's on the multi-process tier)
        self.N, self.row0, self.nloc = A.nrows, 0, A.nrows
        # a rank's window of the manufactured x and the row of its first
        # value (the spot check reads its rows' neighbours there)
        self._x_win, self._x_lo = None, 0

    def _spmv_of(self):
        if self.kernels == "xla-roll":
            return _roll_spmv
        return _spmv_fn("pallas")

    def _manufactured_x(self, seed: int, dtype, xsol):
        if xsol is not None:
            if not isinstance(xsol, torch.Tensor):
                xsol = torch.from_numpy(np.array(xsol))
            return xsol.to(self.device, dtype)
        sdt = acc_dtype(dtype)
        x = prng.normal(seed, self.A.nrows, sdt, self.device)
        return (x / torch.linalg.norm(x)).to(dtype)

    def _fault_refusals(self, fault) -> None:
        """The fault injector's sites and crash hook are not ported to
        the sharded tier yet: an armed spec refuses by name."""
        from acg_tpu_torch import faults
        from acg_tpu_torch.errors import AcgError, ErrorCode
        spec = faults.active_fault()
        if spec is not None and (spec.device_site or spec.site == "crash"):
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"fault injection ({spec}) is not ported to the sharded "
                f"gen-direct tier yet; use a replicated-read solve")

    def ones_b(self, dtype=None) -> torch.Tensor:
        """The all-ones right-hand side (the CLI default b)."""
        return torch.ones(self.A.nrows, dtype=dtype or self._vector_dtype(),
                          device=self.device)

    def manufactured(self, seed: int = 42, xsol=None):
        """``(xsol, b)`` on the device: the JAX package's unit-norm
        normal draw for ``seed`` (or ``xsol`` as it is) and
        ``b = A xsol`` through the roll SpMV (``sharded_dia.py:418-449``).
        The replacement tier's b is f32, as its outer iteration is."""
        dtype = torch.float32 if self.replace_every else \
            self._vector_dtype()
        x = self._manufactured_x(seed, dtype, xsol)
        return x, dia_mv_roll(self.A.data, self.A.offsets, x)

    def manufactured_df(self, seed: int = 42, xsol=None):
        """``(xsol, (bh, bl))``: an f32 manufactured solution with b in
        double-float, the right-hand side of f64-grade refinement targets
        (an f32-rounded b caps the reachable error at ~1e-7)."""
        x = self._manufactured_x(seed, torch.float32, xsol)
        return x, dia_mv_roll_df(self.A.data, self.A.offsets, x,
                                 torch.zeros_like(x))

    def _norm(self, v) -> float:
        """The 2-norm of a solver vector, on the host."""
        return float(torch.linalg.norm(v))

    def _mv_df(self, xh, xl):
        """``A x`` in df64 over the planes (the refinement residual)."""
        return dia_mv_roll_df(self.A.data, self.A.offsets, xh, xl)

    def error_norms(self, x, xsol):
        """``(err0, err)``: the initial and final solution error 2-norms."""
        sdt = acc_dtype(x.dtype)
        return (self._norm(xsol.to(sdt)), self._norm((x - xsol).to(sdt)))

    def error_norms_df(self, xh, xl, xsol):
        """The error norms of a df64 iterate against an f32 xsol, without
        leaving df precision: ``|| (xh - xsol) + xl ||``."""
        dh, dl = two_sum(xh, -xsol)
        return self._norm(xsol), self._norm(dh + (dl + xl))

    def gather_x(self, x) -> np.ndarray:
        """The solution on the host, as f64 (bf16 widened first)."""
        xv = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
        return xv.cpu().numpy().astype(np.float64)

    def solve_refined(self, b, criteria=None, inner_rtol: float = 1e-5,
                      warmup: int = 0, max_passes: int = 40,
                      inner_maxits: int | None = None):
        """Iterative refinement on the device (``sharded_dia.py:
        473-601``): a df64 outer residual through :func:`dia_mv_roll_df`
        over the whole planes, inner solves of this solver's programs,
        and a df64 solution accumulator.  ``b`` is an f32 tensor or a
        ``(bh, bl)`` df64 pair (:meth:`manufactured_df`).  Returns the
        ``(hi, lo)`` solution pair."""
        crit = criteria or StoppingCriteria()
        bh, bl = b if isinstance(b, tuple) else (b.to(torch.float32), None)
        bl = torch.zeros_like(bh) if bl is None else bl

        def residual(xh, xl):
            ah, al = self._mv_df(xh, xl)
            rh, rl = df_add((bh, bl), (-ah, -al))
            return rh, rl, self._norm(rh)

        st = self.stats
        st.criteria = crit
        t0 = time.perf_counter()
        xh, xl = torch.zeros_like(bh), torch.zeros_like(bh)
        rh, rl, r0nrm = residual(xh, xl)
        st.r0nrm2 = r0nrm
        st.bnrm2 = r0nrm   # x0 = 0: r0 == b
        st.x0nrm2 = 0.0
        res_tol = max(crit.residual_atol, crit.residual_rtol * r0nrm)
        unbounded = res_tol <= 0
        total_inner = npasses = 0
        rnrm = r0nrm
        stalled = False
        converged = (not unbounded) and rnrm < res_tol
        while (not converged and not stalled and npasses < max_passes
               and total_inner < crit.maxits):
            budget = crit.maxits - total_inner
            inner_crit = StoppingCriteria(
                maxits=min(inner_maxits or budget, budget),
                residual_rtol=inner_rtol)
            self.stats = type(st)(unknowns=st.unknowns)
            try:
                d = super().solve(rh, criteria=inner_crit,
                                  raise_on_divergence=False, warmup=warmup,
                                  host_result=False)
            finally:
                inner_iters = self.stats.niterations
                self.stats = st
            warmup = 0
            xh_new, xl_new = df_add((xh, xl), (d.to(torch.float32),
                                               torch.zeros_like(xh)))
            rh2, rl2, rnrm_new = residual(xh_new, xl_new)
            npasses += 1
            total_inner += inner_iters
            # `not (new < old)`: a NaN residual (a diverged inner solve)
            # keeps the better iterate and stops too
            if not rnrm_new < rnrm:
                stalled = True
            else:
                xh, xl, rh, rl = xh_new, xl_new, rh2, rl2
                if rnrm_new >= 0.5 * rnrm:
                    stalled = True   # the inner accuracy is exhausted
                rnrm = rnrm_new
            converged = (not unbounded) and rnrm < res_tol
        if unbounded:
            converged = True
        st.tsolve += time.perf_counter() - t0
        st.nsolves += 1
        st.nrefine = npasses
        st.niterations = total_inner
        st.ntotaliterations += total_inner
        st.rnrm2 = rnrm
        st.dxnrm2 = float("inf")
        st.converged = bool(converged)
        st.fexcept_arrays = [np.asarray([0.0])]
        # the last inner solve's ring (each pass ran on a stats of its own)
        st.trace = self.last_trace
        if not converged:
            raise NotConvergedError(
                f"sharded refinement stalled after {npasses} passes "
                f"({total_inner} inner iterations), residual {rnrm:.3e}")
        return xh, xl


def _window_planes(n: int, dim: int, rlo: int, rhi: int, L: int, R: int,
                   dtype, device, epsilon: float = 0.0):
    """The Poisson planes of global rows ``[rlo - L, rhi + R)`` -- a
    rank's rows and its halo -- in :func:`~acg_tpu_torch.io.generators.
    poisson_dia_device`'s values, zero on the halo rows (iota arithmetic:
    no host data, nothing of the other rows)."""
    N = n ** dim
    g = torch.arange(rlo - L, rhi + R, device=device)
    own = (g >= rlo) & (g < rhi)
    row = g.clamp(0, N - 1)
    offsets = sorted([s for a in range(dim) for s in (-(n ** a), n ** a)]
                     + [0])
    planes = torch.zeros((len(offsets), g.numel()), dtype=dtype,
                         device=device)
    for d, off in enumerate(offsets):
        if off == 0:
            diag = torch.full((g.numel(),), float(2 * dim), dtype=dtype,
                              device=device)
            if epsilon:
                diag += torch.tensor(epsilon, dtype=dtype, device=device)
            planes[d] = torch.where(own, diag, 0)
            continue
        coord = (row // abs(off)) % n
        keep = own & ((coord > 0) if off < 0 else (coord < n - 1))
        planes[d] = torch.where(keep, -1.0, 0.0).to(dtype)
    return planes, tuple(int(o) for o in offsets)


class RankShardedDiaCGSolver(ShardedDiaCGSolver):
    """The sharded tier on the multi-process tier (``--multihost`` on
    the gen-direct route, ``acg_tpu/cli.py:2291``): each rank holds the
    rows of its parts, ``[row0, row0 + nloc)``, and the planes of its
    halo'd window ``[row0 - L, row0 + nloc + R)`` only (L, R: the band's
    reach), generated on its card.

    The SpMV is ``PallasRollSpmv``'s (``acg_tpu/parallel/sharded_dia.py:
    86-143``): the edge rows are exchanged with the neighbour ranks (one
    gather of every rank's head and tail), the window is ``[left halo |
    x_loc | right halo]``, K1 runs on it (the roll SpMV under
    ``kernels="xla-roll"``, the CPU's default) and its own rows are
    sliced out -- the bits of one process's SpMV, row for row.  A dot is
    this rank's partial folded with the other ranks' in rank order, so
    every rank holds the same scalar; it is not the one-process dot,
    which sums all N products in one reduction.  Each rank draws only
    its window of the manufactured solution from the partitionable
    counters (the one-process draw's values) and normalises it by the
    norm of its rows' squares folded over the ranks -- not the bits of
    one process's norm, which sums all N squares in one reduction."""

    def __init__(self, n: int, dim: int, nparts: int, dtype=torch.float32,
                 vector_dtype=None, epsilon: float = 0.0,
                 kernels: str = "auto", device=None, **options):
        from acg_tpu_torch.parallel import mesh, multihost

        if options.get("precond") is not None or \
                options.get("algorithm") is not None:
            raise ValueError("ShardedDiaCGSolver: precond and algorithm "
                             "are not ported to the multi-process tier yet")
        self.world = multihost.world()
        size, rank = self.world.size, self.world.rank
        N = n ** dim
        bounds = np.linspace(0, N, nparts + 1).astype(np.int64)
        lo, hi = mesh.part_range(nparts, rank, size)
        rlo, rhi = int(bounds[lo]), int(bounds[hi])
        L = R = n ** (dim - 1)
        if min(int(bounds[b] - bounds[a])
               for a, b in mesh.part_ranges(nparts, size)) < max(L, R):
            raise ValueError(
                f"each rank needs at least {max(L, R)} rows (the band's "
                f"reach) for its halo window; {N} rows over {size} "
                f"ranks are fewer")
        planes, offsets = _window_planes(n, dim, rlo, rhi, L, R, dtype,
                                         device, epsilon)
        nwin = planes.shape[1]
        A = DiaMatrix(data=planes, offsets=offsets, nrows=nwin,
                      ncols_padded=nwin)
        super().__init__(A, nparts=nparts, vector_dtype=vector_dtype,
                         kernels=kernels, device=device,
                         stencil=None if epsilon else (n, dim), **options)
        self.N, self.row0, self.nloc = N, rlo, rhi - rlo
        self.L, self.R = L, R
        self.rank, self.size = rank, size
        self._fold = make_rank_psum([1] * size)
        self.stats.unknowns = N

    @property
    def _spmv_flops(self) -> float:
        from acg_tpu_torch.parallel import multihost
        if self._spmv_flops_cache is None:
            mine = spmv_flops(self.A)
            self._spmv_flops_cache = float(multihost.allgather_array(
                np.asarray([mine])).sum())
        return self._spmv_flops_cache

    def _window(self, *vecs):
        """Each vector of this rank's rows, with its halo from the
        neighbour ranks: ``[left | v | right]`` (zeros past the ends)."""
        from acg_tpu_torch.parallel import multihost
        L, R = self.L, self.R
        edges = torch.cat([torch.cat([v[:R], v[v.numel() - L:]])
                           for v in vecs])
        rows = multihost.all_gather(edges)
        out = []
        for k, v in enumerate(vecs):
            base = k * (L + R)
            left = (rows[self.rank - 1][base + R:base + R + L]
                    if self.rank > 0 else v.new_zeros(L))
            right = (rows[self.rank + 1][base:base + R]
                     if self.rank < self.size - 1 else v.new_zeros(R))
            out.append(torch.cat([left, v, right]))
        return out

    def _rows(self, y):
        y = y[self.L:self.L + self.nloc]
        if y.device.type == "cuda" and y.data_ptr() % 16:
            y = y.clone()
        return y

    def _spmv_of(self):
        base = _roll_spmv if self.kernels == "xla-roll" \
            else _spmv_fn("pallas")

        def spmv(A, x):
            xw, = self._window(x)
            return self._rows(base(A, xw))
        return spmv

    def _dot_setup(self, dtype, precise: bool = False):
        dot, sdt = super()._dot_setup(dtype, precise)
        return (lambda a, c: self._fold(dot(a, c).reshape(1))), sdt

    def _norm(self, v) -> float:
        sdt = acc_dtype(v.dtype)
        return float(torch.sqrt(self._fold(torch.dot(
            v.to(sdt), v.to(sdt)).reshape(1))))

    def _mv_df(self, xh, xl):
        wh, wl = self._window(xh, xl)
        yh, yl = dia_mv_roll_df(self.A.data, self.A.offsets, wh, wl)
        return self._rows(yh), self._rows(yl)

    def ones_b(self, dtype=None) -> torch.Tensor:
        return torch.ones(self.nloc, dtype=dtype or self._vector_dtype(),
                          device=self.device)

    def _window_x(self, seed, dtype, xsol):
        """This rank's window ``[row0 - L, row0 + nloc + R)`` of the
        manufactured x, zeros past its ends: only those rows drawn, over
        the norm of every rank's own rows (or ``xsol``'s rows as they
        are)."""
        lo, hi = self.row0 - self.L, self.row0 + self.nloc + self.R
        a, b = max(lo, 0), min(hi, self.N)
        if xsol is not None:
            if not isinstance(xsol, torch.Tensor):
                xsol = torch.from_numpy(np.array(xsol))
            seg = xsol[a:b].to(self.device, dtype)
        else:
            sdt = acc_dtype(dtype)
            seg = prng.normal(seed, self.N, sdt, self.device, rows=(a, b))
            own = seg[self.row0 - a:self.row0 - a + self.nloc]
            nrm = torch.sqrt(self._fold(torch.dot(own, own).reshape(1)))
            seg = (seg / nrm).to(dtype)
        x = torch.nn.functional.pad(seg, (a - lo, hi - b))
        self._x_win, self._x_lo = x, lo
        return x

    def manufactured(self, seed: int = 42, xsol=None):
        dtype = torch.float32 if self.replace_every else \
            self._vector_dtype()
        x = self._window_x(seed, dtype, xsol)
        b = dia_mv_roll(self.A.data, self.A.offsets, x)
        return x[self.L:self.L + self.nloc].clone(), self._rows(b)

    def manufactured_df(self, seed: int = 42, xsol=None):
        x = self._window_x(seed, torch.float32, xsol)
        bh, bl = dia_mv_roll_df(self.A.data, self.A.offsets, x,
                                torch.zeros_like(x))
        return (x[self.L:self.L + self.nloc].clone(),
                (self._rows(bh), self._rows(bl)))

    def gather_x(self, x) -> np.ndarray:
        """Every rank's rows gathered to a whole f64 host vector, on
        every rank (collective)."""
        from acg_tpu_torch.parallel import multihost
        xv = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
        nmax = max(int(b - a) for a, b in self._rank_rows())
        pad = torch.zeros(nmax, dtype=xv.dtype, device=xv.device)
        pad[:self.nloc] = xv
        rows = multihost.all_gather(pad)
        return np.concatenate([r[:b - a].cpu().numpy().astype(np.float64)
                               for r, (a, b) in zip(rows,
                                                    self._rank_rows())])

    def _rank_rows(self):
        from acg_tpu_torch.parallel import mesh
        bounds = np.linspace(0, self.N, self.nparts + 1).astype(np.int64)
        return [(int(bounds[lo]), int(bounds[hi]))
                for lo, hi in mesh.part_ranges(self.nparts, self.size)]


def spot_check_manufactured(solver, xsol, b, nsample: int = 64,
                            seed: int = 0) -> float:
    """An independent check of a manufactured right-hand side
    (``sharded_dia.py:604-651``): sample rows, recompute each b_i on the
    host in f64 from the analytic stencil (2d x_i minus the in-bounds axis
    neighbours) and return the largest deviation from the device b,
    relative to max |b|.  Nothing is shared with the device SpMV; only
    the sampled entries leave the device."""
    n, dim = solver.stencil
    row0 = solver.row0
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(row0, row0 + solver.nloc, size=nsample))
    lo = 0
    if solver._x_win is not None:
        # a rank's window holds its sampled rows' neighbours
        xsol, lo = solver._x_win, solver._x_lo
    offs = [s for a in range(dim) for s in (-(n ** a), n ** a)]
    need = [rows]
    valid = {}
    for off in offs:
        coord = (rows // abs(off)) % n
        ok = coord > 0 if off < 0 else coord < n - 1
        valid[off] = ok
        need.append(np.where(ok, rows + off, rows))
    need_idx = np.unique(np.concatenate(need))
    bh = b[0] if isinstance(b, tuple) else b
    dev = xsol.device
    xv = xsol[torch.from_numpy(need_idx - lo).to(dev)]
    xv = xv.double().cpu().numpy()
    bv = bh[torch.from_numpy(rows - row0).to(bh.device)]
    bv = bv.double().cpu().numpy()
    lut = {int(g): k for k, g in enumerate(need_idx)}
    expect = 2.0 * dim * xv[[lut[int(i)] for i in rows]]
    for off in offs:
        expect = expect - np.array([xv[lut[int(i + off)]] if ok else 0.0
                                    for i, ok in zip(rows, valid[off])])
    scale = float(np.max(np.abs(bv)) or 1.0)
    return float(np.max(np.abs(bv - expect)) / scale)


def build_sharded_poisson_solver(n: int, dim: int, nparts: int = 1,
                                 dtype=torch.float32, vector_dtype=None,
                                 pipelined: bool = False,
                                 precise_dots: bool = False,
                                 epsilon: float = 0.0,
                                 replace_every: int = 0,
                                 replace_restart: bool = True,
                                 kernels: str = "auto", precond=None,
                                 algorithm=None, device=None, **options):
    """The planes of ``gen:poisson{dim}d:{n}`` on the device and their
    sharded solver (``sharded_dia.py:654-702``).  ``kernels``: ``"auto"``
    takes K1 on the whole planes on CUDA, for any ``nparts``, and the
    roll SpMV on the CPU; ``"pallas"`` (``"pallas-roll"``) K1 (its plain
    version on the CPU); ``"xla"`` (``"xla-roll"``) the roll SpMV.  K1
    refuses a dtype pair it has no kernel for.  ``epsilon`` shifts the
    diagonal and drops the analytic spot check (its stencil is
    unshifted)."""
    kernels = {"xla": "xla-roll", "pallas": "pallas-roll"}.get(kernels,
                                                              kernels)
    from acg_tpu_torch.parallel import multihost
    if multihost.process_count() > 1:
        return RankShardedDiaCGSolver(
            n, dim, nparts, dtype=dtype, vector_dtype=vector_dtype,
            epsilon=epsilon, kernels=kernels, device=device,
            pipelined=pipelined, precise_dots=precise_dots,
            replace_every=replace_every, replace_restart=replace_restart,
            precond=precond, algorithm=algorithm, **options)
    planes, offsets, N = poisson_dia_device(n, dim, dtype=dtype,
                                            device=device, epsilon=epsilon)
    A = DiaMatrix(data=planes, offsets=offsets, nrows=N, ncols_padded=N)
    return ShardedDiaCGSolver(
        A, nparts=nparts, pipelined=pipelined, precise_dots=precise_dots,
        vector_dtype=vector_dtype, stencil=None if epsilon else (n, dim),
        replace_every=replace_every, replace_restart=replace_restart,
        precond=precond, algorithm=algorithm, kernels=kernels,
        device=device, **options)
