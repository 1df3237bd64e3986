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
from acg_tpu_torch.parallel.mesh import PARTS_AXIS
from acg_tpu_torch.parallel.reductions import make_rank_psum
from acg_tpu_torch.solvers.cg import TorchCGSolver, _spmv_fn
from acg_tpu_torch.solvers.stats import StoppingCriteria

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
    the single-device programs (the reference's ``:234-270``), and so do
    ``recovery``, ``health`` and ``ckpt`` (``:244-276``): the audit runs
    this tier's SpMV, a snapshot holds the global vectors under the tier
    name ``sharded-dia``, and a fault lands in the global vector (a
    ``part=`` target refuses with the reference's diagnosis)."""

    # snapshots name their own provenance: the carry is the global-vector
    # layout, but a resume must re-enter the same SpMV selection
    _ckpt_tier = "sharded-dia"

    def __init__(self, A: DiaMatrix, nparts: int = 1,
                 pipelined: bool = False, precise_dots: bool = False,
                 vector_dtype=None, stencil=None, replace_every: int = 0,
                 replace_restart: bool = True, precond=None, algorithm=None,
                 kernels: str = "auto", device=None, trace: int = 0,
                 progress: int = 0, recovery=None, health=None, ckpt=None):
        if kernels not in ("auto", "xla-roll", "pallas-roll"):
            raise ValueError(f"unknown sharded kernels choice {kernels!r} "
                             f"(auto, xla-roll or pallas-roll)")
        if A.ncols_padded != A.nrows:
            raise ValueError("sharded DIA solve needs a square matrix")
        super().__init__(A, pipelined=pipelined, kernels="xla",
                         vector_dtype=vector_dtype, device=device,
                         precise_dots=precise_dots,
                         replace_every=replace_every,
                         replace_restart=replace_restart, precond=precond,
                         algorithm=algorithm, trace=trace,
                         progress=progress, recovery=recovery,
                         health=health, ckpt=ckpt)
        # the fault diagnosis: this tier is multi-part but applies faults
        # to the global vector
        self._fault_nparts = int(nparts)
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

    def comm_profile(self) -> dict:
        """The static per-iteration communication ledger of the sharded
        tier (``acg_tpu/parallel/sharded_dia.py:316-409``), in the
        reference's keys.  The halo is derived from the offsets: under
        ``xla-roll`` each nonzero offset's cyclic shift moves
        ``min(|offset|, nloc)`` boundary elements a shard, one exchange
        per offset; under ``pallas-roll`` (K1 on the whole planes) a
        part reads the ``L + R`` band rows of its neighbours, one
        exchange per populated side.  The CG scalars psum as on the
        stacked tier; the CA recurrences and a preconditioner reclassify
        as there."""
        P = int(self.nparts)
        N = int(self.N)
        nloc = -(-N // P) if P else N
        vdt = (torch.bfloat16 if self.replace_every
               else self._vector_dtype())
        dbl = torch.empty((), dtype=vdt).element_size()
        sdl = torch.empty((), dtype=acc_dtype(vdt)).element_size()
        pallas = self.kernels.startswith("pallas-roll")
        offs = [int(o) for o in self.A.offsets]
        if P <= 1:
            per_shard, max_hops, nexch = 0, 0, 0
        elif pallas:
            L, R = max(0, -min(offs)), max(0, max(offs))
            per_shard, max_hops = L + R, 1
            nexch = int(bool(L)) + int(bool(R))
        else:
            nz = [abs(o) for o in offs if o]
            per_shard = sum(min(o, nloc) for o in nz)
            max_hops = max((-(-o // nloc) for o in nz), default=0)
            nexch = len(nz)
        nred = 1 if self.pipelined else 2
        scal = ((2 if self.pipelined else 1)
                * (2 if self.precise_dots else 1))
        algo_led = {}
        if self.algo is not None:
            from acg_tpu_torch.recurrence import reduction_schedule
            sched = reduction_schedule(self.algo, False)
            nred = sched["allreduce_per_iteration"]
            scal = sched["allreduce_scalars"]
            nexch = nexch * sched["spmv_per_iteration"]
            per_shard = per_shard * sched["spmv_per_iteration"]
            algo_led = {"algorithm": str(self.algo)}
            for extra_key in ("iterations_per_reduction",
                              "reduction_latency_hidden"):
                if extra_key in sched:
                    algo_led[extra_key] = sched[extra_key]
        precond_led = {}
        ar_bytes = None
        if self.precond_spec is not None:
            from acg_tpu_torch.precond import comm_contribution
            pc = comm_contribution(self.precond_spec)
            extra = int(pc.get("halo_spmv_equivalents_per_apply", 0))
            nexch = nexch * (1 + extra)
            per_shard = per_shard * (1 + extra)
            scal = ((3 if self.pipelined else 2)
                    * (2 if self.precise_dots else 1))
            ar_bytes = 3 * (2 if self.precise_dots else 1) * sdl
            precond_led = {"precond": pc}
        return {
            "transport": ("pallas-roll/ppermute" if pallas
                          else "xla-roll/collective-permute"),
            **algo_led,
            "nparts": P,
            "mesh_shape": {PARTS_AXIS: P},
            "halo_exchanges_per_iteration": nexch,
            "halo_bytes_per_iteration": int(per_shard * P * dbl),
            "halo_bytes_per_shard": int(per_shard * dbl),
            "allreduce_per_iteration": (nred if self.algo is not None
                                        else int(nred)),
            "allreduce_scalars": int(scal),
            "allreduce_bytes_per_iteration": int(
                nred * scal * sdl if ar_bytes is None else ar_bytes),
            "max_hops": int(max_hops),
            **precond_led,
        }

    def _manufactured_x(self, seed: int, dtype, xsol):
        if xsol is not None:
            if not isinstance(xsol, torch.Tensor):
                xsol = torch.from_numpy(np.array(xsol))
            return xsol.to(self.device, dtype)
        sdt = acc_dtype(dtype)
        x = prng.normal(seed, self.A.nrows, sdt, self.device)
        return (x / torch.linalg.norm(x)).to(dtype)

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
    one process's norm, which sums all N squares in one reduction.

    ``precond`` takes the window's diagonal (jacobi) or diagonal blocks
    (bjacobi, blocks aligned to the rank's rows) for this rank's rows,
    or the Chebyshev interval of a power iteration over the ranks; the
    CA recurrences fold their Gram and window products over the ranks
    like the dots.  A fault lands in the global vector: its element on
    the rank that owns it.  A snapshot holds the gathered global
    vectors, written by the primary; a resume keeps each rank's rows."""

    def __init__(self, n: int, dim: int, nparts: int, dtype=torch.float32,
                 vector_dtype=None, epsilon: float = 0.0,
                 kernels: str = "auto", device=None, **options):
        from acg_tpu_torch.parallel import mesh, multihost

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

    def _observe_comm(self, niter: int) -> None:
        """Every rank holds the pod-wide ledger: it counts on the
        primary alone, so the ranks' counters sum to the run's traffic
        once."""
        if self.rank == 0:
            super()._observe_comm(niter)

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

    def _ca_ops(self, dot, sdt):
        """The CA recurrences' ops: the Gram and window products of
        this rank's rows folded over the ranks in rank order."""
        from acg_tpu_torch import recurrence as rec
        ops = rec.single_ops(self.A, self._spmv_of(), dot, sdt)
        ops.psum_stack = lambda v: self._fold(v.unsqueeze(0))
        return ops

    def _rank_lmax(self, v) -> float:
        """Power-iteration lambda_max over the ranks' SpMV with norms
        folded over the ranks, from this rank's rows ``v`` of the
        one-process start vector (so only the dots' folding differs)."""
        from acg_tpu_torch.precond import POWER_ITERS
        spmv_ = self._spmv_of()
        sdt = v.dtype

        def fdot(a, c):
            return self._fold(torch.dot(a, c).reshape(1))

        for _ in range(POWER_ITERS):
            w = spmv_(self.A, v).to(sdt)
            v = w / torch.sqrt(fdot(w, w))
        w = spmv_(self.A, v).to(sdt)
        return fdot(v, w) / fdot(v, v)

    def _own_rows(self, v):
        return v[self.row0:self.row0 + self.nloc]

    def _ensure_lam(self):
        """The recurrences' interval from the one-process start vector
        (numpy's ``default_rng(0)`` over all N rows, this rank's rows
        kept)."""
        if self._lam is None:
            from acg_tpu_torch.recurrence import LAM_SAFETY
            if self.algo is not None and self.algo.needs_lam:
                sdt = acc_dtype(self._solve_dtype())
                v = torch.from_numpy(self._own_rows(
                    np.random.default_rng(0).standard_normal(self.N))).to(
                        device=self.device, dtype=sdt)
                self._lam = (0.0, float(self._rank_lmax(v)) * LAM_SAFETY)
            else:
                self._lam = (0.0, 0.0)
        return self._lam

    def _ensure_precond_state(self):
        """The preconditioner state of this rank's rows: jacobi and
        bjacobi from the window's planes (own rows only), cheby from the
        ranks' power iteration."""
        spec = self.precond_spec
        if spec is None or self._mstate is not None:
            return self._mstate
        from acg_tpu_torch import precond as pc
        sdt = acc_dtype(self._solve_dtype())
        if spec.kind == "cheby":
            # the one-process start vector (precond.estimate_lmax's draw)
            gen = torch.Generator(device=self.device).manual_seed(0)
            v = self._own_rows(torch.randn(self.N, generator=gen, dtype=sdt,
                                           device=self.device)).clone()
            self._mstate = pc.cheby_state(self._rank_lmax(v), sdt,
                                          self.device)
            return self._mstate
        if spec.kind == "jacobi":
            (dinv,) = pc.jacobi_state(self.A, sdt)
            self._mstate = (dinv[self.L:self.L + self.nloc].contiguous(),)
            return self._mstate
        bs = spec.block
        if self.row0 % bs or self.L % bs or (
                self.nloc % bs and self.row0 + self.nloc != self.N):
            raise ValueError(
                f"--precond {spec} on the multi-process sharded tier "
                f"needs each rank's rows aligned to the {bs}-row blocks "
                f"(rank rows {self.row0}..{self.row0 + self.nloc})")
        (chol,) = pc.bjacobi_state(self.A, bs, sdt)
        b0 = self.L // bs
        self._mstate = (chol[b0:b0 + -(-self.nloc // bs)].contiguous(),)
        return self._mstate

    def _guard(self, fault, detect: bool, k_offset: int = 0, carry=None,
               state_io: bool = False):
        """The fault of the global vector's element ``seed % N`` fires on
        the rank that owns it, at that row; a scalar fault everywhere."""
        import dataclasses
        if fault is not None and fault.site in ("spmv", "sdc", "precond"):
            g = fault.seed % max(self.N, 1)
            fault = (dataclasses.replace(fault, seed=g - self.row0)
                     if self.row0 <= g < self.row0 + self.nloc else None)
        return super()._guard(fault, detect, k_offset, carry, state_io)

    def _b_host(self, b) -> np.ndarray:
        return self.gather_x(b) if isinstance(b, torch.Tensor) \
            else np.asarray(b, dtype=np.float64)

    def _to_host(self, leaf, name: str) -> np.ndarray:
        if leaf.dim() == 0:
            return leaf.cpu().numpy()
        return self.gather_x(leaf).astype(
            np.dtype(str(leaf.dtype).replace("torch.", "")), copy=False)

    def _to_dev(self, a, name: str, sdt):
        a = np.asarray(a)
        if a.ndim >= 1:
            a = a[self.row0:self.row0 + self.nloc]
        return super()._to_dev(a, name, sdt)

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
