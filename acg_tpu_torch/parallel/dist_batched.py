"""Batched multi-RHS CG on stacked parts: B systems, one solve.

The counterpart of ``acg_tpu/parallel/dist_batched.py``: the classic and
pipelined recurrences of the stacked multi-part tier with a trailing
batch axis, every vector a ``(nparts, nmax_owned, B)`` block.

* The halo exchange moves ``(maxcnt, B)`` windows through one exchange
  an SpMV (the transpose of the send plane, the reference's single
  ``all_to_all``): the payload grows with B, the exchange count does
  not.
* Every per-RHS dot is one column reduction: classic CG keeps its two
  psums an iteration (of (B,) columns), pipelined CG its one fused psum
  (of 2B scalars), through :func:`~acg_tpu_torch.parallel.reductions.
  make_pdot_cols` / ``make_pdotk_cols``.

The recurrences are the single-device batched tier's
(:mod:`acg_tpu_torch.solvers.batched`), over this tier's SpMV and column
psums: per-RHS convergence masks ride the carry, and a converged column
freezes while the loop runs to the slowest column.  Everything is plain
PyTorch, as the reference leaves this tier to XLA.  The halo runs the
transpose transport only (the reference's batched mesh tier takes no
``comm``; its CLI refuses ``--comm dma`` with ``--nrhs``).  A batch of one delegates to
:class:`~acg_tpu_torch.parallel.dist.DistCGSolver`.

The per-RHS residual ring (``trace``, the reference's
``acg_tpu/parallel/dist_batched.py:610``) and the worst-column
heartbeat (``progress``) ride the shared batched loops, and so do the
batched checkpoint chunks (``ckpt``, classic only): a snapshot holds the
``(nparts, nmax_owned, B)`` stacks with the row-permutation sidecar, so
``--resume-repartition`` restores a batch onto another partition.
"""

from __future__ import annotations

import numpy as np
import torch

from acg_tpu_torch._device import resolve_device
from acg_tpu_torch.errors import AcgError, ErrorCode
from acg_tpu_torch.ops.spmv import acc_dtype
from acg_tpu_torch.parallel.dist import DistributedProblem, _put
from acg_tpu_torch.parallel.reductions import (make_pdot_cols,
                                               make_pdotk_cols, psum)
from acg_tpu_torch.solvers.batched import (ChunkedBatchedSolver,
                                           _batched_cg_pipelined_program,
                                           _batched_cg_program)
from acg_tpu_torch.solvers.stats import (SolverStats, StoppingCriteria,
                                         cg_flops_per_iteration)

__all__ = ["BatchedDistCGSolver"]


def _local_mv_multi(block, arrays, X):
    """``Y = A_local @ X`` of every part at once for stacked ``X`` (P,
    nrows, B): one pass over the blocks for all columns (``arrays`` from
    :meth:`BatchedDistCGSolver._upload`)."""
    adt = acc_dtype(X.dtype)
    P, n, B = X.shape
    if block.format == "dia":
        planes, = arrays
        L = max(0, -min(block.offsets))
        R = max(0, max(block.offsets))
        Xp = torch.nn.functional.pad(X, (0, 0, L, R))
        Y = torch.zeros((P, n, B), dtype=adt, device=X.device)
        for plane, off in zip(planes, block.offsets):
            sl = Xp[:, L + off:L + off + n]
            Y = Y + plane[:, :, None].to(adt) * sl.to(adt)
        return Y.to(X.dtype)
    Xf = X.reshape(P * n, B)
    if block.format == "ell":
        data, cols = arrays
        return (data[..., None].to(adt) * Xf[cols].to(adt)).sum(2).to(
            X.dtype)
    # binned ELL: each real row written once, by its bin or hub group
    Y = torch.zeros((P * n, B), dtype=adt, device=X.device)
    for dst, data, cols in arrays:
        Y.index_copy_(0, dst, (data[..., None].to(adt)
                               * Xf[cols].to(adt)).sum(1))
    return Y.view(P, n, B).to(X.dtype)


def _ghost_mv_multi(arrays, Y, Xg):
    """``Y += A_ghost @ Xg`` in place: each coupled row's B-column
    contribution added once (unique rows: exact, the same every run)."""
    dst, data, cols, _ = arrays
    adt = acc_dtype(Xg.dtype)
    Xf = Xg.reshape(-1, Xg.shape[-1])
    contrib = (data[..., None].to(adt) * Xf[cols].to(adt)).sum(1)
    Y.view(-1, Y.shape[-1]).index_add_(0, dst, contrib.to(Y.dtype))
    return Y


def _halo_exchange_multi(X, send_flat, ghost_flat):
    """Multi-column halo exchange: the send plane ``(P, P, maxcnt, B)``
    gathered in one pass, transposed (the single all_to_all), and each
    part's ghost rows gathered from its receive rows.  ``send_flat`` and
    ``ghost_flat`` index the flattened owned and receive stacks."""
    P, n, B = X.shape
    send = X.reshape(P * n, B)[send_flat]
    recv = send.transpose(0, 1).reshape(-1, B)
    return recv[ghost_flat]


class BatchedDistCGSolver(ChunkedBatchedSolver):
    """Batched CG over ``problem.nparts`` stacked parts on one device
    (``acg_tpu.parallel.dist_batched.BatchedDistCGSolver``): B
    right-hand-side columns against one partitioned operator, the
    reduction and exchange counts invariant in B.  Classic (two B-wide
    psums an iteration) or ``pipelined`` (one fused 2B-scalar psum);
    ``precise_dots`` psums compensated column pairs.  ``device`` as for
    :class:`~acg_tpu_torch.parallel.dist.DistCGSolver`."""

    def __init__(self, problem: DistributedProblem, pipelined: bool = False,
                 precise_dots: bool = False, precond=None, trace: int = 0,
                 ckpt=None, device=None, progress: int = 0):
        if precond is not None:
            from acg_tpu_torch.precond import parse_precond
            if parse_precond(precond) is not None:
                raise ValueError(
                    "the batched distributed tier runs unpreconditioned "
                    "CG (preconditioned batching lives on the "
                    "single-device tier, acg_tpu.solvers.batched); "
                    "drop precond or use nparts=1")
        if problem.local.format == "matfree":
            raise ValueError(
                "the batched distributed tier runs assembled local "
                "blocks (its multi-vector shard SpMV has no generated-"
                "plane form yet); matrix-free batching lives on the "
                "single-device tier (acg_tpu.solvers.batched), or drop "
                "--nrhs for the matrix-free mesh solve")
        if ckpt is not None and pipelined:
            raise ValueError(
                "batched checkpointing threads the batched-classic "
                "carry; the pipelined batched mode does not expose "
                "state_io")
        self._check_ckpt(ckpt, True)
        self.device = resolve_device(device)
        self.problem = problem
        self.pipelined = bool(pipelined)
        self.mode = "pipelined" if self.pipelined else "batched"
        self._trace_name = ("dist-cg-batched-pipelined" if self.pipelined
                            else "dist-cg-batched")
        self._check_batched_telemetry(trace, progress)
        self.precise_dots = bool(precise_dots)
        self.stats = SolverStats(unknowns=problem.n)
        self._inner1 = None
        self._dev = None

    def _solve_dtype(self):
        return self.problem.vdtype

    def _inner(self):
        """The single-RHS solver a batch of one delegates to."""
        if self._inner1 is None:
            from acg_tpu_torch.parallel.dist import DistCGSolver
            self._inner1 = DistCGSolver(
                self.problem, pipelined=self.pipelined,
                precise_dots=self.precise_dots, device=self.device,
                ckpt=self.ckpt)
        return self._inner1

    def _upload(self):
        """The blocks and the halo plan on the device, once: local block
        arrays for :func:`_local_mv_multi`, ghost block arrays, and the
        flattened send and unpack indices of the exchange."""
        if self._dev is not None:
            return self._dev
        prob, dev, dt = self.problem, self.device, self.problem.dtype
        P, n = prob.nparts, prob.nmax_owned
        la = prob.local.to(dev, dt)
        if prob.local.format == "ell":
            data, cols = la
            base = torch.arange(P, device=dev)[:, None, None] * n
            la = (data, cols + base)
        h = prob.halo
        width = max(h.nmax_ghost, 1)
        ga = prob.ghost.to(dev, dt, width)
        hd = h.to(dev)
        send_flat = (torch.arange(P, device=dev)[:, None, None] * n
                     + hd.send_idx)
        rows = P * max(h.maxcnt, 1)
        ghost_flat = torch.arange(P, device=dev)[:, None] * rows \
            + hd.ghost_src
        self._dev = (la, ga, send_flat, ghost_flat)
        return self._dev

    def _spmv(self):
        """``spmv(X)`` for stacked ``(P, n, B)`` blocks: local block,
        then the one exchange and the ghost block."""
        prob = self.problem
        la, ga, send_flat, ghost_flat = self._upload()
        has_ghosts = prob.halo.has_ghosts

        def spmv(X):
            Y = _local_mv_multi(prob.local, la, X)
            if has_ghosts:
                _ghost_mv_multi(ga, Y, _halo_exchange_multi(
                    X, send_flat, ghost_flat))
            return Y

        return spmv

    def _program(self, crit: StoppingCriteria, **ckpt_kw):
        """``run(Bm, X0)`` of the armed recurrence (``dist_batched.py:
        200-369``): the single-device batched tier's programs over this
        tier's SpMV and psum'd column dots (``ckpt_kw``: the chunk
        driver's carry hooks, for the classic recurrence)."""
        if crit.needs_diff:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "the batched tiers support residual criteria only")
        sdt = acc_dtype(self.problem.vdtype)

        def lcoldot(a, c):
            return (a.to(sdt) * c.to(sdt)).sum(1)

        pdot_cols = make_pdot_cols(psum, lcoldot, sdt, self.precise_dots)
        spmv = self._spmv()

        def telem(Bm):
            return self._batched_telemetry(Bm.shape[-1], sdt)

        if self.pipelined:
            pdotk_cols = make_pdotk_cols(psum, lcoldot, sdt,
                                         self.precise_dots)
            return lambda Bm, X0: _batched_cg_pipelined_program(
                spmv, pdot_cols, pdotk_cols, Bm, X0, crit, telem=telem(Bm))
        return lambda Bm, X0: _batched_cg_program(spmv, pdot_cols, Bm, X0,
                                                  crit, telem=telem(Bm),
                                                  **ckpt_kw)

    def device_args(self, B_global, x0=None):
        """``(B, X0)`` as stacked ``(P, nmax_owned, B)`` blocks in the
        vector dtype on the solver's device."""
        prob = self.problem
        Bg = np.asarray(B_global, np.float64)
        if Bg.ndim == 1:
            Bg = Bg[:, None]

        def scatter_cols(Xg):
            out = np.stack([prob.scatter(Xg[:, j])
                            for j in range(Xg.shape[1])], axis=-1)
            return _put(out, self.device, prob.vdtype)

        Bm = scatter_cols(Bg)
        X0 = (torch.zeros_like(Bm) if x0 is None
              else scatter_cols(np.asarray(x0, np.float64).reshape(
                  Bg.shape)))
        return Bm, X0

    def _host_x(self, X: np.ndarray) -> np.ndarray:
        """The global ``(n, B)`` columns of the stacked host block."""
        return np.stack([self.problem.gather(X[:, :, j])
                         for j in range(X.shape[2])], axis=1)

    # -- the checkpoint chunks (acg_tpu/parallel/dist_batched.py:649-849) --

    _ckpt_tier = "dist-cg-batched"

    def _ckpt_meta_extra(self, meta: dict, arrs: dict) -> None:
        """The stacked snapshot's partition count and its row-permutation
        sidecar: ``--resume-repartition`` reassembles every column onto
        another partition."""
        prob = self.problem
        meta["nparts"] = int(prob.nparts)
        rp = prob.row_permutation()
        if rp is not None:
            arrs["_rowperm"] = rp
            meta["part_rows"] = prob.part_rows()

    def _validate_snapshot(self, snap, nrhs: int, dtype, b_crc) -> None:
        from acg_tpu_torch import checkpoint as ckpt_mod
        ckpt_mod.validate_resume(
            snap, tier=self._ckpt_tier, pipelined=False, precond=None,
            n=int(self.problem.n), dtype=dtype, b_crc=b_crc,
            nparts=int(self.problem.nparts),
            repartition=self.ckpt.repartition, nrhs=nrhs)

    def _resume_arrays(self, snap) -> tuple:
        """A repartitioned snapshot's columns, reassembled in global row
        order, re-sliced onto this problem's parts."""
        if not self.ckpt.repartition:
            return snap.arrays, None
        from acg_tpu_torch import checkpoint as ckpt_mod
        snap, repartitioned = ckpt_mod.apply_repartition(
            snap, tier=self._ckpt_tier, nparts=int(self.problem.nparts),
            stats=self.stats, precond_spec=None)
        prob = self.problem
        out = {}
        for nm, a in snap.arrays.items():
            a = np.asarray(a)
            if nm in ckpt_mod.BATCHED_COL_LEAVES or a.ndim < 2:
                out[nm] = a
            else:
                out[nm] = np.stack([prob.scatter(a[:, j])
                                    for j in range(a.shape[1])], axis=-1)
        return out, repartitioned

    def _account_ops(self, st, k_total: int, nrhs: int) -> None:
        """The reference's census (``dist_batched.py:590-618``): matrix
        bytes once an iteration for the batch, vector traffic and flops
        times B, the collective count invariant in B."""
        prob = self.problem
        n = prob.n
        st.nflops += (cg_flops_per_iteration(prob.nnz_total, n,
                                             self.pipelined) * k_total
                      + 3.0 * prob.nnz_total + 2.0 * n) * nrhs
        dbl = torch.empty((), dtype=prob.vdtype).element_size()
        mat_dbl = torch.empty((), dtype=prob.dtype).element_size()
        idx_b = 0 if prob.local.format == "dia" else 4
        st.ops["gemv"].add(k_total + 1, 0.0,
                           (prob.nnz_total * (mat_dbl + idx_b)
                            + 2 * n * dbl * nrhs) * (k_total + 1))
        st.ops["dot"].add(k_total, 0.0, 2 * n * dbl * nrhs * k_total)
        st.ops["axpy"].add(3 * k_total, 0.0,
                           3 * n * dbl * nrhs * 3 * k_total)
        nred = 1 if self.pipelined else 2
        st.ops["allreduce"].add(nred * k_total, 0.0,
                                8 * nrhs * nred * k_total)
        halo_total = sum(int(s.halo.total_send) for s in prob.subs)
        st.ops["halo"].add(k_total + 1, 0.0,
                           halo_total * dbl * nrhs * (k_total + 1))
