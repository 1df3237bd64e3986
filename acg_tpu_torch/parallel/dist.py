"""Multi-part CG on stacked parts.

The counterpart of ``acg_tpu/parallel/dist.py``'s ``DistCGSolver``
(classic and pipelined, unpreconditioned).  The JAX package shards every
per-part array over a device mesh and runs one SPMD program; the port
keeps the same per-part arrays STACKED on one device -- a ``(nparts,
...)`` tensor is the layout ``shard_map`` sees -- so one card (or the
CPU) runs any number of parts:

* every per-part array is padded to the largest part and stacked on a
  leading parts axis (:class:`DistributedProblem`, host numpy, moved to
  the device once per solver);
* vectors are ``[owned | padding]``; the padding rows of every block are
  all zero, so padding entries stay exactly zero through every update
  and reduction, with no masks in the loop;
* the local (owned x owned) block is gather-free DIA planes when the
  partition keeps it banded -- kernel K1 batched over parts on the card
  -- else ELL or length-binned ELL gathers; with a matrix-free stencil
  armed (:func:`arm_matfree`) its planes are generated per part instead
  -- kernel K7 stacked over parts for Poisson on the card; the ghost
  (owned x ghost) block covers only the rows that touch ghosts;
* the halo exchange is a pack gather, a transport (the transpose of the
  send plane for ``comm="xla"``, kernel K6 for ``comm="dma"``) and an
  unpack gather (:mod:`.halo`, :mod:`.halo_dma`);
* ``psum`` is a sum over the parts axis (:mod:`.reductions`).

The classic and pipelined programs are the single-device ones of
:mod:`acg_tpu_torch.solvers.cg` (device scalars, one flag read per
chunk, frozen state at convergence) over this tier's SpMV and psum'd
dots, as the JAX tier reuses ``jax_cg._iterate``.

Across processes (:mod:`.multihost`, one rank per card) each rank holds
the ``(nlocal, ...)`` rows of its own parts -- contiguous and
process-major (:mod:`.mesh`) -- of every stacked array; a problem built
with ``owned_parts`` assembles only those blocks, and the local-read
flow (:meth:`DistributedProblem.build_local_read`) reads only their
rows.  The psum gathers every rank's per-part partials and folds them in
part order, and the halo crosses ranks by ``all_to_all_single`` or K6's
peer puts, so a rank's solve has the bits of one process's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_tpu_torch import recurrence as rec
from acg_tpu_torch import tracing
from acg_tpu_torch._device import resolve_device
from acg_tpu_torch.errors import AcgError, ErrorCode
from acg_tpu_torch.graph import (Subdomain, partition_matrix,
                                 reorder_owned_natural)
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.ops.operator import StencilOperator, stencil_planes
from acg_tpu_torch.ops.spmv import (BELL_WIDTHS, acc_dtype, csr_diag_offsets,
                                    dia_mv, dia_planes_fixed,
                                    ell_planes_from_csr, padded_rows)
from acg_tpu_torch.parallel import mesh, multihost
from acg_tpu_torch.parallel.halo import (DeviceHaloPlan, build_device_halo,
                                         halo_exchange, halo_exchange_ranks)
from acg_tpu_torch.parallel.halo_dma import (PeerPlanes, halo_exchange_dma,
                                             halo_exchange_peer)
from acg_tpu_torch.parallel.reductions import (make_ldot, make_pdot,
                                               make_pdotk, make_rank_psum,
                                               psum)
from acg_tpu_torch.precond import (CHEBY_RATIO, CHEBY_SAFETY, POWER_ITERS,
                                   make_apply, parse_precond,
                                   stacked_bjacobi_state,
                                   stacked_jacobi_state, state_from_numpy)
from acg_tpu_torch.solvers import cg as _cg
from acg_tpu_torch.solvers.stats import (SolverStats, StoppingCriteria,
                                         cg_flops_per_iteration)

# the reference's --comm spellings mapped onto the two transports
# (cuda/acg-cuda.c:321-377)
COMM_ALIASES = {"mpi": "xla", "nccl": "xla", "nvshmem": "dma"}


def resolve_comm(name: str) -> str:
    """Transport for a --comm spelling; ``none`` (the CLI's single-device
    selector) resolves to the xla transport."""
    c = COMM_ALIASES.get(str(name), str(name))
    return "xla" if c == "none" else c


def _put(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def _gather_rows(x, cols):
    """``x[p, cols[p]]`` for stacked x (P, n) and cols (P, m, K)."""
    P = x.shape[0]
    return torch.gather(x, 1, cols.reshape(P, -1)).reshape(cols.shape)


@dataclasses.dataclass
class StackedLocalBlock:
    """Per-part owned x owned blocks, stacked over parts (host numpy,
    float64 values: each solver casts them to its dtype on upload).

    ``"dia"``: ``arrays = (planes,)`` with planes (ndiags, P, nrows) over
    the union of all parts' offsets (the JAX package's per-offset (P,
    nrows) planes, stacked).  ``"ell"``: ``(data (P, nrows, K), cols)``.
    ``"binnedell"``: ``(bin_rows, bin_data, bin_cols, tail_rows,
    tail_cols, tail_vals)`` -- per-bin tuples with part-uniform row
    counts (absent rows padded with row id ``nrows``) and a padded COO
    tail for hub rows.  ``"matfree"``: ``(row0 (P,), nowned (P,), *tables
    (P, L))`` -- each part's first global row and owned count, and the
    stencil ``operator``'s coefficient tables stacked per part; the
    planes are generated in the SpMV (:func:`arm_matfree`).

    On upload the binned-ELL block drops its padding rows and turns its
    hub tail into one padded row per hub row (:meth:`_bell_groups`), so
    every row of the stack is one ``.sum(-1)`` written once: no scatter
    adds, and the same bits on every run."""

    format: str      # "dia" | "ell" | "binnedell" | "matfree"
    arrays: tuple
    offsets: tuple   # dia/matfree: static diagonal offsets, ascending
    nrows: int
    bin_ks: tuple = ()   # binnedell only: K_b per bin
    operator: object = None  # matfree only: the StencilOperator template

    def take(self, lo: int, hi: int) -> "StackedLocalBlock":
        """The blocks of parts ``lo .. hi - 1`` (a rank's parts)."""
        a = self.arrays
        if self.format == "dia":
            arrays = (a[0][:, lo:hi],)
        elif self.format == "binnedell":
            arrays = (tuple(r[lo:hi] for r in a[0]),
                      tuple(d[lo:hi] for d in a[1]),
                      tuple(c[lo:hi] for c in a[2]),
                      a[3][lo:hi], a[4][lo:hi], a[5][lo:hi])
        else:
            arrays = tuple(x[lo:hi] for x in a)
        return dataclasses.replace(self, arrays=arrays)

    def to(self, device, dtype) -> tuple:
        """Device tensors for :meth:`mv`: values in ``dtype``, indices
        int64."""
        i64 = torch.int64
        if self.format == "matfree":
            row0, nowned, *tables = self.arrays
            return (_put(row0, device, i64), _put(nowned, device, i64),
                    *(_put(t, device, dtype) for t in tables))
        if self.format == "dia":
            return (_put(self.arrays[0], device, dtype).contiguous(),)
        if self.format == "ell":
            data, cols = self.arrays
            return (_put(data, device, dtype), _put(cols, device, i64))
        return tuple((_put(dst, device, i64), _put(d, device, dtype),
                      _put(c, device, i64))
                     for dst, d, c in self._bell_groups())

    def _bell_groups(self) -> list:
        """The binned-ELL block as ``(dst, data, cols)`` groups over the
        real rows only, one per bin and the hub tail's padded rows
        (:func:`~acg_tpu_torch.ops.spmv.padded_rows`): ``dst`` (m,) and
        ``cols`` (m, K) index the flattened (P * nrows) stack.  Each hub
        row is one padded row, its entries in the tail's order (zero
        values and column 0 pad it, as in every ELL row)."""
        brows, bdata, bcols, trows, tcols, tvals = self.arrays
        n = self.nrows
        groups = []
        for rows, data, cols in zip(brows, bdata, bcols):
            p, i = np.nonzero(rows < n)
            groups.append((p * n + rows[p, i], data[p, i],
                           p[:, None] * n + cols[p, i]))
        p, i = np.nonzero(trows < n)
        # ascending: parts in order, hub rows ascending in each part
        tc, tv = p * n + tcols[p, i], tvals[p, i]
        for dst, idx in padded_rows(p * n + trows[p, i]):
            pad = idx < 0
            groups.append((dst, np.where(pad, 0.0, tv[idx]),
                           np.where(pad, 0, tc[idx])))
        return groups

    def planes(self, arrays):
        """The (ndiags, P, nrows) planes of a DIA block, or the generated
        planes of every part of a matfree block (``acg_tpu/parallel/
        dist.py:116-139``)."""
        if self.format == "dia":
            return arrays[0]
        row0, nowned, *tables = arrays
        return stencil_planes(self.operator.kind, self.operator.grid,
                              self.offsets, tuple(tables), self.nrows,
                              self.operator.dtype, row0=row0, nowned=nowned)

    def mv(self, arrays, x, use_kernel: bool):
        """y = A_local @ x for all parts at once (``arrays`` from
        :meth:`to`); ``use_kernel`` takes kernel K1 for DIA blocks and
        kernel K7 for Poisson matfree blocks."""
        adt = acc_dtype(x.dtype)
        if self.format == "matfree":
            op = self.operator
            row0, nowned, *tables = arrays
            if use_kernel and op.kind == "poisson":
                return K.stencil_spmv(op, x, row0=row0, nowned=nowned)
            return dia_mv(self.planes(arrays), self.offsets, self.nrows, x)
        if self.format == "dia":
            planes, = arrays
            if use_kernel:
                return K.dia_spmv(planes, self.offsets, x)
            return dia_mv(planes, self.offsets, self.nrows, x)
        if self.format == "ell":
            data, cols = arrays
            return (data.to(adt) * _gather_rows(x, cols).to(adt)).sum(
                -1).to(x.dtype)
        xf = x.reshape(-1)
        y = torch.zeros(xf.shape, dtype=adt, device=x.device)
        for dst, data, cols in arrays:
            y.index_copy_(0, dst, (data.to(adt) * xf[cols].to(adt)).sum(-1))
        return y.view(x.shape).to(x.dtype)

    def rows_mv(self, arrays, x, rows):
        """The DIA, matfree or ELL SpMV of the rows ``rows`` only (int64
        ids into the flattened (P * nrows) stack), as a (len(rows),)
        vector: each row's products and sum in the order of :meth:`mv`'s
        plain version, so every row is bitwise :meth:`mv`'s
        (``local_rows_mv``, ``acg_tpu/parallel/dist.py:884-907``)."""
        adt = acc_dtype(x.dtype)
        n = self.nrows
        if self.format == "ell":
            data, cols = arrays
            K = data.shape[-1]
            xs = x.reshape(-1)[cols.reshape(-1, K)[rows]
                               + (rows // n * n)[:, None]]
            return (data.reshape(-1, K)[rows].to(adt) * xs.to(adt)).sum(
                -1).to(x.dtype)
        planes = self.planes(arrays)
        L = max(0, -min(self.offsets))
        R = max(0, max(self.offsets))
        xp = torch.nn.functional.pad(x, (L, R)).reshape(-1)
        # row (p, i) reads padded x at p * (L + n + R) + L + i + off
        base = rows // n * (L + R) + rows + L
        acc = torch.zeros(rows.shape, dtype=adt, device=x.device)
        for d, off in enumerate(self.offsets):
            acc = acc + (planes[d].reshape(-1)[rows].to(adt)
                         * xp[base + off].to(adt))
        return acc.to(x.dtype)


@dataclasses.dataclass
class StackedGhostBlock:
    """Per-part owned x ghost blocks, compressed to the rows that touch
    ghosts (the reference's border-rows-only ``o*`` block): ``rows`` (P,
    bmax) ascending, padded with ``nrows``; ``data``/``cols`` (P, bmax,
    Kg) with cols into the ghost vector."""

    rows: np.ndarray   # (P, bmax) int32
    data: np.ndarray   # (P, bmax, Kg) float64
    cols: np.ndarray   # (P, bmax, Kg) int32
    nrows: int
    bmax: int

    def take(self, lo: int, hi: int) -> "StackedGhostBlock":
        """The blocks of parts ``lo .. hi - 1`` (a rank's parts)."""
        return dataclasses.replace(self, rows=self.rows[lo:hi],
                                   data=self.data[lo:hi],
                                   cols=self.cols[lo:hi])

    def to(self, device, dtype, ghost_width: int) -> tuple:
        """Device tensors for :meth:`add_to` over the real coupled rows
        only: ``dst`` (m,) into the flattened (P * nrows) stack, ``data``
        and ``cols`` (m, Kg) with cols into the flattened stack of ghost
        vectors, each ``ghost_width`` long."""
        p, i = np.nonzero(self.rows < self.nrows)
        i64 = torch.int64
        return (_put(p * self.nrows + self.rows[p, i], device, i64),
                _put(self.data[p, i], device, dtype),
                _put(p[:, None] * ghost_width + self.cols[p, i], device, i64),
                ghost_width)

    def add_to(self, arrays, y, xg):
        """``y += A_ghost @ xg`` in place on the contiguous stack ``y``:
        each coupled row's contribution, rounded to the vector dtype, is
        added once (the rows are unique, so the add is exact and the
        same on every run)."""
        dst, data, cols, width = arrays
        if xg.shape[-1] != width:
            raise ValueError(f"ghost vectors of length {xg.shape[-1]}, "
                             f"the block was uploaded for {width}")
        adt = acc_dtype(xg.dtype)
        xs = torch.gather(xg.reshape(-1), 0, cols.view(-1)).view(cols.shape)
        contrib = (data.to(adt) * xs.to(adt)).sum(-1)
        y.view(-1).index_add_(0, dst, contrib.to(y.dtype))
        return y


def _bell_histogram(blocks) -> np.ndarray:
    """``(len(BELL_WIDTHS) + 1,)`` int64: per-bin MAX row count over the
    given local blocks, hub-tail max nnz last."""
    nbins = len(BELL_WIDTHS)
    out = np.zeros(nbins + 1, dtype=np.int64)
    widths = np.asarray(BELL_WIDTHS)
    for b in blocks:
        row_nnz = np.diff(b.indptr)
        bidx = np.searchsorted(widths, row_nnz)
        cnt = np.bincount(np.minimum(bidx, nbins), minlength=nbins + 1)
        out[:nbins] = np.maximum(out[:nbins], cnt[:nbins])
        out[nbins] = max(out[nbins], int(row_nnz[bidx >= nbins].sum()))
    return out


def _stack_bell_blocks(blocks, nrows_pad: int, bin_ms,
                       tail_max: int) -> StackedLocalBlock:
    """Stack per-part local blocks in the length-binned ELL layout with
    part-uniform shapes: bin b holds ``bin_ms[b]`` row slots per part
    (absent rows pad with row id ``nrows_pad``), the hub tail
    ``tail_max`` COO slots."""
    P = len(blocks)
    widths = np.asarray(BELL_WIDTHS)
    live = [b for b in range(widths.size) if bin_ms[b]]
    bin_rows = [np.full((P, bin_ms[b]), nrows_pad, np.int32) for b in live]
    bin_data = [np.zeros((P, bin_ms[b], widths[b])) for b in live]
    bin_cols = [np.zeros((P, bin_ms[b], widths[b]), np.int32) for b in live]
    T = int(tail_max)
    t_rows = np.full((P, T), nrows_pad, np.int32)
    t_cols = np.zeros((P, T), np.int32)
    t_vals = np.zeros((P, T))
    for p, blk in enumerate(blocks):
        if blk is None:
            continue
        indptr = np.asarray(blk.indptr)
        vals = np.asarray(blk.data)
        colidx = np.asarray(blk.indices)
        row_nnz = np.diff(indptr)
        bidx = np.searchsorted(widths, row_nnz)
        for i, b in enumerate(live):
            rows_b = np.flatnonzero(bidx == b).astype(np.int32)
            if rows_b.size == 0:
                continue
            nnz_b = row_nnz[rows_b]
            flat_r = np.repeat(np.arange(rows_b.size), nnz_b)
            flat_p = (np.arange(nnz_b.sum())
                      - np.repeat(np.cumsum(nnz_b) - nnz_b, nnz_b))
            src = (np.repeat(indptr[rows_b], nnz_b) + flat_p).astype(np.int64)
            bin_rows[i][p, : rows_b.size] = rows_b
            bin_data[i][p][flat_r, flat_p] = vals[src]
            bin_cols[i][p][flat_r, flat_p] = colidx[src]
        hub = np.flatnonzero(bidx >= widths.size)
        if hub.size:
            t_r = np.repeat(hub, row_nnz[hub]).astype(np.int32)
            t_src = np.concatenate(
                [np.arange(indptr[r], indptr[r + 1]) for r in hub])
            t_rows[p, : t_r.size] = t_r
            t_cols[p, : t_r.size] = colidx[t_src]
            t_vals[p, : t_r.size] = vals[t_src]
    return StackedLocalBlock(
        format="binnedell",
        arrays=(tuple(bin_rows), tuple(bin_data), tuple(bin_cols),
                t_rows, t_cols, t_vals),
        offsets=(), nrows=nrows_pad,
        bin_ks=tuple(int(widths[b]) for b in live))


def _stack_local_blocks(subs, nmax_owned: int, max_diags: int = 80,
                        dia_waste_limit: float = 3.0,
                        ell_waste_limit: float = 3.0, global_csr=None,
                        uniform: "UniformShapes | None" = None
                        ) -> StackedLocalBlock:
    """The local blocks of every part in the fastest eligible stacked
    format: DIA over the union offset set when the blocks are banded
    (``max_diags`` keeps headroom over the single-device limit: the union
    of per-part offset sets can exceed any one part's count), else
    length-binned ELL when plain-ELL padding waste passes
    ``ell_waste_limit``, else ELL.

    Parts whose block is None (another process owns them) stay zero.
    With such restricted builds the shape and format decisions must be
    the same on every process (``acg_tpu/parallel/dist.py:378-470``):
    from ``global_csr`` (DIA over the global offsets only when every
    part's owned rows are one contiguous natural-order range, else ELL;
    no binned ELL) or from the agreed ``uniform`` shapes of the
    local-read flow, which bins by the LOCAL-block nnz."""
    blocks = [s.A_local for s in subs]
    built = [b for b in blocks if b is not None]
    if uniform is not None:
        if uniform.offsets is not None:
            offs = np.asarray(uniform.offsets, dtype=np.int64)
            nnz = uniform.nnz_total
        else:
            if uniform.bell_ms is not None:
                return _stack_bell_blocks(blocks, nmax_owned,
                                          uniform.bell_ms, uniform.bell_tail)
            offs = np.zeros(0, np.int64)
            nnz = 0   # the ELL path
        Kl = uniform.Kl
    elif global_csr is not None:
        contiguous = all(
            s.owned_order == "natural" and (s.nowned == 0 or (
                int(s.global_ids[s.nowned - 1]) - int(s.global_ids[0]) + 1
                == s.nowned))
            for s in subs)
        offs = (csr_diag_offsets(global_csr) if contiguous
                else np.zeros(0, np.int64))
        nnz = int(global_csr.nnz) if contiguous else 0
        Kl = int(np.diff(global_csr.indptr).max(initial=0))
    else:
        offs = np.unique(np.concatenate(
            [csr_diag_offsets(b) for b in built] or [np.zeros(1, np.int64)]))
        nnz = sum(int(b.nnz) for b in built)
        Kl = max((int(np.diff(b.indptr).max(initial=0)) for b in built),
                 default=0)
    if (nnz and offs.size <= max_diags
            and offs.size * nmax_owned * len(blocks) <= dia_waste_limit * nnz):
        planes = np.zeros((offs.size, len(blocks), nmax_owned))
        for p, b in enumerate(blocks):
            if b is not None:
                planes[:, p, :] = dia_planes_fixed(b, offs, nmax_owned)
        return StackedLocalBlock(format="dia", arrays=(planes,),
                                 offsets=tuple(int(o) for o in offs),
                                 nrows=nmax_owned)
    if (uniform is None and global_csr is None and nnz
            and Kl * nmax_owned * len(blocks) > ell_waste_limit * nnz):
        bell = _bell_histogram(built)
        return _stack_bell_blocks(blocks, nmax_owned,
                                  tuple(int(m) for m in bell[:-1]),
                                  int(bell[-1]))
    Kl = max(Kl, 1)
    ld = np.zeros((len(blocks), nmax_owned, Kl))
    lc = np.zeros((len(blocks), nmax_owned, Kl), dtype=np.int32)
    for p, b in enumerate(blocks):
        if b is None:
            continue
        ld[p], lc[p] = ell_planes_from_csr(b.indptr, b.indices, b.data,
                                           nmax_owned, pad_k=Kl)
    return StackedLocalBlock(format="ell", arrays=(ld, lc), offsets=(),
                             nrows=nmax_owned)


def _stack_ghost_blocks(subs, nmax_owned: int, global_csr=None,
                        uniform: "UniformShapes | None" = None
                        ) -> StackedGhostBlock:
    """The ghost blocks of every part, compressed to coupled rows; with
    restricted builds the uniform bounds come from the global structure
    (every part's border count, the global row width) or the agreed
    ``uniform`` shapes, and absent blocks stay zero."""
    coupled = [None if s.A_ghost is None
               else np.flatnonzero(np.diff(s.A_ghost.indptr)) for s in subs]
    if uniform is not None:
        bmax = uniform.bmax or 1
        Kg = uniform.Kg or 1
    elif global_csr is not None:
        bmax = max((s.nborder for s in subs), default=0) or 1
        Kg = int(np.diff(global_csr.indptr).max(initial=0)) or 1
    else:
        bmax = max((r.size for r in coupled if r is not None),
                   default=0) or 1
        Kg = max((int(np.diff(s.A_ghost.indptr).max(initial=0))
                  for s in subs if s.A_ghost is not None), default=0) or 1
    P = len(subs)
    rows = np.full((P, bmax), nmax_owned, dtype=np.int32)  # pad = dropped
    data = np.zeros((P, bmax, Kg))
    cols = np.zeros((P, bmax, Kg), dtype=np.int32)
    for p, (s, ri) in enumerate(zip(subs, coupled)):
        if ri is None or ri.size == 0:
            continue
        sub = s.A_ghost[ri]
        d, c = ell_planes_from_csr(sub.indptr, sub.indices, sub.data,
                                   ri.size, pad_k=Kg)
        rows[p, : ri.size] = ri
        data[p, : ri.size] = d
        cols[p, : ri.size] = c
    return StackedGhostBlock(rows=rows, data=data, cols=cols,
                             nrows=nmax_owned, bmax=bmax)


@dataclasses.dataclass(frozen=True)
class UniformShapes:
    """The stacked shapes every process of the local-read flow agrees on
    (each sees only its own parts): the union DIA offsets (None = ELL),
    padded widths and halo maxima -- the reference's max-allreduce
    buffer sizing (``halo.c:883-887``), from one small allgather
    (``acg_tpu/parallel/dist.py:185-206``)."""

    offsets: tuple | None
    Kl: int
    bmax: int
    Kg: int
    maxcnt: int
    nmax_ghost: int
    nnz_total: int
    halo_send_total: int = 0
    bell_ms: tuple | None = None
    bell_tail: int = 0


def _agree_uniform_shapes(subs_owned, nparts: int, max_diags: int = 80,
                          dia_waste_limit: float = 3.0,
                          ell_waste_limit: float = 3.0,
                          nmax_owned: int = 0) -> UniformShapes:
    """This process's block statistics, gathered from every process
    over the process group and max-/union-/sum-reduced, so every process
    derives the same shapes (``acg_tpu/parallel/dist.py:209-295``).
    Binned ELL is chosen by the LOCAL-block nnz here, as in the JAX
    package's flow (its full-information flow bins on the same count)."""
    from acg_tpu_torch.parallel import multihost

    offs = np.unique(np.concatenate(
        [csr_diag_offsets(s.A_local) for s in subs_owned]
        or [np.zeros(0, np.int64)]))
    Kl = max((int(np.diff(s.A_local.indptr).max(initial=0))
              for s in subs_owned), default=0)
    bmax = max((int(np.count_nonzero(np.diff(s.A_ghost.indptr)))
                for s in subs_owned), default=0)
    Kg = max((int(np.diff(s.A_ghost.indptr).max(initial=0))
              for s in subs_owned), default=0)
    maxcnt = max((int(c) for s in subs_owned for c in s.halo.send_counts),
                 default=0)
    nmax_ghost = max((s.nghost for s in subs_owned), default=0)
    nnz = sum(int(s.A_local.nnz + s.A_ghost.nnz) for s in subs_owned)
    nnz_local = sum(int(s.A_local.nnz) for s in subs_owned)
    send_total = sum(int(s.halo.total_send) for s in subs_owned)
    nbins = len(BELL_WIDTHS)
    bell = _bell_histogram([s.A_local for s in subs_owned])
    cap = 2 * max_diags
    too_many = offs.size > cap
    empty = np.iinfo(np.int64).min
    payload = np.full(cap + 9 + nbins + 1, empty, dtype=np.int64)
    payload[:min(offs.size, cap)] = offs[:cap]
    payload[cap:cap + 9] = (offs.size if not too_many else cap + 1,
                            Kl, bmax, Kg, maxcnt, nmax_ghost, nnz,
                            send_total, nnz_local)
    payload[cap + 9:] = bell
    gathered = multihost.allgather_array(payload)
    all_offs = np.unique(np.concatenate(
        [g[:cap][g[:cap] != empty] for g in gathered]
        or [np.zeros(0, np.int64)]))
    counts = gathered[:, cap]
    Kl = int(gathered[:, cap + 1].max())
    bmax = int(gathered[:, cap + 2].max())
    Kg = int(gathered[:, cap + 3].max())
    maxcnt = int(gathered[:, cap + 4].max())
    nmax_ghost = int(gathered[:, cap + 5].max())
    nnz_total = int(gathered[:, cap + 6].sum())
    halo_send_total = int(gathered[:, cap + 7].sum())
    nnz_local_total = int(gathered[:, cap + 8].sum())
    bell_all = gathered[:, cap + 9:].max(axis=0)
    dia_ok = bool(not (counts > cap).any() and all_offs.size <= max_diags
                  and nnz_total
                  and (all_offs.size * nmax_owned * nparts
                       <= dia_waste_limit * nnz_total))
    bell_ok = bool(not dia_ok and nnz_local_total
                   and Kl * nmax_owned * nparts
                   > ell_waste_limit * nnz_local_total)
    return UniformShapes(
        offsets=tuple(int(o) for o in all_offs) if dia_ok else None,
        Kl=Kl, bmax=bmax, Kg=Kg, maxcnt=maxcnt, nmax_ghost=nmax_ghost,
        nnz_total=nnz_total, halo_send_total=halo_send_total,
        bell_ms=(tuple(int(m) for m in bell_all[:nbins]) if bell_ok
                 else None),
        bell_tail=int(bell_all[nbins]) if bell_ok else 0)


@dataclasses.dataclass
class DistributedProblem:
    """Host-side compilation of a partitioned matrix into stacked arrays
    (the role of ``acgsolvercuda_init``, ``cgcuda.c:143-332``).  ``dtype``
    is the matrix blocks' torch dtype, ``vector_dtype`` the vectors' (None
    = the same; bf16 blocks with f32 vectors is ``--dtype mixed``).

    ``owned_parts`` (multi-process): the parts whose blocks this process
    built (None = all); the other parts' rows of every stacked array stay
    zero and are never read here.  ``band_bounds`` (the local-read flow):
    the parts' contiguous row ranges, from which :meth:`gather` and
    :meth:`scatter` take global ids where the other parts are stubs."""

    nparts: int
    n: int
    subs: list
    nmax_owned: int
    halo: DeviceHaloPlan
    local: StackedLocalBlock
    ghost: StackedGhostBlock
    nnz_total: int
    dtype: torch.dtype
    vector_dtype: torch.dtype | None = None
    operator: object = None   # the armed stencil (arm_matfree), if any
    owned_parts: tuple | None = None
    band_bounds: tuple | None = None
    halo_send_total: int | None = None

    @property
    def vdtype(self):
        return self.dtype if self.vector_dtype is None else self.vector_dtype

    @classmethod
    def build(cls, full_csr, part, nparts: int, dtype=torch.float64,
              subs: list[Subdomain] | None = None,
              vector_dtype=None, owned_parts=None) -> "DistributedProblem":
        """Stack the parts of ``part``; ``subs`` are this partition's
        subdomains when the caller built them already.  Each part's
        owned rows are re-sorted by global id (in place in ``subs``), so
        contiguous partitions of banded matrices keep DIA local blocks.

        ``owned_parts`` (multi-process): assemble blocks only for the
        listed parts; the shape and format decisions then come from the
        global matrix, so every process stacks the same shapes
        (``acg_tpu/parallel/dist.py:554-587``)."""
        restricted = owned_parts is not None
        if subs is None or (not restricted and subs[0].A_local is None):
            subs = partition_matrix(full_csr, part, nparts,
                                    owned_parts=owned_parts)
        reorder_owned_natural(subs)
        nmax_owned = max(s.nowned for s in subs)
        gcsr = full_csr if restricted else None
        return cls(nparts=nparts, n=full_csr.shape[0], subs=subs,
                   nmax_owned=nmax_owned, halo=build_device_halo(subs),
                   local=_stack_local_blocks(subs, nmax_owned,
                                             global_csr=gcsr),
                   ghost=_stack_ghost_blocks(subs, nmax_owned,
                                             global_csr=gcsr),
                   nnz_total=int(full_csr.nnz), dtype=dtype,
                   vector_dtype=vector_dtype,
                   owned_parts=(None if owned_parts is None
                                else tuple(int(p) for p in owned_parts)))

    @staticmethod
    def read_local_subdomains(path, nparts: int, bounds=None, owned=None):
        """Phase 1 of the local-read flow, with no collective: the
        header, this process's range reads and its subdomains
        (``acg_tpu/parallel/dist.py:589-627``).  ``bounds`` are the
        nparts + 1 band boundaries (equal rows by default), ``owned``
        the parts this process reads (default: this rank's parts).
        Returns ``(subs, bounds, n, owned)``; the other parts are stubs
        (:class:`~acg_tpu_torch.graph.BandStub`)."""
        from acg_tpu_torch.graph import BandStub, subdomain_from_row_slice
        from acg_tpu_torch.io.mtxfile import (read_mtx_row_range,
                                              read_mtx_sizes)
        from acg_tpu_torch.parallel import mesh, multihost

        n, _, _ = read_mtx_sizes(path)
        if bounds is None:
            bounds = np.linspace(0, n, nparts + 1).astype(np.int64)
        bounds = np.asarray(bounds, dtype=np.int64)
        if owned is None:
            owned = mesh.owned_parts(nparts, multihost.process_index(),
                                     multihost.process_count())
        owned = tuple(int(p) for p in owned)
        subs: list = [None] * nparts
        for p in range(nparts):
            if p in owned:
                sl = read_mtx_row_range(path, int(bounds[p]),
                                        int(bounds[p + 1]))
                if sl.symmetry != "general":
                    raise AcgError(
                        ErrorCode.NOT_SUPPORTED,
                        f"{path}: range reads need FULL storage "
                        f"(symmetry 'general'); this file declares "
                        f"{sl.symmetry!r} -- regenerate with "
                        f"mtx2bin --expand")
                r, c, v = sl.to_coo()
                subs[p] = subdomain_from_row_slice(r, c, v, bounds, p)
            else:
                subs[p] = BandStub(part=p,
                                   nowned_=int(bounds[p + 1] - bounds[p]))
        return subs, bounds, n, owned

    @classmethod
    def assemble_local(cls, subs, bounds, n: int, nparts: int, owned,
                       dtype=torch.float64,
                       vector_dtype=None) -> "DistributedProblem":
        """Phase 2 of the local-read flow: the collective shape
        agreement (:func:`_agree_uniform_shapes`) and the stacking.  Call
        it only once every process passed phase 1."""
        bounds = np.asarray(bounds, dtype=np.int64)
        nmax_owned = int(np.max(np.diff(bounds)))
        uniform = _agree_uniform_shapes([subs[p] for p in owned], nparts,
                                        nmax_owned=nmax_owned)
        return cls(nparts=nparts, n=n, subs=subs, nmax_owned=nmax_owned,
                   halo=build_device_halo(subs, maxcnt=uniform.maxcnt,
                                          nmax_ghost=uniform.nmax_ghost),
                   local=_stack_local_blocks(subs, nmax_owned,
                                             uniform=uniform),
                   ghost=_stack_ghost_blocks(subs, nmax_owned,
                                             uniform=uniform),
                   nnz_total=uniform.nnz_total, dtype=dtype,
                   vector_dtype=vector_dtype,
                   owned_parts=tuple(int(p) for p in owned),
                   band_bounds=tuple(int(b) for b in bounds),
                   halo_send_total=uniform.halo_send_total)

    @classmethod
    def build_local_read(cls, path, nparts: int, dtype=torch.float64,
                         vector_dtype=None, bounds=None,
                         owned=None) -> "DistributedProblem":
        """Each process range-reads only its own rows of a row-sorted
        full-storage binary file (``mtx2bin --expand``) and builds only
        its own subdomains (``acg_tpu/parallel/dist.py:652-679``): I/O,
        host memory and preprocessing are O(local nnz).  Multi-process
        callers that want agreed one-sided failures run
        :meth:`read_local_subdomains`, agree, then
        :meth:`assemble_local` (the CLI does)."""
        subs, bounds, n, owned = cls.read_local_subdomains(
            path, nparts, bounds=bounds, owned=owned)
        return cls.assemble_local(subs, bounds, n, nparts, owned,
                                  dtype=dtype, vector_dtype=vector_dtype)

    def _owned(self):
        return (range(self.nparts) if self.owned_parts is None
                else self.owned_parts)

    def scatter(self, x_global: np.ndarray) -> np.ndarray:
        """A global vector as stacked (nparts, nmax_owned) owned rows,
        zero padding; only this process's parts are filled."""
        x_global = np.asarray(x_global)
        out = np.zeros((self.nparts, self.nmax_owned), dtype=x_global.dtype)
        for p in self._owned():
            s = self.subs[p]
            out[p, : s.nowned] = x_global[s.global_ids[: s.nowned]]
        return out

    def gather(self, stacked) -> np.ndarray:
        """Inverse of :meth:`scatter`: owned rows back to global order
        (every part's rows of ``stacked``)."""
        stacked = np.asarray(stacked)
        out = np.zeros(self.n, dtype=stacked.dtype)
        if self.band_bounds is not None:
            for p in range(self.nparts):
                lo, hi = self.band_bounds[p], self.band_bounds[p + 1]
                out[lo:hi] = stacked[p, : hi - lo]
            return out
        for p, s in enumerate(self.subs):
            out[s.global_ids[: s.nowned]] = stacked[p, : s.nowned]
        return out

    def neighbor_counts(self):
        """(send_counts, recv_counts), each (nparts, nparts) int32:
        ``send_counts[p, q]`` = entries p sends to q.  Gates the puts of
        the one-sided transport.  ``recv_counts`` is filled from the
        receive windows and must be the transpose (every receiver expects
        exactly what its senders put); a full build where it is not
        raises.  In the local-read flow only this process's parts carry
        plans, so only their rows are filled (``acg_tpu/parallel/
        dist.py:693-718``)."""
        scnt = np.zeros((self.nparts, self.nparts), dtype=np.int32)
        rcnt = np.zeros((self.nparts, self.nparts), dtype=np.int32)
        for p, s in enumerate(self.subs):
            h = s.halo
            if h is None:
                continue
            for q, cnt in zip(h.send_parts, h.send_counts):
                scnt[p, int(q)] = int(cnt)
            for q, cnt in zip(h.recv_parts, h.recv_counts):
                rcnt[p, int(q)] = int(cnt)
        if self.owned_parts is None and not np.array_equal(rcnt, scnt.T):
            raise ValueError("halo plan mismatch: a part's receive window "
                             "differs from its sender's send window")
        return scnt, rcnt

    def part_rows(self) -> list:
        """Owned row count per part, in part order."""
        if self.band_bounds is not None:
            return [int(self.band_bounds[p + 1] - self.band_bounds[p])
                    for p in range(self.nparts)]
        return [int(s.nowned) for s in self.subs]

    def row_permutation(self) -> np.ndarray | None:
        """The global row ids in stacked slot order (part 0's owned
        rows, then part 1's, ...), or None where this process cannot
        derive them (parts that are stubs without band bounds),
        ``acg_tpu/parallel/dist.py:728-746``.  A restricted build of the
        multi-process tier still holds every part's node set, so its
        snapshots carry the sidecar too."""
        if self.band_bounds is not None:
            b = self.band_bounds
            return np.concatenate(
                [np.arange(b[p], b[p + 1], dtype=np.int64)
                 for p in range(self.nparts)] or [np.zeros(0, np.int64)])
        if any(getattr(s, "global_ids", None) is None for s in self.subs):
            return None
        return np.concatenate(
            [np.asarray(s.global_ids[: s.nowned], dtype=np.int64)
             for s in self.subs] or [np.zeros(0, np.int64)])

    def halo_total(self) -> int:
        """Entries every part sends per exchange, summed."""
        if self.halo_send_total is not None:
            return int(self.halo_send_total)
        return sum(int(s.halo.total_send) for s in self.subs
                   if s.halo is not None)


def arm_matfree(prob: DistributedProblem, op) -> DistributedProblem:
    """Arm the matrix-free operator tier over a built problem
    (``acg_tpu.parallel.dist.arm_matfree``): the assembled local planes
    give way to a ``matfree`` stacked block whose SpMV generates the
    stencil values per part from ``(row0, nowned)`` and the operator's
    O(grid-side) tables, while the halo plan and the ghost block stay
    assembled and ride the exchange unchanged.  In place; returns
    ``prob``.

    Needs a contiguous natural-order band partition (each part's owned
    rows are then one global row range, so the generated planes masked to
    the owned window equal the assembled stacking bitwise); anything else
    refuses rather than answer a different system."""
    if not isinstance(op, StencilOperator):
        raise AcgError(
            ErrorCode.NOT_SUPPORTED,
            "the distributed matrix-free tier runs the built-in "
            "stencil operators (their local structure is derivable per "
            "part); user-registered operators ride the single-device "
            "tiers")
    if int(op.nrows) != int(prob.n):
        raise AcgError(
            ErrorCode.INVALID_VALUE,
            f"operator computes a {op.nrows}-row system; this problem "
            f"has {prob.n} rows")
    if op.dtype != prob.dtype:
        raise AcgError(
            ErrorCode.INVALID_VALUE,
            f"operator dtype {op.dtype} != problem dtype {prob.dtype}")
    rows0, nowns = [], []
    for s in prob.subs:
        gids = np.asarray(s.global_ids[: s.nowned], dtype=np.int64)
        if s.nowned and (s.owned_order != "natural"
                         or int(gids[-1]) - int(gids[0]) + 1 != s.nowned):
            raise AcgError(
                ErrorCode.NOT_SUPPORTED,
                f"matrix-free stencils need a contiguous natural-order "
                f"band partition (part {s.part} owns a scattered row "
                f"set); use --partition-method band")
        rows0.append(int(gids[0]) if s.nowned else 0)
        nowns.append(int(s.nowned))
    P = prob.nparts
    arrays = (np.asarray(rows0, np.int64), np.asarray(nowns, np.int64))
    for t in op.tables:
        t = t.cpu().double().numpy()
        arrays = arrays + (np.broadcast_to(t, (P,) + t.shape).copy(),)
    prob.local = StackedLocalBlock(format="matfree", arrays=arrays,
                                   offsets=op.offsets,
                                   nrows=prob.nmax_owned, operator=op)
    prob.operator = op
    return prob


def make_dist_spmv(prob: DistributedProblem, la, ga, halo, scnt, comm: str,
                   use_kernel: bool, recv=None, halo_hook=None):
    """``spmv(x)`` for stacked x: the local block (kernel K1 batched over
    parts when ``use_kernel`` and the blocks are DIA), then the halo
    exchange of ``comm`` ("xla": transpose; "dma": kernel K6 into the
    zeroed receive plane ``recv``, or a plane zeroed at the first
    exchange of another vector dtype) and the ghost block's contribution
    (``make_dist_spmv``, ``dist.py:761-810``).  ``la``/``ga``/``halo``/
    ``scnt`` are the device arrays of the problem's blocks, halo plan and
    send counts.  ``halo_hook(ghost)`` (the fault injector's ``halo:``
    site, :meth:`~acg_tpu_torch.solvers.cg.LoopGuard.apply_halo`) sees
    the received ghost values after the exchange (after K6's put under
    dma), as ``acg_tpu/parallel/dist.py:804`` applies it."""
    local, ghost = prob.local, prob.ghost
    has_ghosts = prob.halo.has_ghosts
    # one zeroed receive plane per vector dtype (the replacement program
    # exchanges bf16 and f32 vectors)
    recvs = {} if recv is None else {recv.dtype: recv}

    def recv_for(x):
        if x.dtype not in recvs:
            h = prob.halo
            recvs[x.dtype] = torch.zeros((h.nparts, h.nparts,
                                          max(h.maxcnt, 1)),
                                         dtype=x.dtype, device=x.device)
        return recvs[x.dtype]

    def exchange(x):
        if comm == "dma":
            g = halo_exchange_dma(x, halo.send_idx, halo.ghost_src,
                                  halo.ghost_valid, scnt, recv_for(x))
        else:
            g = halo_exchange(x, halo.send_idx, halo.ghost_src)
        return g if halo_hook is None else halo_hook(g)

    return make_block_spmv(local, ghost, la, ga, has_ghosts, exchange,
                           use_kernel)


def make_block_spmv(local, ghost, la, ga, has_ghosts: bool, exchange,
                    use_kernel: bool):
    """``spmv(x)`` over stacked local and ghost blocks (all parts, or a
    rank's parts) with the ghost vectors from ``exchange(x)``."""
    def spmv(x):
        y = local.mv(la, x, use_kernel)
        if has_ghosts:
            ghost.add_to(ga, y, exchange(x))
        return y

    return spmv


def interior_border_split(prob: DistributedProblem) -> np.ndarray:
    """``(nparts, imax)`` int32 interior row ids per part, ascending,
    padded with ``nmax_owned`` (``acg_tpu/parallel/dist.py:813-842``).

    A row is *border* when it couples to ghost values (it has entries in
    the ghost block: the coupled-row list of :class:`StackedGhostBlock`);
    every other owned row is *interior*, and its SpMV result needs
    nothing from the halo exchange (the reference's interior/border
    graph split, ``graph.c``)."""
    interiors = []
    for s in prob.subs:
        mask = np.ones(s.nowned, dtype=bool)
        coupled = np.flatnonzero(np.diff(s.A_ghost.indptr))
        mask[coupled[coupled < s.nowned]] = False
        interiors.append(np.flatnonzero(mask).astype(np.int32))
    imax = max((r.size for r in interiors), default=0) or 1
    out = np.full((prob.nparts, imax), prob.nmax_owned, dtype=np.int32)
    for p, r in enumerate(interiors):
        out[p, : r.size] = r
    return out


def make_dist_spmv_overlapped(prob: DistributedProblem, la, ga, halo, scnt,
                              comm: str, irows, recv=None, side=None):
    """The interior/border OVERLAPPED distributed SpMV of the fused tier
    (``make_dist_spmv_overlapped``, ``acg_tpu/parallel/dist.py:845-944``):
    the same ``spmv(x)`` as :func:`make_dist_spmv`, bitwise, for DIA, ELL
    and matrix-free local blocks.

    On the card it is aCG's host-initiated stream schedule
    (``cgcuda.c:855-899``): an event marks x ready on the compute
    stream; the side stream ``side`` waits for it and runs the halo
    exchange (pack, K6 or the transpose, unpack) while the compute stream
    runs the local block over ALL owned rows (K1 batched over parts,
    stacked K7, or the ELL gathers: the launch of the unsplit tier); the
    compute stream then waits for the side stream and adds the ghost
    block's contribution.  The local block is enqueued before the halo
    chain: the loop is host-bound, and a chain enqueued first ran alone
    before K1 was launched (none of it hidden).  The unpacked ghost
    vector is recorded on the compute stream before it is freed, so the
    allocator cannot hand its memory to the side stream's next exchange
    early; x and the receive plane ``recv`` (zeroed on the compute
    stream) are ordered by the stream waits themselves.

    On the CPU it is the reference's per-row form: the interior rows
    (``irows``, flat ids into the (P * nrows) stack) and the border rows
    (the ghost block's coupled rows) computed apart, copied into zeros,
    then the ghost contribution added on the border rows."""
    local, ghost = prob.local, prob.ghost
    if local.format not in ("dia", "ell", "matfree"):
        raise ValueError(f"overlapped SpMV needs DIA, ELL or matrix-free "
                         f"local blocks (got {local.format!r})")
    has_ghosts = prob.halo.has_ghosts
    brows = ga[0]

    def exchange(x):
        if comm == "dma":
            return halo_exchange_dma(x, halo.send_idx, halo.ghost_src,
                                     halo.ghost_valid, scnt, recv)
        return halo_exchange(x, halo.send_idx, halo.ghost_src)

    def spmv_rows(x):
        xg = exchange(x) if has_ghosts else None
        y = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
        y.index_copy_(0, irows, local.rows_mv(la, x, irows))
        y.index_copy_(0, brows, local.rows_mv(la, x, brows))
        y = y.view(x.shape)
        if xg is not None:
            ghost.add_to(ga, y, xg)
        return y

    if side is not None:
        ready, done = torch.cuda.Event(), torch.cuda.Event()

    def spmv_streams(x):
        if not has_ghosts:
            return local.mv(la, x, True)
        main = torch.cuda.current_stream(x.device)
        ready.record(main)
        y = local.mv(la, x, True)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            xg = exchange(x)
            done.record(side)
        main.wait_event(done)
        xg.record_stream(main)
        ghost.add_to(ga, y, xg)
        return y

    return spmv_rows if side is None else spmv_streams


class DistCGSolver(_cg.ChunkedCGSolver):
    """Classic or pipelined CG over ``problem.nparts`` stacked parts on one
    device -- the counterpart of ``acg_tpu.parallel.dist.DistCGSolver``.

    ``comm`` is the halo transport: ``"xla"`` (the transpose of the send
    plane, the all_to_all analog) or ``"dma"`` (the one-sided puts of
    kernel K6; its plain version on the CPU).  ``kernels``: ``"auto"``
    takes the hand kernels (K1 batched over parts for DIA local blocks,
    K7 stacked over parts for an armed Poisson stencil, and K5 for the
    pipelined update) on CUDA and plain PyTorch on the CPU; ``"pallas"`` the kernels (their plain versions
    on the CPU, ``"pallas-plain"``); ``"xla"`` plain PyTorch.  The ELL
    and binned-ELL local blocks, the ghost block and the pack/unpack
    gathers are plain PyTorch in every tier.  The receive plane of the
    dma transport is allocated and zeroed once per solve.

    ``precise_dots`` psums compensated dot pairs; ``replace_every``
    (bf16 vectors) runs the replacement program over the stacked SpMV;
    ``precond`` makes the classic and pipelined loops preconditioned,
    with jacobi and bjacobi state built on the host from each part's
    local block and the cheby interval from a power iteration over the
    stacked SpMV (``mstate`` takes a state instead, as host arrays with
    a leading parts axis).

    ``algorithm`` runs a communication-avoiding recurrence
    (:mod:`acg_tpu_torch.recurrence`) over the stacked SpMV: s-step CG
    psums each block's per-part Gram matrices once, p(l)-CG each
    iteration's per-part window dots once, and p(l) restarts on its
    square-root breakdown; the Chebyshev interval comes from the power
    iteration over the stacked SpMV.

    ``kernels="fused"`` runs the classic and pipelined loops of
    :mod:`acg_tpu_torch.solvers.cg` over the interior/border overlapped
    SpMV (:func:`make_dist_spmv_overlapped`): on CUDA the halo exchange
    runs on a side stream of its own while K1 batched over parts (or
    stacked K7, or the ELL gathers) computes every owned row, and the
    pipelined update is K5; on the CPU (``"fused-plain"``) the interior
    and border rows are computed apart.  DIA, ELL and matrix-free local
    blocks, any dtype, residual criteria; it refuses precise_dots,
    precond, replace_every and algorithm.

    In a multi-process run (:func:`~acg_tpu_torch.parallel.multihost.
    initialize`) the solver runs this rank's parts: their blocks, plan
    rows and vectors on its card, the psum over every rank's partials
    (:func:`~acg_tpu_torch.parallel.reductions.make_rank_psum`), the halo
    by ``all_to_all_single`` (``"xla"``) or K6's cross-process form
    (``"dma"``: :class:`~acg_tpu_torch.parallel.halo_dma.PeerPlanes`
    made at the first exchange, released by :meth:`close`; its plain
    version on the CPU).  Host results are gathered to every rank.
    ``precond`` (its state built for this rank's parts, the cheby
    interval from the ranks' power iteration) and the CA recurrences
    (their Gram and window products through the same rank psum) run
    there with the stacked tier's bits; ``kernels="fused"`` is
    refused.

    ``trace``/``progress`` arm the in-loop ring and heartbeat of the
    classic and pipelined loops (:mod:`acg_tpu_torch.telemetry`), on the
    stacked tier and in rank mode: the ring records the psum'd scalars,
    and the heartbeat prints once per run (from process 0 in rank
    mode).  The replacement program refuses them at solve time, the CA
    recurrences at construction.

    ``recovery``, ``health`` and ``ckpt`` arm the robustness tier on the
    stacked tier (:class:`~acg_tpu_torch.solvers.cg.ChunkedCGSolver`):
    detection in the loops, the ``halo:`` and ``part=`` fault sites, the
    ladder's restart, transport (``--comm dma`` -> ``xla``) and
    distributed-host rungs, the audit and ABFT over the psum'd dots, and
    the checkpoint chunks with the row-permutation sidecar that lets a
    snapshot resume on another partition.  In a multi-process run a
    part-targeted fault fires on the rank that owns the part, every
    restart passes the ranks' error agreement, the audit and ABFT run
    over the rank psum, and a snapshot is gathered to every rank and
    written by the primary after :func:`~acg_tpu_torch.checkpoint.
    agree_seq`.  The CA recurrences checkpoint on one device only, as
    the reference's mesh refuses (``dist.py:1217-1221``).
    """

    _what = "dist-cg"
    _beat_name = "dist-cg"
    _ca_ckpt = False

    def __init__(self, problem: DistributedProblem, pipelined: bool = False,
                 comm: str = "xla", kernels: str = "auto", device=None,
                 precise_dots: bool = False, replace_every: int = 0,
                 replace_restart: bool = True, precond=None, mstate=None,
                 algorithm=None, trace: int = 0, progress: int = 0,
                 recovery=None, health=None, ckpt=None):
        if comm not in ("xla", "dma"):
            raise ValueError(f"unknown halo transport {comm!r}")
        self.device = resolve_device(device)
        self.problem = problem
        # the multi-process tier: this rank's parts of every array
        self._ranks = None
        w = multihost.world()
        if w is not None and w.size > 1:
            ranges = mesh.part_ranges(problem.nparts, w.size)
            lo, hi = ranges[w.rank]
            if (problem.owned_parts is not None
                    and tuple(problem.owned_parts) != tuple(range(lo, hi))):
                raise ValueError(
                    f"rank {w.rank} owns parts {lo}..{hi - 1}; this "
                    f"problem was built for parts {problem.owned_parts}")
            self._ranks = (ranges, w.rank)
            if kernels == "fused":
                raise ValueError(
                    "kernels='fused' needs the full-information build: "
                    "restricted multi-controller builds hold other "
                    "controllers' coupled-row lists as stubs, so the "
                    "interior/border split is not derivable")
            if comm == "dma" and self.device.type == "cuda" \
                    and not w.same_host:
                # K6's peer puts need the peers' planes mapped: raise
                # rather than quietly take the plain exchange
                raise ValueError(
                    "comm='dma' across processes needs every rank on one "
                    "host: CUDA IPC maps peer memory within one host "
                    "only; use comm='xla'")
        self.algo = rec.parse_algorithm(algorithm)
        if self.algo is not None and not self.algo.communication_avoiding:
            pipelined = self.algo.kind == "pipelined"
            self.algo = None
        self._lam = None
        self.pipelined = pipelined
        self.comm = comm
        on_cuda = self.device.type == "cuda"
        # a local block with a kernel: DIA planes (K1 batched over parts)
        # or the armed Poisson stencil (K7 stacked over parts); other
        # stencils generate plain planes
        if problem.local.format == "matfree":
            has_kernel = problem.operator.kind == "poisson"
            kernel_ok = (problem.dtype == problem.vdtype
                         and problem.vdtype in K.STENCIL_TYPES)
        else:
            has_kernel = problem.local.format == "dia"
            kernel_ok = (problem.dtype, problem.vdtype) in K.DIA_SPMV_TYPES
        if kernels == "fused":
            # the fused tier (acg_tpu/parallel/dist.py:1109-1129): the
            # classic and pipelined loops over the interior/border
            # overlapped SpMV, which needs a per-row gather form of the
            # local block
            if problem.local.format not in ("dia", "ell", "matfree"):
                raise ValueError(
                    "kernels='fused' needs DIA, ELL or matrix-free "
                    f"local blocks (this problem stacked "
                    f"{problem.local.format!r}, which has no per-row "
                    f"gather form); use kernels='auto'")
            kernels = "fused" if on_cuda else "fused-plain"
        elif kernels == "auto":
            kernels = ("pallas" if on_cuda and has_kernel and kernel_ok
                       else "xla")
        elif kernels == "pallas":
            if has_kernel and not kernel_ok:
                raise ValueError(f"kernels='pallas': no {problem.local.format}"
                                 f" kernel for {problem.dtype} local blocks "
                                 f"with {problem.vdtype} vectors")
            if not on_cuda:
                kernels = "pallas-plain"
        if kernels not in ("xla", "pallas", "pallas-plain", "fused",
                           "fused-plain"):
            raise ValueError(f"unknown kernels choice {kernels!r}")
        self.kernels = kernels
        self.precise_dots = bool(precise_dots)
        self.replace_every = int(replace_every)
        self.replace_restart = bool(replace_restart)
        if self.replace_every < 0:
            raise ValueError("replace_every must be >= 0")
        if self.replace_every:
            if problem.vdtype != torch.bfloat16:
                raise ValueError(
                    "replace_every is the bf16 tier's accuracy contract; "
                    "build the problem with vector_dtype=bf16 (f32/f64 "
                    "storage has no replacement drift to correct)")
            if pipelined:
                raise ValueError("replace_every implements classic CG")
            if self.precise_dots:
                raise ValueError("replace_every computes scalars in "
                                 "plain f32; precise_dots needs the "
                                 "direct programs")
        self.precond_spec = parse_precond(precond)
        if self.precond_spec is not None and self.replace_every:
            raise ValueError(
                "precond does not compose with replace_every: the "
                "replacement segments restructure the recurrences the "
                "preconditioner threads through")
        if mstate is not None and self.precond_spec is None:
            raise ValueError("mstate is the state of a preconditioner; "
                             "pass precond too")
        if self.algo is not None:
            # the reference's set for this tier (dist.py:1192-1237)
            ca = str(self.algo)
            if pipelined:
                raise ValueError(
                    f"--algorithm {ca} selects its own recurrence; it "
                    f"does not compose with the pipelined flag")
            if self.replace_every:
                raise ValueError(
                    f"{ca} does not compose with replace_every")
            if self.precise_dots:
                raise ValueError(
                    f"{ca} accumulates its fused Gram/window reductions "
                    f"in the scalar dtype; precise_dots composes with "
                    f"the classic/pipelined programs")
            if self.precond_spec is not None:
                raise ValueError(
                    f"{ca} runs unpreconditioned: the s-step basis and "
                    f"the p(l) auxiliary basis have no M^-1 hook yet")
            if problem.vdtype == torch.bfloat16:
                raise ValueError(
                    f"{ca} amplifies storage rounding through its basis "
                    f"products; bf16 vectors need the classic/pipelined "
                    f"tiers")
        if kernels.startswith("fused"):
            # the reference's fused base program threads none of these
            # (dist.py:1253-1289); the rest are refused by _REFUSED
            for on, what in (
                    (self.replace_every,
                     "replace_every (the replacement segments "
                     "restructure the loop)"),
                    (self.precise_dots,
                     "precise_dots (the fused tier accumulates its "
                     "dots in the plain scalar dtype)"),
                    (self.precond_spec is not None,
                     "precond (no preconditioner hook in the fused "
                     "base program)"),
                    (self.algo is not None,
                     f"--algorithm {self.algo} (the CA recurrences "
                     f"keep the unsplit SpMV; fused covers "
                     f"classic/pipelined)"),
                    (bool(trace or progress),
                     "convergence telemetry (trace/progress)")):
                if on:
                    raise ValueError(
                        f"kernels='fused' (dist) does not compose with "
                        f"{what}; use kernels='auto'/'xla'/'pallas'")
        self._mstate = None
        self._check_telemetry(trace, progress)
        self._check_robustness(recovery, health, ckpt, None,
                               kernels.startswith("fused"),
                               self.replace_every)
        if self.replace_every and (self.trace or self.progress):
            raise ValueError(
                "convergence telemetry (trace/progress) does not reach "
                "the replacement-segment program (replace_every); use "
                "the direct classic/pipelined programs")
        self.stats = SolverStats(unknowns=problem.n)
        # the matrix, halo plan and counts move to the device once (on
        # the multi-process tier this rank's parts only)
        dev, dt = self.device, problem.dtype
        local, ghost, halo = problem.local, problem.ghost, problem.halo
        scnt, rcnt = problem.neighbor_counts()
        self._psum = psum
        self._peers: dict = {}
        if self._ranks is not None:
            ranges, rank = self._ranks
            lo, hi = ranges[rank]
            local, ghost, halo = (local.take(lo, hi), ghost.take(lo, hi),
                                  halo.take(lo, hi))
            # the counts gating this rank's puts (its rows) and waits
            # (its columns, from its own receive windows)
            scnt = scnt.copy()
            scnt[:, lo:hi] = rcnt[lo:hi].T
            self._psum = make_rank_psum([b - a for a, b in ranges])
        self._local, self._ghost = local, ghost
        self._la = local.to(dev, dt)
        self._ga = ghost.to(dev, dt, max(problem.halo.nmax_ghost, 1))
        self._halo = halo.to(dev)
        self._scnt = _put(scnt, dev, torch.int32)
        if mstate is not None:
            self._mstate = state_from_numpy(
                self.precond_spec, [self._rank_rows(a) for a in mstate],
                dev)
        self._irows = self._side = None
        if kernels == "fused":
            # the halo exchange's own stream, made once
            self._side = torch.cuda.Stream(device=dev)
        elif kernels == "fused-plain":
            # the interior rows of the per-row form, uploaded once
            split = interior_border_split(problem)
            p, i = np.nonzero(split < problem.nmax_owned)
            self._irows = _put(p * problem.nmax_owned + split[p, i], dev,
                               torch.int64)

    def _spmv(self, guard=None):
        """This solve's distributed SpMV, with a fresh zeroed receive
        plane for the dma transport: under ``kernels="fused"`` the
        interior/border overlapped SpMV.  ``guard`` (a
        :class:`~acg_tpu_torch.solvers.cg.LoopGuard`) sees the received
        halo of the loop's main SpMV (the ``halo:`` fault site)."""
        prob = self.problem
        if self._ranks is not None:
            return self._rank_spmv(guard)
        recv = None
        if self.comm == "dma":
            h = prob.halo
            recv = torch.zeros((h.nparts, h.nparts, max(h.maxcnt, 1)),
                               dtype=prob.vdtype, device=self.device)
        if self.kernels.startswith("fused"):
            return make_dist_spmv_overlapped(
                prob, self._la, self._ga, self._halo, self._scnt, self.comm,
                self._irows, recv, self._side)
        return make_dist_spmv(prob, self._la, self._ga, self._halo,
                              self._scnt, self.comm,
                              self.kernels != "xla", recv,
                              None if guard is None or guard.fault is None
                              else guard.apply_halo)

    def _rank_spmv(self, guard=None):
        """The SpMV of the multi-process tier: this rank's parts, the
        halo across ranks (:meth:`_rank_exchange`); ``guard`` sees the
        received halo as on stacked parts."""
        prob = self.problem
        exchange = self._rank_exchange()
        if guard is not None and guard.fault is not None:
            plain = exchange

            def exchange(x):
                return guard.apply_halo(plain(x))
        return make_block_spmv(self._local, self._ghost, self._la, self._ga,
                               prob.halo.has_ghosts, exchange,
                               self.kernels != "xla")

    def _guard(self, fault, detect: bool, k_offset: int = 0, carry=None,
               state_io: bool = False):
        """The loop guard, its fault in this rank's frame: a
        part-targeted fault fires on the rank that owns the part (at its
        row of the rank's stack) and nowhere else; detection stays armed
        on every rank, so the loops keep one shape."""
        if (self._ranks is not None and fault is not None
                and fault.part >= 0):
            ranges, rank = self._ranks
            lo, hi = ranges[rank]
            fault = (dataclasses.replace(fault, part=fault.part - lo)
                     if lo <= fault.part < hi else None)
        return super()._guard(fault, detect, k_offset, carry, state_io)

    def _rank_rows(self, a):
        """This rank's rows of a host array with a leading parts axis
        (all of it on the stacked tier)."""
        if self._ranks is None:
            return a
        ranges, rank = self._ranks
        lo, hi = ranges[rank]
        return np.asarray(a)[lo:hi]

    def _to_dev(self, a, name: str, sdt):
        """A snapshot leaf on the device; in a multi-process run a
        stacked vector keeps this rank's parts."""
        a = np.asarray(a)
        if a.ndim >= 2:
            a = self._rank_rows(a)
        return super()._to_dev(a, name, sdt)

    def _to_host(self, leaf, name: str) -> np.ndarray:
        if self._ranks is not None and leaf.dim() >= 2:
            return multihost.get_global(leaf, self.problem.nparts)
        return super()._to_host(leaf, name)

    def _rank_exchange(self):
        """The halo exchange across ranks -- ``all_to_all_single`` for
        ``comm="xla"``, K6's peer puts for ``"dma"`` (its plain version,
        over ``torch.distributed.all_to_all``, on the CPU into a fresh
        zeroed receive plane)."""
        ranges, rank = self._ranks
        h, prob = self._halo, self.problem
        nlocal = h.send_idx.shape[0]
        recvs: dict = {}

        def exchange(x):
            # a host transport (gloo, or the CPU) leaves no device event:
            # a capture sees it as a "halo_exchange" span
            with tracing.host_span(
                    "halo_exchange", x.device.type != "cuda"
                    or (self.comm == "xla"
                        and multihost.host_collectives())):
                return transport(x)

        def transport(x):
            if self.comm == "xla":
                return halo_exchange_ranks(x, h.send_idx, h.ghost_src,
                                           ranges, rank)
            peer = None
            if x.device.type == "cuda":
                peer = self._peer(x.dtype)
            elif x.dtype not in recvs:
                recvs[x.dtype] = torch.zeros(
                    (nlocal, prob.nparts, max(prob.halo.maxcnt, 1)),
                    dtype=x.dtype, device=x.device)
            return halo_exchange_peer(x, h.send_idx, h.ghost_src,
                                      h.ghost_valid, self._scnt,
                                      recvs.get(x.dtype), ranges, rank,
                                      peer=peer)

        return exchange

    def _peer(self, dtype) -> PeerPlanes:
        """The mapped receive planes of ``dtype`` vectors, made at the
        first exchange (collectively: the ranks' SpMVs run in
        lockstep)."""
        if dtype not in self._peers:
            ranges, rank = self._ranks
            self._peers[dtype] = PeerPlanes(
                self.problem.nparts, ranges, rank, self.problem.halo.maxcnt,
                dtype, self._scnt.cpu().numpy(), self.device)
        return self._peers[dtype]

    def solve(self, b, x0=None, criteria=None, **kw):
        x = super().solve(b, x0=x0, criteria=criteria, **kw)
        for peer in self._peers.values():
            peer.check()
        return x

    def close(self) -> None:
        """Unmap and free K6's peer planes (collective on the
        multi-process tier; a no-op elsewhere)."""
        for peer in self._peers.values():
            peer.close()
        self._peers = {}

    # -- the static communication ledger (acg_tpu/parallel/dist.py:2387) --

    def comm_profile(self) -> dict:
        """The static per-iteration communication ledger (the reference's
        keys): per-neighbour halo payload bytes from the halo plans,
        psum counts and bytes, ring distances over the parts, the padded
        plane the transport moves per exchange ((P-1) windows under dma,
        P under xla), the matrix-free and fused-overlap stanzas, the CA
        recurrences' and the preconditioner's reclassifications.  Pure
        host arithmetic: nothing here touches the device.

        Classic CG psums 2 scalars an iteration apart, pipelined 1 fused
        psum of 2; compensated dots double each payload.  A restricted or
        local-read build holds plans for its own parts only
        (``owned_parts_only``)."""
        prob = self.problem
        P = int(prob.nparts)
        dbl = torch.empty((), dtype=prob.vdtype).element_size()
        sdl = torch.empty((), dtype=acc_dtype(prob.vdtype)).element_size()
        scnt, _rcnt = prob.neighbor_counts()
        neighbors = []
        total = 0
        max_hops = 0
        for p in range(P):
            for q in range(P):
                c = int(scnt[p, q])
                if c == 0 or p == q:
                    continue
                hops = min(abs(p - q), P - abs(p - q))
                max_hops = max(max_hops, hops)
                total += c * dbl
                neighbors.append({"src": p, "dst": q, "bytes": c * dbl,
                                  "hops": hops})
        nred = 1 if self.pipelined else 2
        scal = ((2 if self.pipelined else 1)
                * (2 if self.precise_dots else 1))
        led = {
            "transport": self.comm,
            "nparts": P,
            "mesh_shape": {mesh.PARTS_AXIS: P},
            "halo_exchanges_per_iteration": 1,
            **({"owned_parts_only": True,
                "owned_parts": [int(p) for p in prob.owned_parts]}
               if prob.owned_parts is not None else {}),
            "halo_bytes_per_iteration": int(total),
            "allreduce_per_iteration": int(nred),
            "allreduce_scalars": int(scal),
            "allreduce_bytes_per_iteration": int(nred * scal * sdl),
            "max_hops": int(max_hops),
            "halo_plane_bytes_per_exchange": int(
                ((P - 1) if self.comm == "dma" else P)
                * int(prob.halo.maxcnt) * dbl),
            "ring_distances": sorted({n["hops"] for n in neighbors}),
        }
        if prob.operator is not None:
            led["operator"] = prob.operator.identity()
            led["matrix_free"] = True
            led["matrix_bytes_per_spmv"] = int(prob.operator.table_bytes())
        if self.kernels.startswith("fused"):
            # how much interior-SpMV work can hide the halo exchange
            irows = interior_border_split(prob)
            nint = int((irows < prob.nmax_owned).sum())
            nbor = int((np.asarray(prob.ghost.rows) < prob.nmax_owned).sum())
            mat_b = torch.empty((), dtype=prob.dtype).element_size()
            matfree = prob.local.format == "matfree"
            idx_b = 0 if prob.local.format in ("dia", "matfree") else 4
            nnz_int = 0
            for p, s in enumerate(prob.subs):
                if s.A_local is None:
                    continue
                rnnz = np.diff(s.A_local.indptr)
                ir = irows[p]
                ir = ir[ir < s.nowned]
                nnz_int += int(rnnz[ir].sum())
            led["overlap"] = {
                "split": "interior|border",
                "interior_rows": nint,
                "border_rows": nbor,
                "interior_nnz": nnz_int,
                "interior_matrix_bytes": (
                    (0 if matfree else nnz_int * (mat_b + idx_b))
                    + 2 * nint * dbl),
            }
        if self.algo is not None:
            sched = rec.reduction_schedule(self.algo, False)
            led["algorithm"] = str(self.algo)
            led["allreduce_per_iteration"] = \
                sched["allreduce_per_iteration"]
            led["allreduce_scalars"] = sched["allreduce_scalars"]
            led["allreduce_bytes_per_iteration"] = (
                sched["allreduce_per_iteration"]
                * sched["allreduce_scalars"] * sdl)
            led["halo_exchanges_per_iteration"] = \
                sched["spmv_per_iteration"]
            led["halo_bytes_per_iteration"] = (
                total * sched["spmv_per_iteration"])
            for extra_key in ("iterations_per_reduction",
                              "reduction_latency_hidden"):
                if extra_key in sched:
                    led[extra_key] = sched[extra_key]
        if self.precond_spec is not None:
            # cheby adds its degree's halo'd SpMVs; the PCG scalar widens
            # the fused reductions: both loops move 3 scalars in all
            from acg_tpu_torch.precond import comm_contribution
            pc = comm_contribution(self.precond_spec)
            extra = int(pc.get("halo_spmv_equivalents_per_apply", 0))
            led["halo_exchanges_per_iteration"] = 1 + extra
            led["halo_bytes_per_iteration"] = int(total) * (1 + extra)
            led["allreduce_scalars"] = ((3 if self.pipelined else 2)
                                        * (2 if self.precise_dots else 1))
            led["allreduce_bytes_per_iteration"] = (
                3 * (2 if self.precise_dots else 1) * sdl)
            led["precond"] = pc
        if len(neighbors) > 64:
            led["neighbors_truncated"] = len(neighbors) - 64
            neighbors = neighbors[:64]
        led["neighbors"] = neighbors
        return led

    def _observe_comm(self, niter: int) -> None:
        """Fold this solve's traffic into the comm-byte counters.  Across
        processes each rank counts the halo its own parts send (its rows
        of the ledger's send counts) and the primary counts the psums,
        so the ranks' counters sum to the run's traffic once."""
        from acg_tpu_torch import metrics
        if self._ranks is None:
            metrics.observe_solver_comm(self, niter)
            return
        if not metrics.armed():
            return
        try:
            led = self.comm_profile()
        except Exception:  # noqa: BLE001 -- metrics never sink a solve
            return
        ranges, rank = self._ranks
        lo, hi = ranges[rank]
        scnt = self.problem.neighbor_counts()[0].astype(np.int64)
        np.fill_diagonal(scnt, 0)
        total = int(scnt.sum())
        share = int(scnt[lo:hi].sum()) / total if total else 0.0
        metrics.record_comm(
            {"halo_bytes_per_iteration":
                 led.get("halo_bytes_per_iteration", 0) * share,
             "allreduce_bytes_per_iteration":
                 led.get("allreduce_bytes_per_iteration", 0)
                 if rank == 0 else 0}, niter)

    def _solve_dtype(self):
        """The dtype b and x0 scatter to: the vector dtype, except f32
        for the replacement program, whose outer iteration owns them."""
        return torch.float32 if self.replace_every else self.problem.vdtype

    def device_args(self, b_global, x0=None):
        """``(b, x0)`` scattered to stacked (nparts, nmax_owned) tensors
        in the solve dtype on the solver's device."""
        prob = self.problem
        dev, vdt = self.device, self._solve_dtype()

        def put(v):
            s = prob.scatter(np.asarray(v, np.float64))
            if self._ranks is not None:
                return multihost.put_global(s, prob.nparts, dev, vdt)
            return _put(s, dev, vdt)

        b = put(b_global)
        x0 = torch.zeros_like(b) if x0 is None else put(x0)
        return b, x0

    def _power_lmax(self, iters: int = POWER_ITERS) -> float:
        """Power-iteration lambda_max over the stacked SpMV the solves
        run, norms psum'd over the parts, from numpy's default_rng(0)
        start vector (``acg_tpu/parallel/dist.py:2213-2263``)."""
        prob = self.problem
        sdt = acc_dtype(prob.vdtype)
        spmv = self._spmv()
        ldot = make_ldot(sdt)
        v = _put(self._rank_rows(prob.scatter(
            np.random.default_rng(0).standard_normal(prob.n))),
            self.device, prob.vdtype)
        for _ in range(iters):
            w = spmv(v)
            v = (w.to(sdt) / torch.sqrt(self._psum(ldot(w, w)))).to(
                v.dtype)
        w = spmv(v)
        return float(self._psum(ldot(v, w)) / self._psum(ldot(v, v)))

    def _ensure_precond_state(self):
        """The stacked preconditioner state, built once: jacobi and
        bjacobi from each part's local host block (no communication:
        diagonal entries are owned x owned), cheby from the power
        iteration, its interval tiled over the parts."""
        spec = self.precond_spec
        if spec is None or self._mstate is not None:
            return self._mstate
        prob = self.problem
        sdt = acc_dtype(prob.vdtype)
        if spec.kind == "jacobi":
            host = stacked_jacobi_state(prob, sdt)
        elif spec.kind == "bjacobi":
            host = stacked_bjacobi_state(prob, spec.block, sdt)
        else:
            lmax = self._power_lmax() * CHEBY_SAFETY
            host = (np.full(prob.nparts, lmax / CHEBY_RATIO),
                    np.full(prob.nparts, lmax))
        self._mstate = tuple(_put(self._rank_rows(a), self.device, sdt)
                             for a in host)
        return self._mstate

    def _ensure_lam(self):
        """The (lmin, lmax) interval of the recurrences: the power
        iteration over the stacked SpMV times the recurrences' headroom
        (``acg_tpu/parallel/dist.py:2186-2194``); (0, 0) when unread."""
        if self._lam is None:
            self._lam = ((0.0, self._power_lmax() * rec.LAM_SAFETY)
                         if self.algo.needs_lam else (0.0, 0.0))
        return self._lam

    def _ca_program(self, crit: StoppingCriteria):
        """``run(b, x0)`` of a communication-avoiding recurrence over
        this tier (``_compile_ca``, ``acg_tpu/parallel/dist.py:2063``):
        the stacked SpMV (K1 batched over parts, K6 under ``--comm
        dma``), psum'd dots, and one psum of the per-part Gram or window
        products."""
        if crit.needs_diff:
            raise ValueError(f"{self.algo} supports residual criteria "
                             f"only")
        sdt = acc_dtype(self.problem.vdtype)
        pdot = make_pdot(self._psum, make_ldot(sdt), sdt, False)
        lam = self._ensure_lam()
        algo = self.algo

        def run(b, x0, guard=None):
            ops = rec.TierOps(spmv=self._spmv(guard), dot=pdot,
                              psum_stack=self._psum,
                              sdt=sdt)
            telem = self._telemetry(sdt)
            if algo.kind == "sstep":
                return rec._cg_sstep_program(ops, b, x0, crit, algo.param,
                                             algo.basis, lam, telem, guard)
            return rec._cg_pl_program(ops, b, x0, crit, algo.param, lam,
                                      telem, guard)

        return run

    def _program(self, crit: StoppingCriteria):
        """``run(b, x0)``: one solve on the shared loops of
        :mod:`acg_tpu_torch.solvers.cg`, over this solve's distributed
        SpMV (a fresh zeroed receive plane each run) and psum'd dots."""
        if self.algo is not None:
            return self._ca_program(crit)
        if self.kernels.startswith("fused") and crit.needs_diff:
            raise ValueError("kernels='fused' supports residual "
                             "criteria only")
        sdt = acc_dtype(self.problem.vdtype)
        ldot = make_ldot(sdt)
        pdot = make_pdot(self._psum, ldot, sdt, self.precise_dots)
        pdotk = make_pdotk(self._psum, ldot, sdt, self.precise_dots)
        use_kernel = self.kernels != "xla"
        if self.replace_every:
            if crit.needs_diff:
                raise ValueError("replace_every supports residual "
                                 "criteria only")
            return lambda b, x0, guard=None: _cg._cg_replaced_program(
                self._spmv(), pdot, b, x0, crit, self.replace_every,
                self.replace_restart)
        spec = self.precond_spec
        self._ensure_precond_state()

        def run(b, x0, guard=None):
            spmv = self._spmv(guard)
            telem = self._telemetry(sdt)
            if spec is None:
                if self.pipelined:
                    return _cg._cg_pipelined_program(spmv, pdot, pdotk, b,
                                                     x0, crit, use_kernel,
                                                     telem, guard)
                return _cg._cg_program(spmv, pdot, b, x0, crit,
                                       dotk=pdotk, telem=telem,
                                       guard=guard)
            # the apply rides this run's SpMV: a cheby apply is K more
            # halo'd SpMVs
            apply = make_apply(spec, lambda _A, x: spmv(x))
            mstate = self._mstate

            def papply(r):
                return apply(mstate, None, r)

            if self.pipelined:
                return _cg._pcg_pipelined_program(spmv, pdot, pdotk, b, x0,
                                                  crit, papply, telem,
                                                  guard)
            return _cg._cg_program(spmv, pdot, b, x0, crit, papply, pdotk,
                                   telem, guard)

        return run

    def _solver_name(self) -> str:
        """The telemetry and metrics label (the reference's)."""
        if self.algo is not None:
            return self.algo.solver_name("dist-cg")
        return "dist-cg-pipelined" if self.pipelined else "dist-cg"

    def _host_x(self, x: np.ndarray) -> np.ndarray:
        if self._ranks is not None:
            # every rank's parts, gathered to every rank
            x = multihost.get_global(torch.from_numpy(x).to(self.device),
                                     self.problem.nparts)
        return self.problem.gather(x)

    # -- the robustness tier (acg_tpu/parallel/dist.py:2584-3200) ----------

    _ckpt_tier = "dist-cg"
    _host_fallback_event = "fallback: distributed host reference solver"

    def _ckpt_nparts(self):
        return int(self.problem.nparts)

    def _n_global(self) -> int:
        return int(self.problem.n)

    def _tier_fault_refusals(self, fault) -> None:
        """The stacked tier's refusals (``dist.py:2596-2610``): a halo
        fault needs ghosts, a part fault an existing part."""
        prob = self.problem
        if fault.site == "halo" and not prob.halo.has_ghosts:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "halo fault injection needs a topology with ghost "
                "exchange; this problem has no halo (single part or "
                "fully decoupled partition)")
        if fault.part >= prob.nparts:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"fault spec targets part {fault.part}, but this mesh "
                f"has {prob.nparts} parts -- the fault could never "
                f"fire")

    def _transport_rung(self, driver) -> bool:
        """A breakdown that a restart did not cure, under ``comm="dma"``:
        retire the one-sided transport for the xla exchange
        (``dist.py:2791-2811``), its own rung, not billed to the restart
        budget.  On the card it runs only when the policy names it
        (:meth:`RecoveryPolicy.comm_fallback`)."""
        pol = self.recovery
        if self.comm != "dma":
            return False
        want = (driver.restarts >= 1 and pol is not None
                and pol.comm_fallback(self.device))
        # across processes the rung runs only when every rank takes it
        if not (driver._agree(0 if want else 1) and want):
            return False
        self.stats.nbreakdowns += 1
        driver.on_fallback("fallback: halo transport dma -> xla")
        self.comm = "xla"
        return True

    def _can_host_fallback(self) -> bool:
        """Only a full single-process build holds every part's blocks."""
        prob = self.problem
        return (self._ranks is None and prob.owned_parts is None
                and all(s.A_local is not None for s in prob.subs))

    def _host_fallback(self, b_host, crit, raise_on_divergence: bool,
                       host_result: bool):
        """The last rung (``dist.py:3034-3055``): re-solve on the
        distributed host oracle over the same subdomains from the
        original b, the injector suppressed."""
        from acg_tpu_torch import faults
        from acg_tpu_torch.solvers.host_cg import HostDistCGSolver
        from acg_tpu_torch.solvers.resilience import adopt_host_stats
        hs = HostDistCGSolver(self.problem.subs)
        with faults.suppressed():
            x = hs.solve(np.asarray(b_host, np.float64), criteria=crit,
                         raise_on_divergence=raise_on_divergence)
        adopt_host_stats(self.stats, hs.stats)
        if host_result:
            return x
        return _put(self.problem.scatter(x), self.device,
                    self.problem.vdtype)

    def _ckpt_meta_extra(self, meta: dict, arrs: dict) -> None:
        """The stacked snapshot's partition count and its shape-portable
        sidecar: the global row ids in stacked slot order and the rows
        of each part."""
        prob = self.problem
        meta["nparts"] = int(prob.nparts)
        rp = prob.row_permutation()
        if rp is not None:
            arrs["_rowperm"] = rp
            meta["part_rows"] = prob.part_rows()

    def _resume_arrays(self, snap):
        """A repartitioned snapshot comes back in global row order:
        re-slice its vectors onto this problem's parts."""
        if not self.ckpt.repartition:
            return snap.arrays
        from acg_tpu_torch.checkpoint import SCALAR_LEAVES
        out = {}
        for nm, a in snap.arrays.items():
            a = np.asarray(a)
            out[nm] = (a if nm in SCALAR_LEAVES or a.ndim == 0
                       else self.problem.scatter(a))
        return out

    def _account_ops(self, st, niter: int) -> None:
        """Analytic flop/byte census of ``niter`` iterations, as the JAX
        tier bills the same configuration (``dist.py:2936``): one halo
        exchange per SpMV, classic = 2 allreduces per iteration, pipelined
        = 1 fused allreduce."""
        prob = self.problem
        n = prob.n
        # a CA recurrence runs spmv_eq SpMV-equivalents an iteration, with
        # a halo exchange each, and its own reduction schedule
        sched = None
        spmv_eq = 1.0
        if self.algo is not None:
            sched = rec.reduction_schedule(self.algo, False)
            spmv_eq = sched["spmv_per_iteration"]
        st.nflops += (cg_flops_per_iteration(prob.nnz_total, n,
                                             self.pipelined) * niter
                      + 3.0 * prob.nnz_total + 2.0 * n
                      + 3.0 * prob.nnz_total * (spmv_eq - 1.0) * niter)
        dbl = torch.empty((), dtype=prob.vdtype).element_size()
        mat_dbl = torch.empty((), dtype=prob.dtype).element_size()
        idx_b = 0 if prob.local.format in ("dia", "matfree") else 4
        # matrix-free local blocks read no planes: the matrix term is the
        # operator's O(grid-side) coefficient tables
        mat_read = (prob.operator.table_bytes() if prob.operator is not None
                    else prob.nnz_total * (mat_dbl + idx_b))
        ngemv = int(niter * spmv_eq) + 1
        st.ops["gemv"].add(ngemv, 0.0, (mat_read + 2 * n * dbl) * ngemv)
        st.ops["dot"].add(niter, 0.0, 2 * n * dbl * niter)
        st.ops["nrm2"].add(niter + 1, 0.0, n * dbl * (niter + 1))
        st.ops["axpy"].add(3 * niter, 0.0, 3 * n * dbl * 3 * niter)
        if not self.pipelined:
            st.ops["copy"].add(1, 0.0, 2 * n * dbl)
        if sched is not None:
            nred = max(int(round(sched["allreduce_per_iteration"]
                                 * niter)), 1)
            st.ops["allreduce"].add(nred, 0.0,
                                    8 * sched["allreduce_scalars"] * nred)
        else:
            nred = 1 if self.pipelined else 2
            st.ops["allreduce"].add(nred * niter, 0.0, 8 * nred * niter)
        halo_total = prob.halo_total()
        st.ops["halo"].add(ngemv, 0.0, halo_total * dbl * ngemv)
        if self.precond_spec is not None:
            _cg._account_precond(
                st, self.precond_spec, self._mstate, niter, n, dbl,
                3.0 * prob.nnz_total,
                prob.nnz_total * (mat_dbl + idx_b) + 2 * n * dbl,
                halo_bytes=halo_total * dbl)
