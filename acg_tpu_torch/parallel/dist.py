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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_tpu_torch._device import resolve_device
from acg_tpu_torch.errors import AcgError, ErrorCode
from acg_tpu_torch.graph import (Subdomain, partition_matrix,
                                 reorder_owned_natural)
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.ops.operator import StencilOperator, stencil_planes
from acg_tpu_torch.ops.spmv import (BELL_WIDTHS, acc_dtype, csr_diag_offsets,
                                    dia_mv, dia_planes_fixed,
                                    ell_planes_from_csr, padded_rows)
from acg_tpu_torch.parallel.halo import (DeviceHaloPlan, build_device_halo,
                                         halo_exchange)
from acg_tpu_torch.parallel.halo_dma import halo_exchange_dma
from acg_tpu_torch.parallel.reductions import (make_ldot, make_pdot,
                                               make_pdotk, psum)
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

    def to(self, device, dtype) -> tuple:
        """Device tensors for :meth:`mv`: values in ``dtype``, indices
        int64."""
        i64 = torch.int64
        if self.format == "matfree":
            row0, nowned, *tables = self.arrays
            return (_put(row0, device, i64), _put(nowned, device, i64),
                    *(_put(t, device, dtype) for t in tables))
        if self.format == "dia":
            return (_put(self.arrays[0], device, dtype).contiguous(),
                    torch.tensor(self.offsets, dtype=i64, device=device))
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
            # the generated planes of every part, then dia_mv
            # (acg_tpu/parallel/dist.py:116-139)
            planes = stencil_planes(op.kind, op.grid, self.offsets,
                                    tuple(tables), self.nrows, op.dtype,
                                    row0=row0, nowned=nowned)
            return dia_mv(planes, self.offsets, self.nrows, x)
        if self.format == "dia":
            planes, offsets_t = arrays
            if use_kernel:
                return K.dia_spmv(planes, self.offsets, x,
                                  offsets_t=offsets_t)
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
                        ell_waste_limit: float = 3.0) -> StackedLocalBlock:
    """The local blocks of every part in the fastest eligible stacked
    format: DIA over the union offset set when the blocks are banded
    (``max_diags`` keeps headroom over the single-device limit: the union
    of per-part offset sets can exceed any one part's count), else
    length-binned ELL when plain-ELL padding waste passes
    ``ell_waste_limit``, else ELL."""
    blocks = [s.A_local for s in subs]
    offs = np.unique(np.concatenate(
        [csr_diag_offsets(b) for b in blocks] or [np.zeros(1, np.int64)]))
    nnz = sum(int(b.nnz) for b in blocks)
    Kl = max((int(np.diff(b.indptr).max(initial=0)) for b in blocks),
             default=0)
    if (nnz and offs.size <= max_diags
            and offs.size * nmax_owned * len(blocks) <= dia_waste_limit * nnz):
        planes = np.zeros((offs.size, len(blocks), nmax_owned))
        for p, b in enumerate(blocks):
            planes[:, p, :] = dia_planes_fixed(b, offs, nmax_owned)
        return StackedLocalBlock(format="dia", arrays=(planes,),
                                 offsets=tuple(int(o) for o in offs),
                                 nrows=nmax_owned)
    if nnz and Kl * nmax_owned * len(blocks) > ell_waste_limit * nnz:
        bell = _bell_histogram(blocks)
        return _stack_bell_blocks(blocks, nmax_owned,
                                  tuple(int(m) for m in bell[:-1]),
                                  int(bell[-1]))
    Kl = max(Kl, 1)
    ld = np.zeros((len(blocks), nmax_owned, Kl))
    lc = np.zeros((len(blocks), nmax_owned, Kl), dtype=np.int32)
    for p, b in enumerate(blocks):
        ld[p], lc[p] = ell_planes_from_csr(b.indptr, b.indices, b.data,
                                           nmax_owned, pad_k=Kl)
    return StackedLocalBlock(format="ell", arrays=(ld, lc), offsets=(),
                             nrows=nmax_owned)


def _stack_ghost_blocks(subs, nmax_owned: int) -> StackedGhostBlock:
    """The ghost blocks of every part, compressed to coupled rows."""
    coupled = [np.flatnonzero(np.diff(s.A_ghost.indptr)) for s in subs]
    bmax = max((r.size for r in coupled), default=0) or 1
    Kg = max((int(np.diff(s.A_ghost.indptr).max(initial=0)) for s in subs),
             default=0) or 1
    P = len(subs)
    rows = np.full((P, bmax), nmax_owned, dtype=np.int32)  # pad = dropped
    data = np.zeros((P, bmax, Kg))
    cols = np.zeros((P, bmax, Kg), dtype=np.int32)
    for p, (s, ri) in enumerate(zip(subs, coupled)):
        if ri.size == 0:
            continue
        sub = s.A_ghost[ri]
        d, c = ell_planes_from_csr(sub.indptr, sub.indices, sub.data,
                                   ri.size, pad_k=Kg)
        rows[p, : ri.size] = ri
        data[p, : ri.size] = d
        cols[p, : ri.size] = c
    return StackedGhostBlock(rows=rows, data=data, cols=cols,
                             nrows=nmax_owned, bmax=bmax)


@dataclasses.dataclass
class DistributedProblem:
    """Host-side compilation of a partitioned matrix into stacked arrays
    (the role of ``acgsolvercuda_init``, ``cgcuda.c:143-332``).  ``dtype``
    is the matrix blocks' torch dtype, ``vector_dtype`` the vectors' (None
    = the same; bf16 blocks with f32 vectors is ``--dtype mixed``)."""

    nparts: int
    n: int
    subs: list[Subdomain]
    nmax_owned: int
    halo: DeviceHaloPlan
    local: StackedLocalBlock
    ghost: StackedGhostBlock
    nnz_total: int
    dtype: torch.dtype
    vector_dtype: torch.dtype | None = None
    operator: object = None   # the armed stencil (arm_matfree), if any

    @property
    def vdtype(self):
        return self.dtype if self.vector_dtype is None else self.vector_dtype

    @classmethod
    def build(cls, full_csr, part, nparts: int, dtype=torch.float64,
              subs: list[Subdomain] | None = None,
              vector_dtype=None) -> "DistributedProblem":
        """Stack the parts of ``part``; ``subs`` are this partition's
        subdomains when the caller built them already.  Each part's
        owned rows are re-sorted by global id (in place in ``subs``), so
        contiguous partitions of banded matrices keep DIA local
        blocks."""
        if subs is None:
            subs = partition_matrix(full_csr, part, nparts)
        reorder_owned_natural(subs)
        nmax_owned = max(s.nowned for s in subs)
        return cls(nparts=nparts, n=full_csr.shape[0], subs=subs,
                   nmax_owned=nmax_owned, halo=build_device_halo(subs),
                   local=_stack_local_blocks(subs, nmax_owned),
                   ghost=_stack_ghost_blocks(subs, nmax_owned),
                   nnz_total=int(full_csr.nnz), dtype=dtype,
                   vector_dtype=vector_dtype)

    def scatter(self, x_global: np.ndarray) -> np.ndarray:
        """A global vector as stacked (nparts, nmax_owned) owned rows,
        zero padding."""
        x_global = np.asarray(x_global)
        out = np.zeros((self.nparts, self.nmax_owned), dtype=x_global.dtype)
        for p, s in enumerate(self.subs):
            out[p, : s.nowned] = x_global[s.global_ids[: s.nowned]]
        return out

    def gather(self, stacked) -> np.ndarray:
        """Inverse of :meth:`scatter`: owned rows back to global order."""
        stacked = np.asarray(stacked)
        out = np.zeros(self.n, dtype=stacked.dtype)
        for p, s in enumerate(self.subs):
            out[s.global_ids[: s.nowned]] = stacked[p, : s.nowned]
        return out

    def neighbor_counts(self):
        """(send_counts, recv_counts), each (nparts, nparts) int32:
        ``send_counts[p, q]`` = entries p sends to q.  Gates the puts of
        the one-sided transport.  ``recv_counts`` is filled from the
        receive windows and must be the transpose (every receiver expects
        exactly what its senders put); a plan where it is not raises."""
        scnt = np.zeros((self.nparts, self.nparts), dtype=np.int32)
        rcnt = np.zeros((self.nparts, self.nparts), dtype=np.int32)
        for p, s in enumerate(self.subs):
            h = s.halo
            for q, cnt in zip(h.send_parts, h.send_counts):
                scnt[p, int(q)] = int(cnt)
            for q, cnt in zip(h.recv_parts, h.recv_counts):
                rcnt[p, int(q)] = int(cnt)
        if not np.array_equal(rcnt, scnt.T):
            raise ValueError("halo plan mismatch: a part's receive window "
                             "differs from its sender's send window")
        return scnt, rcnt

    def part_rows(self) -> list:
        """Owned row count per part, in part order."""
        return [int(s.nowned) for s in self.subs]


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
                   use_kernel: bool, recv=None):
    """``spmv(x)`` for stacked x: the local block (kernel K1 batched over
    parts when ``use_kernel`` and the blocks are DIA), then the halo
    exchange of ``comm`` ("xla": transpose; "dma": kernel K6 into the
    zeroed receive plane ``recv``) and the ghost block's contribution
    (``make_dist_spmv``, ``dist.py:761-810``).  ``la``/``ga``/``halo``/
    ``scnt`` are the device arrays of the problem's blocks, halo plan and
    send counts."""
    local, ghost = prob.local, prob.ghost
    has_ghosts = prob.halo.has_ghosts

    def spmv(x):
        y = local.mv(la, x, use_kernel)
        if has_ghosts:
            if comm == "dma":
                xg = halo_exchange_dma(x, halo.send_idx, halo.ghost_src,
                                       halo.ghost_valid, scnt, recv)
            else:
                xg = halo_exchange(x, halo.send_idx, halo.ghost_src)
            ghost.add_to(ga, y, xg)
        return y

    return spmv


# options of acg_tpu's DistCGSolver that this slice does not carry, each
# refused by name: (keyword, value that means "off")
_REFUSED = (("precond", None), ("health", None), ("ckpt", None),
            ("recovery", None), ("trace", 0), ("progress", 0),
            ("replace_every", 0), ("algorithm", None),
            ("precise_dots", False))


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

    Not carried by this slice, each refused with a ValueError naming it:
    ``precond``, ``health``, ``ckpt``, ``recovery``, ``trace``/
    ``progress``, ``replace_every``, ``algorithm``, ``precise_dots`` and
    ``kernels="fused"`` (the overlapped interior/border tier).
    """

    def __init__(self, problem: DistributedProblem, pipelined: bool = False,
                 comm: str = "xla", kernels: str = "auto", device=None,
                 **options):
        for name, off in _REFUSED:
            if options.pop(name, off) not in (off,):
                raise ValueError(f"DistCGSolver: {name} is not ported to "
                                 f"the multi-part tier yet")
        if options:
            raise TypeError(f"DistCGSolver: unexpected options "
                            f"{sorted(options)}")
        if comm not in ("xla", "dma"):
            raise ValueError(f"unknown halo transport {comm!r}")
        self.device = resolve_device(device)
        self.problem = problem
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
            raise ValueError("kernels='fused' (the overlapped interior/"
                             "border tier) is not ported to the multi-part "
                             "tier yet; use kernels='auto'/'xla'/'pallas'")
        if kernels == "auto":
            kernels = ("pallas" if on_cuda and has_kernel and kernel_ok
                       else "xla")
        elif kernels == "pallas":
            if has_kernel and not kernel_ok:
                raise ValueError(f"kernels='pallas': no {problem.local.format}"
                                 f" kernel for {problem.dtype} local blocks "
                                 f"with {problem.vdtype} vectors")
            if not on_cuda:
                kernels = "pallas-plain"
        if kernels not in ("xla", "pallas", "pallas-plain"):
            raise ValueError(f"unknown kernels choice {kernels!r}")
        self.kernels = kernels
        self.stats = SolverStats(unknowns=problem.n)
        # the matrix, halo plan and counts move to the device once
        dev, dt = self.device, problem.dtype
        self._la = problem.local.to(dev, dt)
        self._ga = problem.ghost.to(dev, dt,
                                    max(problem.halo.nmax_ghost, 1))
        self._halo = problem.halo.to(dev)
        scnt, _ = problem.neighbor_counts()
        self._scnt = _put(scnt, dev, torch.int32)

    def _spmv(self):
        """This solve's distributed SpMV, with a fresh zeroed receive
        plane for the dma transport."""
        prob = self.problem
        recv = None
        if self.comm == "dma":
            h = prob.halo
            recv = torch.zeros((h.nparts, h.nparts, max(h.maxcnt, 1)),
                               dtype=prob.vdtype, device=self.device)
        return make_dist_spmv(prob, self._la, self._ga, self._halo,
                              self._scnt, self.comm,
                              self.kernels != "xla", recv)

    def device_args(self, b_global, x0=None):
        """``(b, x0)`` scattered to stacked (nparts, nmax_owned) tensors
        in the vector dtype on the solver's device."""
        prob = self.problem
        dev, vdt = self.device, prob.vdtype
        b = _put(prob.scatter(np.asarray(b_global, np.float64)), dev, vdt)
        x0 = (torch.zeros_like(b) if x0 is None else
              _put(prob.scatter(np.asarray(x0, np.float64)), dev, vdt))
        return b, x0

    def _program(self, crit: StoppingCriteria):
        """``run(b, x0)``: one solve on the shared chunked loop of
        :mod:`acg_tpu_torch.solvers.cg`, over this solve's distributed
        SpMV (a fresh zeroed receive plane each run) and psum'd dots."""
        sdt = acc_dtype(self.problem.vdtype)
        ldot = make_ldot(sdt)
        pdot = make_pdot(psum, ldot, sdt, False)
        use_kernel = self.kernels != "xla"
        if self.pipelined:
            pdotk = make_pdotk(psum, ldot, sdt, False)
            return lambda b, x0: _cg._cg_pipelined_program(
                self._spmv(), pdot, pdotk, b, x0, crit, use_kernel)
        return lambda b, x0: _cg._cg_program(self._spmv(), pdot, b, x0,
                                             crit)

    def _host_x(self, x: np.ndarray) -> np.ndarray:
        return self.problem.gather(x)

    def _account_ops(self, st, niter: int) -> None:
        """Analytic flop/byte census of ``niter`` iterations, as the JAX
        tier bills the same configuration (``dist.py:2936``): one halo
        exchange per SpMV, classic = 2 allreduces per iteration, pipelined
        = 1 fused allreduce."""
        prob = self.problem
        n = prob.n
        st.nflops += (cg_flops_per_iteration(prob.nnz_total, n,
                                             self.pipelined) * niter
                      + 3.0 * prob.nnz_total + 2.0 * n)
        dbl = torch.empty((), dtype=prob.vdtype).element_size()
        mat_dbl = torch.empty((), dtype=prob.dtype).element_size()
        idx_b = 0 if prob.local.format == "dia" else 4
        # matrix-free local blocks read no planes: the matrix term is the
        # operator's O(grid-side) coefficient tables
        mat_read = (prob.operator.table_bytes() if prob.operator is not None
                    else prob.nnz_total * (mat_dbl + idx_b))
        ngemv = niter + 1
        st.ops["gemv"].add(ngemv, 0.0, (mat_read + 2 * n * dbl) * ngemv)
        st.ops["dot"].add(niter, 0.0, 2 * n * dbl * niter)
        st.ops["nrm2"].add(niter + 1, 0.0, n * dbl * (niter + 1))
        st.ops["axpy"].add(3 * niter, 0.0, 3 * n * dbl * 3 * niter)
        if not self.pipelined:
            st.ops["copy"].add(1, 0.0, 2 * n * dbl)
        nred = 1 if self.pipelined else 2
        st.ops["allreduce"].add(nred * niter, 0.0, 8 * nred * niter)
        halo_total = sum(int(s.halo.total_send) for s in prob.subs)
        st.ops["halo"].add(niter + 1, 0.0, halo_total * dbl * (niter + 1))
