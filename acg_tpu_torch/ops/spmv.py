"""Device sparse matrix formats and their SpMV in plain PyTorch.

The counterpart of ``acg_tpu/ops/spmv.py``.  Four formats, chosen from
the sparsity structure at load time by :func:`device_matrix_from_csr`
with the same rule as the JAX package:

* :class:`DiaMatrix` -- diagonal storage ``data[d, i] = A[i, i + off_d]``
  for banded/stencil matrices: SpMV is shifted-slice multiply-adds, no
  gathers.  On CUDA the solvers route it through the hand-written kernel
  :func:`acg_tpu_torch.ops.kernels.dia_spmv`.
* :class:`EllMatrix` -- row-padded (n, K) value/column planes.
* :class:`CooMatrix` -- row-sorted COO.
* :class:`BinnedEllMatrix` -- rows binned by length into near-tight ELL
  blocks, plus a COO tail for hub rows.

Every row of y is written once: the COO entries and the binned-ELL hub
tail are laid out at construction as padded rows (:func:`padded_rows`)
summed by ``.sum(-1)``, so no sum runs through float atomics and every
run on the card gives the same bits.  Matrix-free operators
(:mod:`acg_tpu_torch.ops.operator`) ride the same :func:`spmv` through
their ``matfree_apply``.

Everything here is plain torch: what the JAX package leaves to XLA the
port leaves to PyTorch's own operators (``kernels="xla"``).  Each class
holds tensors on one device; construction takes an explicit ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from acg_tpu_torch._device import resolve_device


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@dataclasses.dataclass
class EllMatrix:
    """ELLPACK storage: ``y[i] = sum_k data[i, k] * x[cols[i, k]]``.

    Padding entries have data == 0 and cols == 0 (a harmless gather).
    ``ncols_padded`` is the length of the x vector this matrix multiplies.
    """

    data: torch.Tensor  # (nrows, K) float
    cols: torch.Tensor  # (nrows, K) int32
    nrows: int
    ncols_padded: int

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device


@dataclasses.dataclass
class CooMatrix:
    """Row-sorted COO.  ``rows``/``cols``/``vals`` are the format's
    arrays (the JAX package's, bitwise); the SpMV runs on ``groups``,
    the same entries as padded rows (:func:`padded_rows`), built at
    construction."""

    rows: torch.Tensor  # (nnz,) int64, sorted ascending
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,) float
    nrows: int
    ncols_padded: int
    groups: tuple = None

    def __post_init__(self):
        if self.groups is None:
            self.groups = _padded_groups(self.rows, self.cols, self.vals)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device


@dataclasses.dataclass
class DiaMatrix:
    """Diagonal (DIA) storage: ``data[d, i] = A[i, i + offsets[d]]``.

    ``data`` is one contiguous (ndiags, nrows) tensor, so the CUDA kernel
    takes one pointer for all planes; ``offsets`` is a tuple of ints
    (ascending) and ``offsets_t`` the same offsets as an int64 tensor on
    the matrix's device, which the kernel reads.
    """

    data: torch.Tensor     # (ndiags, nrows) float
    offsets: tuple         # (ndiags,) ints, ascending
    nrows: int
    ncols_padded: int
    offsets_t: torch.Tensor = None  # (ndiags,) int64 on data.device

    def __post_init__(self):
        if self.offsets_t is None:
            self.offsets_t = torch.tensor(self.offsets, dtype=torch.int64,
                                          device=self.data.device)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device


@dataclasses.dataclass
class BinnedEllMatrix:
    """Length-binned ELL: rows grouped by nnz into near-tight width bins,
    each bin a dense (m_b, K_b) gather-multiply-reduce, plus a row-sorted
    COO tail for hub rows wider than the largest bin."""

    bin_rows: tuple   # per bin: (m_b,) int64 original row ids
    bin_data: tuple   # per bin: (m_b, K_b) values
    bin_cols: tuple   # per bin: (m_b, K_b) int32 (padding -> col 0, val 0)
    tail_rows: torch.Tensor  # (t,) int64 sorted; hub-row leftovers
    tail_cols: torch.Tensor  # (t,) int32
    tail_vals: torch.Tensor  # (t,)
    bin_ks: tuple     # K_b per bin
    nrows: int
    ncols_padded: int
    tail_groups: tuple = None  # the hub tail as padded rows (padded_rows)

    def __post_init__(self):
        if self.tail_groups is None:
            self.tail_groups = _padded_groups(self.tail_rows,
                                              self.tail_cols,
                                              self.tail_vals)

    @property
    def dtype(self):
        return self.bin_data[0].dtype if self.bin_data else self.tail_vals.dtype

    @property
    def device(self):
        return self.tail_vals.device


DeviceMatrix = Union[EllMatrix, CooMatrix, DiaMatrix, BinnedEllMatrix]

# geometric (x1.5) bin widths: padding bounded at ~1.33x, ~18 bins max
BELL_WIDTHS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
               256, 384, 512)

# DIA-eligibility thresholds of the auto format choice
MAX_DIAGS = 64
DIA_WASTE_LIMIT = 3.0


def padded_rows(rows, widths=BELL_WIDTHS) -> list:
    """Row-sorted COO row ids (numpy) -> the padded-row layout ``[(dst,
    idx), ...]``: every row appears once, as one row of ``idx`` (m, K)
    holding its entries' positions in index order, -1 padding after.
    Rows are binned by entry count into the first of ``widths`` (doubled
    past its last) that holds them, so padding stays under 2x.  Summing
    each padded row with ``.sum(-1)`` and writing it once takes the
    place of a scatter-add, whose float atomics on CUDA sum in an order
    that changes from run to run."""
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return []
    dst, start, cnt = np.unique(rows, return_index=True, return_counts=True)
    w = list(widths)
    while w[-1] < cnt.max():
        w.append(2 * w[-1])
    bidx = np.searchsorted(w, cnt)
    groups = []
    for b in np.unique(bidx):
        sel = np.flatnonzero(bidx == b)
        slot = np.arange(int(cnt[sel].max()))
        idx = start[sel, None] + slot
        idx[slot >= cnt[sel, None]] = -1
        groups.append((dst[sel], idx))
    return groups


def _padded_groups(rows, cols, vals) -> tuple:
    """The entries ``(rows, cols, vals)`` (tensors on one device) as
    :func:`padded_rows` groups of tensors ``(dst, data, cols)``: padding
    holds value 0 and column 0."""
    dev = vals.device
    out = []
    for dst, idx in padded_rows(rows.cpu().numpy()):
        i = torch.from_numpy(idx).to(dev)
        pad = i < 0
        i = i.clamp(min=0)
        out.append((torch.from_numpy(dst).to(dev),
                    vals[i].masked_fill(pad, 0),
                    cols[i].long().masked_fill(pad, 0)))
    return tuple(out)


def _padded_mv(groups, y, x, adt):
    """``y[dst] = (data * x[cols]).sum(-1)`` per group, in place: each
    row written once, with no scatter-add."""
    for dst, data, cols in groups:
        y.index_copy_(0, dst, (data.to(adt) * x[cols].to(adt)).sum(-1))
    return y


def binned_ell_arrays(csr, widths=BELL_WIDTHS):
    """Host-side CSR -> the numpy arrays of a :class:`BinnedEllMatrix`:
    ``(bin_rows, bin_data, bin_cols, tail_rows, tail_cols, tail_vals,
    bin_ks)``."""
    indptr = np.asarray(csr.indptr)
    row_nnz = np.diff(indptr)
    widths = np.asarray(widths)
    # bin index per row: first width >= nnz; hubs (> max width) -> tail
    bidx = np.searchsorted(widths, row_nnz)
    bin_rows, bin_data, bin_cols, bin_ks = [], [], [], []
    for b, K in enumerate(widths):
        rows = np.flatnonzero(bidx == b)
        if rows.size == 0:
            continue
        m = rows.size
        data = np.zeros((m, K), dtype=np.float64)
        cols = np.zeros((m, K), dtype=np.int32)
        nnz_b = row_nnz[rows]
        flat_r = np.repeat(np.arange(m), nnz_b)
        flat_p = (np.arange(nnz_b.sum())
                  - np.repeat(np.cumsum(nnz_b) - nnz_b, nnz_b))
        src = (np.repeat(indptr[rows], nnz_b) + flat_p).astype(np.int64)
        data[flat_r, flat_p] = np.asarray(csr.data)[src]
        cols[flat_r, flat_p] = np.asarray(csr.indices)[src]
        bin_rows.append(rows)
        bin_data.append(data)
        bin_cols.append(cols)
        bin_ks.append(int(K))
    hub = np.flatnonzero(bidx >= widths.size)
    t_rows = np.repeat(hub, row_nnz[hub])
    t_src = (np.concatenate([np.arange(indptr[r], indptr[r + 1]) for r in hub])
             if hub.size else np.zeros(0, np.int64))
    return (bin_rows, bin_data, bin_cols, t_rows,
            np.asarray(csr.indices)[t_src], np.asarray(csr.data)[t_src],
            bin_ks)


def csr_diag_offsets(csr) -> np.ndarray:
    """Distinct diagonal offsets (col - row) of a scipy sparse matrix,
    ascending."""
    coo = csr.tocoo()
    return np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))


def count_diagonals(csr) -> int:
    return int(csr_diag_offsets(csr).size)


def acc_dtype(dtype) -> torch.dtype:
    """Accumulation dtype for ``dtype`` storage: sub-f32 storage (bf16)
    accumulates in f32, wider dtypes natively (``acg_tpu.ops.spmv.
    acc_dtype``)."""
    return torch.promote_types(dtype, torch.float32)


def dia_mv_acc(planes, offsets, nrows: int, x: torch.Tensor) -> torch.Tensor:
    """``sum_d planes[d][i] * x[i + offsets[d]]`` summed in ``offsets``
    order in :func:`acc_dtype`, NOT rounded to ``x.dtype``: the shifted-
    slice multiply-adds of ``acg_tpu.ops.spmv.dia_mv``.  Out-of-range x
    positions read padded zeros; ``x`` may be shorter or longer than
    ``nrows``.  A stacked ``x`` of shape (P, n) with planes (ndiags, P,
    nrows) multiplies each part on its own: the shifts run along the last
    axis, so every part has its own edges (``dia_mv`` per shard)."""
    L = max(0, -min(offsets))
    R = max(0, max(offsets) + nrows - x.shape[-1])
    adt = acc_dtype(x.dtype)
    xp = torch.nn.functional.pad(x, (L, R))
    y = torch.zeros(x.shape[:-1] + (nrows,), dtype=adt, device=x.device)
    for d, off in enumerate(offsets):
        y = y + (planes[d].to(adt) * xp[..., L + off:L + off + nrows].to(adt))
    return y


def dia_mv(planes, offsets, nrows: int, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for DIA planes, ``y[i] = sum_d planes[d][i] * x[i +
    offsets[d]]``, rounded once to ``x.dtype`` (:func:`dia_mv_acc`)."""
    return dia_mv_acc(planes, offsets, nrows, x).to(x.dtype)


def dia_from_csr(csr, dtype=torch.float64, device=None) -> DiaMatrix:
    """Convert a scipy CSR matrix to DIA planes."""
    nrows, ncols = csr.shape
    coo = csr.tocoo()
    diag = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(diag)
    data = np.zeros((offsets.size, nrows), dtype=np.float64)
    data[np.searchsorted(offsets, diag), coo.row] = coo.data
    return device_matrix_from_arrays(
        "dia", data, {"offsets": tuple(int(o) for o in offsets),
                      "nrows": nrows, "ncols_padded": ncols},
        dtype=dtype, device=device)


def dia_planes_fixed(csr, offsets, nrows_pad: int) -> np.ndarray:
    """Host-side CSR -> (ndiags, nrows_pad) float64 DIA planes for a
    *given* offset set (mesh-uniform stacking: every part stores the
    union of all parts' offsets, missing diagonals as zero planes)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    coo = csr.tocoo()
    diag = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    dmap = np.searchsorted(offsets, diag)
    if diag.size and ((dmap >= offsets.size)
                      | (offsets[dmap % offsets.size] != diag)).any():
        raise ValueError("matrix has diagonals outside the given offset set")
    data = np.zeros((offsets.size, nrows_pad), dtype=np.float64)
    data[dmap, coo.row] = coo.data
    return data


def prefers_dia(csr, max_diags: int = MAX_DIAGS,
                waste_limit: float = DIA_WASTE_LIMIT) -> bool:
    """True when the matrix is banded enough for gather-free DIA storage
    (and hence a contiguous band partition) -- the CLI's
    ``--partition-method auto`` rule."""
    if not csr.nnz:
        return False
    ndiags = count_diagonals(csr)
    return (ndiags <= max_diags
            and ndiags * csr.shape[0] / csr.nnz <= waste_limit)


def ell_planes_from_csr(rowptr, colidx, vals, nrows_pad: int,
                        pad_k: int | None = None):
    """Host-side CSR -> zero-padded ELL planes (numpy), rows padded to
    ``nrows_pad`` and width to at least ``pad_k`` (mesh-uniform
    stacking)."""
    rowptr = np.asarray(rowptr)
    colidx = np.asarray(colidx)
    vals = np.asarray(vals)
    nrows = len(rowptr) - 1
    row_nnz = np.diff(rowptr)
    K = int(row_nnz.max()) if row_nnz.size else 0
    if pad_k is not None:
        K = max(K, pad_k)
    K = max(K, 1)
    data = np.zeros((nrows_pad, K), dtype=np.float64)
    cols = np.zeros((nrows_pad, K), dtype=np.int32)
    rows = np.repeat(np.arange(nrows), row_nnz)
    pos = np.arange(len(colidx)) - np.repeat(rowptr[:-1], row_nnz)
    data[rows, pos] = vals
    cols[rows, pos] = colidx
    return data, cols


def device_matrix_from_arrays(fmt: str, arrays, meta: dict, *, dtype,
                              device=None) -> DeviceMatrix:
    """Build the port's device matrix from the numpy arrays of a device
    matrix of the JAX package (or of this module's host builders), so
    both packages multiply the same values:

    * ``"dia"``: ``arrays`` = the planes (a sequence of (n,) arrays or one
      (ndiags, n) array); ``meta`` = offsets, nrows, ncols_padded.
    * ``"ell"``: ``arrays`` = (data, cols); ``meta`` = nrows, ncols_padded.
    * ``"coo"``: ``arrays`` = (rows, cols, vals); ``meta`` likewise.
    * ``"bell"``: ``arrays`` = (bin_rows, bin_data, bin_cols, tail_rows,
      tail_cols, tail_vals) with the first three tuples over bins;
      ``meta`` = bin_ks, nrows, ncols_padded.

    ``dtype`` is the value dtype; indices keep integer types.
    """
    device = resolve_device(device)
    nrows, ncols = int(meta["nrows"]), int(meta["ncols_padded"])
    if fmt == "dia":
        planes = np.stack([np.asarray(p, dtype=np.float64) for p in arrays])
        return DiaMatrix(data=_tensor(planes, dtype, device).contiguous(),
                         offsets=tuple(int(o) for o in meta["offsets"]),
                         nrows=nrows, ncols_padded=ncols)
    if fmt == "ell":
        data, cols = arrays
        return EllMatrix(data=_tensor(data, dtype, device),
                         cols=_tensor(cols, torch.int32, device),
                         nrows=nrows, ncols_padded=ncols)
    if fmt == "coo":
        rows, cols, vals = arrays
        return CooMatrix(rows=_tensor(rows, torch.int64, device),
                         cols=_tensor(cols, torch.int32, device),
                         vals=_tensor(vals, dtype, device),
                         nrows=nrows, ncols_padded=ncols)
    if fmt == "bell":
        brows, bdata, bcols, trows, tcols, tvals = arrays
        return BinnedEllMatrix(
            bin_rows=tuple(_tensor(r, torch.int64, device) for r in brows),
            bin_data=tuple(_tensor(d, dtype, device) for d in bdata),
            bin_cols=tuple(_tensor(c, torch.int32, device) for c in bcols),
            tail_rows=_tensor(trows, torch.int64, device),
            tail_cols=_tensor(tcols, torch.int32, device),
            tail_vals=_tensor(tvals, dtype, device),
            bin_ks=tuple(int(k) for k in meta["bin_ks"]),
            nrows=nrows, ncols_padded=ncols)
    raise ValueError(f"unknown device matrix format {fmt!r}")


def device_matrix_from_csr(csr, dtype=torch.float64, format: str = "auto",
                           device=None, ell_waste_limit: float = 3.0,
                           dia_waste_limit: float = DIA_WASTE_LIMIT,
                           max_diags: int = MAX_DIAGS) -> DeviceMatrix:
    """Pick DIA, ELL, binned ELL or COO from the sparsity structure of a
    scipy CSR, with the JAX package's rule: DIA when the matrix is banded
    (few distinct diagonals, bounded fill waste); otherwise ELL when its
    padding waste (K_max * n / nnz) stays below ``ell_waste_limit``, else
    binned ELL."""
    nrows, ncols = csr.shape
    row_nnz = np.diff(csr.indptr)
    K = int(row_nnz.max()) if nrows else 0
    nnz = csr.nnz
    if format == "auto":
        ndiags = count_diagonals(csr)
        if (ndiags <= max_diags and nnz
                and ndiags * nrows / nnz <= dia_waste_limit):
            format = "dia"
        else:
            waste = (K * nrows / nnz) if nnz else 1.0
            format = "ell" if waste <= ell_waste_limit else "bell"
    meta = {"nrows": nrows, "ncols_padded": ncols}
    if format == "dia":
        return dia_from_csr(csr, dtype, device)
    if format == "ell":
        return device_matrix_from_arrays(
            "ell", ell_planes_from_csr(csr.indptr, csr.indices, csr.data,
                                       nrows), meta, dtype=dtype,
            device=device)
    if format == "bell":
        *arrays, bin_ks = binned_ell_arrays(csr)
        return device_matrix_from_arrays("bell", arrays,
                                         dict(meta, bin_ks=bin_ks),
                                         dtype=dtype, device=device)
    if format == "coo":
        rows = np.repeat(np.arange(nrows, dtype=np.int64), row_nnz)
        return device_matrix_from_arrays(
            "coo", (rows, csr.indices, csr.data), meta, dtype=dtype,
            device=device)
    raise ValueError(f"unknown device matrix format {format!r}")


def matrix_dtype(A: DeviceMatrix):
    """Value-storage dtype of any device matrix format."""
    return A.dtype


def matrix_index_bytes(A: DeviceMatrix) -> float:
    """Index bytes read per stored nonzero during SpMV, as the JAX
    package counts them (DIA: none; ELL-family: one int32 column; COO:
    row + column; binned ELL: the nnz-weighted mix of its 4 B bins and
    8 B hub tail; matrix-free operators: none, no nonzero is stored)."""
    if _is_matfree(A) or isinstance(A, DiaMatrix):
        return 0.0
    if isinstance(A, CooMatrix):
        return 8.0
    if isinstance(A, BinnedEllMatrix):
        bins = sum(int(d.numel()) for d in A.bin_data)
        tail = int(A.tail_vals.numel())
        total = bins + tail
        return (4.0 * bins + 8.0 * tail) / total if total else 4.0
    return 4.0


def _is_matfree(A) -> bool:
    """A matrix-free operator (``ops.operator``): it has an apply."""
    return hasattr(A, "matfree_apply")


def spmv(A: DeviceMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a device sparse matrix or a matrix-free operator, in
    plain torch."""
    if _is_matfree(A):
        return A.matfree_apply(x)
    adt = acc_dtype(x.dtype)
    if isinstance(A, DiaMatrix):
        return dia_mv(A.data, A.offsets, A.nrows, x)
    if isinstance(A, EllMatrix):
        return (A.data.to(adt) * x[A.cols].to(adt)).sum(1).to(x.dtype)
    y = torch.zeros(A.nrows, dtype=adt, device=x.device)
    if isinstance(A, CooMatrix):
        return _padded_mv(A.groups, y, x, adt).to(x.dtype)
    if isinstance(A, BinnedEllMatrix):
        # each row lives in exactly one bin or in the hub tail
        _padded_mv(zip(A.bin_rows, A.bin_data, A.bin_cols), y, x, adt)
        return _padded_mv(A.tail_groups, y, x, adt).to(x.dtype)
    raise TypeError(f"unsupported device matrix {type(A)}")


def spmv_flops(A: DeviceMatrix) -> float:
    """Analytic flops per SpMV, reference convention (3 per stored nz);
    nonzeros are counted on the device, so one scalar crosses to the
    host (matrix-free operators count analytically)."""
    if _is_matfree(A):
        return 3.0 * float(A.matfree_nnz())
    if isinstance(A, DiaMatrix):
        nnz = int(torch.count_nonzero(A.data))
    elif isinstance(A, EllMatrix):
        nnz = int(torch.count_nonzero(A.data))
    elif isinstance(A, BinnedEllMatrix):
        nnz = (sum(int(torch.count_nonzero(d)) for d in A.bin_data)
               + A.tail_vals.numel())
    else:
        nnz = A.vals.numel()
    return 3.0 * float(nnz)
