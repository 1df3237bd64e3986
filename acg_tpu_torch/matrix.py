"""Symmetric sparse matrix in packed-upper CSR storage (host numpy).

A copy of ``acg_tpu/matrix.py`` (``acg/symcsrmatrix.c``): the canonical
storage is the packed upper triangle in CSR form (diagonal plus
strictly-upper entries); full-storage CSR is built on demand, optionally
with a diagonal shift (the ``--epsilon`` option,
``symcsrmatrix.c:760-862``).  Assembly from COO and the expansion to
full storage take the native C++ host core
(:mod:`acg_tpu_torch._native`) when its library is built, scipy
otherwise; both give the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from acg_tpu_torch.errors import AcgError, ErrorCode
from acg_tpu_torch.io.mtxfile import IDX_DTYPE, MtxFile


@dataclasses.dataclass
class SymCsrMatrix:
    """A symmetric sparse matrix stored as packed upper-triangle CSR.

    Invariants (matching ``symcsrmatrix.h:62-292``):
      * ``prowptr``/``pcolidx``/``pa`` hold each symmetric entry once with
        ``col >= row`` (diagonal included), rows sorted, no duplicates.
      * ``nrows == ncols`` (SPD systems only).
    """

    nrows: int
    prowptr: np.ndarray  # (nrows+1,) int64
    pcolidx: np.ndarray  # (pnnz,)   int64, col >= row
    pa: np.ndarray       # (pnnz,)   float64

    @property
    def pnnz(self) -> int:
        return int(self.pcolidx.size)

    @property
    def nnz_full(self) -> int:
        """Number of nonzeros in the logically-full symmetric matrix."""
        ndiag = int(np.sum(self.pcolidx == np.repeat(
            np.arange(self.nrows), np.diff(self.prowptr))))
        return 2 * self.pnnz - ndiag

    # -- construction ---------------------------------------------------

    @classmethod
    def from_coo(cls, nrows: int, rowidx, colidx, vals) -> "SymCsrMatrix":
        """Build from COO triplets of a symmetric matrix.

        Accepts either full storage (both triangles present) or one-triangle
        storage (upper or lower); duplicates are summed except when the same
        off-diagonal entry appears in both triangles, in which case the two
        mirror entries must agree and one is kept.
        """
        rowidx = np.asarray(rowidx, dtype=IDX_DTYPE)
        colidx = np.asarray(colidx, dtype=IDX_DTYPE)
        vals = np.asarray(vals, dtype=np.float64)
        from acg_tpu_torch import _native
        if _native.available() and rowidx.size:
            try:
                pr, pc, pa = _native.sym_csr_from_coo(nrows, rowidx, colidx,
                                                      vals)
                return cls(nrows=nrows, prowptr=pr, pcolidx=pc, pa=pa)
            except _native.NativeParseError as e:
                if e.code == -3:
                    raise AcgError(ErrorCode.INDEX_OUT_OF_BOUNDS,
                                   "COO indices out of range")
                # key overflow for huge nrows: numpy path below
        # map everything to the upper triangle
        r = np.minimum(rowidx, colidx)
        c = np.maximum(rowidx, colidx)
        # dedupe via sparse assembly; mirrored duplicates would double
        # off-diagonal values, so detect full storage and halve those.
        upper = sp.coo_matrix((vals, (r, c)), shape=(nrows, nrows)).tocsr()
        upper.sum_duplicates()
        offdiag_in = rowidx != colidx
        # full storage iff any strictly-lower entry present
        has_lower = bool(np.any(rowidx[offdiag_in] > colidx[offdiag_in]))
        has_upper = bool(np.any(rowidx[offdiag_in] < colidx[offdiag_in]))
        if has_lower and has_upper:
            # both triangles were present: off-diagonal sums counted twice
            coo = upper.tocoo()
            off = coo.row != coo.col
            coo.data[off] *= 0.5
            upper = coo.tocsr()
        return cls(nrows=nrows, prowptr=upper.indptr.astype(IDX_DTYPE),
                   pcolidx=upper.indices.astype(IDX_DTYPE), pa=upper.data)

    @classmethod
    def from_mtx(cls, mtx: MtxFile) -> "SymCsrMatrix":
        if mtx.object != "matrix" or mtx.format != "coordinate":
            raise AcgError(ErrorCode.NOT_SUPPORTED, "need a coordinate matrix")
        if mtx.nrows != mtx.ncols:
            raise AcgError(ErrorCode.INVALID_VALUE, "matrix must be square")
        if mtx.symmetry not in ("symmetric", "general"):
            raise AcgError(ErrorCode.NOT_SUPPORTED, f"symmetry {mtx.symmetry}")
        r, c, v = mtx.to_coo()
        return cls.from_coo(mtx.nrows, r, c, v)

    # -- full storage ----------------------------------------------------

    def to_csr(self, epsilon: float = 0.0) -> sp.csr_matrix:
        """Full-storage CSR with optional diagonal shift A + eps*I.

        Equivalent of ``acgsymcsrmatrix_dsymv_init`` (``symcsrmatrix.c:760``).
        """
        from acg_tpu_torch import _native
        if _native.available() and self.pnnz:
            fr, fc, fa = _native.sym_csr_expand(self.nrows, self.prowptr,
                                                self.pcolidx, self.pa,
                                                epsilon)
            idt = (np.int32 if self.nrows < 2**31 and fr[-1] < 2**31
                   else np.int64)
            return sp.csr_matrix((fa, fc.astype(idt, copy=False),
                                  fr.astype(idt, copy=False)),
                                 shape=(self.nrows, self.nrows))
        upper = sp.csr_matrix((self.pa, self.pcolidx, self.prowptr),
                              shape=(self.nrows, self.nrows))
        strict = sp.triu(upper, k=1)
        full = (upper + strict.T).tocsr()
        if epsilon:
            full = (full + epsilon * sp.eye(self.nrows, format="csr")).tocsr()
        full.sort_indices()
        return full

    def to_full_coo(self, epsilon: float = 0.0):
        """Full-storage COO triplets (rowidx, colidx, vals), row-major sorted."""
        full = self.to_csr(epsilon).tocoo()
        return (full.row.astype(IDX_DTYPE), full.col.astype(IDX_DTYPE),
                full.data)

    def dsymv(self, x: np.ndarray, epsilon: float = 0.0) -> np.ndarray:
        """y = (A + eps I) x on host (the role of ``acgsymcsrmatrix_dsymv``)."""
        return self.to_csr(epsilon) @ x

    def row_nnz_full(self) -> np.ndarray:
        """Per-row nonzero counts of the full symmetric matrix."""
        return np.diff(self.to_csr().indptr)

    def to_mtx(self) -> MtxFile:
        """Packed upper triangle as a symmetric MtxFile (lower on disk)."""
        # Matrix Market symmetric files conventionally store the lower
        # triangle; transpose our upper storage when writing.
        rows = np.repeat(np.arange(self.nrows, dtype=IDX_DTYPE),
                         np.diff(self.prowptr))
        return MtxFile(object="matrix", format="coordinate", field="real",
                       symmetry="symmetric", nrows=self.nrows,
                       ncols=self.nrows, nnz=self.pnnz,
                       rowidx=self.pcolidx.copy(), colidx=rows,
                       vals=self.pa.copy())
