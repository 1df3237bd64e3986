"""Symmetric sparse matrices in CSR form (host-side, numpy).

A copy of ``acg_tpu/matrix.py`` without the native C++ expander: the
canonical storage is the packed upper triangle in CSR form (diagonal
plus strictly-upper entries, ``acg/symcsrmatrix.c``); full-storage CSR is
built on demand with scipy, optionally with a diagonal shift (the
``--epsilon`` option, ``symcsrmatrix.c:760-862``).
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

    Invariants (``symcsrmatrix.h:62-292``):
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
        if rowidx.size and (min(rowidx.min(), colidx.min()) < 0
                            or max(rowidx.max(), colidx.max()) >= nrows):
            raise AcgError(ErrorCode.INDEX_OUT_OF_BOUNDS,
                           "COO indices out of range")
        r = np.minimum(rowidx, colidx)
        c = np.maximum(rowidx, colidx)
        upper = sp.coo_matrix((vals, (r, c)), shape=(nrows, nrows)).tocsr()
        upper.sum_duplicates()
        offdiag_in = rowidx != colidx
        # full storage iff both strictly-lower and strictly-upper entries
        # are present: the off-diagonal sums then counted each entry twice
        has_lower = bool(np.any(rowidx[offdiag_in] > colidx[offdiag_in]))
        has_upper = bool(np.any(rowidx[offdiag_in] < colidx[offdiag_in]))
        if has_lower and has_upper:
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

    def to_csr(self, epsilon: float = 0.0) -> sp.csr_matrix:
        """Full-storage CSR with optional diagonal shift A + eps*I
        (``acgsymcsrmatrix_dsymv_init``, ``symcsrmatrix.c:760``)."""
        upper = sp.csr_matrix((self.pa, self.pcolidx, self.prowptr),
                              shape=(self.nrows, self.nrows))
        strict = sp.triu(upper, k=1)
        full = (upper + strict.T).tocsr()
        if epsilon:
            full = (full + epsilon * sp.eye(self.nrows, format="csr")).tocsr()
        full.sort_indices()
        return full

    def dsymv(self, x: np.ndarray, epsilon: float = 0.0) -> np.ndarray:
        """y = (A + eps I) x on host (the role of ``acgsymcsrmatrix_dsymv``)."""
        return self.to_csr(epsilon) @ x
