"""Dense vectors with trailing ghost entries (host-side, numpy).

A copy of ``acg_tpu/vector.py`` (``acg/vector.c``): a dense vector whose
last ``num_ghost`` entries mirror remote data and are excluded from
reductions (``vector.h:152-160``), ghost-aware BLAS-1, and the sparse
gather (``usga``) that extracts partition-conforming subvectors.  The
host multi-part oracle (:class:`~acg_tpu_torch.solvers.host_cg.
HostDistCGSolver`) runs on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PVector:
    """A vector of ``size`` entries of which the trailing ``num_ghost`` are
    ghost copies of remote entries (excluded from dot products and norms)."""

    data: np.ndarray
    num_ghost: int = 0

    @classmethod
    def zeros(cls, n: int, num_ghost: int = 0, dtype=np.float64) -> "PVector":
        return cls(np.zeros(n + num_ghost, dtype=dtype), num_ghost)

    @property
    def size(self) -> int:
        return self.data.size

    @property
    def num_owned(self) -> int:
        return self.data.size - self.num_ghost

    @property
    def owned(self) -> np.ndarray:
        """View of the non-ghost entries (reductions operate on this)."""
        return self.data[: self.num_owned]

    # BLAS-1, ghost-aware (cf. vector.h:335-415).  Updates write through
    # the owned view with explicit ``out=`` (augmented assignment on the
    # ``owned`` property would try to rebind it).
    def dot(self, other: "PVector") -> float:
        return float(np.dot(self.owned, other.owned))

    def nrm2(self) -> float:
        return float(np.linalg.norm(self.owned))

    def axpy(self, alpha: float, x: "PVector") -> None:
        owned = self.owned
        np.add(owned, alpha * x.owned, out=owned)

    def aypx(self, alpha: float, x: "PVector") -> None:
        """y = alpha*y + x (the reference's ``daypx``)."""
        owned = self.owned
        np.multiply(owned, alpha, out=owned)
        np.add(owned, x.owned, out=owned)

    def scal(self, alpha: float) -> None:
        owned = self.owned
        np.multiply(owned, alpha, out=owned)

    def copy_from(self, x: "PVector") -> None:
        np.copyto(self.data, x.data)

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Sparse gather of entries at ``idx`` (the reference's ``usga``)."""
        return self.data[idx]

    def scatter_into(self, idx: np.ndarray, values: np.ndarray) -> None:
        """Sparse scatter (the reference's ``ussc``); used to unpack halos."""
        self.data[idx] = values
