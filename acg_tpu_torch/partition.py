"""Row partitioners: METIS when available, built-in bisection otherwise.

A copy of ``acg_tpu/partition.py`` (host numpy, no device code): a
balanced, edge-cut-minimising partition vector over the matrix sparsity
graph (``acggraph_partition_nodes``, ``graph.c:510-529``).  METIS is
optional: ``libmetis`` is loaded through :mod:`ctypes` only when
``ctypes.util.find_library`` finds it; otherwise the built-in
partitioner runs -- recursive graph-growing bisection from
pseudo-peripheral seeds with greedy boundary refinement.  With the same
seed both packages return the same part vector.

Part p is stacked at index p of the solver's ``(nparts, ...)`` tensors.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import scipy.sparse as sp

from acg_tpu_torch.errors import AcgError, ErrorCode
from acg_tpu_torch.io.mtxfile import IDX_DTYPE

# ---------------------------------------------------------------------------
# METIS via ctypes (optional, like the reference's CMake-gated METIS)
# ---------------------------------------------------------------------------

_METIS = None
_METIS_CHECKED = False


def _load_metis():
    global _METIS, _METIS_CHECKED
    if _METIS_CHECKED:
        return _METIS
    _METIS_CHECKED = True
    path = ctypes.util.find_library("metis")
    if path:
        try:
            _METIS = ctypes.CDLL(path)
        except OSError:
            _METIS = None
    return _METIS


def metis_available() -> bool:
    return _load_metis() is not None


def _metis_kway(lib, np_idx, rowptr, colidx, nparts: int,
                seed: int) -> np.ndarray:
    """Raw METIS_PartGraphKway call at a given index width (np_idx
    dtype)."""
    idx_t = ctypes.c_int32 if np_idx == np.int32 else ctypes.c_int64
    n = len(rowptr) - 1
    xadj = np.ascontiguousarray(rowptr, dtype=np_idx)
    adjncy = np.ascontiguousarray(colidx, dtype=np_idx)
    part = np.zeros(n, dtype=np_idx)
    ncon = idx_t(1)
    objval = idx_t(0)
    options = np.zeros(40, dtype=np_idx)
    lib.METIS_SetDefaultOptions(options.ctypes.data_as(ctypes.POINTER(idx_t)))
    options[8] = seed  # METIS_OPTION_SEED
    nv = idx_t(n)
    npp = idx_t(nparts)
    ret = lib.METIS_PartGraphKway(
        ctypes.byref(nv), ctypes.byref(ncon),
        xadj.ctypes.data_as(ctypes.POINTER(idx_t)),
        adjncy.ctypes.data_as(ctypes.POINTER(idx_t)),
        None, None, None, ctypes.byref(npp), None, None,
        options.ctypes.data_as(ctypes.POINTER(idx_t)),
        ctypes.byref(objval),
        part.ctypes.data_as(ctypes.POINTER(idx_t)))
    if ret != 1:  # METIS_OK
        raise AcgError(ErrorCode.METIS,
                       f"METIS_PartGraphKway returned {ret}")
    return part


_METIS_IDX = None


def _metis_idx_width(lib):
    """libmetis's IDXTYPEWIDTH, probed at run time: partition a tiny path
    graph at each width and keep the one whose result is a valid cover."""
    global _METIS_IDX
    if _METIS_IDX is not None:
        return _METIS_IDX
    rowptr = np.array([0, 1, 3, 5, 6])
    colidx = np.array([1, 0, 2, 1, 3, 2])
    for np_idx in (np.int32, np.int64):
        try:
            part = _metis_kway(lib, np_idx, rowptr, colidx, 2, 0)
        except (AcgError, OSError):
            continue
        if part.min() >= 0 and part.max() == 1 and np.unique(part).size == 2:
            _METIS_IDX = np_idx
            return np_idx
    raise AcgError(ErrorCode.METIS, "could not determine libmetis index width")


def metis_partgraphsym(rowptr, colidx, nparts: int,
                       seed: int = 0) -> np.ndarray:
    """``METIS_PartGraphKway`` on a symmetric adjacency (no self-loops);
    raises when libmetis is not present."""
    lib = _load_metis()
    if lib is None:
        raise AcgError(ErrorCode.METIS, "libmetis not found")
    np_idx = _metis_idx_width(lib)
    if np_idx == np.int32 and (len(colidx) > np.iinfo(np.int32).max
                               or len(rowptr) - 1 > np.iinfo(np.int32).max):
        raise AcgError(ErrorCode.METIS,
                       "graph too large for 32-bit libmetis indices")
    part = _metis_kway(lib, np_idx, rowptr, colidx, nparts, seed)
    if part.min() < 0 or part.max() >= nparts:
        raise AcgError(ErrorCode.METIS, "METIS returned an invalid partition")
    return part.astype(np.int32)


# ---------------------------------------------------------------------------
# Built-in partitioner
# ---------------------------------------------------------------------------

def _frontier_neighbors(graph: sp.csr_matrix,
                        frontier: np.ndarray) -> np.ndarray:
    """All column indices of the given rows, vectorised."""
    indptr, indices = graph.indptr, graph.indices
    starts, ends = indptr[frontier], indptr[frontier + 1]
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    offsets = np.repeat(starts, lens)
    within = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return indices[offsets + within]


def _bfs_order(graph: sp.csr_matrix, seed_node: int,
               mask: np.ndarray) -> np.ndarray:
    """BFS traversal order of the masked subgraph from seed_node."""
    visited = ~mask  # treat out-of-subset as visited
    order = np.empty(int(mask.sum()), dtype=IDX_DTYPE)
    count = 0
    frontier = np.array([seed_node], dtype=IDX_DTYPE)
    visited[seed_node] = True
    while frontier.size:
        order[count:count + frontier.size] = frontier
        count += frontier.size
        nbr = np.unique(_frontier_neighbors(graph, frontier))
        nbr = nbr[~visited[nbr]]
        visited[nbr] = True
        frontier = nbr.astype(IDX_DTYPE)
    return order[:count]


def _pseudo_peripheral(graph: sp.csr_matrix, mask: np.ndarray, rng) -> int:
    """A node of (near-)maximal eccentricity in the masked subgraph."""
    nodes = np.flatnonzero(mask)
    u = int(nodes[rng.integers(nodes.size)])
    for _ in range(3):
        order = _bfs_order(graph, u, mask.copy())
        far = int(order[-1])
        if far == u:
            break
        u = far
    return u


def _refine_bisection(adj: sp.csr_matrix, side: np.ndarray, mask: np.ndarray,
                      target0: int, passes: int = 4) -> None:
    """Greedy boundary refinement: per pass, one sparse matvec counts each
    node's same-side neighbours; nodes with positive gain migrate,
    best-gain first, within a 1% balance slack."""
    nodes = np.flatnonzero(mask)
    size0 = int(np.sum(side[nodes] == 0))
    slack = max(1, nodes.size // 100)
    in_mask = mask.astype(np.float64)
    deg = adj @ in_mask  # within-subset degree
    for _ in range(passes):
        nbr1 = adj @ (in_mask * (side == 1))
        # gain of flipping = external - internal neighbour count
        gain = np.where(side == 0, 2 * nbr1 - deg, deg - 2 * nbr1)
        gain[~mask] = -np.inf
        cand = np.flatnonzero(gain > 0)
        if cand.size == 0:
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        c0 = cand[side[cand] == 0][: max(0, size0 - (target0 - slack))]
        c1 = cand[side[cand] == 1][: max(0, (target0 + slack) - size0)]
        # flip the smaller of the two flows fully, counter-balance the other
        k = min(c0.size, c1.size) or max(c0.size, c1.size)
        c0, c1 = c0[:k], c1[:k]
        if c0.size == 0 and c1.size == 0:
            break
        side[c0] = 1
        side[c1] = 0
        size0 += c1.size - c0.size


def partition_rows_band(full_csr: sp.csr_matrix, nparts: int) -> np.ndarray:
    """Contiguous row-range partition with ~equal nonzeros per part.

    For banded matrices each part's diagonal block stays a contiguous
    sub-band, so the local SpMV keeps the gather-free DIA form (kernel
    K1 on the card)."""
    n = full_csr.shape[0]
    if nparts <= 0:
        raise AcgError(ErrorCode.INVALID_VALUE, "nparts must be positive")
    if nparts > n:
        raise AcgError(ErrorCode.INVALID_PARTITION, "more parts than rows")
    indptr = np.asarray(full_csr.indptr, dtype=np.int64)
    total = int(indptr[-1])
    # row index where each part should start, by cumulative-nnz quantile
    cuts = np.searchsorted(indptr, total * np.arange(1, nparts) / nparts)
    # every part owns at least one row: lower-bound each cut, make the
    # sequence strictly increasing, then upper-bound so trailing parts
    # stay nonempty
    cuts = np.maximum(cuts, np.arange(1, nparts))
    steps = np.arange(nparts - 1)
    cuts = np.maximum.accumulate(cuts - steps) + steps
    cuts = np.minimum(cuts, n - nparts + np.arange(1, nparts))
    part = np.zeros(n, dtype=np.int32)
    part[cuts] = 1
    return np.cumsum(part).astype(np.int32)


def _pattern_graph(graph: sp.csr_matrix) -> sp.csr_matrix:
    """0/1 adjacency with the diagonal removed (refinement and BFS must
    not see matrix values, and METIS forbids self-loops)."""
    coo = graph.tocoo()
    off = coo.row != coo.col
    return sp.coo_matrix((np.ones(int(off.sum())),
                          (coo.row[off], coo.col[off])),
                         shape=graph.shape).tocsr()


def _bisect(graph: sp.csr_matrix, mask: np.ndarray, target0: int,
            rng) -> np.ndarray:
    """One graph-growing bisection of the masked subgraph: the side array
    (0/1 per node; only masked entries meaningful)."""
    n = graph.shape[0]
    nnodes = int(mask.sum())
    seed_node = _pseudo_peripheral(graph, mask, rng)
    order = _bfs_order(graph, seed_node, mask.copy())
    side = np.zeros(n, dtype=np.int8)
    side[order[target0:]] = 1
    # disconnected leftovers go to the smaller side
    leftover = mask.copy()
    leftover[order] = False
    if leftover.any():
        side[leftover] = 1 if target0 > nnodes - target0 else 0
    _refine_bisection(graph, side, mask, target0)
    return side


def partition_rows(full_csr: sp.csr_matrix, nparts: int, seed: int = 0,
                   use_metis: str = "auto",
                   method: str = "graph") -> np.ndarray:
    """Partition matrix rows into ``nparts`` balanced, low-cut parts.

    ``use_metis``: "auto" uses libmetis when it is found, "never" forces
    the built-in partitioner, "require" errors without libmetis.
    ``method``: "graph" (edge-cut minimisation: METIS kway, or the
    built-in recursive bisection) or "band"
    (:func:`partition_rows_band`)."""
    n = full_csr.shape[0]
    if nparts <= 0:
        raise AcgError(ErrorCode.INVALID_VALUE, "nparts must be positive")
    if nparts == 1:
        return np.zeros(n, dtype=np.int32)
    if nparts > n:
        raise AcgError(ErrorCode.INVALID_PARTITION, "more parts than rows")
    if method == "band":
        return partition_rows_band(full_csr, nparts)
    if method != "graph":
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"unknown partition method {method!r}")

    if use_metis in ("auto", "require") and metis_available():
        adj = _pattern_graph(full_csr)
        return metis_partgraphsym(adj.indptr.astype(np.int64),
                                  adj.indices.astype(np.int64), nparts, seed)
    if use_metis == "require":
        raise AcgError(ErrorCode.METIS, "libmetis required but not found")

    graph = _pattern_graph(full_csr)
    rng = np.random.default_rng(seed)
    part = np.zeros(n, dtype=np.int32)
    # recursive bisection: split [lo, hi) part-id range
    stack = [(np.ones(n, dtype=bool), 0, nparts)]
    while stack:
        mask, lo, hi = stack.pop()
        if hi - lo == 1:
            part[mask] = lo
            continue
        nleft_parts = (hi - lo) // 2
        nnodes = int(mask.sum())
        target0 = int(round(nnodes * nleft_parts / (hi - lo)))
        side = _bisect(graph, mask, target0, rng)
        m0 = mask & (side == 0)
        m1 = mask & (side == 1)
        if not m0.any() or not m1.any():
            # degenerate split: even index split instead
            nodes = np.flatnonzero(mask)
            m0 = np.zeros(n, dtype=bool)
            m0[nodes[:target0]] = True
            m1 = mask & ~m0
        stack.append((m0, lo, lo + nleft_parts))
        stack.append((m1, lo + nleft_parts, hi))
    return part


def edgecut(full_csr: sp.csr_matrix, part: np.ndarray) -> int:
    """Number of cut edges (each undirected edge counted once)."""
    coo = full_csr.tocoo()
    off = coo.row < coo.col
    return int(np.sum(part[coo.row[off]] != part[coo.col[off]]))
