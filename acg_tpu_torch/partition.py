"""Row partitioners: METIS when available, built-in bisection otherwise.

A copy of ``acg_tpu/partition.py`` (host numpy, no device code): a
balanced, edge-cut-minimising partition vector over the matrix sparsity
graph (``acggraph_partition_nodes``, ``graph.c:510-529``), and a
fill-reducing nested-dissection ordering (:func:`nested_dissection`,
the ``metis_nd`` role).  METIS is optional: ``libmetis`` is loaded
through :mod:`ctypes` only when ``ctypes.util.find_library`` finds it;
otherwise the built-in partitioner runs -- recursive graph-growing
bisection from pseudo-peripheral seeds with greedy boundary refinement.
With the same seed both packages return the same part vector and the
same permutation.

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


def is_permutation(perm, n: int) -> bool:
    """True when ``perm`` is exactly a permutation of ``[0, n)`` --
    the integrity test for stored row-permutation sidecars (the
    checkpoint tier's repartition resume and the mtx2bin perm files):
    scattering vector rows through anything else silently scrambles
    them."""
    perm = np.asarray(perm).reshape(-1)
    if perm.size != n or n == 0:
        return perm.size == n
    if not np.issubdtype(perm.dtype, np.integer):
        return False
    if perm.min() < 0 or perm.max() >= n:
        return False
    return bool((np.bincount(perm, minlength=n) == 1).all())


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


def _metis_kway(lib, np_idx, rowptr, colidx, nparts: int, seed: int,
                variant: str = "kway") -> np.ndarray:
    """Raw METIS_PartGraph{Kway,Recursive} call at a given index width
    (np_idx dtype).  The two entry points share one C signature
    (``metis.h:39-43``)."""
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
    fn = (lib.METIS_PartGraphRecursive if variant == "recursive"
          else lib.METIS_PartGraphKway)
    ret = fn(
        ctypes.byref(nv), ctypes.byref(ncon),
        xadj.ctypes.data_as(ctypes.POINTER(idx_t)),
        adjncy.ctypes.data_as(ctypes.POINTER(idx_t)),
        None, None, None, ctypes.byref(npp), None, None,
        options.ctypes.data_as(ctypes.POINTER(idx_t)),
        ctypes.byref(objval),
        part.ctypes.data_as(ctypes.POINTER(idx_t)))
    if ret != 1:  # METIS_OK
        raise AcgError(ErrorCode.METIS,
                       f"METIS_PartGraph{variant.capitalize()} returned {ret}")
    return part


_METIS_IDX = None


def _metis_idx_width(lib):
    """Probe libmetis's IDXTYPEWIDTH at runtime (the role of the reference's
    build-time width validation, ``cuda/CMakeLists.txt:143-150``): partition
    a tiny path graph at each width and accept the one whose result is a
    valid cover.  A wrong-width call misreads the buffers and produces an
    invalid partition (or an error), never a silently-plausible one here
    because we validate the output."""
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


def _metis_check_width(np_idx, rowptr, colidx):
    if np_idx == np.int32 and (len(colidx) > np.iinfo(np.int32).max
                               or len(rowptr) - 1 > np.iinfo(np.int32).max):
        raise AcgError(ErrorCode.METIS,
                       "graph too large for 32-bit libmetis indices")


def metis_partgraphsym(rowptr, colidx, nparts: int, seed: int = 0,
                       variant: str = "kway") -> np.ndarray:
    """Call ``METIS_PartGraph{Kway,Recursive}`` on a symmetric adjacency
    (no self-loops).

    The ``metis_partgraphsym`` role (``metis.h:81``); ``variant=
    "recursive"`` selects ``METIS_PartGraphRecursive`` (the reference
    exposes both, ``metis.h:39-43``).  Raises if libmetis is not present;
    callers use :func:`partition_rows` for the fallback.
    """
    if variant not in ("kway", "recursive"):
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"unknown METIS variant {variant!r}")
    lib = _load_metis()
    if lib is None:
        raise AcgError(ErrorCode.METIS, "libmetis not found")
    np_idx = _metis_idx_width(lib)
    _metis_check_width(np_idx, rowptr, colidx)
    part = _metis_kway(lib, np_idx, rowptr, colidx, nparts, seed, variant)
    if part.min() < 0 or part.max() >= nparts:
        raise AcgError(ErrorCode.METIS, "METIS returned an invalid partition")
    return part.astype(np.int32)


def metis_nd(rowptr, colidx) -> tuple[np.ndarray, np.ndarray]:
    """Call ``METIS_NodeND`` on a symmetric adjacency (no self-loops):
    fill-reducing nested-dissection ordering.

    The ``metis_ndsym``/``metis_nd`` role (``metis.h:249-263``).  Returns
    ``(perm, iperm)`` with METIS's convention: ``iperm[old] = new`` and
    ``perm[new] = old``.  Raises if libmetis is not present; callers use
    :func:`nested_dissection` for the built-in fallback.
    """
    lib = _load_metis()
    if lib is None:
        raise AcgError(ErrorCode.METIS, "libmetis not found")
    np_idx = _metis_idx_width(lib)
    _metis_check_width(np_idx, rowptr, colidx)
    idx_t = ctypes.c_int32 if np_idx == np.int32 else ctypes.c_int64
    n = len(rowptr) - 1
    xadj = np.ascontiguousarray(rowptr, dtype=np_idx)
    adjncy = np.ascontiguousarray(colidx, dtype=np_idx)
    perm = np.zeros(n, dtype=np_idx)
    iperm = np.zeros(n, dtype=np_idx)
    options = np.zeros(40, dtype=np_idx)
    lib.METIS_SetDefaultOptions(options.ctypes.data_as(ctypes.POINTER(idx_t)))
    nv = idx_t(n)
    ret = lib.METIS_NodeND(
        ctypes.byref(nv),
        xadj.ctypes.data_as(ctypes.POINTER(idx_t)),
        adjncy.ctypes.data_as(ctypes.POINTER(idx_t)),
        None,
        options.ctypes.data_as(ctypes.POINTER(idx_t)),
        perm.ctypes.data_as(ctypes.POINTER(idx_t)),
        iperm.ctypes.data_as(ctypes.POINTER(idx_t)))
    if ret != 1:
        raise AcgError(ErrorCode.METIS, f"METIS_NodeND returned {ret}")
    p32, i32 = perm.astype(np.int32), iperm.astype(np.int32)
    if not (np.array_equal(np.sort(p32), np.arange(n))
            and np.array_equal(p32[i32], np.arange(n))):
        raise AcgError(ErrorCode.METIS, "METIS_NodeND returned an invalid "
                       "permutation (index-width mismatch?)")
    return p32, i32


# ---------------------------------------------------------------------------
# Built-in fallback partitioner
# ---------------------------------------------------------------------------

def _frontier_neighbors(graph: sp.csr_matrix, frontier: np.ndarray) -> np.ndarray:
    """All column indices of the given rows, vectorised (no per-node loop)."""
    indptr, indices = graph.indptr, graph.indices
    starts, ends = indptr[frontier], indptr[frontier + 1]
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    # ranges [starts[i], ends[i]) flattened without Python-level looping
    offsets = np.repeat(starts, lens)
    within = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return indices[offsets + within]


def _bfs_order(graph: sp.csr_matrix, seed_node: int, mask: np.ndarray) -> np.ndarray:
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
    """Greedy boundary refinement, vectorised: per pass, one sparse matvec
    computes each node's same-side neighbour count; nodes with positive
    gain (external-edge count exceeds internal) migrate, best-gain first,
    subject to a 1% balance slack.  KL/FM-flavoured but whole-boundary."""
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
    K1 on the card).
    """
    n = full_csr.shape[0]
    if nparts <= 0:
        raise AcgError(ErrorCode.INVALID_VALUE, "nparts must be positive")
    if nparts > n:
        raise AcgError(ErrorCode.INVALID_PARTITION, "more parts than rows")
    indptr = np.asarray(full_csr.indptr, dtype=np.int64)
    total = int(indptr[-1])
    # row index where each part should start, by cumulative-nnz quantile
    cuts = np.searchsorted(indptr, total * np.arange(1, nparts) / nparts)
    # every part must own at least one row: lower-bound each cut, make the
    # sequence strictly increasing (equal quantiles collapse when nnz is
    # concentrated), then upper-bound so trailing parts stay nonempty
    cuts = np.maximum(cuts, np.arange(1, nparts))
    steps = np.arange(nparts - 1)
    cuts = np.maximum.accumulate(cuts - steps) + steps
    cuts = np.minimum(cuts, n - nparts + np.arange(1, nparts))
    part = np.zeros(n, dtype=np.int32)
    part[cuts] = 1
    return np.cumsum(part).astype(np.int32)


def _pattern_graph(graph: sp.csr_matrix) -> sp.csr_matrix:
    """0/1 adjacency with the diagonal removed (refinement and BFS must
    not see matrix values: negative off-diagonals would invert flip
    gains, and METIS forbids self-loops)."""
    coo = graph.tocoo()
    off = coo.row != coo.col
    return sp.coo_matrix((np.ones(int(off.sum())),
                          (coo.row[off], coo.col[off])),
                         shape=graph.shape).tocsr()


def _bisect(graph: sp.csr_matrix, mask: np.ndarray, target0: int,
            rng, refine: bool) -> np.ndarray:
    """One graph-growing bisection of the masked subgraph: returns the
    side array (0/1 per node; only masked entries meaningful)."""
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
    if refine:
        _refine_bisection(graph, side, mask, target0)
    return side


def nested_dissection(full_csr: sp.csr_matrix, seed: int = 0,
                      use_metis: str = "auto",
                      leaf_size: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """Fill-reducing nested-dissection ordering of the sparsity graph.

    The ``metis_nd`` role (``metis.h:249-263``) with the same optional-METIS
    contract as :func:`partition_rows`: ``METIS_NodeND`` when libmetis is
    present, otherwise a built-in recursion -- bisect with the graph-growing
    partitioner, extract the vertex separator (side-0 nodes adjacent to
    side 1), order both halves recursively, separator last.  Returns
    ``(perm, iperm)``: ``perm[new] = old``, ``iperm[old] = new``.
    """
    n = full_csr.shape[0]
    graph = _pattern_graph(full_csr)
    if use_metis in ("auto", "require") and metis_available():
        return metis_nd(graph.indptr.astype(np.int64),
                        graph.indices.astype(np.int64))
    if use_metis == "require":
        raise AcgError(ErrorCode.METIS, "libmetis required but not found")

    rng = np.random.default_rng(seed)

    def recurse(mask: np.ndarray) -> np.ndarray:
        nodes = np.flatnonzero(mask)
        if nodes.size <= leaf_size:
            return nodes.astype(np.int32)
        side = _bisect(graph, mask, nodes.size // 2, rng, refine=True)
        m0 = mask & (side == 0)
        m1 = mask & (side == 1)
        if not m0.any() or not m1.any():
            return nodes.astype(np.int32)
        # vertex separator: side-0 nodes with a neighbour in side 1
        nbr1 = (graph @ m1.astype(np.float64)) > 0
        sep = m0 & nbr1
        m0 = m0 & ~sep
        left = recurse(m0) if m0.any() else np.empty(0, dtype=np.int32)
        right = recurse(m1)
        return np.concatenate([left, right, np.flatnonzero(sep).astype(np.int32)])

    perm = recurse(np.ones(n, dtype=bool))
    iperm = np.empty(n, dtype=np.int32)
    iperm[perm] = np.arange(n, dtype=np.int32)
    return perm, iperm


def partition_rows(full_csr: sp.csr_matrix, nparts: int, seed: int = 0,
                   refine: bool = True, use_metis: str = "auto",
                   method: str = "graph", variant: str = "kway") -> np.ndarray:
    """Partition matrix rows into ``nparts`` balanced, low-cut parts.

    The ``acgsymcsrmatrix_partition_rows`` role (``symcsrmatrix.c`` ->
    ``graph.c:510`` -> METIS).  ``use_metis``: "auto" probes for libmetis,
    "never" forces the built-in partitioner, "require" errors without it.
    ``method``: "graph" = edge-cut minimisation (METIS or built-in
    bisection); "band" = contiguous nnz-balanced row ranges
    (:func:`partition_rows_band`).  ``variant``: "kway" (default) or
    "recursive" selects the METIS algorithm (``metis.h:39-43``); the
    built-in partitioner is recursive bisection either way.
    """
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
                                  adj.indices.astype(np.int64), nparts, seed,
                                  variant=variant)
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
        side = _bisect(graph, mask, target0, rng, refine)
        m0 = mask & (side == 0)
        m1 = mask & (side == 1)
        if not m0.any() or not m1.any():
            # degenerate split: fall back to even index split
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
