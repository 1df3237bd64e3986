"""Subdomains and halo plans of a partitioned matrix (host numpy).

A copy of the numpy path of ``acg_tpu/graph.py`` (``acg/graph.c`` and
the halo-plan construction of ``acg/halo.c:61-241``): given a symmetric
CSR and a partition vector, build one :class:`Subdomain` per part whose
nodes are ordered interior -> border -> ghost, with per-neighbour send
and receive lists.  Ghosts are grouped by owner part and sorted by
global id within each group, so each neighbour's receive window is a
contiguous slice of the ghost region; both sides order halo entries by
global id, which is the agreement rule between sender and receiver.

Subdomains are built by the native C++ one-pass partitioner
(:mod:`acg_tpu_torch._native`, O(nnz) whatever nparts) when its library
is built, else by vectorised numpy passes (O(n * nparts)); both give the
same subdomains.  :func:`dsymv_dist_host` and :func:`halo_exchange_host`
are the host multi-part SpMV the host oracle solver runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from acg_tpu_torch.errors import AcgError, ErrorCode
from acg_tpu_torch.io.mtxfile import IDX_DTYPE


@dataclasses.dataclass
class HaloPlan:
    """Per-part halo exchange plan (the ``acghalo`` struct role).

    ``send_parts[i]`` receives ``send_counts[i]`` owned values gathered at
    local indices ``send_idx[send_ptr[i]:send_ptr[i+1]]``; symmetrically
    ``recv_parts``/``recv_counts``/``recv_idx`` scatter received values
    into the ghost region."""

    send_parts: np.ndarray   # (nsend_neighbors,) int32
    send_counts: np.ndarray  # (nsend_neighbors,) int64
    send_ptr: np.ndarray     # (nsend_neighbors+1,)
    send_idx: np.ndarray     # (total_send,) local indices into owned region
    recv_parts: np.ndarray
    recv_counts: np.ndarray
    recv_ptr: np.ndarray
    recv_idx: np.ndarray     # (total_recv,) local indices (>= nowned)

    @property
    def total_send(self) -> int:
        return int(self.send_idx.size)

    @property
    def total_recv(self) -> int:
        return int(self.recv_idx.size)


@dataclasses.dataclass
class Subdomain:
    """One part's view of the partitioned problem.

    Local node ordering is ``[interior | border | ghost]`` (or owned rows
    ascending by global id after :func:`reorder_owned_natural`); vectors
    of this subdomain have ``nowned + nghost`` entries, ghosts last."""

    part: int
    ninterior: int
    nborder: int
    nghost: int
    global_ids: np.ndarray       # (nowned+nghost,) local -> global
    ghost_owner: np.ndarray      # (nghost,) owning part of each ghost
    halo: HaloPlan
    # full-storage CSR blocks in local indices (partition_matrix): owned x
    # owned, and owned x ghost
    A_local: sp.csr_matrix | None = None
    A_ghost: sp.csr_matrix | None = None
    # "ibg" = interior|border|ghost; "natural" = owned nodes ascending by
    # global id (set by reorder_owned_natural)
    owned_order: str = "ibg"

    @property
    def nowned(self) -> int:
        return self.ninterior + self.nborder


def partition_graph_nodes(full_csr: sp.csr_matrix, part: np.ndarray,
                          nparts: int) -> list[Subdomain]:
    """Build all subdomains (without matrix blocks) from a partition vector.

    The role of ``acggraph_partition`` (``graph.c:813-1452``): interface
    extraction, interior/border/ghost reordering, neighbour lists, and halo
    plan derivation (``graph.c:1898-1981``).  Dispatches to the native
    one-pass C++ partitioner (``native/src/graph.cpp``, O(nnz) independent
    of nparts) when available, else vectorised numpy whole-graph passes
    (O(n * nparts)).
    """
    from acg_tpu_torch import _native
    if _native.available():
        try:
            return _partition_graph_nodes_native(full_csr, part, nparts)
        except _native.NativeParseError:
            pass  # fall through to the numpy path for the error message
    return _partition_graph_nodes_numpy(full_csr, part, nparts)


def _partition_graph_nodes_native(full_csr, part, nparts) -> list[Subdomain]:
    from acg_tpu_torch import _native
    n = full_csr.shape[0]
    part = np.asarray(part)
    if part.size != n:
        raise AcgError(ErrorCode.INVALID_PARTITION,
                       f"partition vector has {part.size} entries, matrix has {n} rows")
    if n and (part.min() < 0 or part.max() >= nparts):
        raise AcgError(ErrorCode.INVALID_PARTITION,
                       f"part ids outside [0, {nparts})")
    res = _native.graph_partition(n, np.asarray(full_csr.indptr, IDX_DTYPE),
                                  np.asarray(full_csr.indices, IDX_DTYPE),
                                  part, nparts)
    gid_off = np.concatenate([[0], np.cumsum(res["nowned"] + res["nghost"])])
    ghost_off = np.concatenate([[0], np.cumsum(res["nghost"])])
    send_off = np.concatenate([[0], np.cumsum(res["nsend"])])
    subdomains = []
    for p in range(nparts):
        nowned = int(res["nowned"][p])
        nghost = int(res["nghost"][p])
        global_ids = res["global_ids"][gid_off[p]:gid_off[p + 1]]
        ghost_owner = res["ghost_owner"][ghost_off[p]:ghost_off[p + 1]]
        sp_p = res["send_part"][send_off[p]:send_off[p + 1]]
        send_idx = res["send_lidx"][send_off[p]:send_off[p + 1]]
        send_parts, send_counts = np.unique(sp_p, return_counts=True)
        send_ptr = np.concatenate([[0], np.cumsum(send_counts)]).astype(IDX_DTYPE)
        recv_parts, recv_counts = np.unique(ghost_owner, return_counts=True)
        recv_ptr = np.concatenate([[0], np.cumsum(recv_counts)]).astype(IDX_DTYPE)
        recv_idx = np.arange(nowned, nowned + nghost, dtype=IDX_DTYPE)
        halo = HaloPlan(send_parts=send_parts.astype(np.int32),
                        send_counts=send_counts.astype(IDX_DTYPE),
                        send_ptr=send_ptr, send_idx=send_idx,
                        recv_parts=recv_parts.astype(np.int32),
                        recv_counts=recv_counts.astype(IDX_DTYPE),
                        recv_ptr=recv_ptr, recv_idx=recv_idx)
        subdomains.append(Subdomain(
            part=p, ninterior=int(res["ninterior"][p]),
            nborder=nowned - int(res["ninterior"][p]), nghost=nghost,
            global_ids=global_ids, ghost_owner=ghost_owner, halo=halo))
    return subdomains


def _partition_graph_nodes_numpy(full_csr, part, nparts) -> list[Subdomain]:
    n = full_csr.shape[0]
    part = np.asarray(part)
    if part.size != n:
        raise AcgError(ErrorCode.INVALID_PARTITION,
                       f"partition vector has {part.size} entries, matrix "
                       f"has {n} rows")
    if part.min() < 0 or part.max() >= nparts:
        raise AcgError(ErrorCode.INVALID_PARTITION,
                       f"part ids outside [0, {nparts})")

    indptr, indices = full_csr.indptr, full_csr.indices
    row_of = np.repeat(np.arange(n, dtype=IDX_DTYPE), np.diff(indptr))
    col = indices.astype(IDX_DTYPE)
    rp, cp = part[row_of], part[col]
    cut = rp != cp  # inter-part edges

    # border nodes: any endpoint of a cut edge (on its owner's side)
    is_border = np.zeros(n, dtype=bool)
    is_border[row_of[cut]] = True

    # cut edge list (u owned by p, v owned by q != p): u is sent p->q,
    # v is a ghost of p owned by q
    cut_u, cut_v = row_of[cut], col[cut]
    cut_p, cut_q = rp[cut], cp[cut]

    subdomains = []
    for p in range(nparts):
        owned = np.flatnonzero(part == p).astype(IDX_DTYPE)
        border_mask = is_border[owned]
        interior = owned[~border_mask]
        border = owned[border_mask]

        mine = cut_p == p
        # ghosts of p, grouped by owner part then global id
        gv, gq = cut_v[mine], cut_q[mine]
        ghost_order = np.unique(gq * (n + 1) + gv)
        ghost_owner = (ghost_order // (n + 1)).astype(np.int32)
        ghosts = (ghost_order % (n + 1)).astype(IDX_DTYPE)

        global_ids = np.concatenate([interior, border, ghosts])
        nowned = owned.size

        # send plan: (q, u) pairs with u owned by p adjacent to part q,
        # deduped, grouped by q, sorted by global id within each group
        su, sq = cut_u[mine], cut_q[mine]
        send_order = np.unique(sq * (n + 1) + su)
        send_q = (send_order // (n + 1)).astype(np.int32)
        send_u = (send_order % (n + 1)).astype(IDX_DTYPE)
        send_parts, send_counts = np.unique(send_q, return_counts=True)
        send_ptr = np.concatenate([[0], np.cumsum(send_counts)]).astype(
            IDX_DTYPE)
        # map global send nodes to local indices (all are border nodes)
        g2l = np.full(n, -1, dtype=IDX_DTYPE)
        g2l[global_ids] = np.arange(global_ids.size, dtype=IDX_DTYPE)
        send_idx = g2l[send_u]

        recv_parts, recv_counts = np.unique(ghost_owner, return_counts=True)
        recv_ptr = np.concatenate([[0], np.cumsum(recv_counts)]).astype(
            IDX_DTYPE)
        recv_idx = np.arange(nowned, nowned + ghosts.size, dtype=IDX_DTYPE)

        halo = HaloPlan(send_parts=send_parts,
                        send_counts=send_counts.astype(IDX_DTYPE),
                        send_ptr=send_ptr, send_idx=send_idx,
                        recv_parts=recv_parts,
                        recv_counts=recv_counts.astype(IDX_DTYPE),
                        recv_ptr=recv_ptr, recv_idx=recv_idx)
        subdomains.append(Subdomain(part=p, ninterior=interior.size,
                                    nborder=border.size, nghost=ghosts.size,
                                    global_ids=global_ids,
                                    ghost_owner=ghost_owner, halo=halo))
    return subdomains


def partition_matrix(full_csr: sp.csr_matrix, part: np.ndarray,
                     nparts: int) -> list[Subdomain]:
    """Build subdomains with their owned x owned and owned x ghost CSR
    blocks in local indices (the ``f*``/``o*`` split of
    ``symcsrmatrix.c:760-862``), so the distributed SpMV is ``y = A_local
    x_owned + A_ghost x_ghost`` with the ghosts from the halo exchange."""
    subs = partition_graph_nodes(full_csr, part, nparts)
    n = full_csr.shape[0]
    coo = full_csr.tocoo()
    part = np.asarray(part)
    rp = part[coo.row]
    for s in subs:
        g2l = np.full(n, -1, dtype=IDX_DTYPE)
        g2l[s.global_ids] = np.arange(s.global_ids.size, dtype=IDX_DTYPE)
        mine = rp == s.part
        r, c, v = coo.row[mine], coo.col[mine], coo.data[mine]
        lr, lc = g2l[r], g2l[c]
        if (lr < 0).any() or (lc < 0).any():
            raise AcgError(ErrorCode.INVALID_PARTITION,
                           "matrix entry references node outside subdomain "
                           "closure")
        local = lc < s.nowned
        s.A_local = sp.coo_matrix((v[local], (lr[local], lc[local])),
                                  shape=(s.nowned, s.nowned)).tocsr()
        s.A_ghost = sp.coo_matrix(
            (v[~local], (lr[~local], lc[~local] - s.nowned)),
            shape=(s.nowned, max(s.nghost, 1))).tocsr()
        s.A_local.sort_indices()
        s.A_ghost.sort_indices()
    return subs


def reorder_owned_natural(subs: list[Subdomain]) -> list[Subdomain]:
    """Reorder each subdomain's owned nodes into ascending global id, in
    place (ghosts untouched).  A contiguous partition of a banded matrix
    then keeps every local block banded, so it stacks as gather-free DIA
    planes.  The halo plan stays valid: send windows are keyed by global
    id order, and only their local indices are remapped."""
    for s in subs:
        if s.owned_order == "natural":
            continue
        owned = s.global_ids[: s.nowned]
        perm = np.argsort(owned, kind="stable")   # new local -> old local
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size, dtype=perm.dtype)
        s.global_ids[: s.nowned] = owned[perm]
        s.halo.send_idx = inv[s.halo.send_idx].astype(s.halo.send_idx.dtype)
        if s.A_local is not None:
            s.A_local = s.A_local[perm][:, perm].tocsr()
            s.A_local.sort_indices()
        if s.A_ghost is not None:
            s.A_ghost = s.A_ghost[perm].tocsr()
            s.A_ghost.sort_indices()
        s.owned_order = "natural"
    return subs


def halo_exchange_host(subs: list[Subdomain], xs: list[np.ndarray]) -> None:
    """Host-side halo exchange over subdomain vectors, in place.

    The role of ``acghalo_exchange`` (``halo.c:687``) for the host
    reference path: gather each part's send entries, deliver into the
    matching ghost windows.  Used by the distributed host SpMV oracle and
    as the semantics model for the device implementations.
    """
    packed = {}
    for i, s in enumerate(subs):
        h = s.halo
        for j, q in enumerate(h.send_parts):
            idx = h.send_idx[h.send_ptr[j]:h.send_ptr[j + 1]]
            packed[(s.part, int(q))] = xs[i][idx]
    # deliver
    for i, s in enumerate(subs):
        h = s.halo
        for j, q in enumerate(h.recv_parts):
            window = h.recv_idx[h.recv_ptr[j]:h.recv_ptr[j + 1]]
            buf = packed[(int(q), s.part)]
            if buf.size != window.size:
                raise AcgError(ErrorCode.INVALID_PARTITION,
                               f"halo window mismatch {q}->{s.part}: "
                               f"{buf.size} != {window.size}")
            xs[i][window] = buf


def dsymv_dist_host(subs: list[Subdomain], xs: list[np.ndarray]) -> list[np.ndarray]:
    """Distributed host SpMV (the ``acgsymcsrmatrix_dsymvmpi`` role,
    ``symcsrmatrix.c:1353-1397``): halo exchange then local + offdiag SpMV."""
    halo_exchange_host(subs, xs)
    out = []
    for s, x in zip(subs, xs):
        y = s.A_local @ x[: s.nowned]
        if s.nghost:
            y = y + s.A_ghost @ x[s.nowned: s.nowned + s.nghost]
        out.append(y)
    return out


def comm_matrix(subs: list[Subdomain], nparts: int) -> np.ndarray:
    """Part-to-part communication volume matrix (``--output-comm-matrix``,
    ``cuda/acg-cuda.c:1712-1780``): ``M[p, q]`` values sent from p to q."""
    M = np.zeros((nparts, nparts), dtype=np.int64)
    for s in subs:
        h = s.halo
        for q, cnt in zip(h.send_parts, h.send_counts):
            M[s.part, q] = cnt
    return M


def scatter_vector(subs: list[Subdomain], x_global: np.ndarray,
                   include_ghosts: bool = False) -> list[np.ndarray]:
    """Split a global vector into subdomain-conforming vectors."""
    out = []
    for s in subs:
        v = np.zeros(s.nowned + s.nghost, dtype=x_global.dtype)
        v[: s.nowned] = x_global[s.global_ids[: s.nowned]]
        if include_ghosts:
            v[s.nowned:] = x_global[s.global_ids[s.nowned:]]
        out.append(v)
    return out


def gather_vector(subs: list[Subdomain], xs: list[np.ndarray],
                  n: int) -> np.ndarray:
    """Inverse of :func:`scatter_vector`: owned entries back to global
    order."""
    out = np.zeros(n, dtype=xs[0].dtype)
    for s, x in zip(subs, xs):
        out[s.global_ids[: s.nowned]] = x[: s.nowned]
    return out
