"""Halo plans on stacked parts, and the plain (``--comm xla``) transport.

The counterpart of ``acg_tpu/parallel/halo.py``.  The host plans of
:class:`acg_tpu_torch.graph.HaloPlan` compile into padded index arrays
stacked over parts (numpy on the host, moved to the device once by
:meth:`DeviceHaloPlan.to`).  Every part lives in one ``(nparts, ...)``
tensor on one device -- the layout ``shard_map`` sees in the JAX
package -- so the exchange is:

* pack: one gather ``x[p, send_idx[p]]``, the (nparts, nparts, maxcnt)
  send plane (``halo.cu:41-54``);
* transport: the JAX package's ``lax.all_to_all`` over the parts axis,
  which on stacked parts is the transpose ``recv[p, q] = send[q, p]``;
* unpack: one gather from part p's receive rows into its ghost slots
  (``ghost_src``, ``halo.cu:94-107``).

Across processes each rank holds its own parts' rows of every plan
(:meth:`DeviceHaloPlan.take`), and :func:`halo_exchange_ranks` moves the
send planes with one ``all_to_all_single`` (:func:`transpose_ranks`).
The one-sided transport (``--comm dma``, kernel K6) is in
:mod:`acg_tpu_torch.parallel.halo_dma`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_tpu_torch.graph import Subdomain


@dataclasses.dataclass
class DeviceHaloPlan:
    """Static padded halo plan, stacked over parts.

    ``send_idx[p, q, :]`` gathers from part p's owned vector the window
    it sends to part q (padded with index 0; padding values are never
    read on the receive side).  ``ghost_src[p, g]`` indexes part p's
    flattened receive rows (nparts * maxcnt) to fill ghost slot g.
    ``ghost_valid[p, g]`` is False for padding slots beyond part p's real
    ghost count: the one-sided transport never writes the receive row
    such a slot would read, so its unpack masks them to zero.

    Host arrays are numpy int32/bool (the JAX package's layout); the
    tensors of :meth:`to` hold int64 indices, as ``torch.gather`` wants.
    """

    send_idx: np.ndarray     # (nparts, nparts, maxcnt) int32
    ghost_src: np.ndarray    # (nparts, nmax_ghost) int32
    ghost_valid: np.ndarray  # (nparts, nmax_ghost) bool
    maxcnt: int
    nmax_ghost: int
    nparts: int

    @property
    def has_ghosts(self) -> bool:
        return self.nmax_ghost > 0 and self.maxcnt > 0

    def take(self, lo: int, hi: int) -> "DeviceHaloPlan":
        """The rows of parts ``lo .. hi - 1`` (a rank's parts); the
        receive width stays ``nparts``."""
        return dataclasses.replace(
            self, send_idx=self.send_idx[lo:hi],
            ghost_src=self.ghost_src[lo:hi],
            ghost_valid=self.ghost_valid[lo:hi])

    def to(self, device) -> "DeviceHaloPlan":
        """The same plan with its arrays as tensors on ``device``."""
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)
        return dataclasses.replace(
            self, send_idx=put(self.send_idx, torch.int64),
            ghost_src=put(self.ghost_src, torch.int64),
            ghost_valid=put(self.ghost_valid, torch.bool))


def build_device_halo(subs: list[Subdomain], maxcnt: int | None = None,
                      nmax_ghost: int | None = None) -> DeviceHaloPlan:
    """Compile host halo plans into padded index arrays, every window
    padded to the largest per-neighbour count (the reference's max-size
    symmetric buffers, ``halo.c:883-887``).  ``maxcnt``/``nmax_ghost``
    override the maxima where this process holds only its own parts'
    plans (the local-read flow: parts with ``halo is None`` are skipped,
    their rows stay zero)."""
    nparts = len(subs)
    if maxcnt is None:
        maxcnt = max((int(c) for s in subs if s.halo is not None
                      for c in s.halo.send_counts), default=0)
    if nmax_ghost is None:
        nmax_ghost = max((s.nghost for s in subs), default=0)
    send_idx = np.zeros((nparts, nparts, max(maxcnt, 1)), dtype=np.int32)
    ghost_src = np.zeros((nparts, max(nmax_ghost, 1)), dtype=np.int32)
    ghost_valid = np.zeros((nparts, max(nmax_ghost, 1)), dtype=bool)
    for p, s in enumerate(subs):
        if s.halo is None:
            continue
        ghost_valid[p, : s.nghost] = True
        h = s.halo
        for j, q in enumerate(h.send_parts):
            w = h.send_idx[h.send_ptr[j]:h.send_ptr[j + 1]]
            send_idx[p, int(q), : w.size] = w
        # ghost slot g of part p comes from owner q's send window to p, at
        # the slot's rank within its (contiguous, global-id-sorted) window
        for j, q in enumerate(h.recv_parts):
            lo, hi = int(h.recv_ptr[j]), int(h.recv_ptr[j + 1])
            ghost_src[p, lo:hi] = int(q) * max(maxcnt, 1) + np.arange(hi - lo)
    return DeviceHaloPlan(send_idx=send_idx, ghost_src=ghost_src,
                          ghost_valid=ghost_valid, maxcnt=maxcnt,
                          nmax_ghost=nmax_ghost, nparts=nparts)


def pack(x: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """The send plane: ``send[p, q, :] = x[p, send_idx[p, q, :]]``."""
    P = x.shape[0]
    return torch.gather(x, 1, send_idx.reshape(P, -1)).reshape(
        send_idx.shape)


def unpack(recv: torch.Tensor, ghost_src: torch.Tensor) -> torch.Tensor:
    """Part p's ghost vector from its receive rows ``recv[p]``."""
    P = recv.shape[0]
    return torch.gather(recv.reshape(P, -1), 1, ghost_src)


def halo_exchange(x: torch.Tensor, send_idx: torch.Tensor,
                  ghost_src: torch.Tensor) -> torch.Tensor:
    """Exchange ghost values of the stacked owned vectors ``x`` (nparts,
    nmax_owned); returns the stacked ghost vectors (nparts, nmax_ghost).
    The transport is the transpose of the send plane, the all_to_all of
    the JAX package's ``--comm xla``."""
    return unpack(pack(x, send_idx).transpose(0, 1), ghost_src)


def transpose_ranks(send: torch.Tensor, ranges, rank: int) -> torch.Tensor:
    """The all_to_all of the send planes across ranks: rank ``rank``'s
    receive plane ``recv[p - lo, q] = send_q[p]`` (nlocal, nparts,
    maxcnt) from its send plane (nlocal, nparts, maxcnt) -- on stacked
    parts the transpose.  One ``all_to_all_single`` of raw bytes: rank r
    gets ``send[:, parts of r]`` transposed.  Under gloo the payload is
    staged through pinned host copies, since gloo moves only CPU
    tensors (one device sync an exchange)."""
    from acg_tpu_torch.parallel import multihost
    lo, hi = ranges[rank]
    nl, _, m = send.shape
    isz = send.element_size()
    pieces = [send[:, a:b].transpose(0, 1).contiguous().view(torch.uint8)
              .reshape(-1) for a, b in ranges]
    out = multihost.all_to_all_bytes(
        torch.cat(pieces), [p.numel() for p in pieces],
        [nl * (b - a) * m * isz for a, b in ranges])
    blocks = torch.split(out, [nl * (b - a) * m * isz for a, b in ranges])
    return torch.cat([blk.view(send.dtype).view(nl, b - a, m)
                      for blk, (a, b) in zip(blocks, ranges)], dim=1)


def halo_exchange_ranks(x: torch.Tensor, send_idx: torch.Tensor,
                        ghost_src: torch.Tensor, ranges,
                        rank: int) -> torch.Tensor:
    """:func:`halo_exchange` across ranks (``--comm xla`` on the
    multi-process tier): this rank's stacked owned vectors ``x`` (nlocal,
    nmax_owned) and its rows of the plan -> its ghost vectors."""
    return unpack(transpose_ranks(pack(x, send_idx), ranges, rank),
                  ghost_src)
