"""The one-sided halo exchange (``--comm dma``) on kernel K6.

The counterpart of ``acg_tpu/parallel/halo_dma.py:232-305``.  On the
TPU every shard puts its window for each neighbour into row ``me`` of
the neighbour's receive plane (``pltpu.make_async_remote_copy``, the
reference's NVSHMEM put-with-signal) and waits on DMA semaphores.  With
all parts stacked on one card the puts of every shard are the blocks of
one launch of :func:`acg_tpu_torch.ops.kernels.halo_put`; stream order
stands in for the barrier and the waits.  Pack and unpack stay torch
gathers outside the kernel, as the JAX package keeps them XLA gathers.

Puts are gated by the per-neighbour counts, as on TPU hardware: only
rows of real neighbours are written, the diagonal row never.  The
receive plane is allocated and zeroed by the caller (once per solve),
and the unpack masks padding ghost slots (``ghost_valid``), so no
unwritten row is ever read.  ``gate_by_counts=False`` writes every
off-diagonal row, like the JAX kernel in interpret mode.
"""

from __future__ import annotations

import torch

from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.parallel.halo import pack, unpack


def dma_exchange(sendbuf: torch.Tensor, send_counts: torch.Tensor,
                 recv_counts: torch.Tensor, gate_by_counts: bool = True,
                 recv: torch.Tensor | None = None) -> torch.Tensor:
    """The raw exchange without pack/unpack: returns the receive plane
    ``recv[p, q] = sendbuf[q, p]`` for every pair the transport moves.
    ``recv_counts`` must be ``send_counts`` transposed (each receiver
    waits for exactly what its senders put; checked here, which reads
    both to the host).  ``recv`` (zeros when not given) is written in
    place; with one part nothing moves."""
    if not torch.equal(recv_counts, send_counts.T):
        raise ValueError("dma_exchange: recv_counts must equal "
                         "send_counts transposed")
    if recv is None:
        recv = torch.zeros_like(sendbuf)
    if sendbuf.shape[0] == 1:
        return recv
    return K.halo_put(sendbuf, send_counts, recv,
                      gate_by_counts=gate_by_counts)


def halo_exchange_dma(x: torch.Tensor, send_idx: torch.Tensor,
                      ghost_src: torch.Tensor, ghost_valid: torch.Tensor,
                      send_counts: torch.Tensor, recv: torch.Tensor,
                      gate_by_counts: bool = True) -> torch.Tensor:
    """Exchange ghost values by one-sided puts: the contract of
    :func:`acg_tpu_torch.parallel.halo.halo_exchange` plus the int32
    per-neighbour ``send_counts`` (nparts, nparts) that gate the puts,
    the zeroed receive plane ``recv`` (nparts, nparts, maxcnt) the puts
    land in, and ``ghost_valid``, which masks padding ghost slots.  The
    counts come from :meth:`DistributedProblem.neighbor_counts`, which
    checks that every receiver expects what its senders put."""
    K.halo_put(pack(x, send_idx), send_counts, recv,
               gate_by_counts=gate_by_counts)
    return torch.where(ghost_valid, unpack(recv, ghost_src), 0)
