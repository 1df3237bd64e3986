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

Across processes (one rank per card, or ranks sharing a card) the puts
go into the peers' receive planes mapped through CUDA IPC
(:class:`PeerPlanes`, :func:`acg_tpu_torch.ops.kernels.halo_put_peer`)
and :func:`halo_exchange_peer` is the exchange: pack, the peer put and
its wait, unpack masked by ``ghost_valid``.  On the CPU the plain
version moves the windows with ``torch.distributed.all_to_all``.
"""

from __future__ import annotations

import ctypes

import numpy as np
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


# -- the cross-process form -------------------------------------------------

_ALIGN = 256
# seconds a wait launch spins for its flags and acks before it reports
WAIT_TIMEOUT_S = 60.0
_INT_OF = {8: torch.int64, 4: torch.int32, 2: torch.int16}
_TYPESTR = {8: "<i8", 4: "<i4", 2: "<i2"}


def _up(n: int) -> int:
    return -(-int(n) // _ALIGN) * _ALIGN


class _DeviceArray:
    """Raw device memory as ``__cuda_array_interface__`` for
    ``torch.as_tensor`` (a view: the memory stays the allocation's)."""

    def __init__(self, ptr: int, shape: tuple, itemsize: int):
        self.__cuda_array_interface__ = {
            "shape": tuple(int(s) for s in shape),
            "typestr": _TYPESTR[itemsize], "data": (int(ptr), False),
            "version": 3, "strides": None}


def peer_layout(nlocal: int, nparts: int, maxcnt: int, itemsize: int):
    """Byte offsets inside one rank's allocation: ``(plane0, plane1,
    flags, acks, total)`` for ``nlocal`` parts; every rank derives every
    peer's layout from the peer's part count alone."""
    plane = _up(nlocal * nparts * maxcnt * itemsize)
    rows = _up(nlocal * nparts * 4)
    return 0, plane, 2 * plane, 2 * plane + rows, 2 * plane + 2 * rows


class PeerPlanes:
    """The memory of K6's cross-process form (``csrc/halo_put.cu``,
    :func:`acg_tpu_torch.ops.kernels.halo_put_peer`) for one vector dtype
    of one solver: this rank's two receive planes ``(nlocal, nparts,
    maxcnt)``, its flags and acks, mapped into every rank of the run.

    Made collectively (every rank at the same point): each rank
    allocates with ``cudaMalloc`` in the kernel library (its own
    allocation, so the 64-byte IPC handle carries no offset into a
    caching allocator's block), publishes the handle through
    :func:`~acg_tpu_torch.parallel.erragree.allgather_blobs`, and opens
    every PEER's handle with ``cudaIpcMemLazyEnablePeerAccess`` -- never
    its own, which CUDA refuses.  :meth:`close` unmaps and frees after a
    barrier, so no rank frees memory a peer still maps.  ``ranges`` are
    the ranks' part ranges (:func:`~acg_tpu_torch.parallel.mesh.
    part_ranges`); ``send_counts`` the (nparts, nparts) counts that gate
    the puts (their receive side is the transpose); ``gate`` False puts
    every off-diagonal pair, as the stacked form's dense mode."""

    def __init__(self, nparts: int, ranges, rank: int, maxcnt: int, dtype,
                 send_counts, device, gate: bool = True):
        from acg_tpu_torch.ops import _build
        from acg_tpu_torch.parallel.erragree import allgather_blobs

        self.nparts, self.maxcnt = int(nparts), max(int(maxcnt), 1)
        self.dtype, self.device = dtype, torch.device(device)
        self.gate, self.timeout = bool(gate), WAIT_TIMEOUT_S
        self.ranges, self.rank = [tuple(r) for r in ranges], int(rank)
        self.seq = 0
        lo, hi = self.ranges[self.rank]
        self.nlocal = hi - lo
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        self._lib = lib = _build.lib()
        dev_index = self.device.index or 0
        layout = peer_layout(self.nlocal, self.nparts, self.maxcnt,
                             self.itemsize)
        ptr = ctypes.c_void_p()
        _build.check("acg_ipc_alloc", lib.acg_ipc_alloc(
            dev_index, layout[-1], ctypes.byref(ptr)))
        self._own = int(ptr.value)
        self._opened: list[int] = []
        hsize = lib.acg_ipc_handle_size()
        handle = ctypes.create_string_buffer(hsize)
        _build.check("acg_ipc_handle", lib.acg_ipc_handle(self._own, handle))
        self._handle = handle.raw
        handles = [bytes.fromhex(h) for h in
                   allgather_blobs(self._handle.hex(), tag="k6peer")]
        bases = []
        for q, h in enumerate(handles):
            bases.append(self._own if q == self.rank else self.open(h))
        host, devw = ctypes.c_void_p(), ctypes.c_void_p()
        _build.check("acg_ipc_host_word", lib.acg_ipc_host_word(
            ctypes.byref(host), ctypes.byref(devw)))
        self._err_host = int(host.value)
        self.err_dev = int(devw.value)
        tab = np.zeros(4 * self.nparts, dtype=np.int64)
        for r, (a, b) in enumerate(self.ranges):
            p0, p1, fl, ak, _ = peer_layout(b - a, self.nparts, self.maxcnt,
                                            self.itemsize)
            for p in range(a, b):
                row = (p - a) * self.nparts
                tab[p] = bases[r] + p0 + row * self.maxcnt * self.itemsize
                tab[self.nparts + p] = (bases[r] + p1
                                        + row * self.maxcnt * self.itemsize)
                tab[2 * self.nparts + p] = bases[r] + fl + row * 4
                tab[3 * self.nparts + p] = bases[r] + ak + row * 4
        self.tab = torch.from_numpy(tab).to(self.device)
        self.counts = torch.from_numpy(np.ascontiguousarray(
            np.asarray(send_counts, dtype=np.int32))).to(self.device)
        self.done = torch.zeros(self.nlocal * self.nparts,
                                dtype=torch.int64, device=self.device)
        self.flags_ptr = self._own + layout[2]
        self.acks_ptr = self._own + layout[3]
        shape = (self.nlocal, self.nparts, self.maxcnt)
        self._planes = [torch.as_tensor(_DeviceArray(
            self._own + off, shape, self.itemsize)).view(dtype)
            for off in layout[:2]]

    def open(self, handle: bytes) -> int:
        """Map a peer's allocation; refuses this rank's own handle."""
        from acg_tpu_torch.ops import _build
        if handle == self._handle:
            raise ValueError("PeerPlanes.open: a rank never opens its own "
                             "IPC handle (CUDA refuses it in the process "
                             "that allocated the memory)")
        ptr = ctypes.c_void_p()
        _build.check("acg_ipc_open", self._lib.acg_ipc_open(
            self.device.index or 0, handle, ctypes.byref(ptr)))
        self._opened.append(int(ptr.value))
        return int(ptr.value)

    def plane(self, parity: int) -> torch.Tensor:
        """Receive plane ``parity`` as a (nlocal, nparts, maxcnt) view."""
        return self._planes[parity]

    def check(self) -> None:
        """Raise if a wait gave up (its error word is set)."""
        if self._err_host and ctypes.c_int.from_address(
                self._err_host).value:
            what = ("a sender's flag" if ctypes.c_int.from_address(
                self._err_host).value == 1 else "a receiver's ack")
            raise RuntimeError(
                f"halo_put_peer: {what} did not arrive within "
                f"{self.timeout:.0f} s (exchange {self.seq}): a peer rank "
                f"stopped or fell behind")

    def close(self, timeout: float = 120.0) -> None:
        """Unmap the peers and free this rank's memory, after a barrier
        on either side (collective: every rank calls it)."""
        from acg_tpu_torch.parallel.erragree import barrier
        if self._own is None:
            return
        torch.cuda.synchronize(self.device)
        self._planes = []
        barrier("k6peer-close", timeout=timeout)
        for ptr in self._opened:
            self._lib.acg_ipc_close(ptr)
        self._opened = []
        barrier("k6peer-free", timeout=timeout)
        self._lib.acg_ipc_free(self._own)
        self._lib.acg_ipc_host_free(self._err_host)
        self._own = None
        self._err_host = 0


def halo_exchange_peer(x: torch.Tensor, send_idx: torch.Tensor,
                       ghost_src: torch.Tensor, ghost_valid: torch.Tensor,
                       send_counts: torch.Tensor, recv: torch.Tensor,
                       ranges, rank: int, peer: PeerPlanes | None = None,
                       gate_by_counts: bool = True) -> torch.Tensor:
    """The one-sided exchange across ranks: this rank's stacked owned
    vectors ``x`` (nlocal, nmax_owned) -> its ghost vectors (nlocal,
    nmax_ghost).  ``send_idx``, ``ghost_src`` and ``ghost_valid`` are
    this rank's rows of the plan; ``send_counts`` the global (nparts,
    nparts) counts; ``recv`` the zeroed receive plane of the CPU's plain
    version; ``peer`` the mapped planes of the card's kernel."""
    plane = K.halo_put_peer(pack(x, send_idx), send_counts, recv, ranges,
                            rank, peer=peer, gate_by_counts=gate_by_counts)
    return torch.where(ghost_valid, unpack(plane, ghost_src), 0)
