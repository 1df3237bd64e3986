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
(:class:`PeerPlanes`, :func:`acg_tpu_torch.ops.kernels.halo_put_peer`),
ordered by stream memory operations that flag each put and ack each
unpack (:func:`peer_schedule`), and :func:`halo_exchange_peer` is the
exchange: pack, the peer put between its waits, unpack masked by
``ghost_valid``.  On the CPU the plain version moves the windows with
``torch.distributed.all_to_all``.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import time

import numpy as np
import torch

from acg_tpu_torch.ops import _build
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
# seconds an exchange may wait for a peer's flag or ack before the
# watchdog releases the wait and the next check raises
WAIT_TIMEOUT_S = 60.0
# CU_STREAM_WAIT_VALUE_FLUSH (cuda.h): a satisfied wait also flushes the
# remote writes that reached the card before it
_WAIT_FLUSH = 1 << 30
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
    peer's layout from the peer's part count alone.  Flags and acks are
    (nlocal, nparts) uint32 rows: ``flag[p, q]`` in the memory of p's
    owner, ``ack[q, p]`` in the memory of q's owner."""
    plane = _up(nlocal * nparts * maxcnt * itemsize)
    rows = _up(nlocal * nparts * 4)
    return 0, plane, 2 * plane, 2 * plane + rows, 2 * plane + 2 * rows


def peer_schedule(counts, ranges, rank: int, seq: int, gate: bool = True):
    """The stream memory operations of exchange ``seq`` (>= 1) on rank
    ``rank``: ``(pre, post)``, the operations before and after its put,
    each a list of ``(op, word, value)`` in stream order.  ``op`` is
    "write" or "wait" (until the word is >= value); ``word`` is
    ``("flag", p, q)``, in the memory of p's owner: q's window for p has
    landed in p's rows; or ``("ack", q, p)``, in the memory of q's
    owner: p's owner has unpacked what q sent it.

    pre: ack seq - 1 to every gated sender on another rank (the unpack
    of exchange seq - 1 came before on this stream), then wait for ack
    seq - 2 from every gated receiver on another rank (the last reader
    of the plane seq writes: planes alternate by seq's parity).  post:
    flag seq to every gated receiver on another rank, then wait for the
    flag of every gated sender on another rank.  A pair within one rank
    has no word: its put and its unpack share the rank's stream.  Pair
    q -> p moves when q != p and, with ``gate``, ``counts[q, p] > 0``,
    as the put kernel gates it.  Pure: a function of its arguments."""
    c = np.asarray(counts)
    P = c.shape[0]
    owner = np.empty(P, dtype=np.int64)
    for r, (a, b) in enumerate(ranges):
        owner[a:b] = r
    moves = ~np.eye(P, dtype=bool)
    if gate:
        moves &= c > 0
    lo, hi = ranges[rank]
    sends = [(q, p) for q in range(lo, hi) for p in range(P)
             if moves[q, p] and owner[p] != rank]
    recvs = [(q, p) for p in range(lo, hi) for q in range(P)
             if moves[q, p] and owner[q] != rank]
    pre = []
    if seq >= 2:
        pre += [("write", ("ack", q, p), seq - 1) for q, p in recvs]
    if seq >= 3:
        pre += [("wait", ("ack", q, p), seq - 2) for q, p in sends]
    post = ([("write", ("flag", p, q), seq) for q, p in sends]
            + [("wait", ("flag", p, q), seq) for q, p in recvs])
    return pre, post


class _MemOps:
    """Stream memory operations as ``acg_memops`` takes them: addresses,
    values less the exchange's sequence number, which are waits; the
    arrays stay alive with the pointers passed to the library."""

    def __init__(self, addr, delta, wait):
        self.arrays = (addr, delta, wait)
        self.n = len(addr)
        self.args = (self.n, addr.ctypes.data, delta.ctypes.data,
                     wait.ctypes.data)


class PeerPlanes:
    """The memory and the synchronisation of K6's cross-process form
    (``csrc/halo_put.cu``, :func:`acg_tpu_torch.ops.kernels.
    halo_put_peer`) for one vector dtype of one solver: this rank's two
    receive planes ``(nlocal, nparts, maxcnt)``, its flags and acks,
    mapped into every rank of the run, and the stream memory operations
    of :func:`peer_schedule` that order the puts.

    Made collectively (every rank at the same point): each rank
    allocates with ``cudaMalloc`` in the kernel library (its own
    allocation, so the 64-byte IPC handle carries no offset into a
    caching allocator's block), publishes the handle through
    :func:`~acg_tpu_torch.parallel.erragree.allgather_blobs`, and opens
    every PEER's handle with ``cudaIpcMemLazyEnablePeerAccess`` -- never
    its own, which CUDA refuses.  A libcuda without the stream memory
    operations, or a device that refuses them, raises here; nothing
    falls back.  :meth:`close` unmaps and frees after a barrier, so no
    rank frees memory a peer still maps.  ``ranges`` are the ranks' part
    ranges (:func:`~acg_tpu_torch.parallel.mesh.part_ranges`);
    ``send_counts`` the (nparts, nparts) counts that gate the puts (their
    receive side is the transpose); ``gate`` False puts every
    off-diagonal pair, as the stacked form's dense mode.

    A stream wait has no time bound, so a watchdog thread holds one
    event per exchange, recorded after its last wait: when the oldest
    unfinished one has been the oldest for ``timeout`` seconds, it notes
    which word is missing and writes the awaited values into this
    rank's own flags and acks from a stream of its own that never waits
    for the legacy default stream, which releases the wait.
    :meth:`check` (at every exchange and after a solve) then raises."""

    def __init__(self, nparts: int, ranges, rank: int, maxcnt: int, dtype,
                 send_counts, device, gate: bool = True,
                 timeout: float = WAIT_TIMEOUT_S):
        from acg_tpu_torch.parallel.erragree import allgather_blobs

        self.nparts, self.maxcnt = int(nparts), max(int(maxcnt), 1)
        self.dtype, self.device = dtype, torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.gate, self.timeout = bool(gate), float(timeout)
        self.ranges, self.rank = [tuple(r) for r in ranges], int(rank)
        self.seq = 0
        lo, hi = self.ranges[self.rank]
        self.nlocal = hi - lo
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        self._lib = lib = _build.lib()
        dev_index = self.device.index
        can_flush = ctypes.c_int()
        _build.check("acg_memops_init", lib.acg_memops_init(
            dev_index, ctypes.byref(can_flush)))
        self.can_flush = bool(can_flush.value)
        self._wait_flags = _WAIT_FLUSH if self.can_flush else 0
        self._layouts = [peer_layout(b - a, self.nparts, self.maxcnt,
                                     self.itemsize) for a, b in self.ranges]
        layout = self._layouts[self.rank]
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
        self._bases = [self._own if q == self.rank else self.open(h)
                       for q, h in enumerate(handles)]
        self._owner = np.empty(self.nparts, dtype=np.int64)
        tab = np.zeros(2 * self.nparts, dtype=np.int64)
        for r, (a, b) in enumerate(self.ranges):
            self._owner[a:b] = r
            for p in range(a, b):
                row = (p - a) * self.nparts * self.maxcnt * self.itemsize
                for parity in (0, 1):
                    tab[parity * self.nparts + p] = (
                        self._bases[r] + self._layouts[r][parity] + row)
        self.tab = torch.from_numpy(tab).to(self.device)
        self._counts = np.ascontiguousarray(
            np.asarray(send_counts, dtype=np.int32))
        self.counts = torch.from_numpy(self._counts).to(self.device)
        self.flags_ptr = self._own + layout[2]
        self.acks_ptr = self._own + layout[3]
        shape = (self.nlocal, self.nparts, self.maxcnt)
        self._planes = [torch.as_tensor(_DeviceArray(
            self._own + off, shape, self.itemsize)).view(dtype)
            for off in layout[:2]]
        self._ops: dict = {}
        self.unwaited = False
        side = ctypes.c_void_p()
        _build.check("acg_stream_create", lib.acg_stream_create(
            ctypes.byref(side)))
        self._side = torch.cuda.ExternalStream(side.value,
                                               device=self.device)
        if self.nlocal:
            # libcuda refuses a stream memory operation on a device
            # that lacks them: try one write and one wait on an unused
            # word (the diagonal flag) before any exchange needs them
            word = ("flag", lo, lo)
            self.enqueue(self.arrays([("write", word, 0),
                                       ("wait", word, 0)], 0), 0)
            torch.cuda.synchronize(self.device)
        self._pending: collections.deque = collections.deque()
        self._since = 0.0
        self._error = ""
        self._released = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=f"k6peer-watchdog-{rank}")
        self._thread.start()

    def open(self, handle: bytes) -> int:
        """Map a peer's allocation; refuses this rank's own handle."""
        if handle == self._handle:
            raise ValueError("PeerPlanes.open: a rank never opens its own "
                             "IPC handle (CUDA refuses it in the process "
                             "that allocated the memory)")
        ptr = ctypes.c_void_p()
        _build.check("acg_ipc_open", self._lib.acg_ipc_open(
            self.device.index, handle, ctypes.byref(ptr)))
        self._opened.append(int(ptr.value))
        return int(ptr.value)

    def plane(self, parity: int) -> torch.Tensor:
        """Receive plane ``parity`` as a (nlocal, nparts, maxcnt) view."""
        return self._planes[parity]

    # -- the stream memory operations --

    def _addr(self, word) -> int:
        kind, row, col = word
        r = int(self._owner[row])
        off = self._layouts[r][2 if kind == "flag" else 3]
        return (self._bases[r] + off
                + ((row - self.ranges[r][0]) * self.nparts + col) * 4)

    def arrays(self, ops, seq: int) -> "_MemOps":
        """``ops`` (``(op, word, value)``, of :func:`peer_schedule`) as
        ``acg_memops`` takes them, their values relative to ``seq``."""
        return _MemOps(
            np.array([self._addr(w) for _, w, _ in ops], dtype=np.uint64),
            np.array([v - seq for _, _, v in ops], dtype=np.int64),
            np.array([op == "wait" for op, _, _ in ops], dtype=np.int32))

    def ops(self, seq: int):
        """The operations of exchange ``seq`` as ``acg_memops`` arrays:
        ``(pre, signal, wait)``, :func:`peer_schedule`'s pre list and
        its post list split into the flag writes and the flag waits.
        From exchange 3 on the lists are the same, their values shifted
        by seq, so three are built."""
        key = min(int(seq), 3)
        if key not in self._ops:
            pre, post = peer_schedule(self._counts, self.ranges, self.rank,
                                      key, self.gate)
            self._ops[key] = (
                self.arrays(pre, key),
                self.arrays([o for o in post if o[0] == "write"], key),
                self.arrays([o for o in post if o[0] == "wait"], key))
        return self._ops[key]

    def enqueue(self, ops: "_MemOps", seq: int,
                stream: int | None = None) -> None:
        """Enqueue ``ops`` (of :meth:`ops` or :meth:`arrays`) for
        exchange ``seq`` on ``stream`` (the current stream when None)."""
        if not ops.n:
            return
        if stream is None:
            stream = torch.cuda.current_stream(self.device).cuda_stream
        _build.check("acg_memops", self._lib.acg_memops(
            *ops.args, seq & 0xFFFFFFFF, self._wait_flags, stream))

    def wait(self, marks: list | None = None, stream=None) -> None:
        """Enqueue the flag waits of the last exchange (after a put made
        with ``wait=False``) on ``stream`` (a ``torch.cuda.Stream``; the
        current stream when None) and hand its end to the watchdog."""
        if stream is None:
            stream = torch.cuda.current_stream(self.device)
        self.enqueue(self.ops(self.seq)[2], self.seq, stream.cuda_stream)
        done = torch.cuda.Event(enable_timing=marks is not None)
        done.record(stream)
        if marks is not None:
            marks.append(done)
        with self._lock:
            if not self._pending:
                self._since = time.monotonic()
            self._pending.append((self.seq, done))
        self.unwaited = False

    # -- the watchdog --

    def _watch(self) -> None:
        torch.cuda.set_device(self.device)
        poll = min(0.05, self.timeout / 20)
        while not self._stop.wait(poll):
            with self._lock:
                while self._pending and self._pending[0][1].query():
                    self._pending.popleft()
                    self._since = time.monotonic()
                if not self._pending or (
                        not self._error
                        and time.monotonic() - self._since <= self.timeout):
                    continue
                first, last = self._pending[0][0], self._pending[-1][0]
            if not self._error:
                self._error = self._missing(first)
            if last > self._released:
                self._release(last)

    def _words(self) -> np.ndarray:
        """This rank's flag and ack words, read on the watchdog's stream
        (the exchange's stream may be blocked on them)."""
        n = (self._layouts[self.rank][4] - self._layouts[self.rank][2]) // 4
        view = torch.as_tensor(_DeviceArray(self.flags_ptr, (n,), 4))
        with torch.cuda.stream(self._side):
            return view.to("cpu").numpy().view(np.uint32)

    def _missing(self, seq: int) -> str:
        """Which awaited word of exchange ``seq`` has not arrived."""
        words = self._words()
        rows = (self.acks_ptr - self.flags_ptr) // 4
        lo = self.ranges[self.rank][0]
        pre, post = peer_schedule(self._counts, self.ranges, self.rank, seq,
                                  self.gate)
        for op, (kind, row, col), value in pre + post:
            i = (row - lo) * self.nparts + col + (rows if kind == "ack"
                                                  else 0)
            # the cyclic >= of CU_STREAM_WAIT_VALUE_GEQ
            if op == "wait" and (int(words[i]) - value) & 0x80000000:
                if kind == "flag":
                    return (f"a sender's flag (part {col} to part {row}, "
                            f"exchange {seq})")
                return (f"a receiver's ack (part {col} of part {row}'s "
                        f"window, exchange {seq})")
        return f"a peer's flag or ack (exchange {seq})"

    def _release(self, seq: int) -> None:
        """Write ``seq`` into every own flag and ack word from the
        watchdog's stream: every wait up to exchange ``seq`` passes."""
        n = self.nlocal * self.nparts
        k = np.arange(n, dtype=np.uint64) * 4
        addr = np.concatenate([self.flags_ptr + k, self.acks_ptr + k])
        self.enqueue(_MemOps(addr, np.zeros(2 * n, dtype=np.int64),
                             np.zeros(2 * n, dtype=np.int32)), seq,
                     self._side.cuda_stream)
        self._released = seq

    def check(self) -> None:
        """Raise if the watchdog released a wait (a peer stopped)."""
        if self._error:
            raise RuntimeError(
                f"halo_put_peer: {self._error} did not arrive within "
                f"{self.timeout:g} s: a peer rank stopped or fell behind")

    def close(self, timeout: float = 120.0) -> None:
        """Stop the watchdog, unmap the peers and free this rank's
        memory, after a barrier on either side (collective: every rank
        calls it)."""
        from acg_tpu_torch.parallel.erragree import barrier
        if self._own is None:
            return
        torch.cuda.synchronize(self.device)
        self._stop.set()
        self._thread.join(timeout=self.timeout + 10.0)
        self._lib.acg_stream_destroy(self._side.cuda_stream)
        self._planes = []
        barrier("k6peer-close", timeout=timeout)
        for ptr in self._opened:
            self._lib.acg_ipc_close(ptr)
        self._opened = []
        barrier("k6peer-free", timeout=timeout)
        self._lib.acg_ipc_free(self._own)
        self._own = None


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
