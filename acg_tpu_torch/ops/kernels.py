"""The port's hand-written Hopper kernels: wrappers, plain versions and
launch counters.

Each TPU kernel of ``acg_tpu/ops/pallas_kernels.py`` and
``acg_tpu/parallel/halo_dma.py`` on the ported paths has a CUDA C++
counterpart under ``csrc/`` (built by :mod:`acg_tpu_torch.ops._build`)
and, beside it here, a plain PyTorch version written as the JAX
formulation is:

=====================  ==========================  =======================
wrapper                CUDA source                 replaces (TPU kernel)
=====================  ==========================  =======================
:func:`dia_spmv`       ``csrc/dia_spmv.cu``        ``dia_spmv`` (K1, also
                                                   batched over parts) and
                                                   ``dia_spmv_dot`` (K2)
:func:`cg_phase_a`     ``csrc/cg_fused.cu``        ``cg_phase_a`` (K3)
:func:`cg_phase_b`     ``csrc/cg_fused.cu``        ``cg_phase_b`` (K4)
:func:`pipelined_update` ``csrc/pipelined_update.cu`` ``fused_pipelined_
                                                   update`` (K5)
:func:`halo_put`       ``csrc/halo_put.cu``        ``_exchange_kernel``
                                                   (K6, halo_dma.py)
:func:`halo_put_peer`  ``csrc/halo_put.cu``        the same, its cross-
                                                   process form (K6
                                                   across ranks)
:func:`stencil_spmv`   ``csrc/stencil_spmv.cu``    ``_stencil_poisson_
                                                   call`` (K7, also
                                                   stacked over parts)
:func:`part_dot`       ``csrc/part_dot.cu``        no TPU kernel: the
                                                   per-part dots of the
                                                   multi-part tiers (an
                                                   XLA dot there)
=====================  ==========================  =======================

A wrapper takes the plain version for tensors on the CPU -- and only
because they lie there; for CUDA tensors it launches its kernel or
raises.  :data:`launches` counts kernel launches per wrapper (plain
calls are not counted; K1 and K7 count their stacked (P, n) forms apart,
as ``dia_spmv_batched`` and ``stencil_spmv_batched``, and
:data:`dia_spmv_types` splits K1's by dtype pair), so a run can show
that its path went through the kernels.

The route predicates :func:`dia_spmv_route` / :func:`fused_cg_route`
are copies of the JAX package's, kept so that the solvers refuse the same
configurations (the CUDA kernels themselves take any shape).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from acg_tpu_torch.ops import _build
from acg_tpu_torch.ops.spmv import MAX_DIAGS, acc_dtype, dia_mv, dia_mv_acc

# kernel launches per wrapper since the last reset_launches()
launches = {"dia_spmv": 0, "dia_spmv_batched": 0, "cg_phase_a": 0,
            "cg_phase_b": 0, "pipelined_update": 0, "halo_put": 0,
            "halo_put_peer": 0, "stencil_spmv": 0,
            "stencil_spmv_batched": 0, "part_dot": 0}

# K1's launches of the same period by (planes, x) dtype pair, e.g.
# "bf16/f32" for the mixed product
dia_spmv_types: dict = {}

_BLOCK = 256  # csrc/common.cuh kBlock: threads per block

_SHORT = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    dia_spmv_types.clear()


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_vectors(name, dtypes, *vecs, n=None):
    """Every vector a contiguous 1-D CUDA tensor of length n on the first
    vector's device, with a dtype in ``dtypes``."""
    dev = vecs[0].device
    n = vecs[0].shape[0] if n is None else n
    for v in vecs:
        if v.device != dev or v.dim() != 1 or v.shape[0] != n \
                or not v.is_contiguous() or v.dtype not in dtypes:
            raise ValueError(
                f"{name}: expected contiguous 1-D {n}-vectors of one of "
                f"{[str(d) for d in dtypes]} on {dev}, got "
                f"{v.dtype} {tuple(v.shape)} on {v.device}")
    return dev, n


def _check_scalars(name, dtype, dev, *scalars):
    for s in scalars:
        if s is None:
            continue
        if s.device != dev or s.numel() != 1 or s.dtype != dtype:
            raise ValueError(f"{name}: expected one-element {dtype} device "
                             f"scalars on {dev}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")


def _check_planes(name, planes, n, dev, allowed):
    if planes.device != dev or planes.dim() != 2 \
            or planes.shape[1] != n or not planes.is_contiguous() \
            or planes.dtype not in allowed:
        raise ValueError(f"{name}: planes must be a contiguous (ndiags, {n}) "
                         f"tensor on {dev} in one of "
                         f"{[str(d) for d in allowed]}, got {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}")


def _check_offsets_t(name, offsets_t, nd, dev):
    if offsets_t is None or offsets_t.device != dev \
            or offsets_t.dtype != torch.int64 or offsets_t.numel() != nd:
        raise ValueError(f"{name}: offsets_t must be an int64 tensor of "
                         f"{nd} offsets on {dev}")


def _live_flag(name, live, dev):
    if live is None:
        return None
    if live.device != dev or live.numel() != 1 or live.dtype != torch.bool:
        raise ValueError(f"{name}: live must be a one-element bool tensor "
                         f"on {dev}")
    return live


# -- K1/K2: DIA SpMV, optionally with its (x, y) dot --------------------

# (plane dtype, x dtype) pairs the CUDA kernel is instantiated for
DIA_SPMV_TYPES = {(torch.float64, torch.float64),
                  (torch.float32, torch.float32),
                  (torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32)}


def dia_spmv_plain(planes, offsets, x, with_dot: bool = False):
    """``y = A x`` for square DIA planes (``acg_tpu.ops.spmv.dia_mv``'s
    formulation) and, with the dot, ``(y, x . y)`` where the dot takes
    the unrounded accumulation as the TPU kernel does.  A stacked x (P,
    n) with planes (ndiags, P, n) is the per-part ``dia_mv``."""
    n = x.shape[-1]
    acc = dia_mv_acc(planes, offsets, n, x)
    y = acc.to(x.dtype)
    if with_dot:
        return y, torch.dot(acc, x.to(acc.dtype))
    return y


@dataclasses.dataclass(frozen=True)
class DiaTilePlan:
    """How K1 (``csrc/dia_spmv.cu``) cuts one DIA product: each thread
    owns ``rows_per_thread`` rows (one 16-byte vector of every plane), a
    block a tile of ``tile`` rows of one part, ``nblocks`` tiles per part
    (also the count of the dot's partial sums).  ``index_bits`` is 32
    while every plane and row index fits 31 bits, else 64."""

    offsets: tuple
    rows_per_thread: int
    tile: int
    nblocks: int
    index_bits: int

    def packed(self):
        """The int64 array ``acg_dia_spmv`` reads: rows, tile, nd, bits,
        then the offsets in accumulation order."""
        vals = [self.rows_per_thread, self.tile, len(self.offsets),
                self.index_bits, *self.offsets]
        return (ctypes.c_longlong * len(vals))(*vals)


_packed_plan = functools.lru_cache(maxsize=256)(DiaTilePlan.packed)


@functools.lru_cache(maxsize=256)
def dia_tile_plan(offsets: tuple, n: int, dtype,
                  nparts: int = 1) -> DiaTilePlan:
    """K1's plan for ``planes`` of ``dtype`` with these ``offsets`` over
    ``nparts`` parts of ``n`` rows."""
    offsets = tuple(int(o) for o in offsets)
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"dia_spmv: 1 to {MAX_DIAGS} diagonals, got "
                         f"{len(offsets)}")
    R = 16 // _itemsize(dtype)
    T = _BLOCK * R
    span = max(abs(o) for o in offsets)
    big = max(len(offsets) * nparts * n, nparts * n + span + 2 * T)
    return DiaTilePlan(offsets, R, T, max(1, -(-n // T)),
                       32 if big < 2 ** 31 else 64)


def dia_spmv(planes, offsets, x, *, with_dot: bool = False):
    """``y = A x`` for square DIA ``planes`` ((ndiags, n)) with static
    ``offsets``; with ``with_dot`` also ``x . y`` as a one-element tensor
    in the accumulation dtype.  The kernel takes the offsets by value in
    its launch plan (:func:`dia_tile_plan`).

    Batched over parts: x of shape (P, n) with planes (ndiags, P, n)
    multiplies every part by its own planes with its own edges [0, n)
    (one launch, grid.y = P); the dot is single-part only."""
    if x.device.type == "cpu":
        return dia_spmv_plain(planes, offsets, x, with_dot)
    kinds = (torch.float64, torch.float32, torch.bfloat16)
    stacked = x.dim() == 2
    if with_dot and stacked:
        raise ValueError("dia_spmv: the dot epilogue is single-part; got "
                         f"a stacked x {tuple(x.shape)}")
    if stacked:
        dev, nparts, n = x.device, x.shape[0], x.shape[1]
        if not x.is_contiguous() or x.dtype not in kinds:
            raise ValueError(f"dia_spmv: expected a contiguous (P, n) x in "
                             f"one of {[str(d) for d in kinds]}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if (planes.dim() != 3 or tuple(planes.shape[1:]) != (nparts, n)
                or not planes.is_contiguous()):
            raise ValueError(f"dia_spmv: stacked planes must be a "
                             f"contiguous (ndiags, {nparts}, {n}) tensor, "
                             f"got {tuple(planes.shape)}")
        _check_planes("dia_spmv", planes.view(planes.shape[0], -1),
                      nparts * n, dev, kinds)
    else:
        dev, n = _check_vectors("dia_spmv", kinds, x)
        nparts = 1
        _check_planes("dia_spmv", planes, n, dev, kinds)
    if (planes.dtype, x.dtype) not in DIA_SPMV_TYPES:
        raise ValueError(f"dia_spmv: no kernel for {planes.dtype} planes "
                         f"with {x.dtype} x")
    plan = dia_tile_plan(tuple(offsets), n, planes.dtype, nparts)
    packed = _packed_plan(plan)
    codes = _build.DTYPE_CODES
    y = torch.empty_like(x)
    part = dot = None
    if with_dot:
        adt = acc_dtype(x.dtype)
        part = torch.empty(plan.nblocks, dtype=adt, device=dev)
        dot = torch.empty((), dtype=adt, device=dev)
    err = _build.lib().acg_dia_spmv(
        codes[planes.dtype], codes[x.dtype], planes.data_ptr(), packed,
        nparts, n, x.data_ptr(), y.data_ptr(), _ptr(part), _ptr(dot),
        _stream())
    _build.check("dia_spmv", err)
    launches["dia_spmv_batched" if stacked else "dia_spmv"] += 1
    pair = f"{_SHORT[planes.dtype]}/{_SHORT[x.dtype]}"
    dia_spmv_types[pair] = dia_spmv_types.get(pair, 0) + 1
    return (y, dot) if with_dot else y


# -- K3/K4: the two phases of the fused classic-CG iteration ------------

FUSED_TYPES = {(torch.float32, torch.float32),
               (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)}


def cg_phase_a_plain(planes, offsets, r, p_old, gamma, gamma_prev,
                     live=None):
    """``p = r + (gamma/gamma_prev) p_old`` (beta = 0 when gamma_prev =
    inf), ``t = A p`` and ``(p, t)``, in f32 with each vector rounded once
    to ``r.dtype``; a false ``live`` takes ``p = p_old``."""
    f32 = torch.float32
    beta = gamma / gamma_prev
    p = (r.to(f32) + beta * p_old.to(f32)).to(r.dtype)
    if live is not None:
        p = torch.where(live, p, p_old)
    acc = dia_mv_acc(planes, offsets, r.shape[0], p)
    return p, acc.to(r.dtype), torch.dot(acc, p.to(f32))


def cg_phase_a(planes, offsets, r, p_old, gamma, gamma_prev, *,
               offsets_t=None, live=None):
    """Phase A of the fused classic-CG iteration: returns new tensors
    ``(p, t, pdott)`` -- see :func:`cg_phase_a_plain`.  ``gamma`` and
    ``gamma_prev`` are one-element f32 device tensors; ``live`` an
    optional one-element bool tensor.  The kernel reads the offsets from
    ``offsets_t`` and cuts the rows as K1's plan for the planes' dtype
    says (:func:`dia_tile_plan`)."""
    if r.device.type == "cpu":
        return cg_phase_a_plain(planes, offsets, r, p_old, gamma, gamma_prev,
                                live)
    dev, n = _check_vectors("cg_phase_a", (torch.float32, torch.bfloat16),
                            r, p_old)
    if p_old.dtype != r.dtype:
        raise ValueError("cg_phase_a: r and p_old must share a dtype")
    _check_planes("cg_phase_a", planes, n, dev,
                  (torch.float32, torch.bfloat16))
    _check_offsets_t("cg_phase_a", offsets_t, planes.shape[0], dev)
    if (planes.dtype, r.dtype) not in FUSED_TYPES:
        raise ValueError(f"cg_phase_a: no kernel for {planes.dtype} planes "
                         f"with {r.dtype} vectors")
    _check_scalars("cg_phase_a", torch.float32, dev, gamma, gamma_prev)
    live = _live_flag("cg_phase_a", live, dev)
    plan = dia_tile_plan(tuple(offsets), n, planes.dtype)
    codes = _build.DTYPE_CODES
    p = torch.empty_like(r)
    t = torch.empty_like(r)
    part = torch.empty(plan.nblocks, dtype=torch.float32, device=dev)
    pdott = torch.empty((), dtype=torch.float32, device=dev)
    err = _build.lib().acg_cg_phase_a(
        codes[planes.dtype], codes[r.dtype], planes.data_ptr(),
        offsets_t.data_ptr(), planes.shape[0], n, plan.rows_per_thread,
        plan.index_bits, r.data_ptr(), p_old.data_ptr(), gamma.data_ptr(),
        gamma_prev.data_ptr(), _ptr(live), p.data_ptr(), t.data_ptr(),
        part.data_ptr(), pdott.data_ptr(), _stream())
    _build.check("cg_phase_a", err)
    launches["cg_phase_a"] += 1
    return p, t, pdott


def cg_phase_b_plain(x, p, r, t, gamma, pdott, live=None):
    """``alpha = gamma/(p,t); x + alpha p; r - alpha t`` in f32, each
    rounded once to the vector dtype, and ``gamma' = (r, r)`` of the
    rounded r; a false ``live`` leaves x and r as they are.  Returns new
    tensors ``(x, r, gamma')``."""
    f32 = torch.float32
    alpha = gamma / pdott
    xn = (x.to(f32) + alpha * p.to(f32)).to(x.dtype)
    rn = (r.to(f32) - alpha * t.to(f32)).to(r.dtype)
    if live is not None:
        xn = torch.where(live, xn, x)
        rn = torch.where(live, rn, r)
    rf = rn.to(f32)
    return xn, rn, torch.dot(rf, rf)


def cg_phase_b_plan(n: int, dtype) -> tuple[int, int]:
    """How K4 (``csrc/cg_fused.cu``) cuts ``n`` rows of ``dtype`` vectors:
    ``(rows a thread, blocks)`` -- one 16-byte vector of each vector a
    thread, a tile of 256 of them a block, one partial of ``(r, r)`` a
    block."""
    rows = 16 // _itemsize(dtype)
    return rows, max(1, -(-n // (_BLOCK * rows)))


def cg_phase_b(x, p, r, t, gamma, pdott, *, live=None):
    """Phase B of the fused classic-CG iteration: updates ``x`` and ``r``
    IN PLACE (see :func:`cg_phase_b_plain`) and returns ``(x, r,
    gamma')`` with ``gamma'`` a one-element f32 tensor.  The kernel cuts
    the rows as :func:`cg_phase_b_plan` says."""
    if x.device.type == "cpu":
        xn, rn, g = cg_phase_b_plain(x, p, r, t, gamma, pdott, live)
        x.copy_(xn)
        r.copy_(rn)
        return x, r, g
    dev, n = _check_vectors("cg_phase_b", (torch.float32, torch.bfloat16),
                            x, p, r, t)
    if len({v.dtype for v in (x, p, r, t)}) != 1:
        raise ValueError("cg_phase_b: x, p, r, t must share a dtype")
    _check_scalars("cg_phase_b", torch.float32, dev, gamma, pdott)
    live = _live_flag("cg_phase_b", live, dev)
    rows, nblocks = cg_phase_b_plan(n, x.dtype)
    part = torch.empty(nblocks, dtype=torch.float32, device=dev)
    g = torch.empty((), dtype=torch.float32, device=dev)
    err = _build.lib().acg_cg_phase_b(
        _build.DTYPE_CODES[x.dtype], n, rows, x.data_ptr(), p.data_ptr(),
        r.data_ptr(), t.data_ptr(), gamma.data_ptr(), pdott.data_ptr(),
        _ptr(live), part.data_ptr(), g.data_ptr(), _stream())
    _build.check("cg_phase_b", err)
    launches["cg_phase_b"] += 1
    return x, r, g


# -- K5: the pipelined-CG 6-vector update -------------------------------

def pipelined_update_plain(x, r, w, p, t, z, q, alpha, beta):
    """The Ghysels-Vanroose update as the JAX pipelined loop body
    computes it (``solvers/jax_cg.py:963-973``): in the scalars' dtype,
    each output rounded once to the vector dtype, x/r/w taking the
    rounded p/t/z.  Returns new tensors ``(x, r, w, p, t, z)``."""
    sdt = alpha.dtype

    def store(v):
        return v.to(x.dtype)

    z = store(q.to(sdt) + beta * z.to(sdt))
    t = store(w.to(sdt) + beta * t.to(sdt))
    p = store(r.to(sdt) + beta * p.to(sdt))
    x = store(x.to(sdt) + alpha * p.to(sdt))
    r = store(r.to(sdt) - alpha * t.to(sdt))
    w = store(w.to(sdt) - alpha * z.to(sdt))
    return x, r, w, p, t, z


def pipelined_update(x, r, w, p, t, z, q, alpha, beta, *, live=None):
    """Updates ``x, r, w, p, t, z`` IN PLACE (see
    :func:`pipelined_update_plain`) and returns them; ``alpha``/``beta``
    are one-element tensors in the accumulation dtype, ``live`` an
    optional one-element bool tensor whose False leaves all six
    untouched."""
    vecs = (x, r, w, p, t, z)
    if x.device.type == "cpu":
        new = pipelined_update_plain(x, r, w, p, t, z, q, alpha, beta)
        for old, nv in zip(vecs, new):
            old.copy_(nv if live is None else torch.where(live, nv, old))
        return vecs
    dev, n = _check_vectors("pipelined_update",
                            (torch.float64, torch.float32, torch.bfloat16),
                            *vecs, q)
    if len({v.dtype for v in (*vecs, q)}) != 1:
        raise ValueError("pipelined_update: vectors must share a dtype")
    _check_scalars("pipelined_update", acc_dtype(x.dtype), dev, alpha, beta)
    live = _live_flag("pipelined_update", live, dev)
    err = _build.lib().acg_pipelined_update(
        _build.DTYPE_CODES[x.dtype], n, *(v.data_ptr() for v in vecs),
        q.data_ptr(), alpha.data_ptr(), beta.data_ptr(), _ptr(live),
        _stream())
    _build.check("pipelined_update", err)
    launches["pipelined_update"] += 1
    return vecs


# -- K6: the one-sided halo exchange, stacked on one card ----------------

def halo_put_plain(send, send_counts, recv, gate_by_counts: bool = True):
    """``recv[p, q] = send[q, p]`` for every pair ``q != p`` -- with
    ``gate_by_counts`` only where ``send_counts[q, p] > 0`` -- IN PLACE;
    other rows of ``recv`` keep their values.  Returns ``recv``."""
    P = send.shape[0]
    mask = ~torch.eye(P, dtype=torch.bool, device=send.device)
    if gate_by_counts:
        mask = mask & (send_counts.T > 0)
    recv.copy_(torch.where(mask[..., None], send.transpose(0, 1), recv))
    return recv


def halo_put(send, send_counts, recv, *, gate_by_counts: bool = True):
    """The transport of the ``--comm dma`` halo exchange: writes into
    ``recv`` (P, P, maxcnt) IN PLACE what :func:`halo_put_plain` writes,
    from the stacked send plane ``send`` (P, P, maxcnt) and the int32
    ``send_counts`` (P, P) on the same device.  Returns ``recv``."""
    if send.device.type == "cpu":
        return halo_put_plain(send, send_counts, recv, gate_by_counts)
    dev = send.device
    if (send.dim() != 3 or send.shape[0] != send.shape[1]
            or not send.is_contiguous() or send.element_size() not in
            (8, 4, 2)):
        raise ValueError(f"halo_put: send must be a contiguous (P, P, "
                         f"maxcnt) plane of 8-, 4- or 2-byte elements, got "
                         f"{send.dtype} {tuple(send.shape)}")
    if (recv.device != dev or recv.shape != send.shape
            or recv.dtype != send.dtype or not recv.is_contiguous()):
        raise ValueError(f"halo_put: recv must be a contiguous "
                         f"{tuple(send.shape)} {send.dtype} plane on {dev}")
    P = send.shape[0]
    if (send_counts.device != dev or send_counts.dtype != torch.int32
            or send_counts.shape != (P, P)
            or not send_counts.is_contiguous()):
        raise ValueError(f"halo_put: send_counts must be a contiguous "
                         f"({P}, {P}) int32 tensor on {dev}")
    err = _build.lib().acg_halo_put(
        send.element_size(), send.data_ptr(), send_counts.data_ptr(), P,
        send.shape[2], int(bool(gate_by_counts)), recv.data_ptr(), _stream())
    _build.check("halo_put", err)
    launches["halo_put"] += 1
    return recv


# -- K6 across processes: puts into peer ranks' receive planes ----------

def halo_put_peer_plain(send, send_counts, recv, ranges, rank: int,
                        gate_by_counts: bool = True):
    """The cross-process K6 on CPU tensors: rank ``rank`` owns parts
    ``ranges[rank] = (lo, hi)``; ``send`` (nlocal, nparts, maxcnt) is its
    send plane and ``recv`` (nlocal, nparts, maxcnt) its receive plane.
    For every pair ``q != p`` with p one of this rank's parts -- with
    ``gate_by_counts`` only where ``send_counts[q, p] > 0`` -- it writes
    ``recv[p - lo, q] = send_q[p]`` IN PLACE through one
    ``torch.distributed.all_to_all_single`` of the planes' bytes (the
    collective gloo provides; :func:`acg_tpu_torch.parallel.halo.
    transpose_ranks`); other rows keep their values.  Returns
    ``recv``."""
    from acg_tpu_torch.parallel.halo import transpose_ranks

    lo, hi = ranges[rank]
    P = send.shape[1]
    got = transpose_ranks(send, ranges, rank)
    mask = (torch.arange(lo, hi)[:, None] != torch.arange(P)[None, :])
    if gate_by_counts:
        mask = mask & (send_counts.T[lo:hi] > 0)
    recv.copy_(torch.where(mask[..., None], got, recv))
    return recv


def halo_put_peer(send, send_counts, recv, ranges, rank: int, *,
                  peer=None, gate_by_counts: bool = True):
    """The transport of ``--comm dma`` across ranks: what
    :func:`halo_put_peer_plain` writes, into this rank's receive plane.
    CPU tensors take the plain version into ``recv``.  On the card
    ``peer`` (:class:`~acg_tpu_torch.parallel.halo_dma.PeerPlanes`, whose
    counts and gate were fixed when it was made) holds the receive
    planes every rank maps; one call launches the put of the next
    exchange and its wait, counts once, and returns the receive plane of
    that exchange (``recv`` is not used).  A wait that timed out in an
    earlier exchange raises here."""
    if send.device.type == "cpu":
        return halo_put_peer_plain(send, send_counts, recv, ranges, rank,
                                   gate_by_counts)
    if peer is None or peer.gate != bool(gate_by_counts):
        raise ValueError("halo_put_peer: CUDA tensors need the peer "
                         "planes (parallel.halo_dma.PeerPlanes) made with "
                         "this gate")
    lo, hi = ranges[rank]
    shape = (hi - lo, peer.nparts, peer.maxcnt)
    if (send.device != peer.device or tuple(send.shape) != shape
            or send.dtype != peer.dtype or not send.is_contiguous()):
        raise ValueError(f"halo_put_peer: send must be a contiguous "
                         f"{shape} {peer.dtype} plane on {peer.device}, "
                         f"got {send.dtype} {tuple(send.shape)} on "
                         f"{send.device}")
    peer.check()
    seq = peer.seq + 1
    lib = _build.lib()
    err = lib.acg_halo_put_peer(
        send.element_size(), send.data_ptr(), peer.counts.data_ptr(),
        peer.nparts, lo, hi - lo, peer.maxcnt, int(peer.gate),
        peer.tab.data_ptr(), seq % 2, seq, peer.done.data_ptr(), _stream())
    _build.check("halo_put_peer", err)
    err = lib.acg_halo_wait_peer(
        peer.counts.data_ptr(), peer.nparts, lo, hi - lo, int(peer.gate),
        peer.tab.data_ptr(), peer.flags_ptr, peer.acks_ptr, seq,
        int(peer.timeout * 1e9), peer.err_dev, _stream())
    _build.check("halo_wait_peer", err)
    peer.seq = seq
    launches["halo_put_peer"] += 1
    return peer.plane(seq % 2)


# -- the per-part dots of stacked vectors -------------------------------

# elements a plain per-part dot row is padded to (512 bytes of f64, 256
# of f32): every row of the product starts past any vector width the
# reductions load with, as a fresh allocation does
_ROW_ALIGN = 64

# each stream's per-row tickets of csrc/part_dot.cu (zero between
# launches), by (device index, stream)
_dot_tickets: dict = {}


def part_dot_plain(a, c, sdt):
    """Per-part dots of stacked vectors in the scalar dtype ``sdt``:
    (P, n) x 2 -> (P,), ``(a.to(sdt) * c.to(sdt)).sum()`` row by row.

    One reduction per part row, each row starting on a 512-byte
    boundary: a reduction over the last axis of a (P, n) tensor picks its
    split of the rows by P (on the CPU one row alone is split over the
    threads), and vectorizes by its data's alignment, so a part's dot
    would depend on how many parts the tensor stacks and where its row
    sits.  Row by row, from aligned rows, a part's dot has the same bits
    whatever stacks it."""
    P, n = a.shape[0], a.shape[-1]
    pitch = -(-n // _ROW_ALIGN) * _ROW_ALIGN
    prod = torch.empty((P, pitch), dtype=sdt, device=a.device)[:, :n]
    torch.mul(a.to(sdt), c.to(sdt), out=prod)
    return torch.stack([prod[p].sum() for p in range(P)])


def part_dot(a, c, sdt):
    """What :func:`part_dot_plain` computes, in one launch of
    ``csrc/part_dot.cu`` on the card: each row summed in an order fixed
    by n alone, so a part's dot has the same bits whatever stacks it and
    wherever its row starts.  CPU tensors take the plain version.  Both
    operands have one dtype and unit-stride rows."""
    if a.device.type == "cpu":
        return part_dot_plain(a, c, sdt)
    codes = _build.DTYPE_CODES
    if (a.dim() != 2 or tuple(c.shape) != tuple(a.shape)
            or c.device != a.device or a.stride(-1) != 1
            or c.stride(-1) != 1 or a.dtype not in codes
            or c.dtype != a.dtype
            or sdt not in (torch.float64, torch.float32)
            or not 0 < a.shape[0] <= 65535):
        raise ValueError(f"part_dot: expected two (P, n) CUDA tensors of "
                         f"one of f64/f32/bf16 with unit-stride rows (P <= "
                         f"65535) and an f64 or f32 scalar dtype, got "
                         f"{a.dtype} {tuple(a.shape)} on {a.device}, "
                         f"{c.dtype} {tuple(c.shape)} on {c.device}, {sdt}")
    P, n = a.shape
    out = torch.empty(P, dtype=sdt, device=a.device)
    lib = _build.lib()
    nb = lib.acg_part_dot_blocks(n)
    part = torch.empty(P * nb, dtype=sdt, device=a.device)
    stream = _stream()
    key = (a.device.index, stream)
    ticket = _dot_tickets.get(key)
    if ticket is None or ticket.numel() < P:
        ticket = torch.zeros(max(P, 64), dtype=torch.int32,
                             device=a.device)
        _dot_tickets[key] = ticket
    err = lib.acg_part_dot(codes[a.dtype], codes[sdt], P, n,
                           a.data_ptr(), a.stride(0), c.data_ptr(),
                           c.stride(0), part.data_ptr(), ticket.data_ptr(),
                           out.data_ptr(), stream)
    _build.check("part_dot", err)
    launches["part_dot"] += 1
    return out


# -- K7: the matrix-free Poisson stencil SpMV ----------------------------

# vector dtypes K7 is instantiated for (operators run f32 and f64)
STENCIL_TYPES = (torch.float64, torch.float32)


def stencil_spmv_plain(op, x, row0=None, nowned=None):
    """``y = A x`` for a constant-coefficient Poisson
    :class:`~acg_tpu_torch.ops.operator.StencilOperator` as the JAX
    package computes it: the shifted-view apply (``op.matfree_apply``)
    for a whole-grid x; for a stacked x (P, nrows) with per-part ``row0``
    and ``nowned`` (P,) tensors, the generated local planes through
    ``dia_mv`` (``StackedLocalBlock.shard_mv``'s matfree form)."""
    if row0 is None:
        return op.matfree_apply(x)
    nrows = x.shape[-1]
    planes = op.planes(row0=row0, nrows=nrows, nowned=nowned)
    return dia_mv(planes, op.offsets, nrows, x)


def stencil_spmv(op, x, *, row0=None, nowned=None):
    """``y = A x`` for a constant-coefficient Poisson operator with the
    coefficients made in the kernel (no plane exists): x of the whole
    grid ((N,), N = n^dim), or stacked over parts ((P, nrows)) with the
    per-part first global row ``row0`` and owned count ``nowned`` as
    (P,) int64 tensors on x's device -- see :func:`stencil_spmv_plain`.
    f32 and f64 only."""
    if x.device.type == "cpu":
        return stencil_spmv_plain(op, x, row0, nowned)
    if getattr(op, "kind", None) != "poisson":
        raise ValueError(f"stencil_spmv: the kernel computes the constant-"
                         f"coefficient Poisson stencil, got "
                         f"{getattr(op, 'kind', type(op).__name__)!r}")
    n, dim = op.grid
    stacked = row0 is not None
    if stacked:
        dev = x.device
        if (x.dim() != 2 or not x.is_contiguous()
                or x.dtype not in STENCIL_TYPES):
            raise ValueError(f"stencil_spmv: expected a contiguous (P, "
                             f"nrows) x in one of "
                             f"{[str(d) for d in STENCIL_TYPES]}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        nparts, nrows = x.shape
        for name, t in (("row0", row0), ("nowned", nowned)):
            if (t is None or t.device != dev or t.dtype != torch.int64
                    or t.shape != (nparts,) or not t.is_contiguous()):
                raise ValueError(f"stencil_spmv: {name} must be a "
                                 f"contiguous ({nparts},) int64 tensor on "
                                 f"{dev}")
    else:
        if nowned is not None:
            raise ValueError("stencil_spmv: nowned needs row0")
        _, nrows = _check_vectors("stencil_spmv", STENCIL_TYPES, x,
                                  n=op.nrows)
        nparts = 1
    if x.dtype != op.dtype:
        raise ValueError(f"stencil_spmv: {x.dtype} x for a {op.dtype} "
                         f"operator")
    y = torch.empty_like(x)
    err = _build.lib().acg_stencil_spmv(
        _build.DTYPE_CODES[x.dtype], dim, n, nparts, nrows, _ptr(row0),
        _ptr(nowned), x.data_ptr(), y.data_ptr(), _stream())
    _build.check("stencil_spmv", err)
    launches["stencil_spmv_batched" if stacked else "stencil_spmv"] += 1
    return y


# -- route predicates, copied from acg_tpu/ops/pallas_kernels.py ---------

# row-tile length of the TPU SpMV kernel
TILE = 16384


def dia_spmv_route(offsets: tuple, n: int, dtype, ndiags: int | None = None):
    """The route ``acg_tpu.ops.pallas_kernels.dia_spmv`` takes for this
    shape: ``("fast", Lpad, Rpad, tile, align)``, ``("clustered", central,
    far, Lpad, Rpad, tile, align)``, ``("padded",)`` or ``("xla",)``.
    The CUDA kernel has no routes; this copy decides the refusals the
    fused tier shares with the JAX package."""
    ndiags = len(offsets) if ndiags is None else ndiags
    L = max(0, -min(offsets))
    R = max(0, max(offsets))
    itemsize = _itemsize(dtype)
    budget = 12 * 2 ** 20

    def vmem_bytes(tile, halo):
        return (tile + 2 * halo + 2 * (ndiags + 1) * tile) * itemsize

    align = {4: 1024, 2: 2048}.get(itemsize)
    if align is not None:
        Lpad = L + (-L) % align
        Rpad = R + (-R) % align
        band = max(Lpad, Rpad)
        tile = TILE
        while tile < band and vmem_bytes(2 * tile, band) <= budget:
            tile *= 2
        if (band <= tile and n % tile == 0 and n >= tile
                and vmem_bytes(tile, band) <= budget):
            return ("fast", Lpad, Rpad, tile, align)
        clustered = _cluster_route(offsets, n, itemsize, align, budget,
                                   ndiags)
        if clustered is not None:
            return clustered
    if L + R >= TILE:
        return ("xla",)
    return ("padded",)


def _cluster_route(offsets, n, itemsize, align, budget, ndiags):
    """Multi-window route for clustered diagonals (3D Poisson's far
    +-n^2 offsets), as ``acg_tpu.ops.pallas_kernels._cluster_route``."""
    if n % TILE or n < TILE:
        return None
    sorted_offs = sorted(offsets)
    clusters: list[list[int]] = [[sorted_offs[0]]]
    for o in sorted_offs[1:]:
        if o - clusters[-1][-1] > TILE // 2:
            clusters.append([o])
        else:
            clusters[-1].append(o)
    if len(clusters) < 2:
        return None
    central = min(clusters, key=lambda c: min(abs(o) for o in c))
    far = [c for c in clusters if c is not central]
    if any(len(c) != 1 or c[0] % TILE or abs(c[0]) >= n for c in far):
        return None
    L = max(0, -min(central))
    R = max(0, max(central))
    Lpad = L + (-L) % align
    Rpad = R + (-R) % align
    if max(Lpad, Rpad) > TILE:
        return None

    def vmem(tile):
        return (tile + Lpad + Rpad + len(far) * tile
                + 2 * (ndiags + 1) * tile) * itemsize

    tile = TILE
    while (n % (2 * tile) == 0 and vmem(2 * tile) <= budget
           and all(c[0] % (2 * tile) == 0 for c in far)):
        tile *= 2
    if vmem(tile) > budget:
        return None
    return ("clustered", tuple(central), tuple(c[0] for c in far),
            Lpad, Rpad, tile, align)


def fused_cg_route(offsets: tuple, n: int, dtype) -> tuple | None:
    """``(Lpad, Rpad, tile, align)`` when the JAX package's two-phase
    fused CG iteration supports this shape (square DIA, single-window
    band, n divisible by the tile, 2- or 4-byte vectors), else None --
    the port's fused tier refuses exactly where the JAX one does."""
    route = dia_spmv_route(offsets, n, dtype)
    if route[0] != "fast":
        return None
    Lpad, Rpad, tile, align = route[1:]
    ndiags = len(offsets)
    itemsize = _itemsize(dtype)
    budget = 12 * 2 ** 20

    def vmem(t):
        return (4 * (t + Lpad + Rpad) + 2 * (ndiags + 2) * t) * itemsize

    while n % (2 * tile) == 0 and vmem(2 * tile) <= budget:
        tile *= 2
    return Lpad, Rpad, tile, align
