"""Mesh reductions on stacked parts.

The counterpart of ``acg_tpu/parallel/reductions.py``.  A global
dot is a per-part dot (``ldot``: the (nparts,) local dots of stacked
vectors) followed by ``psum``, which on stacked parts is a sum over the
parts axis.  :func:`psum` folds the parts one after another in part
order, so the result does not depend on how a reduction kernel would
split the axis.  Across processes, :func:`make_rank_psum` first gathers
every rank's per-part partials into the (nparts, ...) stack, in part
order, and folds it the same way -- not ``all_reduce``, whose order
differs -- so a dot over ranks has the bits of the stacked tier's.
:func:`make_pdotk` fuses k dots into one ``psum`` -- the single fused
allreduce of pipelined CG.

The column variants :func:`make_pdot_cols` and :func:`make_pdotk_cols`
serve the batched tier: every per-RHS dot of a ``(nparts, n, B)`` block
in one psum of ``(nparts, B)`` (or ``(nparts, k, B)``) payloads, so the
reduction count does not grow with B.

``precise=True`` psums compensated (hi, lo) pairs
(:func:`acg_tpu_torch.ops.precision.dot_compensated` per part), so the
local summation error stays out of the global scalar.
"""

from __future__ import annotations

import torch

from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.ops.precision import dot_compensated


def psum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (parts) axis, folded in part order."""
    s = v[0]
    for p in range(1, v.shape[0]):
        s = s + v[p]
    return s


def make_ldot(sdt):
    """Per-part dots of stacked vectors, in the scalar dtype ``sdt``
    (bf16 storage is widened first): (nparts, n) x 2 -> (nparts,), each
    part's dot with the same bits whatever else the stack holds
    (:func:`acg_tpu_torch.ops.kernels.part_dot`) -- a rank of the
    multi-process tier stacks fewer parts than one process does."""
    def ldot(a, c):
        return K.part_dot(a, c, sdt)
    return ldot


def make_rank_psum(counts):
    """``psum`` across ranks: this rank's (nlocal, ...) per-part
    partials gathered with every rank's into (nparts, ...) (``counts``:
    each rank's part count, in rank order), then :func:`psum`.  Every
    rank folds the same values in the same order, so every rank holds
    the same bits."""
    from acg_tpu_torch import tracing
    from acg_tpu_torch.parallel import multihost

    def rank_psum(v):
        # a gloo gather leaves no device event: a capture sees it as a
        # "psum" span
        with tracing.host_span("psum", multihost.host_collectives()):
            return psum(multihost.gather_parts(v, counts))
    return rank_psum


def make_pdot(psum, ldot, sdt, precise: bool):
    """The single global dot product: ``pdot(a, c)`` = one psum of the
    per-part dots (plain) or of the per-part compensated hi/lo pairs
    (``precise``)."""
    if precise:
        def pdot(a, c):
            hi, lo = dot_compensated(a.to(sdt), c.to(sdt))
            pair = psum(torch.stack([hi, lo], dim=-1))
            return pair[0] + pair[1]
        return pdot

    def pdot(a, c):
        return psum(ldot(a, c))
    return pdot


def make_pdotk(psum, ldot, sdt, precise: bool):
    """``pdotk((a1, c1), ..., (ak, ck))`` -> k global scalars in ONE
    psum of the stacked (nparts, k) per-part dots, or of the (nparts,
    2k) interleaved hi/lo pairs (``precise``)."""
    if precise:
        def pdotk(*pairs):
            hls = [dot_compensated(a.to(sdt), c.to(sdt)) for a, c in pairs]
            flat = psum(torch.stack([v for hl in hls for v in hl], dim=-1))
            return tuple(flat[2 * i] + flat[2 * i + 1]
                         for i in range(len(pairs)))
        return pdotk

    def pdotk(*pairs):
        red = psum(torch.stack([ldot(a, c) for a, c in pairs], dim=-1))
        return tuple(red[i] for i in range(len(pairs)))
    return pdotk


def _comp_cols(a, c, sdt):
    """Per-part compensated column dots of ``(nparts, n, B)`` blocks:
    the (hi, lo) pairs, each ``(nparts, B)``."""
    return dot_compensated(a.to(sdt).transpose(-1, -2),
                           c.to(sdt).transpose(-1, -2))


def make_pdot_cols(psum, lcoldot, sdt, precise: bool):
    """The B-column global dot of the batched tier: ``pdot_cols(a, c)``
    = one psum of the per-part column dots ``lcoldot(a, c)`` (nparts,
    B), or of the stacked compensated hi/lo columns (``precise``)."""
    if precise:
        def pdot_cols(a, c):
            hi, lo = _comp_cols(a, c, sdt)
            pair = psum(torch.stack([hi, lo], dim=1))
            return pair[0] + pair[1]
        return pdot_cols

    def pdot_cols(a, c):
        return psum(lcoldot(a, c))
    return pdot_cols


def make_pdotk_cols(psum, lcoldot, sdt, precise: bool):
    """The B-column twin of :func:`make_pdotk`: ``pdotk_cols((A1, C1),
    ..., (Ak, Ck))`` -> k length-B columns in ONE psum of the (nparts,
    k, B) stack (or (nparts, 2k, B) interleaved hi/lo pairs)."""
    if precise:
        def pdotk_cols(*pairs):
            hls = [_comp_cols(a, c, sdt) for a, c in pairs]
            flat = psum(torch.stack([v for hl in hls for v in hl], dim=1))
            return tuple(flat[2 * i] + flat[2 * i + 1]
                         for i in range(len(pairs)))
        return pdotk_cols

    def pdotk_cols(*pairs):
        red = psum(torch.stack([lcoldot(a, c) for a, c in pairs], dim=1))
        return tuple(red[i] for i in range(len(pairs)))
    return pdotk_cols
