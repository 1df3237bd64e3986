"""Mesh reductions on stacked parts.

The counterpart of ``acg_tpu/parallel/reductions.py:28-60``.  A global
dot is a per-part dot (``ldot``: the (nparts,) local dots of stacked
vectors) followed by ``psum``, which on stacked parts is a sum over the
parts axis.  :func:`psum` folds the parts one after another in part
order, so the result does not depend on how a reduction kernel would
split the axis.  :func:`make_pdotk` fuses k dots into one ``psum`` --
the single fused allreduce of pipelined CG.

Only the plain dots are ported: ``precise=True`` (compensated hi/lo
pairs) needs ``ops/precision.py``, which the port does not have yet.
"""

from __future__ import annotations

import torch


def psum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (parts) axis, folded in part order."""
    s = v[0]
    for p in range(1, v.shape[0]):
        s = s + v[p]
    return s


def make_ldot(sdt):
    """Per-part dots of stacked vectors, in the scalar dtype ``sdt``
    (bf16 storage is widened first): (nparts, n) x 2 -> (nparts,)."""
    def ldot(a, c):
        return (a.to(sdt) * c.to(sdt)).sum(-1)
    return ldot


def _refuse_precise(precise: bool) -> None:
    if precise:
        raise ValueError("precise dots (compensated hi/lo reductions) "
                         "need ops/precision.py, not yet ported")


def make_pdot(psum, ldot, sdt, precise: bool):
    """The single global dot product: ``pdot(a, c)`` = one psum of the
    per-part dots."""
    _refuse_precise(precise)

    def pdot(a, c):
        return psum(ldot(a, c))
    return pdot


def make_pdotk(psum, ldot, sdt, precise: bool):
    """``pdotk((a1, c1), ..., (ak, ck))`` -> k global scalars in ONE
    psum of the stacked (nparts, k) per-part dots."""
    _refuse_precise(precise)

    def pdotk(*pairs):
        red = psum(torch.stack([ldot(a, c) for a, c in pairs], dim=-1))
        return tuple(red[i] for i in range(len(pairs)))
    return pdotk
