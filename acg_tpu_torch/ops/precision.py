"""Extended-precision building blocks for f32 (and bf16-stored) solves.

The counterpart of ``acg_tpu/ops/precision.py``, with the same names:

* **Error-free transforms** (:func:`two_sum`, :func:`split`,
  :func:`two_prod`; Knuth/Dekker): exact (hi, lo) representations of a
  sum and a product in the working precision.
* **Compensated reductions**: :func:`df_sum` tree-reduces along the last
  axis in double-float arithmetic (~2x working precision);
  :func:`dot_compensated` is the Ogita-Rump-Oishi dot2 built on it and
  :func:`dot2` collapses it to one scalar.  They carry the CG scalars of
  ``precise_dots`` solves, whose f32 rounding is what stalls plain f32
  CG near 1e-6 relative residuals.

The transforms are exact only if no product is contracted into a fused
multiply-add.  Every eager PyTorch op here is a kernel of its own, which
rounds its result once, so the plain form is exact: do not wrap these
functions in ``torch.compile`` or fuse them.

Every function works along the LAST axis, so stacked parts (P, n) reduce
to (P,) per-part pairs with the fold order of one part.
"""

from __future__ import annotations

import torch

_MANTISSA_BITS = {torch.float32: 24, torch.float64: 53, torch.bfloat16: 8,
                  torch.float16: 11}


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly (|e| <= ulp(s)/2)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def split(a):
    """Dekker split of a float into hi + lo with non-overlapping
    half-width mantissas (12+12 bits for f32, 27+26 for f64); the split
    constant follows the input dtype."""
    bits = _MANTISSA_BITS[a.dtype]
    c = (2.0 ** ((bits + 1) // 2) + 1.0) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker two-product: p + e == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """Double-float addition: (hi, lo) + (hi, lo) -> (hi, lo)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + xl + yl
    return two_sum(s, e)


def df_sum(hi: torch.Tensor, lo: torch.Tensor | None = None):
    """Tree-sum along the last axis in double-float arithmetic: zero-pad
    to a power of two, then fold the upper half onto the lower one with
    :func:`df_add` until one entry is left (the reference's fold order).
    Returns the (hi, lo) pair, scalars for a vector input."""
    if lo is None:
        lo = torch.zeros_like(hi)
    n = hi.shape[-1]
    p2 = 1 << max(0, (n - 1).bit_length())
    if p2 != n:
        hi = torch.nn.functional.pad(hi, (0, p2 - n))
        lo = torch.nn.functional.pad(lo, (0, p2 - n))
    while p2 > 1:
        half = p2 // 2
        hi, lo = df_add((hi[..., :half], lo[..., :half]),
                        (hi[..., half:], lo[..., half:]))
        p2 = half
    return hi[..., 0], lo[..., 0]


def dot_compensated(x: torch.Tensor, y: torch.Tensor):
    """Ogita-Rump-Oishi dot2 along the last axis: the dot product with
    ~2x working precision, as the (hi, lo) pair whose sum is the
    compensated value."""
    p, e = two_prod(x, y)
    return df_sum(p, e)


def dot2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated dot product collapsed to one working-precision value."""
    hi, lo = dot_compensated(x, y)
    return hi + lo
