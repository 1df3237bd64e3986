"""``jax.random.normal(jax.random.key(seed), (n,), dtype)`` without JAX.

The JAX package draws the sharded tier's manufactured solution from
JAX's threefry PRNG (``acg_tpu/parallel/sharded_dia.py:418-477``) with
``jax_threefry_partitionable`` on.  This module computes the same draw
with torch integer and float ops, on any device:

* the key of ``jax.random.key(seed)``: ``(seed >> 32, seed & 0xffffffff)``
  as uint32 (``jax/_src/prng.py`` ``_threefry_seed``);
* the bits: Threefry-2x32 (20 rounds, rotations 13 15 26 6 / 17 29 16 24,
  key schedule with 0x1BD11BDA) over the partitionable counters -- the
  row-major index i of each element as the pair (i >> 32, i & 0xffffffff)
  -- giving two words; 32-bit draws take ``w1 ^ w2``, 64-bit draws
  ``w1 << 32 | w2`` (``_threefry_random_bits_partitionable``);
* the uniform on ``(nextafter(-1, 0), 1)``: the top mantissa bits under
  the exponent of 1.0, minus 1, scaled by ``hi - lo`` and shifted by
  ``lo``, clamped below at ``lo`` (``jax.random._uniform``);
* the normal: ``sqrt(2) * erfinv(u)`` with XLA's ErfInv polynomials
  (Giles' single-precision form for f32, its double-precision form for
  f64; XLA's ``ErfInv32``/``ErfInv64``).

The bits are exact.  The polynomials are evaluated as XLA's CPU backend
evaluates them -- Horner steps contracted into FMAs, log1p in Cephes'
rational form below sqrt(2) - 1 -- and the normals then agree with
JAX's to the bit in all but ~3e-5 (f64) and ~2e-2 (f32) of the draws,
within 3 ulp everywhere: XLA's own ``log`` (the log1p above sqrt(2) - 1)
is an ulp off the C library's in ~0.1 % (f64) and ~7 % (f32) of its
arguments, and that ulp of w can grow to 3 ulp of the normal.
Integers ride int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from acg_tpu_torch.ops.precision import two_prod, two_sum

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 24   # elements per pass, to bound the int64 temporaries

# XLA ErfInv32: Giles' single-precision polynomials (w < 5, w >= 5)
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682))
# XLA ErfInv64: Giles' double-precision polynomials (w < 6.25, w < 16,
# w >= 16)
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def seed_key(seed: int) -> tuple[int, int]:
    """The two uint32 words of ``jax.random.key(seed)`` for a 64-bit
    seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32) & _M32, s & _M32


def threefry2x32(key: tuple[int, int], x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter pairs ``(x1, x2)`` (int64 tensors
    holding uint32 values) under ``key``; returns the two words, int64."""
    k1, k2 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _words(key, lo: int, hi: int, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    return threefry2x32(key, idx >> 32, idx & _M32)


def random_bits(seed: int, n: int, bit_width: int = 32,
                device="cpu") -> torch.Tensor:
    """``jax.random.bits(jax.random.key(seed), (n,), uint32|uint64)``
    as int64 values (64-bit draws as their two's-complement int64)."""
    key = seed_key(seed)
    w1, w2 = _words(key, 0, int(n), device)
    if bit_width == 32:
        return w1 ^ w2
    if bit_width == 64:
        return (w1 << 32) | w2
    raise ValueError("bit_width must be 32 or 64")


def _fma(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA's CPU backend contracts the
    Horner steps: f32 through an exact f64 product, f64 through
    Dekker's two-product and Knuth's two-sum."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c).float()
    ph, pl = two_prod(a, b)
    sh, sl = two_sum(ph, torch.full_like(ph, c))
    return sh + (sl + pl)


def _horner(coeffs, w):
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, w, c)
    return p


# XLA's Log1p on the CPU (elemental_ir_emitter EmitLog1p): Cephes'
# rational form x - x^2/2 + x^3 P(x)/Q(x) for |x| below sqrt(2) - 1,
# log(1 + x) above
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` as XLA's CPU backend computes it."""
    x2 = x * x
    small = (x * x2) * (_horner(_LOG1P_P, x) / _horner(_LOG1P_Q, x))
    small = x + (-0.5 * x2 + small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(1.0 + x))


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's ErfInv for f32 or f64 ``x`` (|x| < 1)."""
    w = -log1p_xla(-x * x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt, _horner(_ERFINV32[0], w),
                        _horner(_ERFINV32[1], w))
    elif x.dtype == torch.float64:
        lt6 = w < 6.25
        lt16 = w < 16.0
        sw = torch.sqrt(w)
        p = torch.where(
            lt6, _horner(_ERFINV64[0], w - 3.125),
            torch.where(lt16, _horner(_ERFINV64[1], sw - 3.25),
                        _horner(_ERFINV64[2], sw - 5.0)))
    else:
        raise ValueError(f"erfinv_xla takes f32 or f64, got {x.dtype}")
    return torch.where(x.abs() == 1, x * torch.finfo(x.dtype).max, p * x)


def _uniform_from_words(w1, w2, dtype):
    """The uniform on (nextafter(-1, 0), 1) of ``jax.random.normal``."""
    if dtype == torch.float32:
        bits = (((w1 ^ w2) >> 9) | 0x3F800000).to(torch.int32)
        floats = bits.view(torch.float32) - 1.0
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
        span = np.float32(1.0) - lo
    else:
        # the top 52 of the 64 bits w1 << 32 | w2
        bits = (w1 << 20) | (w2 >> 12) | (1023 << 52)
        floats = bits.view(torch.float64) - 1.0
        lo = np.nextafter(np.float64(-1.0), np.float64(0.0))
        span = np.float64(1.0) - lo
    lo_t = torch.tensor(float(lo), dtype=dtype, device=floats.device)
    return torch.maximum(lo_t, floats * float(span) + lo_t)


def normal(seed: int, n: int, dtype=torch.float64, device="cpu",
           rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``jax.random.normal(jax.random.key(seed), (n,), dtype)`` as a
    torch tensor on ``device`` (f32 or f64), computed in chunks of
    2^24 elements.  ``rows=(lo, hi)`` draws only elements ``[lo, hi)``
    of it: each element's counter is its index, so a slice of the draw
    costs only its own length."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"normal draws f32 or f64, got {dtype}")
    lo, hi = (0, int(n)) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo <= hi <= int(n):
        raise ValueError(f"normal: rows {rows} outside [0, {n}]")
    key = seed_key(seed)
    sqrt2 = float(np.sqrt(np.float64(2.0)).astype(
        np.float32 if dtype == torch.float32 else np.float64))
    out = torch.empty(hi - lo, dtype=dtype, device=device)
    for a in range(lo, hi, _CHUNK):
        b = min(hi, a + _CHUNK)
        w1, w2 = _words(key, a, b, device)
        out[a - lo:b - lo] = sqrt2 * erfinv_xla(
            _uniform_from_words(w1, w2, dtype))
    return out
