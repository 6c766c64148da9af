"""Threefry-2x32 counter-based random numbers with ``jax.random``'s
semantics, in PyTorch.

The port's counterpart of the ``jax.random`` calls the reference makes
(``PRNGKey``, ``fold_in``, ``split``, ``bits``, ``uniform``, ``normal``,
``randint``),
so a seed or key gives the port the same draws it gives the reference:
the same keys and bits exactly, and normals within ``NORMAL_RTOL``.

Layouts are those of JAX with ``jax_threefry_partitionable`` on (the
default of the installed ``jax``; the pinned 0.4.37 needs
``jax.threefry_partitionable(True)`` around the reference call):

* a key is a pair of 32-bit words; ``PRNGKey(seed)`` is ``(0, seed mod
  2**32)``, as JAX builds it from a seed taken as a 32-bit integer
  (64-bit mode off);
* ``fold_in(key, d) = threefry2x32(key, (0, d))``;
* ``split(key, n)[i] = threefry2x32(key, (hi(i), lo(i)))``, the two words
  of the 64-bit row-major index ``i`` (JAX's ``_threefry_split_foldlike``);
* ``random_bits(key, shape)[i] = y1 ^ y2`` where ``(y1, y2) =
  threefry2x32(key, (hi(i), lo(i)))`` (``_threefry_random_bits_partitionable``).

Deriving a key runs on the host in Python integers, so a tick's keys cost
no device work or sync.  Bits run as torch integer ops on the caller's
device, in int64 tensors holding 32-bit words (masked after every add;
threefry needs no multiply), so they are identical on the CPU and the
GPU.  ``normal`` is ``sqrt(2) * erfinv(u)`` with ``erfinv`` a copy of the
float32 polynomial XLA lowers ``lax.erf_inv`` to (``materializeErfInvF32``
in StableHLO's CHLO decomposition), evaluated with one rounding per
operation; XLA's own ``log1p`` and its fused multiply-adds differ from
torch's in the last bits, hence the tolerance.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
Key = Tuple[int, int]

#: normals against ``jax.random.normal`` on the same key (measured on the
#: CPU over 2e6 draws: 95% bit-equal, the rest within 2 float32 ulps of
#: erfinv, i.e. relative 2.3e-7)
NORMAL_RTOL = 1e-6
NORMAL_ATOL = 1e-7

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# erfinv polynomial coefficients, w < 5 and w >= 5 (XLA's float32 ErfInv)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _schedule(k1: int, k2: int):
    """The 5 key injections of threefry2x32-20: (rotations, add to x0,
    add to x1) after each block of 4 rounds."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    for i in range(5):
        yield (_ROTATIONS[i % 2], ks[(i + 1) % 3],
               (ks[(i + 2) % 3] + i + 1) & MASK)


def threefry2x32_int(key: Key, x1: int, x2: int) -> Key:
    """threefry2x32 of one counter pair, in Python integers."""
    k1, k2 = key
    x1, x2 = (x1 + k1) & MASK, (x2 + k2) & MASK
    for rots, a0, a1 in _schedule(k1, k2):
        for r in rots:
            x1 = (x1 + x2) & MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & MASK
            x2 ^= x1
        x1, x2 = (x1 + a0) & MASK, (x2 + a1) & MASK
    return x1, x2


def threefry2x32(key: Key, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of counter tensors: int64 tensors of 32-bit words,
    elementwise, on their device.  Returns two new tensors."""
    k1, k2 = key
    x1 = (x1 + k1).bitwise_and_(MASK)
    x2 = (x2 + k2).bitwise_and_(MASK)
    for rots, a0, a1 in _schedule(k1, k2):
        for r in rots:
            x1.add_(x2).bitwise_and_(MASK)
            hi = x2 >> (32 - r)
            x2.bitwise_left_shift_(r).bitwise_or_(hi).bitwise_and_(MASK)
            x2.bitwise_xor_(x1)
        x1.add_(a0).bitwise_and_(MASK)
        x2.add_(a1).bitwise_and_(MASK)
    return x1, x2


def PRNGKey(seed: int) -> Key:
    """The key ``jax.random.PRNGKey(seed)`` holds (64-bit mode off)."""
    return 0, int(seed) & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: a new key from ``key`` and a 32-bit int."""
    return threefry2x32_int(key, 0, int(data) & MASK)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` (partitionable threefry)."""
    return tuple(threefry2x32_int(key, i >> 32, i & MASK)
                 for i in range(num))


def _shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else \
        tuple(int(s) for s in shape)


def random_bits(key: Key, shape, *, device, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of
    32-bit words on ``device`` (required: a draw the size of a weight
    belongs where the weight lies).  ``offset``: the row-major index of
    the first element in a larger draw; element i's bits depend only on
    (key, i), so this is elements ``[offset, offset + prod(shape))`` of
    any draw that holds them (a shard's rows of a global draw)."""
    shape = _shape(shape)
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(key, idx >> 32, idx.bitwise_and_(MASK))
    return y1.bitwise_xor_(y2).reshape(shape)


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            *, device, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [minval, maxval) with one
    rounding, as XLA fuses the multiply-add (emulated in float64 unless
    the span is a power of two, where the product is exact).
    ``offset`` as for ``random_bits``."""
    bits = random_bits(key, shape, device=device, offset=offset)
    f = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(
        torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(lo))
    if math.frexp(span)[0] == 0.5:
        f.mul_(span).add_(lo)
    else:
        f = f.double().mul_(span).add_(lo).float()
    return f.clamp_min_(lo)


_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(key: Key, shape, minval: int, maxval: int, *,
            device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` at int32, bit
    for bit (``jax/_src/random.py::_randint``): 32 bits from each half of
    ``split(key)`` (``hi``, ``lo``), ``span = maxval - minval`` as a
    uint32 (1 when ``maxval <= minval``), ``multiplier = (2**16 % span)**2
    % span`` (the square wrapping at 2**32, as uint32), and the result
    ``minval + ((hi % span) * multiplier + lo % span) % span`` in uint32
    arithmetic that wraps.  ``minval`` and ``maxval`` are ints in the
    int32 range.  An int32 tensor on ``device``."""
    if not _INT32_MIN <= minval <= _INT32_MAX or \
            not _INT32_MIN <= maxval <= _INT32_MAX:
        raise ValueError(f'randint bounds ({minval}, {maxval}) must be int32')
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device=device)
    lo = random_bits(k2, shape, device=device)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = (((2 ** 16 % span) ** 2) & MASK) % span
    a = hi.remainder_(span)
    # a * mult mod 2**32 without leaving int64: mult in 16-bit halves
    prod = (a * (mult & 0xFFFF) + ((a * (mult >> 16)) & 0xFFFF) * 2 ** 16)
    off = prod.add_(lo.remainder_(span)).bitwise_and_(MASK).remainder_(span)
    return off.add_(minval).to(torch.int32)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by XLA's polynomial (``lax.erf_inv``), one rounding
    per operation; +-inf at +-1.  Both branches run over the whole
    tensor: selecting the rare tail (|x| > 0.9966) would cost a device
    sync."""
    w = torch.log1p(x * -x).neg_()
    p = torch.where(w < 5.0, _horner(_ERFINV_LT5, w - 2.5),
                    _horner(_ERFINV_GE5, w.sqrt() - 3.0))
    p.mul_(x)
    return torch.where(x.abs() == 1.0, x * math.inf, p)


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p.mul_(w).add_(c)
    return p


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: Key, shape, *, device, offset: int = 0) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with u
    uniform on [nextafter(-1, 0), 1).  ``offset`` as for
    ``random_bits``."""
    return erfinv(uniform(key, shape, _LO, 1.0, device=device,
                          offset=offset)).mul_(_SQRT2)
