"""A frozen copy of the threefry-2x32 draws the served path takes its
randomness from (``jax.random``'s partitionable layout): ``PRNGKey``,
``fold_in``, ``split`` and ``normal``, with XLA's float32 erfinv
polynomial.  The reference works a request's initial noise out again
from its seed with these, and a noisy request's analog perturbation from
the engine's noise seed, its ticks and its slot (``noise.py``), as the
served path draws them.  Element i of a draw depends only on the key and
i, so ``normal_at`` draws any elements of a larger draw by their
counters.  Plain torch and numpy."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
Key = Tuple[int, int]
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _schedule(k1: int, k2: int):
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    for i in range(5):
        yield (_ROTATIONS[i % 2], ks[(i + 1) % 3],
               (ks[(i + 2) % 3] + i + 1) & MASK)


def _threefry_int(key: Key, x1: int, x2: int) -> Key:
    k1, k2 = key
    x1, x2 = (x1 + k1) & MASK, (x2 + k2) & MASK
    for rots, a0, a1 in _schedule(k1, k2):
        for r in rots:
            x1 = (x1 + x2) & MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & MASK
            x2 ^= x1
        x1, x2 = (x1 + a0) & MASK, (x2 + a1) & MASK
    return x1, x2


def _threefry(key: Key, x1: torch.Tensor, x2: torch.Tensor):
    k1, k2 = key
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for rots, a0, a1 in _schedule(k1, k2):
        for r in rots:
            x1 = (x1 + x2) & MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & MASK
            x2 = x2 ^ x1
        x1 = (x1 + a0) & MASK
        x2 = (x2 + a1) & MASK
    return x1, x2


def PRNGKey(seed: int) -> Key:
    return 0, int(seed) & MASK


def fold_in(key: Key, data: int) -> Key:
    return _threefry_int(key, 0, int(data) & MASK)


def split(key: Key, num: int = 2):
    return tuple(_threefry_int(key, i >> 32, i & MASK) for i in range(num))


def _uniform_lo_1(key: Key, idx: torch.Tensor) -> torch.Tensor:
    y1, y2 = _threefry(key, idx >> 32, idx & MASK)
    bits = (y1 ^ y2) >> 9 | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(1.0) - np.float32(_LO))
    return (f.double() * span + _LO).float().clamp_min(_LO)


def _horner(coeffs, w):
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = p * w + c
    return p


def normal(key: Key, shape, offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 on ``device`` (the
    CPU by default); ``offset``: the elements from ``offset`` on of a
    larger draw."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64,
                       device=device)
    return normal_at(key, idx).reshape(shape)


def normal_at(key: Key, idx: torch.Tensor) -> torch.Tensor:
    """Elements ``idx`` (an int64 tensor of counters) of any float32
    ``jax.random.normal`` draw from ``key``, on ``idx``'s device."""
    x = _uniform_lo_1(key, idx)
    w = -torch.log1p(x * -x)
    p = torch.where(w < 5.0, _horner(_ERFINV_LT5, w - 2.5),
                    _horner(_ERFINV_GE5, w.sqrt() - 3.0)) * x
    p = torch.where(x.abs() == 1.0, x * math.inf, p)
    return p * _SQRT2


def initial_noise(seed: int, shape) -> torch.Tensor:
    """A DDIM request's starting latent: ``normal(split(PRNGKey(seed))[0],
    shape)``."""
    k0, _ = split(PRNGKey(seed))
    return normal(k0, shape)
