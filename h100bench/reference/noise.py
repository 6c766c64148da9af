"""The analog perturbation of a ``w8a8+noise`` request, as the paper's
robustness model states it, and the keys it is drawn from.

Each attention projection of a noisy request is

    y = ((x_q + e_x) (w_q + e_w) + e_pd * sqrt(K)) * x_scale * w_scale

with ``x_q``, ``w_q`` and the scales the W8A8 rule's (``numerics``) and
the ``e`` zero-mean Gaussians in LSBs of the 8-bit datapath: ``e_x``
(modulation error) at 0.2, ``e_w`` (MR calibration and thermal drift) at
0.3, ``e_pd`` (photodetector shot noise 0.5 and the crosstalk of the 35
other wavelengths of a 36-channel waveguide at -28 dB each, in
quadrature, in LSBs of 127) on every sum.  The perturbed operands are no
longer integers: their product is a float32 one (TF32 off).

Keys (``prng``): a step that ran at engine tick ``k`` draws from
``fold_in(PRNGKey(noise_seed), k)``.  Without DeepCache the conditional
evaluation's base key is ``fold_in(fold_in(tick, t0), 0)`` and the
unconditional one's ``fold_in(fold_in(fold_in(tick, 1), t0), 0)``, ``t0``
being the timestep of the request in slot 0 at that tick (0 if none);
with DeepCache the bases are ``tick`` and ``fold_in(tick, 1)``.  The
i-th projection of an evaluation, in the order the network runs them,
takes ``split(fold_in(base, i), 3)``: the activation noise, the weight
noise and the sums' noise.  The weight noise is one draw, shared by
every slot of the tick; the others are drawn over the whole slot buffer,
slot ``s``'s rows at counter ``s * rows * K`` (``s * rows * N``).
Plain torch and numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import prng
from .numerics import Numerics, quantize

SIGMA_X = 0.2
SIGMA_W = 0.3
SIGMA_PD = 0.5
CROSSTALK_DB = -28.0
CHANNELS = 36
#: the sums' noise in LSBs, a float32 constant: shot noise and the
#: crosstalk's amplitude ``127 sqrt((n - 1) 10^(dB / 10))`` in quadrature
SIGMA_SUM = float(np.sqrt(np.float32(
    SIGMA_PD ** 2 + (math.sqrt((CHANNELS - 1) * 10.0 ** (CROSSTALK_DB / 10.0))
                     * 127.0) ** 2)))


@dataclasses.dataclass(frozen=True)
class Draws:
    """What one noisy request's perturbation is drawn from: the engine's
    ``seed``, the engine tick each of its steps ran at (``ticks[i]``:
    step i's), its ``slot``, and per tick the DDIM step index of the
    request then in slot 0 (``slot0_step``; a tick missing from it had
    slot 0 empty)."""
    seed: int
    ticks: Sequence[int]
    slot: int
    slot0_step: Dict[int, int]


class Stream:
    """The keys of one evaluation of some rows (requests in ``slots``):
    the i-th projection draws from ``fold_in(base, i)``."""

    def __init__(self, base: prng.Key, slots: List[int]):
        self.base, self.slots, self.i = base, slots, 0

    def linear(self, num: Numerics, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        key = prng.fold_in(self.base, self.i)
        self.i += 1
        y = noisy_w8a8(num, x, w, key, self.slots)
        return y if b is None else y + b


def bases(seed: int, tick: int, t0: int, cached: bool, shift: int = 0):
    """(conditional, unconditional) base keys of a step at ``tick``."""
    k = prng.fold_in(prng.PRNGKey(seed), tick + shift)
    u = prng.fold_in(k, 1)
    if cached:
        return k, u
    return (prng.fold_in(prng.fold_in(k, t0), 0),
            prng.fold_in(prng.fold_in(u, t0), 0))


def _counters(slots: List[int], n: int, device) -> torch.Tensor:
    """The counters of ``n`` elements per slot, slot s's from ``s * n``."""
    start = torch.tensor(slots, dtype=torch.int64, device=device) * n
    return (start[:, None] + torch.arange(n, dtype=torch.int64,
                                          device=device)[None]).reshape(-1)


def noisy_w8a8(num: Numerics, x: torch.Tensor, w: torch.Tensor,
               key: prng.Key, slots: List[int]) -> torch.Tensor:
    """x (B, ..., K) of the requests in ``slots`` (one each) @ w (K, N)
    with the perturbation drawn from ``key``, float32 out."""
    kx, kw, kp = prng.split(key, 3)
    K, N = w.shape
    dev = x.device
    rows = x.reshape(-1, K)
    R = rows.shape[0] // x.shape[0]
    xq, xs = quantize(rows, 1, num.qbits)
    wq, ws = quantize(w, 0, num.qbits)
    xn = prng.normal_at(kx, _counters(slots, R * K, dev)).reshape(-1, K) \
        * SIGMA_X + xq.float()
    wn = prng.normal(kw, (K, N), device=dev) * SIGMA_W + wq.float()
    acc = num.mm(xn, wn)
    sqrt_k = float(np.sqrt(np.float32(K)))
    acc = acc + prng.normal_at(kp, _counters(slots, R * N, dev)).reshape(
        -1, N) * SIGMA_SUM * sqrt_k
    return (acc * xs * ws).reshape(*x.shape[:-1], N)

