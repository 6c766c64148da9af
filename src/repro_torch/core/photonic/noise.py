"""Analog-noise robustness model (paper §VI future work: "mitigating
fabrication process variations to further improve reliability"), port of
``repro/core/photonic/noise.py``.

Non-coherent photonic MACs are analog: MR transmission calibration error,
thermal drift between TO re-tunes, inter-channel crosstalk (bounded by the
36-MR WDM limit) and PD shot noise all perturb the effective weights and
partial sums.  The aggregate is modelled as

    y = (x_q + eps_x) (w_q + eps_w) + eps_pd

with eps_* zero-mean Gaussians in LSBs of the 8-bit datapath, drawn from
``core/prng`` so a key gives the reference's draws.  ``xn @ wn`` is a
float32 product of perturbed integers: the operands are no longer
integers, so it runs as ``torch.matmul`` (TF32 off, PyTorch's default)
and not through the int8 kernel, as the reference runs it in ``jnp``
outside its Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.quantization import (QTensor, quantize,
                                           quantize_per_channel)


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    sigma_w_lsb: float = 0.3     # MR calibration + thermal drift (weights)
    sigma_x_lsb: float = 0.2     # activation modulation error
    sigma_pd_lsb: float = 0.5    # BPD / shot noise on the accumulated sum
    crosstalk_db_per_channel: float = -28.0   # adjacent-channel isolation


def crosstalk_sigma_lsb(n_channels: int, model: NoiseModel) -> float:
    """Aggregate crosstalk contribution (in LSBs of the output) of the other
    n-1 wavelengths on one waveguide.  Grows ~linearly in channel count at
    fixed isolation: the quantitative reason a waveguide is capped at 36
    MRs (paper §V, Lumerical analysis)."""
    leak = 10.0 ** (model.crosstalk_db_per_channel / 10.0)
    return math.sqrt(max(n_channels - 1, 0) * leak) * 127.0


def noisy_w8a8_matmul(key: prng.Key, x: torch.Tensor, w,
                      model: NoiseModel = NoiseModel(),
                      n_channels: int = 36,
                      first_sample: int = 0) -> torch.Tensor:
    """W8A8 matmul with analog perturbations.  Serves both the robustness
    sweeps and the engine's ``w8a8+noise`` policy; ``w`` may be a float
    weight ``(K, N)`` or a pre-quantized QTensor.  The same key gives the
    same draw: ``split(key, 3)`` keys the activation noise (shape of the
    quantized rows), the weight noise (shape of the int8 weight) and the
    output noise (shape of the product, scaled by sqrt(K)), in that order.

    ``first_sample``: x's leading axis holds samples ``first_sample ...
    first_sample + x.shape[0] - 1`` of a larger batch, and the activation
    and output noise are those samples' rows of the draws over that batch
    (a shard of the slot axis draws what the unsharded batch draws for
    it; the partitionable threefry makes a row's draw independent of the
    rows after it).  The weight noise does not depend on it."""
    kx, kw, kp = prng.split(key, 3)
    dev = x.device
    xq = quantize(x.reshape(-1, x.shape[-1]), axis=(1,))
    wq = w if isinstance(w, QTensor) else quantize_per_channel(w)
    # every sample holds the same number of rows, batch-major
    row0 = first_sample * (xq.q.shape[0] // x.shape[0])
    K, N = xq.q.shape[1], wq.q.shape[-1]
    xn = prng.normal(kx, xq.q.shape, device=dev, offset=row0 * K).mul_(
        model.sigma_x_lsb).add_(xq.q.float())
    wn = prng.normal(kw, wq.q.shape, device=dev).mul_(model.sigma_w_lsb).add_(
        wq.q.float())
    acc = torch.matmul(xn, wn)
    # float32 constants, as the reference's jnp.sqrt of a Python float
    sigma_out = float(np.sqrt(np.float32(
        model.sigma_pd_lsb ** 2 + crosstalk_sigma_lsb(n_channels, model) ** 2)))
    sqrt_k = float(np.sqrt(np.float32(x.shape[-1])))
    acc.add_(prng.normal(kp, acc.shape, device=dev, offset=row0 * N).mul_(
        sigma_out).mul_(sqrt_k))
    out = acc.mul_(xq.scale).mul_(wq.scale.reshape(1, -1))
    return out.reshape(x.shape[:-1] + (wq.q.shape[-1],))


def robustness_sweep(key: prng.Key, x: torch.Tensor, w: torch.Tensor,
                     channel_counts=(2, 8, 16, 24, 36, 48, 64),
                     model: NoiseModel = NoiseModel()):
    """Relative output error vs WDM channel count: reproduces the shape of
    the paper's error-free-operation constraint (<= 36 channels).  Returns
    {channels: rel_l2_error}."""
    exact = x.reshape(-1, x.shape[-1]) @ w
    out = {}
    for i, n in enumerate(channel_counts):
        y = noisy_w8a8_matmul(prng.fold_in(key, i), x, w, model=model,
                              n_channels=n)
        out[n] = float(torch.linalg.norm(y.reshape(exact.shape) - exact) /
                       torch.linalg.norm(exact))
    return out
