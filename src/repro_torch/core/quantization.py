"""W8A8 symmetric quantization (paper §V, Q-Diffusion style).

Port of ``repro/core/quantization.py``: an int8 tensor plus a float32
scale, symmetric absmax scales clamped at ``1e-8/127``, round half to
even (``torch.round``), so a tensor quantizes bit-identically in both
packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INT8_MAX = 127.0


@dataclasses.dataclass
class QTensor:
    """An int8 tensor with a broadcastable float32 scale: x ~= q * scale."""

    q: torch.Tensor      # int8
    scale: torch.Tensor  # float32, broadcastable against q
    #: a 2-D weight's K-major copy for the CUDA W8A8 kernel: (N, K padded
    #: to 16) int8, built once per weight (``layers.QWeight``); None
    #: elsewhere.  ``q`` keeps the reference's (K, N).
    kmajor: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.q.shape


def rounded(x: torch.Tensor, axis: Tuple[int, ...]):
    """The int8 values of ``quantize(x, axis)`` still in float32, and the
    scale; the caller casts (and may lay out) the values."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / INT8_MAX
    return torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX), scale


def quantize(x: torch.Tensor,
             axis: Optional[Tuple[int, ...]] = None) -> QTensor:
    """Symmetric quantization; ``axis`` lists the axes reduced for the
    scale (``None``: per-tensor).  A weight ``(in, out)`` quantized per
    output channel uses ``axis=(0,)``."""
    if axis is None:
        axis = tuple(range(x.ndim))
    q, scale = rounded(x, axis)
    return QTensor(q.to(torch.int8), scale)


def quantize_per_channel(w: torch.Tensor) -> QTensor:
    """Weight ``(..., in, out)``: one scale per output channel."""
    return quantize(w, axis=(w.ndim - 2,))
