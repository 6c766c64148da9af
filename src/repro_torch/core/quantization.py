"""W8A8 symmetric quantization (paper §V, Q-Diffusion style).

Port of ``repro/core/quantization.py``: an int8 tensor plus a float32
scale, symmetric absmax scales clamped at ``1e-8/127``, round half to
even (``torch.round``), so a tensor quantizes bit-identically in both
packages.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

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

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


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


def fake_quantize(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Quantize-dequantize round trip in x's dtype (for QAT / error
    measurement)."""
    return quantize(x, axis=axis).dequantize(x.dtype)


def quantization_error(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Relative L2 error of the W8A8 round trip (Table-I quality proxy),
    a 0-d tensor."""
    d = (x - fake_quantize(x, axis=axis)).reshape(-1)
    return torch.linalg.vector_norm(d) / torch.clamp_min(
        torch.linalg.vector_norm(x.reshape(-1)), 1e-12)


#: the parameter names ``quantize_params`` quantizes (the reference's)
MATMUL_WEIGHTS = ('w', 'w_gate', 'w_up', 'w_down')


def quantize_params(module: nn.Module, min_size: int = 1 << 12) -> nn.Module:
    """Serve-time weight quantization (paper C1), the reference's rule on
    a copy of ``module``: every float32 or bfloat16 parameter named as in
    ``MATMUL_WEIGHTS``, at least 2-D and of at least ``min_size``
    elements, becomes a ``QWeight`` with per-output-channel scales
    (``layers.quantize_weight_``); everything else (norms, biases,
    embedding tables) stays float.  As in the reference, a conv kernel
    (named ``w``) matches the rule too."""
    from repro_torch.models.layers import quantize_weight_
    out = copy.deepcopy(module)
    for m in list(out.modules()):
        for name, p in list(m.named_parameters(recurse=False)):
            if (name in MATMUL_WEIGHTS and p.dim() >= 2
                    and p.dtype in (torch.float32, torch.bfloat16)
                    and p.numel() >= min_size):
                quantize_weight_(m, name)
    return out
