"""The arithmetic the plain references share: the W8A8 product as the
configurations state it, and the lower precisions their controls run.

W8A8 (DiffLight C1): activations quantize per row, weights per output
channel, symmetric, absmax scales clamped at ``1e-8 / qmax``, round half
to even; the integer product is exact (float64 holds every partial sum
of int8 operands), then ``float(acc) * x_scale * w_scale``.  ``qbits=4``
is the same rule with ``qmax = 7``: the control one precision below int8.

TF32: float32 operands rounded to 10 bits of mantissa (to nearest, ties
away from zero), as the tensor cores take them, products and sums in
float32: the control one precision below float32 with TF32 off.
bfloat16: operands rounded to 7 bits of mantissa, products and sums in
float32, as the tensor cores take bfloat16: a control two steps below.

A noisy request's controls (``noise.py``): its analog perturbation left
out (the plain W8A8 rule in its place), or drawn from the keys of the
tick after the one each step ran at.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """float32 products stay float32 on the GPU (PyTorch lets cuDNN take
    TF32 by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (1 + 8 + 10 bits), kept in float32."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def quantize(x: torch.Tensor, dim: int, qbits: int = 8):
    """(integer values as float64, float32 scale) of x, the scale reducing
    ``dim``."""
    qmax = float(2 ** (qbits - 1) - 1)
    xf = x.float()
    scale = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.double(), scale


@dataclasses.dataclass(frozen=True)
class Numerics:
    """How a reference computes: ``float_mode`` None (float32, TF32 off),
    'tf32' or 'bf16'; ``qbits`` of the W8A8 products (8, or 4 for a
    control); ``analog``: a noisy request's perturbation drawn (False: a
    control without it); ``tick_shift``: added to the tick a noisy step's
    keys fold in (1: a control)."""
    float_mode: Optional[str] = None
    qbits: int = 8
    analog: bool = True
    tick_shift: int = 0

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """A float product's operand; under TF32 the rounding passes the
        gradient through unchanged (the backward's products then take the
        rounded operands the forward saved)."""
        x = x.float()
        if self.float_mode is None:
            return x
        lo = tf32(x) if self.float_mode == 'tf32' else \
            x.bfloat16().float()
        return x + (lo - x).detach() if x.requires_grad else lo

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self.op(a), self.op(b))

    def w8a8(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) on the W8A8 rule, float32 out."""
        lead = x.shape[:-1]
        xq, xs = quantize(x.reshape(-1, x.shape[-1]), 1, self.qbits)
        wq, ws = quantize(w, 0, self.qbits)
        acc = (xq @ wq).float()
        return (acc * xs * ws).reshape(*lead, w.shape[-1])

    def linear(self, x, w, b=None, quant: bool = False) -> torch.Tensor:
        y = self.w8a8(x, w) if quant else self.mm(x, w)
        return y if b is None else y + b

    def conv(self, x: torch.Tensor, w: torch.Tensor, b, pads,
             stride: int = 1) -> torch.Tensor:
        """Correlation of NHWC ``x`` with an OIHW kernel after explicit
        (top, bottom, left, right) zero padding."""
        xc = F.pad(x.permute(0, 3, 1, 2), (pads[2], pads[3], pads[0], pads[1]))
        y = F.conv2d(self.op(xc), self.op(w), stride=stride)
        y = y.permute(0, 2, 3, 1)
        return y if b is None else y + b


FP32 = Numerics()
