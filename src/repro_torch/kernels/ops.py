"""Public wrappers around the kernels, port of ``repro/kernels/ops.py``.

They do what the reference wrappers do around the Pallas kernels
(activation quantization, weight quantization unless pre-quantized, the
GroupNorm group fallback, folding heads into the batch, or reading
grouped heads in place) and dispatch by
the tensor's device: a CUDA tensor always launches the hand-written
kernel, a CPU tensor runs the plain PyTorch version, and any other
device raises, as does a fake or ``meta`` tensor that claims CUDA (the
dry run's stand-ins have no memory to hand a kernel).  There is no
switch and no fallback from one to the other.  ``conv2d``, which the
reference leaves to XLA, runs a fake or ``meta`` tensor through its
plain version, which computes shapes and launches nothing, so the models'
shapes can be traced.

Gradients: the plain versions are differentiable.  On CUDA,
``fused_gn_swish`` and ``conv2d`` go through ``GNSwish`` and ``Conv2d``
(the kernel forward, a plain backward) when a gradient is wanted; the
W8A8 and flash kernels have no backward, so their wrappers raise when one
is wanted rather than return an output that autograd cannot trace.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.quantization import (QTensor, quantize,
                                           quantize_per_channel)
from repro_torch.kernels import conv2d as _cv
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_gn_swish as _gn
from repro_torch.kernels import w8a8_matmul as _mm

_KERNEL_MODULES = {'fused_gn_swish': _gn, 'w8a8_matmul': _mm,
                   'flash_attention': _fa, 'conv2d_nhwc': _cv}


def launch_counts() -> Dict[str, int]:
    """CUDA-kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_launches() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0


#: the kernels a diffusion engine can reach, which ``prepare`` readies
PREPARED = ('fused_gn_swish', 'w8a8_matmul', 'conv2d_nhwc')


def prepare(names, devices) -> None:
    """Build the named kernels' libraries that this process has not
    loaded and that are missing (all at once, one ``nvcc`` each), load
    them and set each kernel's shared-memory attribute on every CUDA
    device of ``devices``, launching nothing: what their first launches
    there would do.  A loaded library stays in use even if its file has
    since been evicted.  The CPU runs the plain versions, so a CPU
    device needs nothing.  ``names`` are among ``PREPARED``."""
    cuda = sorted({torch.device(d) for d in devices
                   if torch.device(d).type == 'cuda'}, key=str)
    if not cuda or not names:
        return
    from repro_torch.kernels import build
    missing = [n for n in names if n not in build._loaded]
    if missing:
        build.build(missing)
    for name in names:
        for dev in cuda:
            _KERNEL_MODULES[name].prepare(dev)


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == 'cuda':
        if _without_memory(t):
            raise ValueError(f'{op}: a fake tensor on {t.device} has no '
                             'memory for the kernel to read')
        return True
    if t.device.type == 'cpu':
        return False
    raise ValueError(f'{op}: no kernel for device {t.device}')


def _without_memory(t: torch.Tensor) -> bool:
    """A ``FakeTensor`` (the dry run's stand-ins) or a ``meta`` tensor:
    shapes and types with no device memory behind them."""
    from torch._subclasses.fake_tensor import is_fake
    return t.is_meta or is_fake(t)


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _no_backward(op: str, *tensors) -> None:
    if _grad_wanted(*tensors):
        raise RuntimeError(
            f'{op}: the CUDA kernel has no backward; call it under '
            'torch.no_grad() or with inputs that do not require grad')


def w8a8_matmul(x: torch.Tensor,
                w: Union[torch.Tensor, QTensor]) -> torch.Tensor:
    """x (..., K) float, w (K, N) float or pre-quantized QTensor ->
    (..., N) float32.  Activations quantize per row (dynamic), weights per
    output channel unless already a QTensor (serve-time prequant).  On
    CUDA both are written K-major and K-padded for the kernel in the pass
    that quantizes them; a QTensor's K-major copy is reused when it has
    one."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if _on_cuda(x, 'w8a8_matmul'):
        _no_backward('w8a8_matmul', x, w)
        xq, xs = _mm.quantize_rows_padded(x2)
        if isinstance(w, QTensor):
            wt = w.kmajor if w.kmajor is not None else _mm.kmajor_weight(w.q)
            ws = w.scale
        else:
            wt, ws = _mm.quantize_weight_kmajor(w)
        N = wt.shape[0]
        out = _mm.w8a8_matmul_kernel(xq, xs, wt,
                                     ws.reshape(1, N).contiguous())
    else:
        xq = quantize(x2, axis=(1,))
        wq = w if isinstance(w, QTensor) else quantize_per_channel(w)
        N = wq.q.shape[-1]
        out = _mm.w8a8_matmul_plain(xq.q, xq.scale, wq.q,
                                    wq.scale.reshape(1, N))
    return out.reshape(*lead, N)


def fused_gn_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   *, groups: int = 32) -> torch.Tensor:
    """GroupNorm (largest ``g <= groups`` dividing C) then swish, NHWC.
    On CUDA under a wanted gradient the kernel runs inside ``GNSwish``."""
    C = x.shape[-1]
    g = min(groups, C)
    while C % g:
        g -= 1
    if _on_cuda(x, 'fused_gn_swish'):
        if _grad_wanted(x, scale, bias):
            return _gn.GNSwish.apply(x.contiguous(), scale, bias, g)
        return _gn.fused_gn_swish_kernel(x.contiguous(), scale, bias, g)
    return _gn.gn_swish_plain(x, scale, bias, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, S, d), k/v (B, H, T, d) -> (B, H, S, d) in q's type."""
    B, H, S, d = q.shape
    T = k.shape[2]
    qf = q.reshape(B * H, S, d)
    kf = k.reshape(B * H, T, d)
    vf = v.reshape(B * H, T, d)
    if _on_cuda(q, 'flash_attention'):
        _no_backward('flash_attention', q, k, v)
        out = _fa.flash_attention_kernel(qf.contiguous(), kf.contiguous(),
                                         vf.contiguous(), causal=causal,
                                         scale=scale)
    else:
        out = _fa.flash_attention_plain(qf, kf, vf, causal=causal,
                                        scale=scale)
    return out.reshape(B, H, S, d)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, S, H, d), k/v (B, T, G, d) with H % G == 0 -> (B, S, H, d)
    in q's type; query head h reads KV head h // (H // G).  On CUDA the
    kernel reads every operand where it lies (a slice of the KV cache
    included): no head repeat, no transpose, no copy."""
    if _on_cuda(q, 'flash_attention'):
        _no_backward('flash_attention_bshd', q, k, v)
        return _fa.flash_attention_bshd_kernel(q, k, v, causal=causal,
                                               scale=scale)
    return _fa.flash_attention_bshd_plain(q, k, v, causal=causal,
                                          scale=scale)


def conv2d(x: torch.Tensor, w: torch.Tensor, pad_h: Tuple[int, int],
           pad_w: Tuple[int, int], stride: int = 1, *,
           bias: Optional[torch.Tensor] = None,
           row: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None, taps: _cv.Taps = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Correlation of NHWC ``x`` (N, H, W, Cin) with the OIHW kernel ``w``
    (Cout, Cin, kh, kw), or the ``taps = (rows, cols)`` of it, under
    explicit (lo, hi) padding per spatial dim (negative crops), then
    ``+ bias``, ``+ row[:, None, None, :]`` and ``residual +``, each
    optional, in that order: (N, Ho, Wo, Cout), written into ``out`` when
    one is given (a view such as ``y[:, py::2, px::2, :]``).  On CUDA the
    kernel writes there itself; under a wanted gradient it runs inside
    ``Conv2d`` and its output is copied in."""
    if x.device.type == 'cuda' and not _without_memory(x):
        if not _grad_wanted(x, w, bias, row, residual):
            return _cv.conv2d_kernel(x, w, pad_h, pad_w, stride, bias, row,
                                     residual, taps=taps, out=out)
        y = _cv.Conv2d.apply(x, w, bias, row, residual, pad_h, pad_w,
                             stride, taps)
    elif x.device.type in ('cpu', 'meta') or _without_memory(x):
        y = _cv.conv2d_plain(x, _cv.tap_grid(w, taps), pad_h, pad_w, stride,
                             bias, row, residual)
    else:
        raise ValueError(f'conv2d: no kernel for device {x.device}')
    if out is None:
        return y
    return out.copy_(y)
