"""W8A8 GEMM (DiffLight C1): the CUDA kernel of ``csrc/w8a8_matmul.cu``
and its plain PyTorch version.

Contract of both: int8 ``(M, K)`` x int8 ``(K, N)`` accumulated exactly
in int32, then ``float(acc) * x_scale[m] * w_scale[n]`` in that order.
The kernel replaces ``repro/kernels/w8a8_matmul.py::w8a8_matmul_kernel``;
the plain version is bit-identical to ``repro/kernels/ref.py::
w8a8_matmul_ref``.
"""
from __future__ import annotations

import ctypes

import torch

#: launches of the CUDA kernel since the last reset (``ops.reset_launches``)
launches = 0

_fn = None


def w8a8_matmul_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                      wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8, x_scale (M, 1) f32, wq (K, N) int8, w_scale (1, N)
    f32 -> (M, N) f32.  The product runs in float64, which holds every
    partial sum exactly (|acc| <= K * 127^2 < 2^53 for any K below 5e11)
    and exists on CUDA, where torch has no int32 matmul."""
    acc = (xq.double() @ wq.double()).to(torch.int32)
    return acc.float() * x_scale * w_scale


def _kernel_fn():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load('w8a8_matmul').w8a8_matmul_s8
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def w8a8_matmul_kernel(xq: torch.Tensor, x_scale: torch.Tensor,
                       wq: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Same contract as
    ``w8a8_matmul_plain``; every tensor contiguous on one CUDA device.
    Ragged M, N, K are masked in the kernel: no padding needed."""
    global launches
    if not xq.is_cuda:
        raise ValueError('w8a8_matmul_kernel needs CUDA tensors')
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f'bad operand shapes {tuple(xq.shape)} x '
                         f'{tuple(wq.shape)}')
    M, K = xq.shape
    N = wq.shape[1]
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f'empty product ({M}, {K}) x ({K}, {N})')
    for name, t, dtype, numel in (('xq', xq, torch.int8, M * K),
                                  ('x_scale', x_scale, torch.float32, M),
                                  ('wq', wq, torch.int8, K * N),
                                  ('w_scale', w_scale, torch.float32, N)):
        if t.dtype != dtype or t.device != xq.device:
            raise ValueError(f'{name} must be {dtype} on {xq.device}')
        if t.numel() != numel or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous with {numel} '
                             f'elements, got {tuple(t.shape)}')
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = _kernel_fn()(xq.data_ptr(), x_scale.data_ptr(), wq.data_ptr(),
                       w_scale.data_ptr(), out.data_ptr(), M, N, K,
                       torch.cuda.current_stream(xq.device).cuda_stream)
    if err:
        raise RuntimeError(f'w8a8_matmul launch failed: CUDA error {err}')
    launches += 1
    return out
