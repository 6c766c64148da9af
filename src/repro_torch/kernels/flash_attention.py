"""Flash attention with the paper's streaming LSE softmax (C2): the CUDA
kernel of ``csrc/flash_attention.cu`` and its plain PyTorch version.

Contract of both: q ``(BH, S, d)``, k/v ``(BH, T, d)`` -> ``(BH, S, d)``
in q's type, float32 arithmetic, q scaled before the product, an
optional causal mask ``k_pos <= q_pos`` counted from 0, and the final
``acc / max(l, 1e-30)``.  The kernel replaces
``repro/kernels/flash_attention.py::flash_attention_kernel`` and takes
any S and T (ragged edges are masked inside it); the plain version is
``streaming_attention_ref`` with ``block = 128``, which is what the
reference's wrapper runs off the TPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.lse_softmax import streaming_attention_ref

#: launches of the CUDA kernel since the last reset (``ops.reset_launches``)
launches = 0

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
#: (q dtype, k/v dtype) pairs the kernel takes
DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16))

_fn = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    return streaming_attention_ref(q, k, v, block=128, causal=causal,
                                   scale=scale)


def _kernel_fn():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load('flash_attention').flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Same contract as
    ``flash_attention_plain``; every tensor contiguous on one CUDA
    device, d in ``HEAD_DIMS``, dtypes one of ``DTYPES``."""
    global launches
    if not q.is_cuda:
        raise ValueError('flash_attention_kernel needs CUDA tensors')
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f'bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}'
                         f', v {tuple(v.shape)}: want (BH, S, d), (BH, T, d)')
    BH, S, d = q.shape
    T = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f'head dim {d} not in {HEAD_DIMS}')
    if BH == 0 or S == 0 or T == 0 or BH > 65535:
        raise ValueError(f'BH = {BH}, S = {S}, T = {T}: need 0 < BH <= '
                         '65535 and S, T > 0')
    if (q.dtype, k.dtype) not in DTYPES or v.dtype != k.dtype:
        raise ValueError(f'dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} not '
                         f'among {DTYPES}')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous on {q.device}')
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), BH, S, T, d,
                       int(q.dtype == torch.bfloat16),
                       int(k.dtype == torch.bfloat16), scale, int(causal),
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f'flash_attention launch failed: CUDA error {err}')
    launches += 1
    return out
