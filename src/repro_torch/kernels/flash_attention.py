"""Flash attention with the paper's streaming LSE softmax (C2): the CUDA
kernel of ``csrc/flash_attention.cu`` and its plain PyTorch version.

Contract of both: q ``(BH, S, d)``, k/v ``(BH, T, d)`` -> ``(BH, S, d)``
in q's type, float32 arithmetic, q scaled before the product, an
optional causal mask ``k_pos <= q_pos`` counted from 0, and the final
``acc / max(l, 1e-30)``.  The kernel replaces
``repro/kernels/flash_attention.py::flash_attention_kernel`` and takes
any S and T (ragged edges are masked inside it); the plain version is
``streaming_attention_ref`` with ``block = 128``, which is what the
reference's wrapper runs off the TPU.  The kernel runs both products on
the tensor cores in error-compensated TF32 (hi/lo split, three TF32
products per float32 product), which keeps the float32 contract.

The second entry, ``flash_attention_bshd``, computes the same function
on the LM's layout where it lies: q ``(B, S, H, d)``, k/v ``(B, T, G,
d)`` with ``H % G == 0`` and KV head ``h // (H // G)``, each with its
own strides (last dimension contiguous) -> ``(B, S, H, d)`` contiguous.
Both entries launch the same kernel and count one launch each.
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
#: TF32 products per float32 product: q (or P) is split into hi + lo, and
#: so is a float32 K or V; a bf16 K or V is exact in TF32 (lo = 0)
PASSES = {torch.float32: 3, torch.bfloat16: 2}

_fn = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    return streaming_attention_ref(q, k, v, block=128, causal=causal,
                                   scale=scale)


def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = False,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The plain version on q (B, S, H, d), k/v (B, T, G, d): repeat the
    KV heads, move heads before rows, stream, and move them back."""
    H, G = q.shape[2], k.shape[2]
    if H != G:
        k = k.repeat_interleave(H // G, dim=2)
        v = v.repeat_interleave(H // G, dim=2)
    out = streaming_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), block=128,
                                  causal=causal, scale=scale)
    return out.transpose(1, 2).contiguous()


def _kernel_fn():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load('flash_attention').flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_common(q, k, v, d: int) -> None:
    if not q.is_cuda:
        raise ValueError('the flash kernel needs CUDA tensors')
    if d not in HEAD_DIMS:
        raise ValueError(f'head dim {d} not in {HEAD_DIMS}')
    if (q.dtype, k.dtype) not in DTYPES or v.dtype != k.dtype:
        raise ValueError(f'dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} not '
                         f'among {DTYPES}')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device != q.device:
            raise ValueError(f'{name} must be on {q.device}')


def _strides(name: str, t: torch.Tensor):
    """The element strides of a (B, rows, heads, d) view's first three
    dimensions, as the kernel takes them: last dimension contiguous,
    16-byte aligned, the other strides multiples of 8 elements (a
    dimension of size 1 takes any stride)."""
    st = [s if n > 1 else 8 for s, n in zip(t.stride()[:3], t.shape[:3])]
    if t.stride(3) != 1 or any(s % 8 for s in st) or t.data_ptr() % 16:
        raise ValueError(f'{name} {tuple(t.shape)} with strides {t.stride()}'
                         ': the last dimension must be contiguous, the '
                         'others strided by multiples of 8 elements, the '
                         'data 16-byte aligned')
    return st


def _launch(q4, k4, v4, out4, causal: bool, scale: Optional[float]):
    """Launch on (B, S, H, d), (B, T, G, d) views; out4 (B, S, H, d)."""
    global launches
    B, S, H, d = q4.shape
    T, G = k4.shape[1], k4.shape[2]
    strides = []
    for name, t in (('q', q4), ('k', k4), ('v', v4), ('out', out4)):
        strides += _strides(name, t)
    if scale is None:
        scale = d ** -0.5
    fn = _kernel_fn()
    # the launch goes to the current device: make it the operands'
    with torch.cuda.device(q4.device):
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                 out4.data_ptr(), B, H, G, S, T, d,
                 ctypes.cast((ctypes.c_longlong * 12)(*strides),
                             ctypes.c_void_p),
                 int(q4.dtype == torch.bfloat16),
                 int(k4.dtype == torch.bfloat16), scale, int(causal),
                 torch.cuda.current_stream(q4.device).cuda_stream)
    if err:
        raise RuntimeError(f'flash_attention launch failed: CUDA error {err}')
    launches += 1


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of q's device.  Same
    contract as ``flash_attention_plain``; every tensor contiguous on one
    CUDA device, d in ``HEAD_DIMS``, dtypes one of ``DTYPES``."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f'bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}'
                         f', v {tuple(v.shape)}: want (BH, S, d), (BH, T, d)')
    BH, S, d = q.shape
    T = k.shape[1]
    _check_common(q, k, v, d)
    if BH == 0 or S == 0 or T == 0 or BH > 65535:
        raise ValueError(f'BH = {BH}, S = {S}, T = {T}: need 0 < BH <= '
                         '65535 and S, T > 0')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous on {q.device}')
    out = torch.empty_like(q)
    _launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), out.unsqueeze(2),
            causal, scale)
    return out


def flash_attention_bshd_kernel(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = False,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Launch the CUDA kernel on q (B, S, H, d) and k/v (B, T, G, d) as
    they lie (a slice of a longer KV cache included); returns (B, S, H,
    d) contiguous in q's type.  Same contract as
    ``flash_attention_bshd_plain``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f'bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}'
                         f', v {tuple(v.shape)}: want (B, S, H, d), '
                         '(B, T, G, d)')
    B, S, H, d = q.shape
    T, G = k.shape[1], k.shape[2]
    _check_common(q, k, v, d)
    if min(B, S, H, T, G) == 0 or H % G or B * H > 65535:
        raise ValueError(f'B = {B}, S = {S}, H = {H}, T = {T}, G = {G}: need '
                         'all > 0, H % G == 0 and B * H <= 65535')
    out = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, scale)
    return out
