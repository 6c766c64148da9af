"""W8A8 GEMM (DiffLight C1): the CUDA kernel of ``csrc/w8a8_matmul.cu``
and its plain PyTorch version.

Contract of both: int8 ``(M, K)`` x int8 ``(K, N)`` accumulated exactly
in int32, then ``float(acc) * x_scale[m] * w_scale[n]`` in that order.
The kernel replaces ``repro/kernels/w8a8_matmul.py::w8a8_matmul_kernel``;
the plain version is bit-identical to ``repro/kernels/ref.py::
w8a8_matmul_ref``.

The kernel runs on the int8 tensor cores (``wgmma``), whose 8-bit forms
take both operands K-major: it reads the activations as ``(M, Kp)`` and
the weight as its K-major copy ``(N, Kp)``, both with K zero-padded to
``Kp``, a multiple of ``K_ALIGN`` (its TMA loads need 16-byte row
strides).  The helpers below build those operands, the weight's in the
pass that quantizes it; ``w8a8_plan`` picks the kernel's tile and split.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.quantization import rounded

#: launches of the CUDA kernel since the last reset (``ops.reset_launches``):
#: one per product, however many device launches the product takes
launches = 0

K_ALIGN = 16        # bytes: TMA's global row stride granule
K_BOX = 128         # K bytes per shared-memory stage (one swizzle row)
TILE_ROWS = 128     # rows of the kernel's first operand per block
SMALL_M = 64        # below this M the kernel swaps its operands
SMALL_WIDTHS = (8, 16, 32, 64)   # wgmma N for the activations when swapped
SMS = 132           # H100 SXM streaming multiprocessors

_fn = None


def w8a8_matmul_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                      wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8, x_scale (M, 1) f32, wq (K, N) int8, w_scale (1, N)
    f32 -> (M, N) f32.  The product runs in float64, which holds every
    partial sum exactly (|acc| <= K * 127^2 < 2^53 for any K below 5e11)
    and exists on CUDA, where torch has no int32 matmul."""
    acc = (xq.double() @ wq.double()).to(torch.int32)
    return acc.float() * x_scale * w_scale


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def padded_k(K: int) -> int:
    return -(-K // K_ALIGN) * K_ALIGN


def pad_k(q: torch.Tensor) -> torch.Tensor:
    """Rounded (R, K) values, float or int8, any strides -> contiguous
    (R, Kp) int8 with zero columns appended; the cast, the layout and the
    padding are one pass."""
    R, K = q.shape
    Kp = padded_k(K)
    if Kp == K and q.dtype == torch.int8 and q.is_contiguous():
        return q
    out = torch.empty((R, Kp), dtype=torch.int8, device=q.device)
    if Kp == K:
        return out.copy_(q)
    out[:, K:] = 0
    out[:, :K] = q
    return out


def kmajor_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 (K, N) weight -> its K-major, K-padded copy (N, Kp)."""
    return pad_k(wq.t())


def quantize_rows_padded(x: torch.Tensor):
    """Activations (M, K) float -> (int8 (M, Kp), scale (M, 1)): the
    values of ``quantize(x, axis=(1,))``, written K-padded."""
    q, scale = rounded(x, (1,))
    return pad_k(q), scale


def quantize_weight_kmajor(w: torch.Tensor):
    """Weight (K, N) float -> (int8 (N, Kp), scale (1, N)): the values of
    ``quantize_per_channel(w)``, written transposed and K-padded by the
    pass that casts them to int8."""
    q, scale = rounded(w, (0,))
    return pad_k(q.t()), scale


# ---------------------------------------------------------------------------
# the kernel's plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class W8A8Plan:
    swap: bool       # weight as the 64-row wgmma operand (small M)
    bn: int          # wgmma N: the second operand's rows per block
    split: int       # K split over blocks; divides k_boxes
    k_boxes: int     # 128-byte K boxes of the padded K
    blocks: int

    @property
    def device_launches(self) -> int:
        """memset + GEMM + epilogue when K is split, else the GEMM."""
        return 3 if self.split > 1 else 1


@functools.lru_cache(maxsize=None)
def w8a8_plan(M: int, N: int, K: int) -> W8A8Plan:
    """Tile and split of the kernel for (M, K) x (K, N).  M >= 64: the
    activations are the 128-row operand, tiles of 128 x 128, no split.
    M < 64: the weight is, the activations' width is M rounded up to 8, 16,
    32 or 64, and K splits by the smallest divisor of its box count that
    gives at least ``SMS`` blocks (the weight's bytes are the whole bound,
    so every SM should stream them)."""
    k_boxes = -(-padded_k(K) // K_BOX)
    if M >= SMALL_M:
        blocks = -(-M // TILE_ROWS) * -(-N // 128)
        return W8A8Plan(False, 128, 1, k_boxes, blocks)
    bn = next(b for b in SMALL_WIDTHS if M <= b)
    tiles = -(-N // TILE_ROWS)
    split = k_boxes
    for d in range(1, k_boxes + 1):
        if k_boxes % d == 0 and tiles * d >= SMS:
            split = d
            break
    return W8A8Plan(True, bn, split, k_boxes, tiles * split)


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

def prepare(device) -> None:
    """Load the kernel's library (built first if needed) and raise the
    kernel's shared-memory limit on the CUDA ``device``, as its first
    launch there would; launches nothing."""
    from repro_torch.kernels.build import load
    fn = load('w8a8_matmul').w8a8_matmul_prepare
    fn.argtypes = []
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn()
    if err:
        raise RuntimeError(f'w8a8_matmul_prepare failed on {device}: CUDA '
                           f'error {err}')


def _kernel_fn():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load('w8a8_matmul').w8a8_matmul_s8
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def w8a8_matmul_kernel(xq: torch.Tensor, x_scale: torch.Tensor,
                       wt: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the operands'
    device (made the current device for the launch): xq (M, Kp) int8,
    x_scale (M, 1) f32, wt (N, Kp) int8 -- the K-major weight -- and
    w_scale (1, N) f32, every tensor contiguous on one CUDA device, Kp a
    multiple of ``K_ALIGN`` (``pad_k``, ``kmajor_weight``).  Equals
    ``w8a8_matmul_plain`` on the unpadded (M, K) x (K, N) operands."""
    global launches
    if not xq.is_cuda:
        raise ValueError('w8a8_matmul_kernel needs CUDA tensors')
    if xq.dim() != 2 or wt.dim() != 2 or xq.shape[1] != wt.shape[1]:
        raise ValueError(f'bad operand shapes {tuple(xq.shape)} x '
                         f'{tuple(wt.shape)}^T')
    M, Kp = xq.shape
    N = wt.shape[0]
    if M == 0 or N == 0 or Kp == 0:
        raise ValueError(f'empty product ({M}, {Kp}) x ({Kp}, {N})')
    if Kp % K_ALIGN:
        raise ValueError(f'K = {Kp} is not padded to a multiple of {K_ALIGN}')
    dev = xq.get_device()            # checks kept cheap: this is per call
    for name, t, dtype, numel in (('xq', xq, torch.int8, M * Kp),
                                  ('x_scale', x_scale, torch.float32, M),
                                  ('wt', wt, torch.int8, N * Kp),
                                  ('w_scale', w_scale, torch.float32, N)):
        if t.dtype is not dtype or t.get_device() != dev:
            raise ValueError(f'{name} must be {dtype} on {xq.device}')
        if t.numel() != numel or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous with {numel} '
                             f'elements, got {tuple(t.shape)}')
    if xq.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError('xq and wt must start 16-byte aligned')
    plan = w8a8_plan(M, N, Kp)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    scratch = (torch.empty((M, N), dtype=torch.int32, device=xq.device)
               if plan.split > 1 else out)
    fn = _kernel_fn()
    with torch.cuda.device(dev):     # the launch goes to the current device
        err = fn(xq.data_ptr(), x_scale.data_ptr(), wt.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 M, N, Kp, int(plan.swap), plan.bn, plan.split,
                 torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f'w8a8_matmul launch failed: CUDA error {err}')
    launches += 1
    return out
