"""Convolution on NHWC: the CUDA kernel of ``csrc/conv2d_nhwc.cu`` and
its plain PyTorch version.

Contract of both: the correlation of an NHWC input with an OIHW kernel
``(Cout, Cin, kh, kw)`` under explicit (lo, hi) padding per spatial dim
(negative padding crops) at stride 1 or 2, then in this order ``+ bias``
(``(Cout,)``), ``+ row[:, None, None, :]`` (``(N, Cout)``: the ResBlock's
time embedding) and ``residual + `` (``(N, Ho, Wo, Cout)``: the
ResBlock's skip), each optional, as the unfused code adds them.  ``taps
= (rows, cols)`` takes only those rows and columns of the kernel's taps
(a phase of the sparse transposed convolution).

The kernel replaces no TPU kernel (the JAX package leaves convolution to
XLA); it takes the port's float32 convolutions off cuDNN's CUDA-core
kernels onto the TF32 tensor cores in error-compensated 3xTF32.  The
plain version is today's ``F.conv2d`` path and is what the CPU runs.
The kernel reads the weight as (Cout, kh, kw, Cin), split into TF32 hi
and lo halves (``kernel_weight``), made once per weight and remade when
an in-place update bumps its version.  ``conv_plan`` picks its tile from
what it can see: output pixels and channels.

The kernel writes through ``ctypes``, so autograd cannot see it;
``Conv2d`` gives it a gradient (the kernel forward, a plain backward),
as ``GNSwish`` does for GroupNorm+swish.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

#: launches of the CUDA kernel since the last reset (``ops.reset_launches``)
launches = 0

SMS = 132            # H100 SXM streaming multiprocessors
C_ALIGN = 4          # channels: TMA's 16-byte row-stride granule
TILE_ROWS = (128, 64)            # output pixels per block, widest first
TILE_COLS = (16, 64, 128)        # output channels per block
HALF_ULP = 0x1000                # half a TF32 ulp, in float32 bits
HI_MASK = -0x2000                # 0xffffe000: sign, exponent, 10 bits

Taps = Optional[Tuple[Sequence[int], Sequence[int]]]

_fn = None


def tap_grid(w: torch.Tensor, taps: Taps) -> torch.Tensor:
    """The kernel ``w`` (Cout, Cin, kh, kw) cut to the taps' rows and
    columns (all of them when ``taps`` is None)."""
    if taps is None:
        return w
    rows, cols = taps
    return w[:, :, list(rows)][:, :, :, list(cols)]


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, pad_h: Tuple[int, int],
                 pad_w: Tuple[int, int], stride: int = 1,
                 bias: Optional[torch.Tensor] = None,
                 row: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, Cin) NHWC, w (Cout, Cin, kh, kw) -> (N, Ho, Wo, Cout).
    The NHWC tensor is handed to ``F.conv2d`` as a channels-last NCHW
    view, so no layout copy is made; unequal or negative padding pads
    (crops) first."""
    xc = x.permute(0, 3, 1, 2)
    if pad_h[0] == pad_h[1] >= 0 and pad_w[0] == pad_w[1] >= 0:
        y = F.conv2d(xc, w, stride=stride, padding=(pad_h[0], pad_w[0]))
    else:
        xc = F.pad(xc, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
        y = F.conv2d(xc, w, stride=stride)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    if row is not None:
        y = y + row[:, None, None, :]
    if residual is not None:
        y = residual + y
    return y


# ---------------------------------------------------------------------------
# the weight the kernel reads
# ---------------------------------------------------------------------------

def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` -> (hi, lo): hi = t rounded to the nearest TF32 value
    (ties away from zero, on the bits: add half a TF32 ulp, clear the 13
    low mantissa bits), lo = t - hi rounded the same way; the kernel's
    split of its activations, done once for a weight."""
    def rnd(v):
        return ((v.view(torch.int32) + HALF_ULP) & HI_MASK).view(torch.float32)
    hi = rnd(t)
    return hi, rnd(t - hi)


def weight_layout(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, kh, kw) -> (Cout, kh, kw, Cp) contiguous float32,
    Cin zero-padded to Cp, a multiple of ``C_ALIGN``."""
    Cin = w.shape[1]
    wt = w.detach().float().permute(0, 2, 3, 1)
    if Cin % C_ALIGN:
        wt = F.pad(wt, (0, C_ALIGN - Cin % C_ALIGN))
    return wt.contiguous()


def kernel_weight(w: torch.Tensor, taps: Taps = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (hi, lo) halves of ``tap_grid(w, taps)`` in
    ``weight_layout``, made at the first call and kept on ``w`` until
    ``w`` changes (its version or its storage), so a static weight is
    split once and a training step's update makes it anew."""
    key = None if taps is None else (tuple(taps[0]), tuple(taps[1]))
    cache = w.__dict__.setdefault('_tf32x3', {})
    # an inference tensor keeps no version: it cannot change outside
    # inference mode
    stamp = (None if w.is_inference() else w._version, w.data_ptr(),
             w.device)
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = cache[key] = (stamp,) + split_tf32(
            weight_layout(tap_grid(w.detach(), taps)))
    return hit[1], hit[2]


# ---------------------------------------------------------------------------
# the kernel's plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvPlan:
    rows: int        # output pixels per block: 128 or 64
    cols: int        # output channels per block: 128, 64 or 16
    box: Tuple[int, int, int]   # the pixels of a block: (bw, bh, bn)
    blocks: int


def _box(N: int, Ho: int, Wo: int, rows: int) -> Tuple[int, int, int]:
    bw = min(Wo, rows)
    bh = min(Ho, rows // bw)
    bn = min(N, rows // (bw * bh)) if bh == Ho else 1
    return bw, bh, bn


@functools.lru_cache(maxsize=None)
def conv_plan(N: int, Ho: int, Wo: int, Cout: int) -> ConvPlan:
    """Tile of the kernel for an (N, Ho, Wo, Cout) output.  A block's
    pixels are a box of the output: ``bw`` of a row (all of it when it
    fits), ``bh`` rows, and ``bn`` whole images when whole images fit.
    128-pixel blocks, or 64-pixel ones where 128 would leave SMs idle
    (fewer blocks than ``SMS``); the narrowest channel width that holds
    Cout up to 128 (64-channel blocks to fill the SMs measured slower:
    half the products for each split of the activations)."""
    cols = next((c for c in TILE_COLS if Cout <= c), TILE_COLS[-1])
    ctiles = -(-Cout // cols)
    for rows in TILE_ROWS:
        bw, bh, bn = _box(N, Ho, Wo, rows)
        blocks = -(-Wo // bw) * -(-Ho // bh) * -(-N // bn) * ctiles
        if blocks >= SMS:
            break
    return ConvPlan(rows, cols, (bw, bh, bn), blocks)


def out_size(size: int, k: int, pad: Tuple[int, int], stride: int) -> int:
    return (size + pad[0] + pad[1] - k) // stride + 1


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

def prepare(device) -> None:
    """Load the kernel's library (built first if needed) and raise every
    tile's shared-memory limit on the CUDA ``device``, as its first launch
    there would; launches nothing."""
    from repro_torch.kernels.build import load
    fn = load('conv2d_nhwc').conv2d_nhwc_prepare
    fn.argtypes = []
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn()
    if err:
        raise RuntimeError(f'conv2d_nhwc_prepare failed on {device}: CUDA '
                           f'error {err}')


def _kernel_fn():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load('conv2d_nhwc').conv2d_nhwc_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [
            ctypes.c_longlong] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _operand(name: str, t: Optional[torch.Tensor], shape, dev) -> int:
    if t is None:
        return 0
    if t.dtype is not torch.float32 or t.get_device() != dev:
        raise ValueError(f'{name} must be float32 on cuda:{dev}')
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous {tuple(shape)}, got '
                         f'{tuple(t.shape)}')
    return t.data_ptr()


def conv2d_kernel(x: torch.Tensor, w: torch.Tensor, pad_h: Tuple[int, int],
                  pad_w: Tuple[int, int], stride: int = 1,
                  bias: Optional[torch.Tensor] = None,
                  row: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None, *,
                  taps: Taps = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of x's device (made
    the current device for the launch): ``conv2d_plain`` of x (N, H, W,
    Cin) float32 and ``tap_grid(w, taps)``, with the epilogue's operands,
    written into ``out`` (a float32 (N, Ho, Wo, Cout) view with contiguous
    channels, e.g. ``y[:, py::2, px::2, :]``) or a new tensor.  An input
    whose channels are not a multiple of ``C_ALIGN`` is copied with zero
    channels appended."""
    global launches
    if not x.is_cuda:
        raise ValueError('conv2d_kernel needs a CUDA tensor')
    if x.dim() != 4 or w.dim() != 4 or x.shape[-1] != w.shape[1]:
        raise ValueError(f'bad operands: x {tuple(x.shape)}, w '
                         f'{tuple(w.shape)}')
    if x.dtype is not torch.float32 or w.dtype is not torch.float32:
        raise ValueError('conv2d_kernel takes float32 x and w')
    if stride not in (1, 2):
        raise ValueError(f'stride {stride}: the kernel takes 1 or 2')
    N, H, W, Cin = x.shape
    if stride == 2 and (H < 2 or W < 2):
        raise ValueError(f'stride 2 needs H, W >= 2, got {(H, W)}')
    hi, lo = kernel_weight(w, taps)
    Cout, kh, kw, Cp = hi.shape
    Ho, Wo = out_size(H, kh, pad_h, stride), out_size(W, kw, pad_w, stride)
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f'empty output {(Ho, Wo)}')
    dev = x.get_device()
    if hi.get_device() != dev:
        raise ValueError(f'w must be on {x.device}')
    xk = x.contiguous() if Cp == Cin else F.pad(x, (0, Cp - Cin))
    if xk.data_ptr() % 16:
        xk = xk.clone()
    if out is None:
        out = torch.empty((N, Ho, Wo, Cout), dtype=torch.float32,
                          device=x.device)
    elif (out.dtype is not torch.float32 or out.get_device() != dev
          or tuple(out.shape) != (N, Ho, Wo, Cout) or out.stride(3) != 1):
        raise ValueError(f'out must be float32 {(N, Ho, Wo, Cout)} with '
                         f'contiguous channels on {x.device}')
    bias, row, residual = (None if t is None else t.contiguous()
                           for t in (bias, row, residual))
    ptrs = [_operand('bias', bias, (Cout,), dev),
            _operand('row', row, (N, Cout), dev),
            _operand('residual', residual, (N, Ho, Wo, Cout), dev)]
    plan = conv_plan(N, Ho, Wo, Cout)
    fn = _kernel_fn()
    with torch.cuda.device(dev):     # the launch goes to the current device
        err = fn(xk.data_ptr(), hi.data_ptr(), lo.data_ptr(), *ptrs,
                 out.data_ptr(), N, H, W, Cp, Ho, Wo, Cout, kh, kw,
                 -pad_h[0], -pad_w[0], stride, out.stride(0), out.stride(1),
                 out.stride(2), plan.rows, plan.cols, *plan.box,
                 torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f'conv2d_nhwc launch failed: CUDA error {err}')
    launches += 1
    return out


class Conv2d(torch.autograd.Function):
    """``conv2d_kernel`` with a gradient: the forward launches the kernel
    (and counts as its launch), the backward differentiates
    ``conv2d_plain`` at the saved ``x`` and ``w`` for x and w, and takes
    the bias's, row's and residual's gradients as sums of the output's.
    ``Conv2d.apply(x, w, bias, row, residual, pad_h, pad_w, stride,
    taps)``."""

    @staticmethod
    def forward(ctx, x, w, bias, row, residual, pad_h, pad_w, stride, taps):
        ctx.save_for_backward(x, w)
        ctx.conf = (pad_h, pad_w, stride, taps)
        return conv2d_kernel(x, w, pad_h, pad_w, stride, bias, row, residual,
                             taps=taps)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        pad_h, pad_w, stride, taps = ctx.conf
        need = ctx.needs_input_grad
        gx = gw = None
        if need[0] or need[1]:
            with torch.enable_grad():
                xd = x.detach().requires_grad_(need[0])
                wd = w.detach().requires_grad_(need[1])
                y = conv2d_plain(xd, tap_grid(wd, taps), pad_h, pad_w,
                                 stride)
            wrt = [t for t, n in ((xd, need[0]), (wd, need[1])) if n]
            grads = list(torch.autograd.grad(y, wrt, gy))
            gx = grads.pop(0) if need[0] else None
            gw = grads.pop(0) if need[1] else None
        return (gx, gw, gy.sum((0, 1, 2)) if need[2] else None,
                gy.sum((1, 2)) if need[3] else None,
                gy if need[4] else None, None, None, None, None)
