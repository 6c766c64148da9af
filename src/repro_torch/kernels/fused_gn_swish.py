"""Fused GroupNorm + swish (DiffLight C5): the CUDA kernel of
``csrc/fused_gn_swish.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/fused_gn_swish.py::
fused_gn_swish_kernel``; the plain version repeats the reference's
arithmetic (``repro/kernels/ref.py::gn_swish_ref``) and is what the CPU
runs.  ``kernels/ops.py`` picks one by the tensor's device.

The kernel writes its output through ``ctypes``, so autograd cannot see
it.  ``GNSwish`` gives it a gradient: its forward launches the kernel,
its backward is the plain ``gn_swish_backward_plain`` (the reference has
no backward kernel either).  ``ops.fused_gn_swish`` routes a CUDA call
through it only when a gradient is wanted.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

#: launches of the CUDA kernel since the last reset (``ops.reset_launches``)
launches = 0

#: shared memory one block may use on the H100 (232,448 bytes), less room
#: for the kernel's static reduction scratch
SMEM_PER_BLOCK = 232448 - 1024
MAX_CLUSTER = 8        # portable cluster size
CHUNK_BYTES = 32 * 1024  # aim per block: enough blocks to fill 132 SMs

_fn = None


def gn_swish_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5) -> torch.Tensor:
    """x (N, H, W, C) NHWC, scale/bias (C,); C % groups == 0.  Population
    variance (mean of squared deviations), as ``jnp.var``."""
    N, H, W, C = x.shape
    xf = x.float().reshape(N, H, W, groups, C // groups)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 2, 4), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(N, H, W, C)
    y = y * scale + bias
    return (y * torch.sigmoid(y)).to(x.dtype)


def gn_swish_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, groups: int,
                            grad_out: torch.Tensor, eps: float = 1e-5):
    """The gradient of ``gn_swish_plain`` at ``x`` for the output gradient
    ``grad_out``: ``(dx, dscale, dbias)``.  The group mean and rstd are
    recomputed from ``x`` (nothing but the inputs is saved).  With
    ``xhat`` the normalised input, ``y = xhat * scale + bias`` and ``dy``
    the gradient through swish (``s + y s (1 - s)``, ``s = sigmoid(y)``),
    ``dx = rstd (g - mean(g) - xhat mean(g xhat))`` over each (n, group),
    ``g = dy * scale``."""
    N, H, W, C = x.shape
    cg = C // groups
    xf = x.float().reshape(N, H * W, groups, cg)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt(xc.square().mean(dim=(1, 3), keepdim=True) + eps)
    xhat = (xc * rstd).reshape(N, H * W, C)
    y = xhat * scale + bias
    s = torch.sigmoid(y)
    dy = grad_out.float().reshape(N, H * W, C) * (s * (1 + y * (1 - s)))
    dscale = (dy * xhat).sum(dim=(0, 1))
    dbias = dy.sum(dim=(0, 1))
    g = (dy * scale).reshape(N, H * W, groups, cg)
    xhat = xhat.reshape(N, H * W, groups, cg)
    dx = rstd * (g - g.mean(dim=(1, 3), keepdim=True)
                 - xhat * (g * xhat).mean(dim=(1, 3), keepdim=True))
    return (dx.reshape(N, H, W, C).to(x.dtype), dscale.to(scale.dtype),
            dbias.to(bias.dtype))


@dataclasses.dataclass(frozen=True)
class GNPlan:
    cluster: int     # blocks per (n, group) slab, 1..MAX_CLUSTER
    chunk: int       # H*W positions per block
    resident: bool   # chunk held in shared memory
    smem: int        # dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=None)
def gn_plan(HW: int, cg: int) -> GNPlan:
    """Cluster and chunk of one (H*W, C/g) slab: about ``CHUNK_BYTES`` a
    block, at most ``MAX_CLUSTER`` blocks, no block without a position; a
    slab small enough for one block gets a cluster of one.  The chunk is
    kept in shared memory when it fits (every Stable Diffusion v1.4 slab
    does)."""
    slab = HW * cg * 4
    cluster = min(MAX_CLUSTER, HW, max(1, -(-slab // CHUNK_BYTES)))
    chunk = -(-HW // cluster)
    cluster = -(-HW // chunk)
    smem = chunk * cg * 4
    resident = smem <= SMEM_PER_BLOCK
    return GNPlan(cluster, chunk, resident, smem if resident else 0)


def prepare(device) -> None:
    """Load the kernel's library (built first if needed) and raise the
    kernel's shared-memory limit on the CUDA ``device``, as its first
    launch there would; launches nothing."""
    from repro_torch.kernels.build import load
    fn = load('fused_gn_swish').fused_gn_swish_prepare
    fn.argtypes = []
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn()
    if err:
        raise RuntimeError(f'fused_gn_swish_prepare failed on {device}: CUDA '
                           f'error {err}')


def _kernel_fn():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load
        fn = load('fused_gn_swish').fused_gn_swish_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_gn_swish_kernel(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of x's device (made
    the current device for the launch): one cluster of
    ``gn_plan(H*W, C/groups).cluster`` blocks per (n, group).  x (N, H, W,
    C) contiguous float32 on a CUDA device, scale/bias (C,) float32 on the
    same device, C % groups == 0."""
    global launches
    if not x.is_cuda:
        raise ValueError('fused_gn_swish_kernel needs a CUDA tensor')
    if x.dim() != 4:
        raise ValueError(f'x must be (N, H, W, C), got {tuple(x.shape)}')
    N, H, W, C = x.shape
    if C % groups:
        raise ValueError(f'{C} channels do not split into {groups} groups')
    dev = x.get_device()             # checks kept cheap: this is per call
    for name, t, shape in (('x', x, x.shape), ('scale', scale, (C,)),
                           ('bias', bias, (C,))):
        if t.dtype is not torch.float32 or t.get_device() != dev:
            raise ValueError(f'{name} must be float32 on {x.device}')
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous {tuple(shape)}, '
                             f'got {tuple(t.shape)}')
    plan = gn_plan(H * W, C // groups)
    out = torch.empty_like(x)
    fn = _kernel_fn()
    with torch.cuda.device(dev):     # the launch goes to the current device
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), N, H * W, C, groups, plan.cluster,
                 plan.chunk, int(plan.resident), eps,
                 torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f'fused_gn_swish launch failed: CUDA error {err}')
    launches += 1
    return out


class GNSwish(torch.autograd.Function):
    """``fused_gn_swish_kernel`` with a gradient: the forward launches the
    kernel (and counts as its launch), the backward runs
    ``gn_swish_backward_plain`` from the saved ``x``, ``scale`` and
    ``bias``.  ``GNSwish.apply(x, scale, bias, groups, eps)``."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float = 1e-5):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        return fused_gn_swish_kernel(x, scale, bias, groups, eps)

    @staticmethod
    def backward(ctx, grad_out):
        x, scale, bias = ctx.saved_tensors
        grads = gn_swish_backward_plain(x, scale, bias, ctx.groups,
                                        grad_out, ctx.eps)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None, None)
