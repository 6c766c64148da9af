"""Sparsity-aware transposed convolution (paper §IV-C), port of
``repro/core/sparse_dataflow.py``.

A stride-s transposed convolution equals s^2 dense stride-1 convolutions
over the un-expanded input, one per output phase, whose outputs
interleave; each phase uses only the kernel taps that land on real
input pixels, so the zero-MACs of the zero-inserted input vanish.

Semantics are those of ``jax.lax.conv_transpose`` with SAME padding and
no kernel flip (correlation), which is NOT ``nn.ConvTranspose2d``:
``out[o] = sum_d k[d] * x[(o + d - pad_a) / s]`` where the division is
exact and in range.

Layouts: activations NHWC; kernels OIHW ``(Cout, Cin, kh, kw)``, i.e.
the reference's HWIO kernel transposed by ``(3, 2, 0, 1)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def _pad_a(k: int, s: int) -> int:
    """Leading padding ``jax.lax.conv_transpose(SAME)`` applies to the
    zero-inserted input (``sparse_dataflow.py:73-76`` of the reference);
    the total is ``k + s - 2``."""
    return k - 1 if s > k - 1 else -(-(k + s - 2) // 2)


def conv_transpose_dense(x: torch.Tensor, kernel: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """Baseline dataflow: zero-insert ``stride - 1`` zeros between input
    pixels, then one dense correlation (SAME: output ``H*s x W*s``)."""
    N, H, W, C = x.shape
    _, _, kh, kw = kernel.shape
    s = stride
    xd = x.new_zeros(N, (H - 1) * s + 1, (W - 1) * s + 1, C)
    xd[:, ::s, ::s, :] = x
    ph, pw = _pad_a(kh, s), _pad_a(kw, s)
    return ops.conv2d(xd, kernel, (ph, kh + s - 2 - ph),
                      (pw, kw + s - 2 - pw))


def _phase_grid(k: int, s: int, phase: int, pad_a: int):
    """Kernel taps feeding output phase ``phase`` along one dim, ordered
    by the input offset each reads, and the offset range (lo, hi); None
    when no tap does."""
    taps = [d for d in range(k) if (phase + d - pad_a) % s == 0]
    if not taps:
        return None
    offs = [(phase + d - pad_a) // s for d in taps]
    lo, hi = min(offs), max(offs)
    # offsets step by one as d steps by s, so every offset in [lo, hi]
    # has exactly one tap
    return [taps[offs.index(o)] for o in range(lo, hi + 1)], lo, hi


def conv_transpose_sparse(x: torch.Tensor, kernel: torch.Tensor,
                          stride: int,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero-skipping transposed conv via sub-pixel decomposition, then
    ``+ bias`` when one is given (added by each phase's convolution).

    x (N, H, W, Cin), kernel (Cout, Cin, kh, kw) -> (N, H*s, W*s, Cout).
    """
    if stride == 1:
        y = conv_transpose_dense(x, kernel, 1)
        return y if bias is None else y + bias
    N, H, W, _ = x.shape
    cout, _, kh, kw = kernel.shape
    s = stride
    pt, pl = _pad_a(kh, s), _pad_a(kw, s)
    phases = {(py, px): (_phase_grid(kh, s, py, pt),
                         _phase_grid(kw, s, px, pl))
              for py in range(s) for px in range(s)}
    # a phase no tap reaches stays zero; every other is written whole
    whole = all(gy is not None and gx is not None
                for gy, gx in phases.values())
    out = (x.new_empty if whole else x.new_zeros)(N, H * s, W * s, cout)
    for (py, px), (gy, gx) in phases.items():
        if gy is None or gx is None:
            continue
        (rows, oy0, oy1), (cols, ox0, ox1) = gy, gx
        # out[i] = sum_d x[i + off0 + d] * grid[d]: pad lo by -off0 and hi
        # by off1 (negative padding crops); the phase is written in place
        ops.conv2d(x, kernel, (-oy0, oy1), (-ox0, ox1),
                   bias=bias if whole else None, taps=(rows, cols),
                   out=out[:, py::s, px::s, :])
    return out if whole or bias is None else out + bias


def zero_mac_fraction(kh: int, kw: int, stride: int) -> float:
    """Fraction of baseline transposed-conv MACs that hit inserted zeros
    (what the sparse dataflow saves): 1 - 1/s^2 for k >= s."""
    dense = kh * kw
    live = -(-kh // stride) * (-(-kw // stride))  # ceil(k/s)^2 on average
    return 1.0 - live / dense
