"""Gradient compression for cross-pod data parallelism, port of
``repro/distributed/compression.py``.

At 1000+ nodes the cross-pod all-reduce is the scarcest bandwidth.  This
is int8 symmetric gradient compression with **error feedback** (the
residual carried to the next step, so compression error does not bias
the optimizer; Karimireddy et al. 2019): the pod-local reduction runs at
full precision, only the cross-pod exchange is quantized.

Usage inside a train step:
    g_q, new_residual = compress_with_feedback(grads, residual)
    g_sync = all_reduce_over_pods(decompress(g_q))   # 4x less traffic

A tree is a dict, list or tuple of tensors (nested).  ``torch.round``
rounds half to even, as ``jnp.round``, so ``q`` and ``scale`` equal the
reference's bit for bit.  As in the reference, no trainer calls it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch


class CompressedTree(NamedTuple):
    q: Any          # int8 tree
    scale: Any      # float32 scalars per leaf


def _map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _one(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp(g.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress(grads: Any) -> CompressedTree:
    return CompressedTree(_map(lambda g: _one(g)[0], grads),
                          _map(lambda g: _one(g)[1], grads))


def decompress(c: CompressedTree) -> Any:
    return _map(lambda q, s: q.to(torch.float32) * s, c.q, c.scale)


def compress_with_feedback(grads: Any, residual: Any
                           ) -> Tuple[CompressedTree, Any]:
    """Quantize (grads + residual); the new residual is what quantization
    lost."""
    corrected = _map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    c = compress(corrected)
    recon = decompress(c)
    return c, _map(lambda x, y: x - y, corrected, recon)


def init_residual(grads_like: Any) -> Any:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads_like)
