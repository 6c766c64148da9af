"""Weights made from the seed, on the device, in a few large draws.

A configuration's parameter list (``reference/*.param_spec``: name,
shape, and a uniform range ``center +- bound``) fixes the layout of one
flat float32 buffer.  The buffer is drawn in chunks of ``CHUNK`` values,
chunk ``c`` from its own generator seeded by ``(seed, c)``, on the
device; each parameter is then a view of its span, shifted and scaled
in place.  The same seed gives the same weights on every device, and the
reference draws them again after the program's state is freed.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

#: (name, shape, bound, center): uniform on [center - bound, center + bound)
Spec = Sequence[Tuple[str, Tuple[int, ...], float, float]]
CHUNK = 1 << 28


def _chunk_seed(seed: int, c: int) -> int:
    return (int(seed) * 1_000_003 + c) % (1 << 63)


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, views of one buffer."""
    total = sum(math.prod(s) for _, s, _, _ in spec)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    for c, lo in enumerate(range(0, total, CHUNK)):
        gen = torch.Generator(device=device).manual_seed(_chunk_seed(seed, c))
        hi = min(total, lo + CHUNK)
        torch.rand(hi - lo, generator=gen, device=device, out=flat[lo:hi])
    out, off = {}, 0
    for name, shape, bound, center in spec:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        v.mul_(2.0 * bound).add_(center - bound)
        out[name] = v
        off += n
    return out


def install(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """Put ``tensors`` in as ``module``'s parameters, by name, without a
    gradient (a trainer turns it on); the module's parameter names and
    shapes must be exactly those of ``tensors`` (built on the ``meta``
    device, it holds no memory of its own)."""
    have = {n: tuple(p.shape) for n, p in module.named_parameters()}
    want = {n: tuple(t.shape) for n, t in tensors.items()}
    if have != want:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(n for n in set(have) & set(want)
                        if have[n] != want[n])[:5]
        raise ValueError(f'parameters differ from the benchmark\'s list: '
                         f'not in the model {missing}, not in the list '
                         f'{extra}, other shapes {shapes}')
    for name, t in tensors.items():
        prefix, _, leaf = name.rpartition('.')
        owner = module.get_submodule(prefix) if prefix else module
        owner._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return module
