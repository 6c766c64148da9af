"""AdamW, its schedule and the gradient utilities: port of
``repro/optim/adamw.py``.

Written by hand rather than taken from ``torch.optim.AdamW``, whose
update differs from the reference's in three ways: the schedule here is
evaluated at ``step + 1``, weight decay applies to every leaf and goes
into ``delta`` before the step, and the moments may be kept in bfloat16
while the update math stays float32.

Where the reference maps pytrees, the port takes lists of tensors in the
model's parameter order (``launch.steps.train_params``): ``AdamWState``
holds ``m`` and ``v`` in that order, and ``step`` as a 0-d int32 tensor
on the parameters' device, so the schedule and the bias corrections are
float32 tensor math there (the reference's ``step.astype(float32)``) and
an update never waits for the host.

On a mesh the parameters and moments are ``DTensor``s and the gradients
come back from autograd ``Partial`` or in another layout:
``adamw_update`` first redistributes each gradient to its parameter's
placements (a reduce-scatter or an all-reduce), then updates each
rank's local shards; ``global_norm`` sums every element once over the
whole mesh.  ``step`` stays a plain tensor, the same on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.distributed import sharding as SH


class AdamWState(NamedTuple):
    step: torch.Tensor              # () int32
    m: List[torch.Tensor]
    v: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # 'bfloat16' halves the optimizer state's memory; the update math
    # still runs in float32.
    moment_dtype: str = 'float32'


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * \
        0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_adamw(params: Sequence[torch.Tensor],
               moment_dtype: torch.dtype = torch.float32) -> AdamWState:
    """Zero moments in ``moment_dtype`` and step 0, on the parameters'
    device."""
    zeros = lambda: [torch.zeros_like(p, dtype=moment_dtype,
                                      memory_format=torch.contiguous_format)
                     for p in params]
    device = params[0].device if len(params) else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros(), zeros())


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage), a plain tensor as it
    is."""
    return x.to_local() if SH.is_dtensor(x) else x


def _owned_square_sum(x) -> torch.Tensor:
    """The local sum of squares of ``x``, counted on the ranks at index 0
    of every mesh dim that replicates it (0 elsewhere), so the sum over
    the mesh counts every element once."""
    from torch.distributed.tensor import Replicate
    if any(pl.is_partial() for pl in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if pl.is_partial()
                                           else pl for pl in x.placements])
    mesh = x.device_mesh
    owner = all(mesh.get_local_rank(i) == 0
                for i, pl in enumerate(x.placements) if pl.is_replicate())
    local = x.to_local().float().square().sum()
    return local if owner else torch.zeros_like(local)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all the tensors together; over DTensors, one sum
    over the mesh, the same value on every rank."""
    if not any(SH.is_dtensor(x) for x in tensors):
        return torch.sqrt(sum(x.float().square().sum() for x in tensors))
    from torch.distributed.tensor import DTensor, Partial
    mesh = next(x.device_mesh for x in tensors)
    local = sum(_owned_square_sum(x) for x in tensors)
    total = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim)
    return torch.sqrt(total.full_tensor())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [g * factor for g in grads], norm


def _like(ref: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as a shard laid out as the DTensor ``ref``; a plain
    tensor when ``ref`` is one."""
    if not SH.is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              shape=ref.shape, stride=ref.stride())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Sequence[torch.Tensor],
                 state: AdamWState, params: Sequence[torch.Tensor]
                 ) -> Tuple[Sequence[torch.Tensor], AdamWState,
                            torch.Tensor]:
    """Returns (params, new_state, grad_norm), ``grad_norm`` taken before
    clipping.  The parameters are updated in place (the reference's jit
    donates their buffers) and come back as given; so are the moments
    already in ``moment_dtype``, and the others are replaced by new
    tensors in it.  Clipping scales each gradient as the update reads it,
    so no clipped copy of all of them is held."""
    if any(SH.is_dtensor(p) for p in params):
        grads = [g if tuple(g.placements) == tuple(p.placements)
                 else g.redistribute(p.device_mesh, p.placements)
                 for p, g in zip(params, grads)]
    gnorm = global_norm(grads)
    factor = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                          max=1.0) if cfg.grad_clip > 0 else None)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    mdt = getattr(torch, cfg.moment_dtype)
    new_m, new_v = [], []
    for p, g, m, v in zip(params, grads, state.m, state.v):
        pl, g, ml, vl = _local(p), _local(g), _local(m), _local(v)
        g = g.float() if factor is None else g.float() * factor
        m2 = cfg.b1 * ml.float() + (1 - cfg.b1) * g
        v2 = cfg.b2 * vl.float() + (1 - cfg.b2) * g.square()
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) + \
            cfg.weight_decay * pl.float()
        pl.copy_(pl.float() - lr * delta)
        for old, old_l, new, out in ((m, ml, m2, new_m), (v, vl, v2, new_v)):
            if old.dtype == mdt:
                old_l.copy_(new)
                out.append(old)
            else:
                out.append(_like(old, new.to(mdt)))
    return params, AdamWState(step.to(torch.int32), new_m, new_v), gnorm
