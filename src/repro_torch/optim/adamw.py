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
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Sequence, Tuple

import torch


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


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [g * factor for g in grads], norm


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
        g = g.float() if factor is None else g.float() * factor
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        for old, new, out in ((m, m2, new_m), (v, v2, new_v)):
            if old.dtype == mdt:
                out.append(old.copy_(new))
            else:
                out.append(new.to(mdt))
    return params, AdamWState(step.to(torch.int32), new_m, new_v), gnorm
