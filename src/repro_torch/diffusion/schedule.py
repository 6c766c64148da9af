"""Noise schedules, the forward (noising) process and the DDPM training
objective (paper Eq. 1), port of ``repro/diffusion/schedule.py``.

``ddpm_loss`` draws its timesteps and noise with ``core/prng``, which
reproduces ``jax.random``: the same key gives the reference's ``t`` bit
for bit and its noise within ``prng.NORMAL_RTOL``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class Schedule:
    betas: torch.Tensor            # (T,)
    alphas: torch.Tensor           # (T,)
    alpha_bars: torch.Tensor       # (T,) cumulative products

    @property
    def T(self) -> int:
        return self.betas.shape[0]


def linear_schedule(T: int = 1000, beta_0: float = 1e-4,
                    beta_T: float = 0.02, device='cpu') -> Schedule:
    betas = torch.linspace(beta_0, beta_T, T, dtype=torch.float32,
                           device=device)
    alphas = 1.0 - betas
    return Schedule(betas, alphas, torch.cumprod(alphas, dim=0))


def cosine_schedule(T: int = 1000, s: float = 0.008,
                    device='cpu') -> Schedule:
    t = torch.arange(T + 1, dtype=torch.float32, device=device) / T
    f = torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2
    alpha_bars = f / f[0]
    betas = torch.clamp(1 - alpha_bars[1:] / alpha_bars[:-1], 0, 0.999)
    alphas = 1.0 - betas
    return Schedule(betas, alphas, torch.cumprod(alphas, dim=0))


def q_sample(sched: Schedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward process (Eq. 1, closed form over t steps):
    x_t = sqrt(alpha_bar_t) x_0 + sqrt(1 - alpha_bar_t) eps."""
    ab = sched.alpha_bars[t.long()].reshape((-1,) + (1,) * (x0.ndim - 1))
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def ddpm_loss(unet_apply_fn, sched: Schedule, model, x0: torch.Tensor,
              key: prng.Key, context=None) -> torch.Tensor:
    """Simple epsilon-prediction objective (Ho et al.), the reference's
    key chain: ``kt, kn = split(key)``, ``t = randint(kt, (B,), 0, T)``,
    ``noise = normal(kn, x0.shape)``, drawn on x0's device.
    ``unet_apply_fn(model, x_t, t, context)`` predicts the noise."""
    kt, kn = prng.split(key)
    B = x0.shape[0]
    t = prng.randint(kt, (B,), 0, sched.T, device=x0.device)
    noise = prng.normal(kn, tuple(x0.shape), device=x0.device).to(x0.dtype)
    x_t = q_sample(sched, x0, t, noise)
    pred = unet_apply_fn(model, x_t, t, context)
    return torch.mean(torch.square(pred - noise))
