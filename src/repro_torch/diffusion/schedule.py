"""Noise schedule, port of ``repro/diffusion/schedule.py::linear_schedule``."""
from __future__ import annotations

import dataclasses

import torch


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
