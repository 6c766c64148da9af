"""Reverse-process samplers, port of ``repro/diffusion/samplers.py``:
DDPM ancestral sampling (paper Eq. 2) and DDIM.

DDPM keeps the reference's key chain (``core/prng`` reproduces
``jax.random``); a Python loop over the T steps replaces ``fori_loop``.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.diffusion.schedule import Schedule

# eps_fn(x_t, t_batch) -> predicted noise
EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Steps = Union[int, np.ndarray, torch.Tensor]


def ddpm_step(sched: Schedule, eps_fn: EpsFn, x_t: torch.Tensor, t: int,
              key: prng.Key) -> torch.Tensor:
    """One reverse step (Eq. 2): x_{t-1} = mu_theta(x_t, t) + sigma_t z.
    ``z`` is drawn from ``key`` on x_t's device even at t = 0, where its
    weight is 0, as in the reference."""
    t = int(t)
    B = x_t.shape[0]
    eps = eps_fn(x_t, torch.full((B,), t, dtype=torch.long,
                                 device=x_t.device))
    beta = sched.betas[t]
    alpha = sched.alphas[t]
    ab = sched.alpha_bars[t]
    mu = (x_t - beta / torch.sqrt(1.0 - ab) * eps) / torch.sqrt(alpha)
    sigma = torch.sqrt(beta)
    z = prng.normal(key, tuple(x_t.shape), device=x_t.device).to(x_t.dtype)
    return mu + (sigma if t > 0 else 0.0) * z


def ddpm_sample(sched: Schedule, eps_fn: EpsFn, shape, key: prng.Key, *,
                device) -> torch.Tensor:
    """Full T-step ancestral sampling from pure noise, the reference's key
    chain: ``k0, kloop = split(key)``, ``x_T = normal(k0, shape)`` (drawn
    on the CPU and moved to ``device``, as the pipeline's
    ``initial_noise``), then per step ``kloop, ks = split(kloop)``."""
    k0, kloop = prng.split(key)
    x = prng.normal(k0, tuple(shape), device='cpu').to(device)
    for i in range(sched.T):
        kloop, ks = prng.split(kloop)
        x = ddpm_step(sched, eps_fn, x, sched.T - 1 - i, ks)
    return x


def ddim_timesteps(sched: Schedule, steps: int) -> np.ndarray:
    """The uniform DDIM sub-sequence of ``steps`` timesteps (T-1 ... 0),
    on the host: the engine and ``ddim_sample`` both read it, so their
    trajectories agree by construction."""
    return np.linspace(sched.T - 1, 0, steps).astype(np.int32)


def _per_sample(t: Steps, B: int, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.long, device=device).expand(B)


def ddim_step(sched: Schedule, eps: torch.Tensor, x: torch.Tensor, t: Steps,
              t_prev: Steps, return_x0: bool = False):
    """One deterministic (eta = 0) DDIM update x_t -> x_{t_prev} given the
    predicted noise.  ``t`` / ``t_prev`` may be scalars or per-sample (B,)
    vectors, so samples at different depths share one call; a
    ``t_prev < 0`` entry steps to x_0 (alpha_bar_prev = 1).
    ``return_x0`` also returns the clean-image prediction."""
    B = x.shape[0]
    bshape = (B,) + (1,) * (x.ndim - 1)
    t = _per_sample(t, B, x.device)
    t_prev = _per_sample(t_prev, B, x.device)
    ab = sched.alpha_bars
    ab_t = ab[t].reshape(bshape)
    ab_prev = torch.where(t_prev >= 0, ab[t_prev.clamp_min(0)],
                          torch.ones((), device=x.device)).reshape(bshape)
    x0_pred = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    x_prev = torch.sqrt(ab_prev) * x0_pred + \
        torch.sqrt((1 - ab_prev).clamp_min(0.0)) * eps
    if return_x0:
        return x_prev, x0_pred
    return x_prev


def ddim_sample(sched: Schedule, eps_fn: EpsFn, x: torch.Tensor,
                steps: int = 50) -> torch.Tensor:
    """DDIM over the uniform sub-sequence of ``steps`` timesteps, starting
    from the noise ``x`` (the caller draws it)."""
    ts = ddim_timesteps(sched, steps)
    B = x.shape[0]
    for i, t in enumerate(ts):
        t_prev = int(ts[i + 1]) if i + 1 < steps else -1
        eps = eps_fn(x, torch.full((B,), int(t), dtype=torch.long,
                                   device=x.device))
        x = ddim_step(sched, eps, x, int(t), t_prev)
    return x
