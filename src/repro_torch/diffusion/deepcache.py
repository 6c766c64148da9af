"""DeepCache (Ma et al., CVPR 2024), port of
``repro/diffusion/deepcache.py``: the paper's strongest algorithmic
baseline (Figs. 9-10).  Cache the deep (low-resolution) UNet features
across adjacent timesteps and recompute only the shallow layers on "skip"
steps: a full pass every ``interval`` steps refreshes the cache, skip
steps reuse the cached activation that enters the last up level.

It serves the engine's DeepCache-phased slots and is a workload
transform for the photonic simulator (``shallow_workload_fraction``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.precision import resolve, stream_for
from repro_torch.models.unet import UNet, UNetConfig


def unet_apply_cached(unet: UNet, cfg: UNetConfig, x: torch.Tensor,
                      t: torch.Tensor, cache: Optional[torch.Tensor],
                      refresh: bool, context=None, policy=None, *,
                      noise_key: Optional[prng.Key] = None,
                      first_sample: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UNet forward with DeepCache.

    refresh=True  : full pass; returns (eps, new_cache), the cache being
                    the activation entering the LAST up level.
    refresh=False : recompute only the outermost (full-resolution) down
                    blocks and the last up level, splicing in ``cache``.

    A noisy policy dispenses its keys from ``stream_for(policy,
    noise_key)`` directly (no timestep folded in), in the order the
    blocks run, as the reference does; ``first_sample`` as for
    ``UNet.forward``.  The passes are ``UNet``'s own
    parts (``shallow_in``, ``deep``, ``shallow_out``); ``cfg`` is
    ``unet.cfg``, in the reference's signature.
    """
    pol = resolve(policy)
    keys = stream_for(pol, noise_key, first_sample)
    h, skips, t_emb = unet.shallow_in(x, t, context, pol, keys)
    if refresh or cache is None:
        cache = unet.deep(h, t_emb, context, pol, keys)
    return unet.shallow_out(cache, skips, t_emb, context, pol, keys), cache


def shallow_workload_fraction(cfg: UNetConfig) -> float:
    """MAC fraction of one skip (shallow) pass vs one full UNet pass: the
    full-resolution share of the MAC count (outermost down level, last up
    level, in/out convs).  Feeds both the derived DeepCache simulator
    point and the engine's photonic accountant, which bills skip ticks at
    this fraction of a full-UNet tick."""
    from repro_torch.core.photonic.workload import unet_workload
    full = unet_workload(cfg).total_macs_dense
    shallow_cfg = UNetConfig(
        name=cfg.name + '-shallow', img_size=cfg.img_size, in_ch=cfg.in_ch,
        base_ch=cfg.base_ch, ch_mults=cfg.ch_mults[:1],
        n_res_blocks=cfg.n_res_blocks,
        attn_resolutions=cfg.attn_resolutions, n_heads=cfg.n_heads,
        context_dim=cfg.context_dim)
    return unet_workload(shallow_cfg).total_macs_dense / full


def deepcache_workload_factor(cfg: UNetConfig, interval: int = 5) -> float:
    """Average per-step MAC fraction vs the full UNet (for the simulator's
    derived DeepCache point): 1 full pass + (interval-1) shallow passes."""
    s = shallow_workload_fraction(cfg)
    return (1.0 + (interval - 1) * s) / interval
