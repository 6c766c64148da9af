"""Latent VAE for LDM / SDM, port of ``repro/models/autoencoder.py``:
the encoder (images -> latents, for latent-diffusion training) and the
decoder (latents -> pixels after the denoising loop, the only half on
the serving path).  Downsample factor f = 2^(len(ch_mults)-1); a
KL-regularised bottleneck as in LDM.  GroupNorm + swish stays plain
tensor code here, as in the reference.

``VAEEncoder`` and ``VAEDecoder`` hold one half each; ``VAE`` holds
both, so its state-dict keys are the whole reference tree's
(``enc_in``, ``enc.<lvl>.res.*``, ``enc.<lvl>.down``, ``enc_out``,
``dec_in``, ``dec.<lvl>.res.*``, ``dec.<lvl>.up``, ``dec_gn``,
``dec_out``).  ``vae_encode`` takes an encoder or a ``VAE``,
``vae_decode`` a decoder or a ``VAE``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.core import prng
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    img_size: int
    in_ch: int = 3
    z_ch: int = 4
    base_ch: int = 128
    ch_mults: Tuple[int, ...] = (1, 2, 4, 4)
    groups: int = 32


class _Res(nn.Module):
    def __init__(self, c_in, c_out, device):
        super().__init__()
        self.gn1 = L.GroupNorm(c_in, device)
        self.conv1 = L.Conv(3, 3, c_in, c_out, device=device)
        self.gn2 = L.GroupNorm(c_out, device)
        self.conv2 = L.Conv(3, 3, c_out, c_out, device=device)
        self.skip = L.Conv(1, 1, c_in, c_out, device=device) \
            if c_in != c_out else None

    def forward(self, x, g):
        h = self.conv1(L.swish(self.gn1(x, g)))
        skip = self.skip(x) if self.skip is not None else x
        return self.conv2(L.swish(self.gn2(h, g)), residual=skip)


class _EncLevel(nn.Module):
    def __init__(self, c_in, c_out, downsample: bool, device):
        super().__init__()
        self.res = _Res(c_in, c_out, device)
        self.down = L.Conv(3, 3, c_out, c_out, device=device) \
            if downsample else None


class _DecLevel(nn.Module):
    def __init__(self, c_in, c_out, upsample: bool, device):
        super().__init__()
        self.res = _Res(c_in, c_out, device)
        self.up = L.Conv(4, 4, c_out, c_out, device=device) if upsample \
            else None


def _encoder_modules(cfg: VAEConfig, device) -> dict:
    ch = cfg.base_ch
    enc = []
    for lvl, m in enumerate(cfg.ch_mults):
        out = cfg.base_ch * m
        enc.append(_EncLevel(ch, out, lvl < len(cfg.ch_mults) - 1, device))
        ch = out
    return {'enc_in': L.Conv(3, 3, cfg.in_ch, cfg.base_ch, device=device),
            'enc': nn.ModuleList(enc),
            'enc_out': L.Conv(3, 3, ch, 2 * cfg.z_ch, device=device)}


def _decoder_modules(cfg: VAEConfig, device) -> dict:
    ch = cfg.base_ch * cfg.ch_mults[-1]
    dec_in = L.Conv(3, 3, cfg.z_ch, ch, device=device)
    dec = []
    for lvl, m in reversed(list(enumerate(cfg.ch_mults))):
        out = cfg.base_ch * m
        dec.append(_DecLevel(ch, out, lvl > 0, device))
        ch = out
    return {'dec_in': dec_in, 'dec': nn.ModuleList(dec),
            'dec_gn': L.GroupNorm(ch, device),
            'dec_out': L.Conv(3, 3, ch, cfg.in_ch, device=device)}


class VAEEncoder(nn.Module):
    """The encoder half: state-dict keys ``enc_in``, ``enc.<lvl>.res.*``,
    ``enc.<lvl>.down`` and ``enc_out``.  ``forward`` is
    ``vae_encode``."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name, m in _encoder_modules(cfg, device).items():
            self.add_module(name, m)

    def forward(self, x: torch.Tensor,
                key: Optional[prng.Key] = None) -> torch.Tensor:
        return vae_encode(self, x, key)


class VAEDecoder(nn.Module):
    """The decoder half: state-dict keys ``dec_in``, ``dec.<lvl>.res.*``,
    ``dec.<lvl>.up``, ``dec_gn`` and ``dec_out``.  ``forward`` is
    ``vae_decode``."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name, m in _decoder_modules(cfg, device).items():
            self.add_module(name, m)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return vae_decode(self, z)


class VAE(nn.Module):
    """Both halves, with the reference ``init_vae`` tree's keys, so
    ``bridge.load_jax_params(VAE(cfg), tree)`` loads the whole tree;
    ``vae_encode`` and ``vae_decode`` take it."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name, m in {**_encoder_modules(cfg, device),
                        **_decoder_modules(cfg, device)}.items():
            self.add_module(name, m)


def vae_encode(enc: nn.Module, x: torch.Tensor,
               key: Optional[prng.Key] = None) -> torch.Tensor:
    """Image (B, H, W, in_ch) -> latent (B, H/f, W/f, z_ch): the mean, or
    with ``key`` a draw ``mean + exp(0.5 * clip(logvar, -30, 20)) *
    normal(key, mean.shape)`` (``core/prng``, on x's device)."""
    g = enc.cfg.groups
    h = enc.enc_in(x)
    for lvl in enc.enc:
        h = lvl.res(h, g)
        if lvl.down is not None:
            h = lvl.down(h, stride=2)
    mean, logvar = torch.chunk(enc.enc_out(h), 2, dim=-1)
    if key is None:
        return mean
    return mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * \
        prng.normal(key, tuple(mean.shape), device=mean.device).to(mean.dtype)


def vae_decode(vae: nn.Module, z: torch.Tensor) -> torch.Tensor:
    """Latent (B, h, w, z_ch) -> image (B, h*f, w*f, in_ch) in [-1, 1]."""
    g = vae.cfg.groups
    h = vae.dec_in(z)
    for lvl in vae.dec:
        h = lvl.res(h, g)
        if lvl.up is not None:
            h = L.conv_transpose2d(h, lvl.up.w, lvl.up.b, stride=2)  # C4
    h = L.swish(vae.dec_gn(h, g))
    return torch.tanh(vae.dec_out(h))
