"""Latent VAE decoder for LDM / SDM, port of the decoder half of
``repro/models/autoencoder.py`` (only the decoder is on the serving path:
latents -> pixels after the denoising loop).  GroupNorm + swish stays
plain tensor code here, as in the reference."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

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
        h = self.conv2(L.swish(self.gn2(h, g)))
        return (self.skip(x) if self.skip is not None else x) + h


class _DecLevel(nn.Module):
    def __init__(self, c_in, c_out, upsample: bool, device):
        super().__init__()
        self.res = _Res(c_in, c_out, device)
        self.up = L.Conv(4, 4, c_out, c_out, device=device) if upsample \
            else None


class VAEDecoder(nn.Module):
    """State-dict keys are the reference VAE's decoder keys (``dec_in``,
    ``dec.<lvl>.res.*``, ``dec.<lvl>.up``, ``dec_gn``, ``dec_out``)."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.base_ch * cfg.ch_mults[-1]
        self.dec_in = L.Conv(3, 3, cfg.z_ch, ch, device=device)
        dec = []
        for lvl, m in reversed(list(enumerate(cfg.ch_mults))):
            out = cfg.base_ch * m
            dec.append(_DecLevel(ch, out, lvl > 0, device))
            ch = out
        self.dec = nn.ModuleList(dec)
        self.dec_gn = L.GroupNorm(ch, device)
        self.dec_out = L.Conv(3, 3, ch, cfg.in_ch, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        g = self.cfg.groups
        h = self.dec_in(z)
        for lvl in self.dec:
            h = lvl.res(h, g)
            if lvl.up is not None:
                h = L.conv_transpose2d(h, lvl.up.w, lvl.up.b, stride=2)  # C4
        h = L.swish(self.dec_gn(h, g))
        return torch.tanh(self.dec_out(h))


def vae_decode(vae: VAEDecoder, z: torch.Tensor) -> torch.Tensor:
    """Latent (B, h, w, z_ch) -> image (B, h*f, w*f, in_ch) in [-1, 1]."""
    return vae(z)
