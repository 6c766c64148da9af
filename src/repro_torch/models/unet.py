"""Diffusion UNet (DDPM / LDM / SDM families, paper Table I), port of
``repro/models/unet.py``.

ResBlocks run GroupNorm+swish through the fused kernel (C5); attention
blocks use the LSE softmax (C2) with optional cross-attention; stride-2
upsampling goes through the sparse transposed-conv dataflow (C4).  A
w8a8 ``PrecisionPolicy`` runs every attention projection on the W8A8
path (C1); a noisy one (``w8a8+noise``) draws one independent analog
perturbation per projection from a ``NoiseKeyStream``, in the
reference's order.  ``UNet.state_dict()`` keys are the reference
pytree's key paths (``down.1.blocks.0.attn.wq.w``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.core.lse_softmax import lse_softmax
from repro_torch.core.precision import resolve, stream_for
from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    img_size: int
    in_ch: int
    base_ch: int
    ch_mults: Tuple[int, ...]
    n_res_blocks: int
    attn_resolutions: Tuple[int, ...]
    n_heads: int = 8
    context_dim: Optional[int] = None      # cross-attention (SDM)
    transformer_depth: int = 1
    timesteps: int = 1000
    latent: bool = False                    # operates in VAE latent space
    sparse_dataflow: bool = True            # C4 toggle
    groups: int = 32


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cos before sin as in the reference."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, t_dim: int, device=None):
        super().__init__()
        self.gn1 = L.GroupNorm(c_in, device)
        self.conv1 = L.Conv(3, 3, c_in, c_out, device=device)
        self.t_proj = L.Linear(t_dim, c_out, device=device)
        self.gn2 = L.GroupNorm(c_out, device)
        self.conv2 = L.Conv(3, 3, c_out, c_out, device=device)
        self.skip = L.Conv(1, 1, c_in, c_out, device=device) \
            if c_in != c_out else None

    def forward(self, x, t_emb, groups: int):
        """``skip(x) + conv2(gn2(conv1(gn1(x)) + t_proj(swish(t_emb))))``;
        the time embedding's add and the skip's go into the convolutions'
        epilogues (``conv1``'s row, ``conv2``'s residual)."""
        h = ops.fused_gn_swish(x, self.gn1.scale, self.gn1.bias, groups=groups)
        h = self.conv1(h, row=self.t_proj(L.swish(t_emb)))
        h = ops.fused_gn_swish(h, self.gn2.scale, self.gn2.bias, groups=groups)
        skip = self.skip(x) if self.skip is not None else x
        return self.conv2(h, residual=skip)


def _mha(q, k, v, n_heads: int) -> torch.Tensor:
    """q (B, S, C), k/v (B, T, C) -> (B, S, C) via the LSE softmax (C2)."""
    B, S, C = q.shape
    T = k.shape[1]
    hd = C // n_heads
    qh = q.reshape(B, S, n_heads, hd).float() * hd ** -0.5
    kh = k.reshape(B, T, n_heads, hd).float()
    vh = v.reshape(B, T, n_heads, hd).float()
    s = torch.einsum('bshd,bthd->bhst', qh, kh)
    pr = lse_softmax(s, dim=-1)
    o = torch.einsum('bhst,bthd->bshd', pr, vh)
    return o.reshape(B, S, C).to(q.dtype)


class AttnBlock(nn.Module):
    def __init__(self, ch: int, n_heads: int, context_dim: Optional[int],
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.gn = L.GroupNorm(ch, device)
        self.wq = L.Linear(ch, ch, bias=False, device=device)
        self.wk = L.Linear(ch, ch, bias=False, device=device)
        self.wv = L.Linear(ch, ch, bias=False, device=device)
        self.wo = L.Linear(ch, ch, device=device)
        self.cross = context_dim is not None
        if self.cross:
            self.xq = L.Linear(ch, ch, bias=False, device=device)
            self.xk = L.Linear(context_dim, ch, bias=False, device=device)
            self.xv = L.Linear(context_dim, ch, bias=False, device=device)
            self.xo = L.Linear(ch, ch, device=device)

    def forward(self, x, groups: int, context=None, policy=None, keys=None):
        """``keys``: a ``NoiseKeyStream`` dispensing one key per projection
        (wq, wk, wv, wo, then xq, xk, xv, xo) under a noisy policy;
        without one, a per-block stream anchored at the policy's seed."""
        pol = resolve(policy)
        if keys is None:
            keys = stream_for(pol)

        def proj(lin, v):
            return lin(v, pol, keys.next(), keys.first_sample)

        B, H, W, C = x.shape
        t = self.gn(x, groups).reshape(B, H * W, C)
        o = _mha(proj(self.wq, t), proj(self.wk, t), proj(self.wv, t),
                 self.n_heads)
        t = t + proj(self.wo, o)
        if context is not None and self.cross:
            o = _mha(proj(self.xq, t), proj(self.xk, context),
                     proj(self.xv, context), self.n_heads)
            t = t + proj(self.xo, o)
        return x + t.reshape(B, H, W, C)


class _Block(nn.Module):
    """One down/up step: a ResBlock and, at attention resolutions, an
    AttnBlock (the reference's ``{'res': ..., 'attn': ...}``)."""

    def __init__(self, res: ResBlock, attn: Optional[AttnBlock]):
        super().__init__()
        self.res = res
        self.attn = attn


class _Level(nn.Module):
    def __init__(self, blocks, resample: Optional[L.Conv], resample_name: str):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if resample is not None:
            self.add_module(resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, ch, t_dim, cfg: UNetConfig, device):
        super().__init__()
        self.res1 = ResBlock(ch, ch, t_dim, device)
        self.attn = AttnBlock(ch, cfg.n_heads, cfg.context_dim, device)
        self.res2 = ResBlock(ch, ch, t_dim, device)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        t_dim = cfg.base_ch * 4

        def attn(ch):
            return AttnBlock(ch, cfg.n_heads, cfg.context_dim, device)

        self.t_mlp1 = L.Linear(cfg.base_ch, t_dim, device=device)
        self.t_mlp2 = L.Linear(t_dim, t_dim, device=device)
        self.conv_in = L.Conv(3, 3, cfg.in_ch, cfg.base_ch, device=device)
        chs = [cfg.base_ch]
        ch, res = cfg.base_ch, cfg.img_size
        down = []
        for lvl, mult in enumerate(cfg.ch_mults):
            out_ch = cfg.base_ch * mult
            blocks = []
            for _ in range(cfg.n_res_blocks):
                r = ResBlock(ch, out_ch, t_dim, device)
                ch = out_ch
                blocks.append(_Block(r, attn(ch) if res in cfg.attn_resolutions
                                     else None))
                chs.append(ch)
            conv = None
            if lvl < len(cfg.ch_mults) - 1:
                conv = L.Conv(3, 3, ch, ch, device=device)
                chs.append(ch)
                res //= 2
            down.append(_Level(blocks, conv, 'down'))
        self.down = nn.ModuleList(down)
        self.mid = _Mid(ch, t_dim, cfg, device)
        up = []
        for lvl, mult in reversed(list(enumerate(cfg.ch_mults))):
            out_ch = cfg.base_ch * mult
            blocks = []
            for _ in range(cfg.n_res_blocks + 1):
                r = ResBlock(ch + chs.pop(), out_ch, t_dim, device)
                ch = out_ch
                blocks.append(_Block(r, attn(ch) if res in cfg.attn_resolutions
                                     else None))
            conv = None
            if lvl > 0:
                # stride-2 transposed conv: the C4 sparse-dataflow target
                conv = L.Conv(4, 4, ch, ch, device=device)
                res *= 2
            up.append(_Level(blocks, conv, 'upconv'))
        self.up = nn.ModuleList(up)
        self.gn_out = L.GroupNorm(ch, device)
        self.conv_out = L.Conv(3, 3, ch, cfg.in_ch, device=device)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None, policy=None,
                noise_key=None, first_sample: int = 0):
        """x (B, H, W, C_in) NHWC, t (B,) int timesteps -> predicted noise.
        ``policy`` sets the precision of every attention projection; a
        noisy one draws from ``noise_key`` (default: the policy's seed
        anchor), so the forward is deterministic under a fixed key, and
        draws for x's samples as samples ``first_sample``... of a larger
        batch (a shard of the engine's slot axis)."""
        pol = resolve(policy)
        keys = stream_for(pol, noise_key, first_sample)
        h, skips, t_emb = self.shallow_in(x, t, context, pol, keys)
        h = self.deep(h, t_emb, context, pol, keys)
        return self.shallow_out(h, skips, t_emb, context, pol, keys)

    # The forward in three parts, which DeepCache (``diffusion/deepcache``)
    # runs apart: a skip pass replaces ``deep`` by its cached output.  The
    # parts share one key stream, so a noisy policy's keys go out in the
    # order the blocks run.

    def shallow_in(self, x, t, context, pol, keys):
        """Time embedding, ``conv_in`` and the outermost down level's
        blocks.  Returns (h, the skips they leave for the last up level,
        the time embedding)."""
        g = self.cfg.groups
        t_emb = timestep_embedding(t, self.cfg.base_ch)
        t_emb = self.t_mlp2(L.swish(self.t_mlp1(t_emb)))
        h = self.conv_in(x)
        skips = [h]
        h = self._down_blocks(self.down[0], h, skips, t_emb, context, pol,
                              keys)
        return h, skips, t_emb

    def deep(self, h, t_emb, context, pol, keys):
        """From the outermost level's downsampling through the mid block
        and every up level but the last: the activation that enters the
        last up level (what DeepCache caches)."""
        g = self.cfg.groups
        skips = []
        for i, lvl in enumerate(self.down):
            if i > 0:       # the outermost level's blocks ran in shallow_in
                h = self._down_blocks(lvl, h, skips, t_emb, context, pol,
                                      keys)
            if hasattr(lvl, 'down'):
                h = lvl.down(h, stride=2)
                skips.append(h)
        h = self.mid.res1(h, t_emb, g)
        h = self.mid.attn(h, g, context, pol, keys)
        h = self.mid.res2(h, t_emb, g)
        for lvl in self.up[:-1]:
            h = self._up_level(lvl, h, skips, t_emb, context, pol, keys)
        return h

    def shallow_out(self, h, skips, t_emb, context, pol, keys):
        """The last up level on ``h`` and the skips of ``shallow_in``, then
        ``gn_out`` and ``conv_out``: the predicted noise."""
        h = self._up_level(self.up[-1], h, skips, t_emb, context, pol, keys)
        h = ops.fused_gn_swish(h, self.gn_out.scale, self.gn_out.bias,
                               groups=self.cfg.groups)
        return self.conv_out(h)

    def _down_blocks(self, lvl, h, skips, t_emb, context, pol, keys):
        g = self.cfg.groups
        for b in lvl.blocks:
            h = b.res(h, t_emb, g)
            if b.attn is not None:
                h = b.attn(h, g, context, pol, keys)
            skips.append(h)
        return h

    def _up_level(self, lvl, h, skips, t_emb, context, pol, keys):
        g = self.cfg.groups
        for b in lvl.blocks:
            h = torch.cat([h, skips.pop()], dim=-1)
            h = b.res(h, t_emb, g)
            if b.attn is not None:
                h = b.attn(h, g, context, pol, keys)
        if hasattr(lvl, 'upconv'):
            h = L.conv_transpose2d(h, lvl.upconv.w, lvl.upconv.b, stride=2,
                                   sparse_dataflow=self.cfg.sparse_dataflow)
        return h


def unet_apply(unet: UNet, x: torch.Tensor, t: torch.Tensor,
               context: Optional[torch.Tensor] = None,
               policy=None, noise_key=None) -> torch.Tensor:
    """Functional spelling of ``UNet.forward`` (the reference's
    ``unet_apply`` entry point)."""
    return unet(x, t, context, policy, noise_key)
