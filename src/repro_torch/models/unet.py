"""Diffusion UNet (DDPM / LDM / SDM families, paper Table I), port of
``repro/models/unet.py``.

ResBlocks run GroupNorm+swish through the fused kernel (C5); attention
blocks use the LSE softmax (C2) with optional cross-attention; stride-2
upsampling goes through the sparse transposed-conv dataflow (C4).  A
w8a8 ``PrecisionPolicy`` runs every attention projection on the W8A8
path (C1).  ``UNet.state_dict()`` keys are the reference pytree's key
paths (``down.1.blocks.0.attn.wq.w``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.core.lse_softmax import lse_softmax
from repro_torch.core.precision import resolve
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
        h = ops.fused_gn_swish(x, self.gn1.scale, self.gn1.bias, groups=groups)
        h = self.conv1(h)
        h = h + self.t_proj(L.swish(t_emb))[:, None, None, :]
        h = ops.fused_gn_swish(h, self.gn2.scale, self.gn2.bias, groups=groups)
        h = self.conv2(h)
        skip = self.skip(x) if self.skip is not None else x
        return skip + h


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

    def forward(self, x, groups: int, context=None, policy=None):
        B, H, W, C = x.shape
        t = self.gn(x, groups).reshape(B, H * W, C)
        o = _mha(self.wq(t, policy), self.wk(t, policy), self.wv(t, policy),
                 self.n_heads)
        t = t + self.wo(o, policy)
        if context is not None and self.cross:
            o = _mha(self.xq(t, policy), self.xk(context, policy),
                     self.xv(context, policy), self.n_heads)
            t = t + self.xo(o, policy)
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
                context: Optional[torch.Tensor] = None, policy=None):
        """x (B, H, W, C_in) NHWC, t (B,) int timesteps -> predicted noise.
        ``policy`` sets the precision of every attention projection."""
        cfg, pol, g = self.cfg, resolve(policy), self.cfg.groups
        t_emb = timestep_embedding(t, cfg.base_ch)
        t_emb = self.t_mlp2(L.swish(self.t_mlp1(t_emb)))
        h = self.conv_in(x)
        skips = [h]
        for lvl in self.down:
            for b in lvl.blocks:
                h = b.res(h, t_emb, g)
                if b.attn is not None:
                    h = b.attn(h, g, context, pol)
                skips.append(h)
            if hasattr(lvl, 'down'):
                h = lvl.down(h, stride=2)
                skips.append(h)
        h = self.mid.res1(h, t_emb, g)
        h = self.mid.attn(h, g, context, pol)
        h = self.mid.res2(h, t_emb, g)
        for lvl in self.up:
            for b in lvl.blocks:
                h = torch.cat([h, skips.pop()], dim=-1)
                h = b.res(h, t_emb, g)
                if b.attn is not None:
                    h = b.attn(h, g, context, pol)
            if hasattr(lvl, 'upconv'):
                h = L.conv_transpose2d(h, lvl.upconv.w, lvl.upconv.b, stride=2,
                                       sparse_dataflow=cfg.sparse_dataflow)
        h = ops.fused_gn_swish(h, self.gn_out.scale, self.gn_out.bias,
                               groups=g)
        return self.conv_out(h)


def unet_apply(unet: UNet, x: torch.Tensor, t: torch.Tensor,
               context: Optional[torch.Tensor] = None,
               policy=None) -> torch.Tensor:
    """Functional spelling of ``UNet.forward`` (the reference's
    ``unet_apply`` entry point)."""
    return unet(x, t, context, policy)
