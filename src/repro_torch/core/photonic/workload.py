"""Workload extraction: per-denoising-step operation counts of a UNet.

A copy of ``repro/core/photonic/workload.py`` against the port's
``UNetConfig``.  Walks the same structure as ``models.unet.UNet`` (the
reference's ``init_unet``) and produces the per-category totals the
DiffLight simulator maps onto its units.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.models.unet import UNetConfig


@dataclasses.dataclass
class Workload:
    name: str
    conv_macs: float = 0.0        # regular convs + 1x1 (Residual unit)
    convt_macs: float = 0.0       # transposed-conv MACs, *dense* count
    convt_zero_frac: float = 0.75  # fraction of convt MACs hitting zeros
    proj_macs: float = 0.0        # Q/K/V projections (head-block MR banks)
    linear_macs: float = 0.0      # out-proj / time-emb (linear+add block)
    attn_score_macs: float = 0.0  # Q.K^T
    attn_v_macs: float = 0.0      # attn . V
    softmax_elems: float = 0.0    # score elements through the ECU pipeline
    act_elems: float = 0.0        # swish activations (SOA blocks)
    norm_elems: float = 0.0       # broadband-MR normalizations
    batch: int = 1

    @property
    def total_macs_dense(self) -> float:
        return (self.conv_macs + self.convt_macs + self.proj_macs +
                self.linear_macs + self.attn_score_macs + self.attn_v_macs)

    def total_macs(self, sparse_dataflow: bool) -> float:
        convt = self.convt_macs * (1.0 - self.convt_zero_frac
                                   if sparse_dataflow else 1.0)
        return (self.conv_macs + convt + self.proj_macs + self.linear_macs +
                self.attn_score_macs + self.attn_v_macs)

    @property
    def total_ops_nominal(self) -> float:
        """Nominal ops (2 x dense MACs) — the numerator of GOPS."""
        return 2.0 * self.total_macs_dense

    def scale(self, f: float) -> 'Workload':
        out = dataclasses.replace(self)
        for fld in ('conv_macs', 'convt_macs', 'proj_macs', 'linear_macs',
                    'attn_score_macs', 'attn_v_macs', 'softmax_elems',
                    'act_elems', 'norm_elems'):
            setattr(out, fld, getattr(self, fld) * f)
        return out


def _attn_counts(w: Workload, S: int, C: int, heads: int,
                 ctx_len: Optional[int], ctx_dim: Optional[int]):
    # self-attention: Q/K/V in head blocks, out-proj in the linear block
    w.proj_macs += 3 * S * C * C
    w.linear_macs += S * C * C
    w.attn_score_macs += S * S * C
    w.attn_v_macs += S * S * C
    w.softmax_elems += heads * S * S
    if ctx_dim is not None and ctx_len:
        w.proj_macs += S * C * C + 2 * ctx_len * ctx_dim * C
        w.linear_macs += S * C * C
        w.attn_score_macs += S * ctx_len * C
        w.attn_v_macs += S * ctx_len * C
        w.softmax_elems += heads * S * ctx_len


def _res_counts(w: Workload, res: int, c_in: int, c_out: int, t_dim: int):
    hw = res * res
    w.norm_elems += hw * c_in
    w.act_elems += hw * c_in
    w.conv_macs += 9 * c_in * c_out * hw
    w.linear_macs += t_dim * c_out            # time-embedding projection
    w.norm_elems += hw * c_out
    w.act_elems += hw * c_out
    w.conv_macs += 9 * c_out * c_out * hw
    if c_in != c_out:
        w.conv_macs += c_in * c_out * hw      # 1x1 skip


def unet_workload(cfg: UNetConfig, batch: int = 1,
                  ctx_len: Optional[int] = 77) -> Workload:
    """Per-denoising-step op counts for one UNet forward (batch=1), walked
    level-by-level in lockstep with ``init_unet``."""
    w = Workload(name=cfg.name, batch=batch)
    t_dim = cfg.base_ch * 4
    ctx_dim = cfg.context_dim
    # time MLP
    w.linear_macs += cfg.base_ch * t_dim + t_dim * t_dim
    w.act_elems += t_dim
    res = cfg.img_size
    ch = cfg.base_ch
    w.conv_macs += 9 * cfg.in_ch * cfg.base_ch * res * res
    chs = [cfg.base_ch]
    for lvl, mult in enumerate(cfg.ch_mults):
        out_ch = cfg.base_ch * mult
        for _ in range(cfg.n_res_blocks):
            _res_counts(w, res, ch, out_ch, t_dim)
            ch = out_ch
            if res in cfg.attn_resolutions:
                w.norm_elems += res * res * ch
                _attn_counts(w, res * res, ch, cfg.n_heads, ctx_len, ctx_dim)
            chs.append(ch)
        if lvl < len(cfg.ch_mults) - 1:
            w.conv_macs += 9 * ch * ch * (res // 2) ** 2
            chs.append(ch)
            res //= 2
    # mid
    _res_counts(w, res, ch, ch, t_dim)
    w.norm_elems += res * res * ch
    _attn_counts(w, res * res, ch, cfg.n_heads, ctx_len, ctx_dim)
    _res_counts(w, res, ch, ch, t_dim)
    # up
    for lvl, mult in reversed(list(enumerate(cfg.ch_mults))):
        out_ch = cfg.base_ch * mult
        for _ in range(cfg.n_res_blocks + 1):
            skip_ch = chs.pop()
            _res_counts(w, res, ch + skip_ch, out_ch, t_dim)
            ch = out_ch
            if res in cfg.attn_resolutions:
                w.norm_elems += res * res * ch
                _attn_counts(w, res * res, ch, cfg.n_heads, ctx_len, ctx_dim)
        if lvl > 0:
            # stride-2 4x4 transposed conv (C4 target): dense MAC count on
            # the zero-inserted grid; 1 - 1/s^2 of them hit zeros
            res *= 2
            w.convt_macs += 16 * ch * ch * res * res
    w.norm_elems += res * res * ch
    w.act_elems += res * res * ch
    w.conv_macs += 9 * ch * cfg.in_ch * res * res
    if batch != 1:
        w = w.scale(batch)
        w.batch = batch
    return w
