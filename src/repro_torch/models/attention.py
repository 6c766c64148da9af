"""Grouped-query attention with RoPE and a KV cache, port of
``repro/models/attention.py`` for the dense LM family (MLA waits for its
slice, ROADMAP Queue 1 item 7b).

Paper hooks, as in the reference: C2, the softmax always goes through
the LSE decomposition (``gqa_core``: grouped einsum + ``lse_softmax``;
``flash_core``: the hand-written flash kernel); C3, 1/sqrt(d) is folded
into q; C1, ``quant=True`` runs ``wq`` and ``wo`` on the W8A8 kernel
(``wk`` and ``wv`` stay float, as the reference leaves them).

Routing.  Without a cache, ``impl='xla'`` (the default) is ``gqa_core``
and ``impl='pallas'`` is ``flash_core``, now the CUDA kernel.  With a
cache, the prefill (``cache_pos == 0`` as a Python int) computes its
output with ``flash_core`` over the rows just written into the cache,
read back in the cache's dtype where they lie: the same function as the
reference's ``gqa_core`` over the whole cache, whose rows past S weigh
``exp(-1e30 - m) = 0``.  A decode step (``cache_pos > 0``) is
``gqa_core`` over the whole cache, as in the reference.  The cache is
updated in place and the same dict comes back as the new cache (the
reference returns an updated copy).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lse_softmax import lse_softmax
from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), pos (B, S) -> rotated x (half-split convention)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = pos[..., None].float() * freqs                 # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(cfg: ArchConfig, x: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    if cfg.rope == 'none':
        return x
    if cfg.rope == 'mrope':
        raise NotImplementedError('M-RoPE is ported with the VLM family '
                                  '(ROADMAP Queue 1 item 7e)')
    return rope(x, pos, cfg.rope_theta)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def gqa_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, q_offset: int = 0, kv_len: Optional[int] = None,
             scale: Optional[float] = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, T, G, hd) with H = G * rep; K/V are never
    repeated in memory.  ``kv_len``: valid cache rows; ``q_offset``:
    absolute position of q's row 0 (causal masking against the cache)."""
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    rep = H // G
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, S, G, rep, hd).float() * scale
    s = torch.einsum('bsgrd,btgd->bgrst', qg, k.float())
    t_pos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(S, device=q.device) + q_offset
        mask = mask & (t_pos[None, :] <= q_pos[:, None])
    if kv_len is not None:
        mask = mask & (t_pos[None, :] < kv_len)
    s = torch.where(mask, s, NEG_INF)
    p = lse_softmax(s, dim=-1)                             # paper Eq. 4
    out = torch.einsum('bgrst,btgd->bsgrd', p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool) -> torch.Tensor:
    """The flash kernel on q (B, S, H, hd), k/v (B, T, G, hd) as they lie
    (the prefill passes slices of the cache): query head h reads KV head
    h // (H // G), and the output comes back as (B, S, H, hd)."""
    return ops.flash_attention_bshd(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# the GQA layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """The reference's ``init_attention`` params ``{'wq', 'wk', 'wv',
    'wo'}``; K/V project to ``n_kv_heads`` heads.  ``layers.init_params``
    draws them."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
        self.wq = L.Linear(d, H * hd, cfg.attn_bias, device)
        self.wk = L.Linear(d, cfg.n_kv_heads * hd, cfg.attn_bias, device)
        self.wv = L.Linear(d, cfg.n_kv_heads * hd, cfg.attn_bias, device)
        self.wo = L.Linear(H * hd, d, cfg.attn_bias, device)


def _project_kv(p: Attention, cfg: ArchConfig, x_kv: torch.Tensor,
                pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, _ = x_kv.shape
    k = p.wk(x_kv).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    v = p.wv(x_kv).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    k = apply_rope(cfg, k, pos)
    if cfg.kv_repeat > 1:     # the reference's logical replication
        k = k.repeat_interleave(cfg.kv_repeat, dim=2)
        v = v.repeat_interleave(cfg.kv_repeat, dim=2)
    return k, v


def attention(p: Attention, cfg: ArchConfig, x: torch.Tensor, *,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[int] = None,
              causal: bool = True,
              impl: str = 'xla',
              quant: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One self-attention layer; returns (out, new_cache).  Positions
    count from ``cache_pos`` (0 without a cache).

    Modes: no cache (train / plain forward), ``cache`` with
    ``cache_pos = 0`` (prefill: fills the cache), ``cache`` with
    ``cache_pos`` = the current length (decode).  The reference's
    cross-attention (``memory``) and explicit positions come with the
    encoder-decoder and VLM slices."""
    B, S, _ = x.shape
    hd, H = cfg.hd, cfg.n_heads
    if impl not in ('xla', 'pallas'):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    start = 0 if cache_pos is None else cache_pos
    pos = torch.arange(start, start + S, device=x.device)[None, :]
    pos = pos.expand(B, S)
    pol = 'w8a8' if quant else None
    q = apply_rope(cfg, p.wq(x, pol).reshape(B, S, H, hd), pos)
    k, v = _project_kv(p, cfg, x, pos)

    if cache is None:                            # plain self-attention
        core = flash_core if impl == 'pallas' else gqa_core
        out = core(q, k, v, causal=causal)
    else:                                        # prefill or decode
        ck, cv = cache['k'], cache['v']
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        if isinstance(cache_pos, int) and cache_pos == 0:
            out = flash_core(q, ck[:, :S], cv[:, :S], causal=True)
        else:
            out = gqa_core(q, ck, cv, causal=True, q_offset=cache_pos,
                           kv_len=cache_pos + S)
    return p.wo(out.reshape(B, S, H * hd), pol), cache


def init_attention_cache(cfg: ArchConfig, batch: int, max_len: int,
                         dtype: torch.dtype = torch.bfloat16,
                         device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads * cfg.kv_repeat, cfg.hd)
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device)}
