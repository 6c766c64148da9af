"""Attention, port of ``repro/models/attention.py``: grouped-query
attention with RoPE or M-RoPE (Qwen2-VL's multimodal rotary embedding),
a KV cache and cross-attention into an encoder's memory, and MLA
(DeepSeek-V2's multi-head latent attention) with its compressed cache.

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
reference returns an updated copy).  Cross-attention into an encoder's
memory is ``gqa_core``, as in the reference.

MLA keeps both of the reference's paths.  Without a cache it decompresses
K and V from the latent ``c_kv``; with a cache (the prefill, whose
``cache_pos`` is 0, and every decode step) it runs the absorbed path:
q is projected into the latent space, and the cache holds only ``c_kv``
and the shared RoPE key ``k_pe``.  Its scores go through ``lse_softmax``
as in the reference; the flash kernel does not fit it (q/k heads of
``nope + rope`` = 192 against 128 for v; absorbed keys 576 wide).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lse_softmax import lse_softmax
from repro_torch.core.quantization import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) rotated by the angles ang (B, S, hd/2), half-split
    convention, in float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), pos (B, S) -> rotated x (half-split convention)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, pos[..., None].float() * freqs)


def mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
          sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): pos3 (B, S, 3) holds the (t, h, w)
    position ids; the hd/2 frequency channels split into ``sections``
    (in order), each rotated by its own stream.  For pure text the three
    streams are equal and M-RoPE is RoPE."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f'M-RoPE sections {sections} do not cover the '
                         f'{hd // 2} frequency channels of head dim {hd}')
    freqs = _rope_freqs(hd, theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))             # (hd/2,)
    return _rotate(x, pos3.float()[..., sec_id] * freqs)


def apply_rope(cfg: ArchConfig, x: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """RoPE, M-RoPE or nothing, per ``cfg.rope``.  Under M-RoPE a 2-D
    ``pos`` (B, S) is text: it is broadcast to three equal streams."""
    if cfg.rope == 'none':
        return x
    if cfg.rope == 'mrope':
        if pos.dim() == 2:
            pos = pos[..., None].expand(*pos.shape, 3)
        return mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
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
    qg = SH.split_dim(q, 2, (G, rep)).float() * scale
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


def core_on_shards(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   **kw) -> torch.Tensor:
    """``core(q, k, v, **kw)``; on a mesh, on each rank's own batch rows
    and heads (``sharding.on_shards``): attention is independent per row
    and per KV group, so the local core is the core.  q's heads follow
    K's: when the KV heads do not divide 'model' (kept whole by
    ``shard_hint``), q's are gathered too."""
    if SH.is_dtensor(q) and q.placements != k.placements:
        q = q.redistribute(q.device_mesh, k.placements)
    return SH.on_shards(lambda a, b, c: core(a, b, c, **kw), 1, q, k, v)


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
                pos: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V of ``x_kv``; K rotated at ``pos`` unless it is None (the
    encoder memory of cross-attention)."""
    B, T, _ = x_kv.shape
    k = SH.split_dim(p.wk(x_kv), -1, (cfg.n_kv_heads, cfg.hd))
    v = SH.split_dim(p.wv(x_kv), -1, (cfg.n_kv_heads, cfg.hd))
    if pos is not None:
        k = apply_rope(cfg, k, pos)
    if cfg.kv_repeat > 1:     # the reference's logical replication
        k = k.repeat_interleave(cfg.kv_repeat, dim=2)
        v = v.repeat_interleave(cfg.kv_repeat, dim=2)
    tp = 'model' if cfg.model_axis_tp else None
    return (SH.shard_hint(k, 'dp', None, tp, None),
            SH.shard_hint(v, 'dp', None, tp, None))


def _positions(x: torch.Tensor, cache_pos: Optional[int]) -> torch.Tensor:
    """(B, S) positions counting from ``cache_pos`` (0 without a cache)."""
    B, S, _ = x.shape
    start = 0 if cache_pos is None else cache_pos
    pos = torch.arange(start, start + S, device=x.device)[None, :]
    return pos.expand(B, S)


def attention(p: Attention, cfg: ArchConfig, x: torch.Tensor, *,
              pos: Optional[torch.Tensor] = None,
              memory: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[int] = None,
              causal: bool = True,
              impl: str = 'xla',
              quant: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention layer; returns (out, new_cache).  ``pos``: (B, S)
    positions, or (B, S, 3) M-RoPE streams; by default they count from
    ``cache_pos`` (0 without a cache).

    Modes: no cache (train / plain forward), ``cache`` with
    ``cache_pos = 0`` (prefill: fills the cache), ``cache`` with
    ``cache_pos`` = the current length (decode).  ``memory`` (B, T, d)
    switches to cross-attention: K and V are projected from it without
    rotation, ``gqa_core`` attends to all of it with no mask, and the
    cache comes back as passed."""
    B, S, _ = x.shape
    hd, H = cfg.hd, cfg.n_heads
    if impl not in ('xla', 'pallas'):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    if pos is None:
        pos = _positions(x, cache_pos)
    pol = 'w8a8' if quant else None
    tp = 'model' if cfg.model_axis_tp else None
    x = SH.shard_hint(x, 'dp', None, None)
    q = SH.shard_hint(SH.split_dim(p.wq(x, pol), -1, (H, hd)),
                      'dp', None, tp, None)
    q = apply_rope(cfg, q, pos)

    if memory is not None:                       # cross-attention
        k, v = _project_kv(p, cfg, memory, None)
        out = core_on_shards(gqa_core, q, k, v, causal=False)
    elif cache is None:                          # plain self-attention
        k, v = _project_kv(p, cfg, x, pos)
        core = flash_core if impl == 'pallas' else gqa_core
        out = core_on_shards(core, q, k, v, causal=causal)
    else:                                        # prefill or decode
        k, v = _project_kv(p, cfg, x, pos)
        ck, cv = cache['k'], cache['v']
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        if isinstance(cache_pos, int) and cache_pos == 0:
            out = flash_core(q, ck[:, :S], cv[:, :S], causal=True)
        else:
            out = gqa_core(q, ck, cv, causal=True, q_offset=cache_pos,
                           kv_len=cache_pos + S)
    out = SH.shard_hint(out, 'dp', None, tp, None)
    y = p.wo(out.reshape(B, S, H * hd), pol)
    return SH.shard_hint(y, 'dp', None, None), cache


def init_attention_cache(cfg: ArchConfig, batch: int, max_len: int,
                         dtype: torch.dtype = torch.bfloat16,
                         device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads * cfg.kv_repeat, cfg.hd)
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV cache
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """The reference's ``init_mla`` params: ``wq`` (all heads' nope + rope
    dims), the latent down-projection ``w_dkv`` and its ``kv_norm``, the
    shared RoPE key ``w_kpe``, the up-projections ``w_uk`` / ``w_uv`` and
    ``wo``; no biases."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        nope, rpe = m.qk_nope_head_dim, m.qk_rope_head_dim
        rank = m.kv_lora_rank
        self.wq = L.Linear(d, H * (nope + rpe), False, device)
        self.w_dkv = L.Linear(d, rank, False, device)
        self.w_kpe = L.Linear(d, rpe, False, device)
        self.w_uk = L.Linear(rank, H * nope, False, device)
        self.w_uv = L.Linear(rank, H * m.v_head_dim, False, device)
        self.wo = L.Linear(H * m.v_head_dim, d, False, device)
        self.kv_norm = L.RMSNorm(rank, device)


def _raw(lin: L.Linear) -> torch.Tensor:
    """A Linear's weight as float32, dequantizing a serve-time QWeight."""
    w = lin.weight
    return w.q.float() * w.scale if isinstance(w, QTensor) else w.float()


def mla_attention(p: MLA, cfg: ArchConfig, x: torch.Tensor, *,
                  pos: Optional[torch.Tensor] = None,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_pos: Optional[int] = None,
                  quant: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One MLA layer; returns (out, new_cache).  ``pos`` (B, S): by
    default positions count from ``cache_pos`` (0 without a cache).
    Without a cache: the decompressed
    path.  With one (prefill or decode): ``c_kv`` and ``k_pe`` are written
    at ``cache_pos``, in place, and the absorbed path attends over the
    whole cache, rows past ``cache_pos + S`` masked."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rpe, vd, rank = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                           m.v_head_dim, m.kv_lora_rank)
    if pos is None:
        pos = _positions(x, cache_pos)
    pol = 'w8a8' if quant else None
    tp = 'model' if cfg.model_axis_tp else None
    x = SH.shard_hint(x, 'dp', None, None)
    q = SH.shard_hint(SH.split_dim(p.wq(x, pol), -1, (H, nope + rpe)),
                      'dp', None, tp, None)
    q_nope = q[..., :nope].float()
    q_pe = rope(q[..., nope:], pos, cfg.rope_theta).float()
    c_kv = L.rmsnorm(p.kv_norm, p.w_dkv(x, pol))
    k_pe = rope(p.w_kpe(x, pol)[:, :, None, :], pos,
                cfg.rope_theta)[:, :, 0, :]               # (B, S, rpe)
    scale = (nope + rpe) ** -0.5

    if cache is not None and cache_pos is not None:      # absorbed path
        cc, cp = cache['c_kv'], cache['k_pe']
        cc[:, cache_pos:cache_pos + S] = c_kv.to(cc.dtype)
        cp[:, cache_pos:cache_pos + S] = k_pe.to(cp.dtype)
        T = cc.shape[1]
        ccf = cc.float()
        # q_nope' = q_nope @ W_uk^T: the query in the latent space
        q_lat = torch.einsum('bshn,rhn->bshr', q_nope,
                             _raw(p.w_uk).reshape(rank, H, nope))
        s = (torch.einsum('bshr,btr->bhst', q_lat, ccf)
             + torch.einsum('bshp,btp->bhst', q_pe, cp.float())) * scale
        t_pos = torch.arange(T, device=x.device)
        q_pos = torch.arange(S, device=x.device) + cache_pos
        mask = (t_pos[None, :] <= q_pos[:, None]) & \
            (t_pos[None, :] < cache_pos + S)
        pr = lse_softmax(torch.where(mask, s, NEG_INF), dim=-1)
        o_lat = torch.einsum('bhst,btr->bshr', pr, ccf)
        out = torch.einsum('bshr,rhv->bshv', o_lat,
                           _raw(p.w_uv).reshape(rank, H, vd))
    else:                                                # decompressed
        k_nope = SH.shard_hint(SH.split_dim(p.w_uk(c_kv), -1, (H, nope)),
                               'dp', None, tp, None)
        vv = SH.shard_hint(SH.split_dim(p.w_uv(c_kv), -1, (H, vd)),
                           'dp', None, tp, None)
        out = SH.on_shards(
            lambda a, b, c, d, e: _mla_core(a, b, c, d, e, scale), 1,
            q_nope, q_pe, k_nope, k_pe, vv)
    out = SH.shard_hint(out.to(x.dtype), 'dp', None, tp, None)
    y = p.wo(out.reshape(B, S, H * vd), pol)
    return SH.shard_hint(y, 'dp', None, None), cache


def _mla_core(q_nope, q_pe, k_nope, k_pe, vv, scale):
    """The decompressed MLA core: causal scores of q = (nope, pe) against
    k = (nope per head, pe shared), softmax, times v per head.  On a mesh
    it runs per rank on its batch rows and heads (``on_shards``; the
    shared ``k_pe`` serves every head shard)."""
    S = q_nope.shape[1]
    s = (torch.einsum('bshn,bthn->bhst', q_nope, k_nope.float())
         + torch.einsum('bshp,btp->bhst', q_pe, k_pe.float())) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
    pr = lse_softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum('bhst,bthv->bshv', pr, vv.float())


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {'c_kv': torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            'k_pe': torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                dtype=dtype, device=device)}
