"""Whisper-style encoder-decoder backbone: port of
``repro/models/encdec.py``.

The conv/audio frontend is a stub, as in the reference: ``encode`` takes
frame embeddings (B, T_enc, d).  The encoder is a bidirectional
transformer; the decoder is causal self-attention with a KV cache, then
cross-attention into the encoder's memory, then a biased, non-gated
tanh-gelu MLP, each behind a LayerNorm.  Positions are the reference's
float32 sinusoids added to the inputs (``rope='none'``).

Routing, as in the reference's code: the encoder and cross-attention run
``gqa_core`` (``impl='xla'``); the decoder's self-attention is the LM's
``attention`` with a cache, so its prefill runs the flash kernel on the
rows just written (one launch per decoder layer) and a decode step runs
``gqa_core``.  The reference's docstring says cross-attention uses the
paper's Eq. 6 reordering when profitable; its code always calls
``gqa_core``, and the port follows the code.  Nothing here takes
``quant``: the reference's encoder-decoder path never quantizes.

The reference stacks each block kind's params on a leading axis and
scans them; the port keeps ``enc_blocks`` and ``dec_blocks`` as
``nn.ModuleList``s (``bridge.load_jax_encdec_params`` unstacks the
reference's tree), and the decoder cache is a list with one ``{'k',
'v'}`` per layer, updated in place.

Training: ``encdec_loss`` is the LM's cross-entropy over
``decode_train``'s logits.  Every encoder layer, and every decoder layer
without a cache, runs under full remat (``layers.remat``) when grad is
enabled and ``cfg.remat`` is not ``'none'``: the reference's encoder and
decoder take plain ``jax.checkpoint`` for ``'dots'`` too.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, attention,
                                          init_attention_cache)


def _sinusoid(T: int, d: int, device=None, start: int = 0) -> torch.Tensor:
    """Rows ``start .. start + T - 1`` of the reference's float32 table:
    ``[sin(pos / 10000^(2i/d)), cos(...)]`` over i < d/2."""
    pos = torch.arange(start, start + T, device=device,
                       dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncBlock(nn.Module):
    """The reference's ``init_enc_block`` params: ``attn`` behind
    ``attn_norm``, a biased non-gated ``mlp`` behind ``ffn_norm``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.attn_norm = L.LayerNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ffn_norm = L.LayerNorm(cfg.d_model, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, gated=False, bias=True,
                         device=device)


class DecBlock(EncBlock):
    """The reference's ``init_dec_block`` params: an encoder block's, and
    the cross-attention ``xattn`` behind ``xattn_norm``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(cfg, device)
        self.xattn_norm = L.LayerNorm(cfg.d_model, device)
        self.xattn = Attention(cfg, device)


class EncDec(nn.Module):
    """The reference's ``init_encdec`` params; the readout is tied to the
    decoder's embedding table."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        n_enc = cfg.n_enc_layers or cfg.n_layers
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device)
                                        for _ in range(n_enc))
        self.enc_norm = L.LayerNorm(cfg.d_model, device)
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.dec_norm = L.LayerNorm(cfg.d_model, device)


def init_encdec(generator: torch.Generator, cfg: ArchConfig,
                device=None) -> EncDec:
    """The encoder-decoder with the reference's initialisation drawn from
    ``generator`` (which must live on ``device``)."""
    m = EncDec(cfg, device)
    L.init_params(m, generator)
    return m


def _ffn(blk: EncBlock, x: torch.Tensor) -> torch.Tensor:
    # the residual stream held at ('dp', None, None) on both sides, as
    # the LM's blocks hold it: a product's output may land with its rows
    # on 'model', which the next block's backward cannot follow, and a
    # batch of one row must not stay split over a 'data' axis of one rank
    x = SH.shard_hint(x, 'dp', None, None)
    return SH.shard_hint(x + L.mlp(blk.mlp, L.layernorm(blk.ffn_norm, x),
                                   act='gelu'), 'dp', None, None)


def encode(p: EncDec, cfg: ArchConfig, frames: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """frames (B, T_enc, d) stub embeddings -> memory (B, T_enc, d)."""
    x = frames.to(dtype) + _sinusoid(frames.shape[1], cfg.d_model,
                                     frames.device).to(dtype)

    def body(blk, h):
        a, _ = attention(blk.attn, cfg, L.layernorm(blk.attn_norm, h),
                         causal=False)
        return _ffn(blk, h + a)

    for blk in p.enc_blocks:
        x = L.remat(_remat(cfg), functools.partial(body, blk), x)
    return L.layernorm(p.enc_norm, x)


def _remat(cfg: ArchConfig) -> str:
    """The encoder's and decoder's policy: full unless ``'none'``."""
    return 'none' if cfg.remat == 'none' else 'full'


def _dec_blocks(p: EncDec, cfg: ArchConfig, x: torch.Tensor,
                memory: torch.Tensor, *, cache=None,
                cache_pos: Optional[int] = None):
    """The decoder layers, the counterpart of the reference's
    ``_dec_scan``: causal self-attention (with the cache when given),
    cross-attention into ``memory``, the MLP."""

    def body(blk, blk_cache, h, mem):
        a, _ = attention(blk.attn, cfg, L.layernorm(blk.attn_norm, h),
                         cache=blk_cache, cache_pos=cache_pos)
        h = h + a
        xa, _ = attention(blk.xattn, cfg, L.layernorm(blk.xattn_norm, h),
                          memory=mem)
        return _ffn(blk, h + xa)

    for i, blk in enumerate(p.dec_blocks):
        if cache is None:
            x = L.remat(_remat(cfg), functools.partial(body, blk, None), x,
                        memory)
        else:
            x = body(blk, cache[i], x, memory)
    return x, cache


def _readout(p: EncDec, x: torch.Tensor) -> torch.Tensor:
    return L.embedding_logits(p.embed, L.layernorm(p.dec_norm, x))


def decode_train(p: EncDec, cfg: ArchConfig, frames: torch.Tensor,
                 tokens: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, vocab), no cache."""
    memory = encode(p, cfg, frames, dtype)
    x = L.embedding(p.embed, tokens, dtype) + _sinusoid(
        tokens.shape[1], cfg.d_model, tokens.device).to(dtype)
    x, _ = _dec_blocks(p, cfg, x, memory)
    return _readout(p, x)


def init_dec_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> List[Dict[str, torch.Tensor]]:
    """One ``{'k', 'v'}`` self-attention cache per decoder layer."""
    return [init_attention_cache(cfg, batch, max_len, dtype, device)
            for _ in range(cfg.n_layers)]


def encdec_prefill(p: EncDec, cfg: ArchConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, cache,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[torch.Tensor, list, torch.Tensor]:
    """Encode the frames and fill the decoder cache with the prompt;
    returns (last-token logits, cache, memory)."""
    memory = encode(p, cfg, frames, dtype)
    x = L.embedding(p.embed, tokens, dtype) + _sinusoid(
        tokens.shape[1], cfg.d_model, tokens.device).to(dtype)
    x, cache = _dec_blocks(p, cfg, x, memory, cache=cache, cache_pos=0)
    return _readout(p, x[:, -1:]), cache, memory


def encdec_decode(p: EncDec, cfg: ArchConfig, token: torch.Tensor, cache,
                  pos_scalar: int, memory: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16):
    """One decode step: token (B, 1) at ``pos_scalar`` = current length.
    The reference slices row ``pos_scalar`` of a sinusoid table of
    ``max_seq_len`` rows (2^16 when that is 2^20 or more), its start
    clamped to the last row; the port computes that one row."""
    rows = cfg.max_seq_len if cfg.max_seq_len < (1 << 20) else 1 << 16
    x = L.embedding(p.embed, token, dtype) + _sinusoid(
        1, cfg.d_model, token.device, min(pos_scalar, rows - 1)).to(dtype)
    x, cache = _dec_blocks(p, cfg, x, memory, cache=cache,
                           cache_pos=pos_scalar)
    return _readout(p, x), cache


def encdec_loss(p: EncDec, cfg: ArchConfig, frames: torch.Tensor,
                tokens: torch.Tensor, labels: torch.Tensor,
                dtype: torch.dtype = torch.float32,
                real_vocab: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy of ``decode_train``'s logits, as ``lm_loss``."""
    return L.token_xent(decode_train(p, cfg, frames, tokens, dtype), labels,
                        real_vocab)
