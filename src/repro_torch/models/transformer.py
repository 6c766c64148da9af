"""Decoder-only LM, dense family: port of ``repro/models/transformer.py``.

The reference stacks the block params on a leading layer axis and scans
them; the port keeps the blocks in an ``nn.ModuleList`` and loops, so
its ``state_dict`` keys are ``blocks.{i}.sub0...`` where the reference
has ``blocks.sub0...`` with that axis (``bridge.load_jax_lm_params``
unstacks it).  The KV cache is a list with one ``{'sub0': {'k', 'v'}}``
per layer, updated in place.  The other families raise at ``init_lm``,
naming the ROADMAP item that ports them; ``lm_loss`` waits for the
training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, attention,
                                          init_attention_cache)

NORMS = {'rmsnorm': (L.RMSNorm, L.rmsnorm),
         'layernorm': (L.LayerNorm, L.layernorm)}


def _check_ported(cfg: ArchConfig) -> None:
    missing = []
    if cfg.moe is not None or cfg.family == 'moe':
        missing.append('MoE (ROADMAP Queue 1 item 7a)')
    if cfg.mla is not None:
        missing.append('MLA (item 7b)')
    if cfg.ssm is not None or cfg.family in ('ssm', 'hybrid'):
        missing.append('SSM / hybrid (item 7c)')
    if cfg.family == 'encdec':
        missing.append('encoder-decoder (item 7d)')
    if cfg.family == 'vlm' or cfg.rope == 'mrope':
        missing.append('M-RoPE / VLM (item 7e)')
    if missing:
        raise NotImplementedError(f'{cfg.name}: the port has the dense LM '
                                  'family only; not yet ported: '
                                  + ', '.join(missing))


class _SubLayer(nn.Module):
    """The reference's ``sub0``: attention and a dense MLP, each behind
    its norm."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        norm = NORMS[cfg.norm][0]
        self.mix_norm = norm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ffn_norm = norm(cfg.d_model, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff,
                         gated=cfg.act in ('swish', 'silu'),
                         bias=cfg.mlp_bias, device=device)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.sub0 = _SubLayer(cfg, device)


def apply_block(p: Block, cfg: ArchConfig, x: torch.Tensor, *,
                cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
                quant: bool = False):
    norm = NORMS[cfg.norm][1]
    sub = p.sub0
    h, nc = attention(sub.attn, cfg, norm(sub.mix_norm, x),
                      cache=None if cache is None else cache['sub0'],
                      cache_pos=cache_pos, quant=quant)
    x = x + h
    x = x + L.mlp(sub.mlp, norm(sub.ffn_norm, x), act=cfg.act, quant=quant)
    return x, (None if cache is None else {'sub0': nc})


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        _check_ported(cfg)
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = NORMS[cfg.norm][0](cfg.d_model, device)
        self.lm_head = None if cfg.tie_embeddings else L.Linear(
            cfg.d_model, cfg.vocab, bias=False, device=device, stddev=0.02)


def init_lm(generator: torch.Generator, cfg: ArchConfig, device=None) -> LM:
    """The LM with the reference's initialisation drawn from
    ``generator`` (which must live on ``device``)."""
    lm = LM(cfg, device)
    L.init_params(lm, generator)
    return lm


def _readout(p: LM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = NORMS[cfg.norm][1](p.final_norm, x)
    return (L.embedding_logits(p.embed, x) if cfg.tie_embeddings
            else p.lm_head(x))


def _apply_blocks(p: LM, cfg: ArchConfig, x: torch.Tensor, *, cache=None,
                  cache_pos=None, quant=False):
    new_cache: Optional[List[Any]] = None if cache is None else []
    for i, blk in enumerate(p.blocks):
        x, nc = apply_block(blk, cfg, x,
                            cache=None if cache is None else cache[i],
                            cache_pos=cache_pos, quant=quant)
        if new_cache is not None:
            new_cache.append(nc)
    return x, new_cache


def lm_apply(p: LM, cfg: ArchConfig, tokens: torch.Tensor, *,
             dtype: torch.dtype = torch.float32,
             quant: bool = False) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab), no cache.  (The reference's
    ``pos`` and ``inputs_embeds`` serve the frontend families.)"""
    x = L.embedding(p.embed, tokens, dtype)
    x, _ = _apply_blocks(p, cfg, x, quant=quant)
    return _readout(p, cfg, x)


def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    return [{'sub0': init_attention_cache(cfg, batch, max_len, dtype,
                                          device)}
            for _ in range(cfg.n_layers)]


def lm_prefill(p: LM, cfg: ArchConfig, tokens: torch.Tensor, cache, *,
               dtype: torch.dtype = torch.bfloat16, quant: bool = False):
    """Fill the cache with a prompt; returns (last-token logits, cache)."""
    x = L.embedding(p.embed, tokens, dtype)
    x, cache = _apply_blocks(p, cfg, x, cache=cache, cache_pos=0,
                             quant=quant)
    return _readout(p, cfg, x[:, -1:]), cache


def lm_decode(p: LM, cfg: ArchConfig, token: torch.Tensor, cache,
              pos_scalar: int, *, dtype: torch.dtype = torch.bfloat16,
              quant: bool = False):
    """One decode step.  token (B, 1); ``pos_scalar`` = current length."""
    x = L.embedding(p.embed, token, dtype)
    x, cache = _apply_blocks(p, cfg, x, cache=cache, cache_pos=pos_scalar,
                             quant=quant)
    return _readout(p, cfg, x), cache
