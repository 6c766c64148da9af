"""Decoder-only LM covering the dense, MoE, SSM, hybrid and VLM
families: port of ``repro/models/transformer.py``.

The reference stacks the params of its scanned units on a leading axis
and scans them; the port keeps the units in an ``nn.ModuleList`` and
loops.  A unit (``Block``) holds one sub-layer per ``(mixer, ffn)`` kind
of ``_block_kinds``: one for the dense (``A``/``D``), MoE (``A``/``E``),
MLA (``L``/``E``) and SSM (``M``/``-``) families, and the unrolled
pattern of a hybrid super-block (Jamba: 8, attention at position 3, the
MoE FFN on odd positions).  So the ``state_dict`` keys are
``blocks.{i}.sub{j}...`` where the reference has ``blocks.sub{j}...``
with the leading axis of ``n_scan_steps`` units
(``bridge.load_jax_lm_params`` unstacks it).  The cache is a list with
one ``{'sub{j}': ...}`` per unit (GQA ``k``/``v``, MLA ``c_kv``/``k_pe``,
Mamba ``conv``/``state``), updated in place.  The VLM family (Qwen2-VL)
is the dense blocks under M-RoPE; its vision frontend is a stub that
hands ``lm_apply`` the ``inputs_embeds``.  The encoder-decoder family
lives in ``models/encdec.py``.

Training: ``lm_loss`` is the reference's causal cross-entropy, and
without a cache each unit runs under ``cfg.remat`` (``layers.remat``:
``torch.utils.checkpoint`` where the reference wraps its scan body in
``jax.checkpoint``) when grad is enabled; a unit with a cache never is.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.attention import (MLA, Attention, attention,
                                          init_attention_cache,
                                          init_mla_cache, mla_attention)

NORMS = {'rmsnorm': (L.RMSNorm, L.rmsnorm),
         'layernorm': (L.LayerNorm, L.layernorm)}


def _block_kinds(cfg: ArchConfig):
    """Per-sub-layer (mixer, ffn) kinds within one scanned unit: mixer
    ``A`` attention, ``L`` MLA, ``M`` Mamba; ffn ``D`` dense MLP, ``E``
    MoE, ``-`` none."""
    if cfg.family == 'hybrid':
        return tuple(zip(cfg.hybrid_block, cfg.hybrid_ffn))
    if cfg.family == 'ssm':
        return (('M', '-'),)
    mixer = 'L' if cfg.mla is not None else 'A'
    ffn = 'E' if (cfg.moe is not None and cfg.moe.every == 1) else 'D'
    return ((mixer, ffn),)


def n_scan_steps(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(_block_kinds(cfg))


class _SubLayer(nn.Module):
    """One sub-layer: its mixer (``attn`` or ``mamba``) behind
    ``mix_norm``, and its FFN (``mlp`` or ``moe``) behind ``ffn_norm``."""

    def __init__(self, cfg: ArchConfig, mixer: str, ffn: str, device=None):
        super().__init__()
        norm = NORMS[cfg.norm][0]
        self.mix_norm = norm(cfg.d_model, device)
        if mixer == 'A':
            self.attn = Attention(cfg, device)
        elif mixer == 'L':
            self.attn = MLA(cfg, device)
        else:
            self.mamba = SSM.Mamba(cfg, device)
        if ffn != '-':
            self.ffn_norm = norm(cfg.d_model, device)
        if ffn == 'D':
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff,
                             gated=cfg.act in ('swish', 'silu'),
                             bias=cfg.mlp_bias, device=device)
        elif ffn == 'E':
            self.moe = MOE.MoE(cfg, device)


class Block(nn.Module):
    """One scanned unit: sub-layers ``sub0 .. sub{n-1}``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        for i, (mixer, ffn) in enumerate(_block_kinds(cfg)):
            self.add_module(f'sub{i}', _SubLayer(cfg, mixer, ffn, device))


def apply_block(p: Block, cfg: ArchConfig, x: torch.Tensor, *,
                cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
                pos: Optional[torch.Tensor] = None, quant: bool = False):
    norm = NORMS[cfg.norm][1]
    for i, (mixer, ffn) in enumerate(_block_kinds(cfg)):
        sub = getattr(p, f'sub{i}')
        sub_cache = None if cache is None else cache[f'sub{i}']
        h = norm(sub.mix_norm, x)
        if mixer == 'A':
            h, _ = attention(sub.attn, cfg, h, pos=pos, cache=sub_cache,
                             cache_pos=cache_pos, quant=quant)
        elif mixer == 'L':
            h, _ = mla_attention(sub.attn, cfg, h, pos=pos, cache=sub_cache,
                                 cache_pos=cache_pos, quant=quant)
        else:
            h, _ = SSM.mamba(sub.mamba, cfg, h, cache=sub_cache, quant=quant)
        x = x + h
        if ffn != '-':
            h = norm(sub.ffn_norm, x)
            if ffn == 'E':
                h = MOE.moe_ffn(sub.moe, cfg, h, quant=quant)
            else:
                h = L.mlp(sub.mlp, h, act=cfg.act, quant=quant,
                          tp_axis='model' if cfg.model_axis_tp else None)
            x = x + h
    return x, cache


def init_block_cache(cfg: ArchConfig, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """One unit's cache.  The Mamba cache is float32 whatever ``dtype``
    is, as the reference's ``init_mamba_cache`` default."""
    c = {}
    for i, (mixer, _) in enumerate(_block_kinds(cfg)):
        if mixer == 'A':
            c[f'sub{i}'] = init_attention_cache(cfg, batch, max_len, dtype,
                                                device)
        elif mixer == 'L':
            c[f'sub{i}'] = init_mla_cache(cfg, batch, max_len, dtype, device)
        else:
            c[f'sub{i}'] = SSM.init_mamba_cache(cfg, batch, device=device)
    return c


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(n_scan_steps(cfg)))
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
    logits = (L.embedding_logits(p.embed, x) if cfg.tie_embeddings
              else p.lm_head(x))
    return SH.shard_hint(logits, 'dp', None, 'model')


def _apply_blocks(p: LM, cfg: ArchConfig, x: torch.Tensor, *, cache=None,
                  cache_pos=None, pos=None, quant=False):
    if cache is None:
        for blk in p.blocks:
            x = L.remat(cfg.remat, lambda h, blk=blk: apply_block(
                blk, cfg, h, pos=pos, quant=quant)[0], x)
        return x, None
    new_cache: List[Any] = []
    for i, blk in enumerate(p.blocks):
        x, nc = apply_block(blk, cfg, x,
                            cache=cache[i], cache_pos=cache_pos, pos=pos,
                            quant=quant)
        new_cache.append(nc)
    return x, new_cache


def lm_apply(p: LM, cfg: ArchConfig, tokens: Optional[torch.Tensor], *,
             dtype: torch.dtype = torch.float32,
             pos: Optional[torch.Tensor] = None,
             inputs_embeds: Optional[torch.Tensor] = None,
             quant: bool = False) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab), no cache.  ``inputs_embeds``
    (B, S, d) replaces the embedding lookup (the modality frontends'
    stubs); ``pos`` (B, S), or (B, S, 3) M-RoPE streams, replaces the
    positions 0 .. S-1 in every attention mixer."""
    x = (L.embedding(p.embed, tokens, dtype) if inputs_embeds is None
         else inputs_embeds.to(dtype))
    x = SH.shard_hint(x, 'dp', None, None)
    x, _ = _apply_blocks(p, cfg, x, pos=pos, quant=quant)
    return _readout(p, cfg, x)


def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    return [init_block_cache(cfg, batch, max_len, dtype, device)
            for _ in range(n_scan_steps(cfg))]


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


def lm_loss(p: LM, cfg: ArchConfig, tokens: Optional[torch.Tensor],
            labels: torch.Tensor, *, dtype: torch.dtype = torch.float32,
            real_vocab: Optional[int] = None,
            inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal cross-entropy of ``lm_apply``'s logits (``layers.token_xent``:
    padded vocabulary rows masked, labels of -1 ignored)."""
    logits = lm_apply(p, cfg, tokens, dtype=dtype,
                      inputs_embeds=inputs_embeds)
    return L.token_xent(logits, labels, real_vocab)
