"""Prefill and decode step builders, port of the serving half of
``repro/launch/steps.py`` (the train step waits for the training slice).

The reference jits these steps; the port runs them eagerly.  Each step
returns the greedy next token ``(B, 1)`` int32 and the serve state.  For
the encoder-decoder family the steps ignore ``quant``, as the
reference's do: Whisper under ``--w8a8`` runs float and launches no W8A8
kernel.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device=None) -> nn.Module:
    """The model of ``cfg``: ``EncDec`` for the encoder-decoder family,
    else the ``LM``."""
    if cfg.family == 'encdec':
        return ED.init_encdec(generator, cfg, device)
    return T.init_lm(generator, cfg, device)


def init_serve_state(cfg: ArchConfig, batch: int, max_len: int,
                     cache_dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, Any]:
    """The cache; for the encoder-decoder also the encoder ``memory``,
    which the prefill replaces."""
    if cfg.family == 'encdec':
        enc_len = min(max_len, 4096)
        return {'cache': ED.init_dec_cache(cfg, batch, max_len, cache_dtype,
                                           device),
                'memory': torch.zeros((batch, enc_len, cfg.d_model),
                                      dtype=cache_dtype, device=device)}
    return {'cache': T.init_lm_cache(cfg, batch, max_len, cache_dtype,
                                     device)}


def build_prefill_step(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                       quant: bool = False) -> Callable:
    """(params, serve_state, batch) -> (next_token, serve_state); the
    batch holds ``tokens``, and ``frames`` for the encoder-decoder."""

    @torch.no_grad()
    def prefill(params, state, batch):
        if cfg.family == 'encdec':
            logits, cache, memory = ED.encdec_prefill(
                params, cfg, batch['frames'], batch['tokens'],
                state['cache'], dtype=dtype)
            state = {'cache': cache,
                     'memory': memory.to(state['memory'].dtype)}
        else:
            logits, cache = T.lm_prefill(params, cfg, batch['tokens'],
                                         state['cache'], dtype=dtype,
                                         quant=quant)
            state = {'cache': cache}
        return logits.argmax(dim=-1).to(torch.int32), state

    return prefill


def build_decode_step(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                      quant: bool = False) -> Callable:
    """(params, serve_state, token (B, 1), pos) -> (token, serve_state)."""

    @torch.no_grad()
    def decode(params, state, token, pos: int):
        if cfg.family == 'encdec':
            logits, cache = ED.encdec_decode(params, cfg, token,
                                             state['cache'], pos,
                                             state['memory'], dtype=dtype)
        else:
            logits, cache = T.lm_decode(params, cfg, token, state['cache'],
                                        pos, dtype=dtype, quant=quant)
        return logits.argmax(dim=-1).to(torch.int32), dict(state, cache=cache)

    return decode
