"""Prefill and decode step builders, port of the serving half of
``repro/launch/steps.py`` (the train step waits for the training slice).

The reference jits these steps; the port runs them eagerly.  Each step
returns the greedy next token ``(B, 1)`` int32 and the serve state.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device=None) -> T.LM:
    """The LM of ``cfg``; the families not ported yet raise."""
    return T.init_lm(generator, cfg, device)


def init_serve_state(cfg: ArchConfig, batch: int, max_len: int,
                     cache_dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, Any]:
    return {'cache': T.init_lm_cache(cfg, batch, max_len, cache_dtype,
                                     device)}


def build_prefill_step(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                       quant: bool = False) -> Callable:
    """(params, serve_state, batch) -> (next_token, serve_state)."""

    @torch.no_grad()
    def prefill(params, state, batch):
        logits, cache = T.lm_prefill(params, cfg, batch['tokens'],
                                     state['cache'], dtype=dtype,
                                     quant=quant)
        return logits.argmax(dim=-1).to(torch.int32), {'cache': cache}

    return prefill


def build_decode_step(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                      quant: bool = False) -> Callable:
    """(params, serve_state, token (B, 1), pos) -> (token, serve_state)."""

    @torch.no_grad()
    def decode(params, state, token, pos: int):
        logits, cache = T.lm_decode(params, cfg, token, state['cache'], pos,
                                    dtype=dtype, quant=quant)
        return logits.argmax(dim=-1).to(torch.int32), dict(state, cache=cache)

    return decode
