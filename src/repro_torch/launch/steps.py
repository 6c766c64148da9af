"""Train, prefill and decode step builders, port of
``repro/launch/steps.py``.

The reference jits these steps; the port runs them eagerly.  The train
step is the loss under autograd, then AdamW (``optim/adamw.py``); it
updates the model's parameters in place, where the reference's jit
donates their buffers, and launches no kernel of ``kernels/``: the loss
runs the float projections and ``gqa_core``, as the reference's, and
neither package has a backward kernel.  Given a mesh, the train step
lays the batch out over the data-parallel axes, runs the loss and its
gradient under ``implicit_replication`` (the positions, masks and RoPE
tables the forward makes are plain tensors, taken as replicated), and
reduces the loss to its full value.  Each serving step returns the
greedy next token ``(B, 1)`` int32 and the serve state.  For the
encoder-decoder family the serving steps ignore ``quant``, as the
reference's do: Whisper under ``--w8a8`` runs float and launches no W8A8
kernel.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device=None) -> nn.Module:
    """The model of ``cfg``: ``EncDec`` for the encoder-decoder family,
    else the ``LM``."""
    if cfg.family == 'encdec':
        return ED.init_encdec(generator, cfg, device)
    return T.init_lm(generator, cfg, device)


def train_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The model's float parameters by name, in registration order (the
    order of ``AdamWState``'s moments), with gradients turned on.  A
    quantized weight (``layers.QWeight``) holds buffers, not parameters,
    so it never gets a gradient."""
    params = {n: p for n, p in model.named_parameters()
              if p.is_floating_point()}
    for p in params.values():
        p.requires_grad_(True)
    return params


def train_loss(model: nn.Module, cfg: ArchConfig,
               batch: Dict[str, torch.Tensor],
               dtype: torch.dtype = torch.bfloat16,
               real_vocab: Optional[int] = None) -> torch.Tensor:
    """The training loss of one batch: ``encdec_loss`` (which reads
    ``frames``) for the encoder-decoder family, else ``lm_loss``."""
    if cfg.family == 'encdec':
        return ED.encdec_loss(model, cfg, batch['frames'], batch['tokens'],
                              batch['labels'], dtype=dtype,
                              real_vocab=real_vocab)
    return T.lm_loss(model, cfg, batch['tokens'], batch['labels'],
                     dtype=dtype, real_vocab=real_vocab)


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """The global batch, the same on every rank, as DTensors sharded over
    the mesh's data-parallel axes (``batch_pspecs``) and replicated over
    'model': each rank keeps its own rows."""
    return {k: SH.distribute(v, mesh, SH.batch_pspecs(mesh, v.shape[0],
                                                      v.dim()))
            for k, v in batch.items()}


def build_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                     real_vocab: Optional[int] = None,
                     dtype: torch.dtype = torch.bfloat16,
                     mesh=None) -> Callable:
    """(model, opt_state, batch) -> (model, opt_state, metrics): one
    AdamW step on the batch's loss, the parameters updated in place;
    ``metrics`` holds the ``loss`` and the ``grad_norm`` before clipping,
    as 0-d tensors on the model's device.  With ``mesh`` the model's
    parameters are DTensors on it, the batch is the global one, and both
    metrics are full values, the same on every rank."""

    def train_step(model, opt_state, batch):
        params = list(train_params(model).values())
        if mesh is None:
            ctx = contextlib.nullcontext()
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            ctx = implicit_replication()
            batch = shard_batch(batch, mesh)
        with SH.use_mesh(mesh), ctx:
            loss = train_loss(model, cfg, batch, dtype, real_vocab)
            grads = torch.autograd.grad(loss, params)
        _, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state, params)
        if mesh is not None:
            loss = loss.full_tensor()
        return model, opt_state, {'loss': loss.detach(), 'grad_norm': gnorm}

    return train_step


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


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The greedy next token, int32; on a mesh over each rank's rows with
    the vocabulary gathered (DTensor's argmax over a sharded vocabulary
    reads global offsets from the data, which fake tensors lack)."""
    return SH.shard_hint(logits, 'dp').argmax(dim=-1).to(torch.int32)


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
        return _greedy(logits), state

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
        return _greedy(logits), dict(state, cache=cache)

    return decode


def make_batch_struct(cfg: ArchConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    """Stand-ins for one training batch of ``shape``: tensors on the
    ``meta`` device, with the reference's shapes and dtypes (``frames``
    bfloat16 for the encoder-decoder)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {'tokens': torch.empty((B, S), dtype=torch.int32, device='meta'),
             'labels': torch.empty((B, S), dtype=torch.int32, device='meta')}
    if cfg.family == 'encdec':
        batch['frames'] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device='meta')
    return batch
