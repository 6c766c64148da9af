"""Gradient accumulation: port of ``repro/optim/accumulation.py``.

The global batch splits into ``accum_steps`` microbatches (rows ``i *
mb .. (i + 1) * mb - 1``, the reference's reshape); each one's gradients
are added in float32, divided by ``accum_steps``, into one sum, and the
optimizer takes one update from it.  Activation memory is that of one
microbatch, where the reference gets the same from ``lax.scan``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def build_accum_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                           accum_steps: int,
                           real_vocab: Optional[int] = None,
                           dtype: torch.dtype = torch.bfloat16) -> Callable:
    """(model, opt_state, batch) -> (model, opt_state, metrics), as
    ``launch.steps.build_train_step``; the batch's leading dimension must
    divide by ``accum_steps``, and ``loss`` is the mean of the
    microbatches' losses."""

    def train_step(model, opt_state, batch):
        B = batch['tokens'].shape[0]
        if B % accum_steps:
            raise ValueError(f'batch {B} does not split into {accum_steps} '
                             'microbatches')
        mb = B // accum_steps
        params = list(ST.train_params(model).values())
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = ST.train_loss(model, cfg, micro, dtype, real_vocab)
            for acc, g in zip(grads, torch.autograd.grad(loss, params)):
                acc.add_(g.float() / accum_steps)
            loss_sum += loss.detach() / accum_steps
        _, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state, params)
        return model, opt_state, {'loss': loss_sum, 'grad_norm': gnorm}

    return train_step
