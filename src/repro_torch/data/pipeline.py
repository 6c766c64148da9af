"""Deterministic, indexable synthetic token pipeline: port of the token
half of ``repro/data/pipeline.py``.

Every batch is a pure function of (seed, step, shard), so a restarted job
resumes at any step with no pipeline state to restore.  The draws are
the reference's numpy code, unchanged, so the tokens equal the
reference's bit for bit; they come back as int32 tensors on the device
asked for.  ``image_batch`` is not ported: it resizes through
``jax.image.resize``'s bicubic kernel, and no port trainer calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def token_batch(cfg: TokenPipelineConfig, step: int,
                shard: Tuple[int, int] = (0, 1),
                device='cpu') -> Dict[str, torch.Tensor]:
    """Batch for ``step``, host-shard ``shard=(index, count)``: each
    sequence is an arithmetic token progression with 5% noise, so a
    model can learn it.  ``tokens`` and ``labels`` (shifted by one) are
    (global_batch / count, seq_len) int32 on ``device``."""
    idx, count = shard
    if cfg.global_batch % count:
        raise ValueError(f'global batch {cfg.global_batch} does not split '
                         f'into {count} shards')
    local = cfg.global_batch // count
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, idx]))
    start = rng.integers(0, cfg.vocab, (local, 1))
    stride = rng.integers(1, 7, (local, 1))
    seq = (start + stride * np.arange(cfg.seq_len + 1)) % cfg.vocab
    noise_mask = rng.random((local, cfg.seq_len + 1)) < 0.05
    noise = rng.integers(0, cfg.vocab, (local, cfg.seq_len + 1))
    seq = torch.from_numpy(np.where(noise_mask, noise, seq).astype(np.int32))
    return {'tokens': seq[:, :-1].contiguous().to(device),
            'labels': seq[:, 1:].contiguous().to(device)}


def token_stream(cfg: TokenPipelineConfig, start_step: int = 0,
                 shard: Tuple[int, int] = (0, 1),
                 device='cpu') -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield token_batch(cfg, step, shard, device)
        step += 1
