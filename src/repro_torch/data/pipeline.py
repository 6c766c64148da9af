"""Deterministic, indexable synthetic data pipelines, port of
``repro/data/pipeline.py``.

Every batch is a pure function of (seed, step, shard), so a restarted job
resumes at any step with no pipeline state to restore.  The draws are
the reference's numpy code, unchanged, so the tokens and the image
batches' low-resolution fields equal the reference's bit for bit; they
come back as tensors on the device asked for.  ``image_batch`` resizes
its fields with ``jax.image.resize``'s bicubic rule (``resize_weights``),
not ``F.interpolate``'s.
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


@dataclasses.dataclass(frozen=True)
class ImagePipelineConfig:
    img_size: int
    channels: int
    global_batch: int
    seed: int = 0


def image_low(cfg: ImagePipelineConfig, step: int,
              shard: Tuple[int, int] = (0, 1)) -> np.ndarray:
    """The 4 x 4 normal field behind ``image_batch`` (local, 4, 4,
    channels) float32, the reference's draw."""
    idx, count = shard
    local = cfg.global_batch // count
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, idx, 7]))
    return rng.normal(size=(local, 4, 4, cfg.channels)).astype(np.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 on |distance| ``x``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int, device='cpu') -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis of ``jax.image.resize(...,
    'bicubic')`` with its default ``antialias=True``
    (``jax/_src/image/scale.py::compute_weight_mat``): sample positions at
    half-pixel centres, Keys' cubic (a = -0.5) on the distance (stretched
    by the inverse scale when downsampling), each output's weights
    divided by their sum (0 where the sum is below 1000 float32 eps), and
    0 for a sample outside the input."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=f32)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() \
        / torch.clamp_min(inv_scale, 1.0)
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def image_batch(cfg: ImagePipelineConfig, step: int,
                shard: Tuple[int, int] = (0, 1),
                device='cpu') -> torch.Tensor:
    """Synthetic image batch in [-1, 1] for ``step``, host-shard
    ``shard=(index, count)``: smooth random fields (so a DDPM can fit
    structure), the 4 x 4 normal field of ``image_low`` resized bicubic
    to ``img_size`` on ``device`` (one weight matrix per axis, two
    einsums), then ``tanh``.  (local, img_size, img_size, channels)
    float32."""
    low = torch.from_numpy(image_low(cfg, step, shard)).to(device)
    w = resize_weights(4, cfg.img_size, device=device)
    img = torch.einsum('nhwc,hH,wW->nHWc', low, w, w)
    return torch.tanh(img)
