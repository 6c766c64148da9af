"""The one generator every traffic mix (``traffic/<mix>.json``) is read
by.  A mix is parameters only; the seed picks the contents, never the
amount of work: every seed gets the same sizes and the same arrival
times, and only the requests (their seeds, prompts and tokens) differ.

Keys a mix may hold, by ``arrivals``:

* ``closed``: ``clients`` callers, each sending its next request when its
  last one returns;
* ``poisson``: an open loop at ``rate`` requests/s.  The gaps are the
  exponential distribution's quantiles in one shuffled order, the same
  schedule for every seed;
* ``batches``: back-to-back batches of ``batch`` prompts whose lengths
  cycle through ``prompt_lengths``, token ids uniform over the
  vocabulary;
* ``train``: one training batch a step, ``rows`` x ``seq_len`` tokens.

Image requests carry ``steps``, ``guidance`` and ``cache_interval`` from
the mix and a seed of their own drawn from the run's seed.  A mix's
``precision`` is one name (``fp32``, ``w8a8``, ``w8a8+noise``), which
every request carries, or a ``{name: weight}`` map, from which each
request's is drawn (``precision``).
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def image_requests(mix: dict, seed: int, seconds: float) -> Iterator[Dict]:
    """Requests in sending order: ``{'id', 'seed'}`` and, in an open loop,
    ``'due'`` (seconds after the window of ``seconds`` opens).  Endless
    for a closed loop."""
    rng = _rng(seed, 1)
    if mix['arrivals'] == 'poisson':
        dues = poisson_dues(mix, seconds)
    k = 0
    while mix['arrivals'] == 'closed' or k < len(dues):
        req = {'id': k, 'seed': int(rng.integers(0, 2 ** 31 - 1))}
        if mix['arrivals'] == 'poisson':
            req['due'] = float(dues[k])
        yield req
        k += 1


def precisions(mix: dict) -> List[str]:
    """The precisions a mix's requests carry, sorted."""
    p = mix['precision']
    return [p] if isinstance(p, str) else sorted(p)


def precision(mix: dict, seed: int, rid: int) -> str:
    """Request ``rid``'s precision: the mix's one name, or a draw from
    its ``{name: weight}`` map on a stream of the seed and the request's
    own, so that the same seed gives every request the same one."""
    p = mix['precision']
    if isinstance(p, str):
        return p
    names = sorted(p)
    w = np.array([float(p[n]) for n in names])
    return names[int(_rng(seed, 8, rid).choice(len(names), p=w / w.sum()))]


def poisson_dues(mix: dict, seconds: float) -> np.ndarray:
    """Due times of an open loop at ``mix['rate']`` over a window of
    ``seconds``: ``n = floor(rate * seconds)`` gaps, the exponential
    distribution's quantiles at ``(i + 0.5) / n`` scaled to sum to
    ``(n - 0.5) / rate``, in one shuffled order.  The schedule is the same
    for every seed, which picks only the requests sent at its times."""
    rate = float(mix['rate'])
    n = int(rate * seconds)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= ((n - 0.5) / rate) / gaps.sum()
    return np.cumsum(_rng(0, 2).permutation(gaps))


def prompts(mix: dict, seed: int, b: int, vocab: int) -> torch.Tensor:
    """Batch ``b``'s prompts: (batch, length) int32 ids."""
    lengths: List[int] = mix['prompt_lengths']
    n = lengths[b % len(lengths)]
    ids = _rng(seed, 3, b).integers(0, vocab, (mix['batch'], n))
    return torch.from_numpy(ids.astype(np.int32))


def train_batch(mix: dict, seed: int, step: int, vocab: int):
    """Step ``step``'s tokens and labels (rows, seq_len) int32: ids uniform
    over the vocabulary, the labels the tokens shifted by one."""
    seq = _rng(seed, 4, step).integers(0, vocab,
                                       (mix['rows'], mix['seq_len'] + 1))
    seq = torch.from_numpy(seq.astype(np.int32))
    return {'tokens': seq[:, :-1].contiguous(), 'labels': seq[:, 1:].contiguous()}
