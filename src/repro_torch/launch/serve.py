"""LM serving, port of ``repro/launch/serve.py``'s LM path: ``serve_lm``
(one prefill, then greedy decode steps) and ``main``'s ``--arch`` branch.

    python -m repro_torch.launch.serve --arch internlm2-1.8b --preset full \\
        --batch 4 --prompt 1000 --tokens 32 [--w8a8]
    python -m repro_torch.launch.serve --arch internlm2-1.8b --preset smoke \\
        --device cpu

It runs on the GPU unless ``--device cpu`` is given, and raises when the
GPU it is asked for is missing.  ``--diffusion`` is not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get, smoke_config
from repro_torch.diffusion.pipeline import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models.transformer import LM

log_serve = logging.getLogger('serve')


def serve_lm(cfg: ArchConfig, batch: int, prompt_len: int, new_tokens: int,
             quant: bool = False, dtype: torch.dtype = torch.float32,
             device='cuda', params: Optional[LM] = None
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy generation for ``batch`` prompts of ``prompt_len`` token ids
    drawn by ``numpy.random.default_rng(0)``, with activations and cache
    in ``dtype``.  ``params``: the LM to serve (default: initialised from
    seed 0 on ``device``).  Returns the ``(batch, new_tokens)`` int32
    tokens and the timings ``prefill_s``, ``decode_s`` and
    ``decode_tok_s`` (host clock around work that ends in a device
    synchronise)."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = ST.init_params(gen, cfg, dev)
    state = ST.init_serve_state(cfg, batch, prompt_len + new_tokens,
                                cache_dtype=dtype, device=dev)
    prefill = ST.build_prefill_step(cfg, dtype=dtype, quant=quant)
    decode = ST.build_decode_step(cfg, dtype=dtype, quant=quant)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len)))
    tokens = tokens.to(device=dev, dtype=torch.int32)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    tok, state = prefill(params, state, {'tokens': tokens})
    sync()
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        tok, state = decode(params, state, tok, prompt_len + i)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    tps = batch * (new_tokens - 1) / max(t_decode, 1e-9)
    log_serve.info('prefill %d toks x%d: %.3fs; decode %d steps: %.3fs '
                   '(%.1f tok/s)', prompt_len, batch, t_prefill,
                   new_tokens - 1, t_decode, tps)
    return torch.cat(out, dim=1), {'prefill_s': t_prefill,
                                   'decode_s': t_decode, 'decode_tok_s': tps}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', default='internlm2-1.8b')
    ap.add_argument('--preset', default='smoke', choices=['smoke', 'full'])
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--prompt', type=int, default=16)
    ap.add_argument('--tokens', type=int, default=16)
    ap.add_argument('--w8a8', action='store_true',
                    help='quantized (W8A8) projections and MLP')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (plain PyTorch kernels)")
    ap.add_argument('--diffusion', action='store_true',
                    help='diffusion serving: not ported yet')
    args = ap.parse_args(argv)
    if args.diffusion:
        raise NotImplementedError('serve --diffusion is ROADMAP Queue 1 '
                                  'item 4; serve diffusion requests through '
                                  'repro_torch.serving.'
                                  'ContinuousBatchingEngine')
    logging.basicConfig(level=logging.INFO, format='[%(name)s] %(message)s',
                        stream=sys.stdout, force=True)
    cfg = smoke_config(args.arch) if args.preset == 'smoke' \
        else get(args.arch)
    seqs, _ = serve_lm(cfg, args.batch, args.prompt, args.tokens,
                       quant=args.w8a8, device=args.device)
    log_serve.info('sample token ids: %s', seqs[0, :12].cpu().numpy())


if __name__ == '__main__':
    main()
