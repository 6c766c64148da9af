#!/usr/bin/env python3
"""How far an LM's cache path drifts from its plain forward, by depth, on
one GPU.

    python3 scripts/torch_lm_gap.py

For DeepSeek-V2-Lite at 1, 3, 9 and 27 layers, and Granite-MoE and
Mamba2 at full depth, it builds the LM at full width with random weights
from seed 0 on the card, and for each depth (the first ``depth`` scanned
units) runs ``serve_lm``'s prompt (batch 4, 1000 tokens from
``numpy.random.default_rng(0)``, float32) through ``lm_prefill`` into a
cache and through ``lm_apply``, at fp32 and at w8a8.  It prints the gap
between the two paths' last-token logits (max abs, as a share of the
largest logit, and relative L2) at each precision, beside the distance
of ``lm_apply``'s w8a8 logits from its fp32 ones: the quantization noise
that a w8a8 gap grows to and not beyond (``chip_smoke.py`` holds phase
9's w8a8 check to that distance).  Needs a GPU.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUNS = [('deepseek-v2-lite-16b', (1, 3, 9, 27)),
        ('granite-moe-1b-a400m', (24,)),
        ('mamba2-2.7b', (64,))]


def gap(a, b) -> str:
    d = a - b
    return (f'max {d.abs().max().item():.3e} '
            f'({100 * d.abs().max().item() / b.abs().max().item():.2f}% of '
            f'max |logit| {b.abs().max().item():.3f}), relative L2 '
            f'{(d.norm() / b.norm()).item():.3e}')


def sweep(torch, np, arch: str, depths) -> None:
    import torch.nn as nn
    from repro_torch.configs.registry import get
    from repro_torch.launch.steps import init_params
    from repro_torch.models import transformer as T
    cfg0 = get(arch)
    lm = init_params(torch.Generator(device='cuda').manual_seed(0), cfg0,
                     'cuda')
    units = list(lm.blocks)
    per_unit = cfg0.n_layers // len(units)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg0.vocab, (4, 1000))).to('cuda', torch.int32)
    for depth in depths:
        cfg = cfg0.scaled(n_layers=depth * per_unit)
        lm.blocks = nn.ModuleList(units[:depth])
        logits = {}
        with torch.no_grad():
            for quant in (False, True):
                cache = T.init_lm_cache(cfg, 4, 1001, torch.float32, 'cuda')
                last, _ = T.lm_prefill(lm, cfg, tokens, cache,
                                       dtype=torch.float32, quant=quant)
                del cache
                full = T.lm_apply(lm, cfg, tokens, quant=quant)[:, -1]
                logits[quant] = (last[:, 0].clone(), full.clone())
                del last, full
                torch.cuda.empty_cache()
        for quant in (False, True):
            print(f'[gap] {arch} {depth} units {"w8a8" if quant else "fp32"}'
                  f': prefill vs lm_apply {gap(*logits[quant])}')
        print(f'[gap] {arch} {depth} units: lm_apply w8a8 vs fp32 '
              f'{gap(logits[True][1], logits[False][1])}', flush=True)
    del lm, units
    torch.cuda.empty_cache()


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('torch_lm_gap: needs a CUDA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / 'src'))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    for arch, depths in RUNS:
        sweep(torch, np, arch, depths)
    return 0


if __name__ == '__main__':
    sys.exit(main())
