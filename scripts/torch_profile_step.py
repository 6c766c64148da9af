#!/usr/bin/env python3
"""Where the device time of one serving tick goes, for the PyTorch/CUDA
port on one GPU.

    python3 scripts/torch_profile_step.py [--slots 4] [--ticks 3]

Builds Stable Diffusion v1.4 at full width with random weights from seed
0 (no VAE: decode is not part of a denoise tick), fills every slot of a
``ContinuousBatchingEngine`` with requests of one (precision, guidance)
mix, and profiles ``--ticks`` steady ticks with ``torch.profiler``.  For
each mix it prints the host wall time per tick (synchronised), the
summed kernel time, the device idle share (1 - kernel time / wall), the
time per kernel family, and the heaviest kernels.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FAMILIES = (                       # first match wins, on the kernel name
    ('fused_gn_swish (ours)', ('fused_gn_swish',)),
    ('w8a8_matmul (ours)', ('w8a8_matmul',)),
    ('convolution', ('conv', 'implicit', 'wgrad', 'dgrad', 'winograd',
                     'fft')),
    ('matmul', ('gemm', 'cutlass', 'sm90_xmma', 'ampere', 'cublas')),
    ('reduction', ('reduce', 'norm')),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled', 'copy',
                     'fill', 'where', 'index', 'cat')),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return 'other'


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--ticks', type=int, default=3)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print('torch_profile_step: needs a CUDA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / 'src'))
    from repro_torch.configs.diffusion import SD_V1_4
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    pipe = DiffusionPipeline.init(0, SD_V1_4, device='cuda')
    ctx = torch.randn((args.slots, 77, SD_V1_4.context_dim),
                      generator=torch.Generator().manual_seed(1)).cuda()
    for precision in ('fp32', 'w8a8'):
        for guidance in (0.0, 7.5):
            engine = ContinuousBatchingEngine(pipe, slots=args.slots,
                                              context=ctx, quality_probe=0)
            for i in range(args.slots):
                engine.submit(GenerationRequest(
                    i, seed=i, steps=args.ticks + 3, guidance=guidance,
                    precision=precision))
            engine.tick()                      # admission + a warm tick
            engine.tick()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.ticks):
                    engine.tick()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / args.ticks
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            by_name = collections.Counter()
            for e in kernels:
                by_name[e.name] += e.time_range.elapsed_us() / 1e3 / args.ticks
            busy = sum(by_name.values())
            fams = collections.Counter()
            for name, ms in by_name.items():
                fams[family(name)] += ms
            print(f'\n[{precision}, guidance {guidance}] {card}: '
                  f'{args.slots} slots, per tick: wall {wall_ms:.3f} ms, '
                  f'kernels {busy:.3f} ms, device idle '
                  f'{(1 - busy / wall_ms) if busy else float("nan"):.1%}')
            if not kernels:
                print('  the profiler recorded no device activity')
                continue
            for fam, ms in fams.most_common():
                print(f'  {fam:24s} {ms:9.3f} ms  {ms / busy:6.1%}')
            for name, ms in by_name.most_common(6):
                print(f'    {ms:8.3f} ms  {name[:90]}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
