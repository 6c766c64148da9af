#!/usr/bin/env python3
"""Where the device time of one serving or training step goes, for the
PyTorch/CUDA port on one GPU.

    python3 scripts/torch_profile_step.py [--slots 4] [--ticks 3]
    python3 scripts/torch_profile_step.py --features [--slots 4] [--ticks 3]
    python3 scripts/torch_profile_step.py --lm [--arch A ...] [--ticks 3]
    python3 scripts/torch_profile_step.py --train

Diffusion (the default): builds Stable Diffusion v1.4 at full width with
random weights from seed 0 (no VAE: decode is not part of a denoise
tick), fills every slot of a ``ContinuousBatchingEngine`` with requests
of one (precision, guidance) mix, and profiles ``--ticks`` steady ticks.
``--features``: the same model and slots, unguided: ``--ticks`` ticks
of ``w8a8+noise`` requests (a noisy full step each), then a DeepCache
engine (cadence 3) of w8a8 requests, one refresh tick and two skip
ticks.
``--lm``: builds each ``--arch`` in turn (default InternLM2-1.8B; the
MoE, MLA, SSM, encoder-decoder and VLM families too:
granite-moe-1b-a400m, deepseek-v2-lite-16b, mamba2-2.7b, whisper-base,
qwen2-vl-7b) at full width with random weights from seed 0, freeing the
one before, and profiles, at fp32 and w8a8, one prefill of
``serve_lm``'s traffic (batch 4, a 1000-token prompt, float32
activations and cache; for Whisper also 1000 stub frames, and fp32 only,
since its steps ignore ``quant``) and ``--ticks`` decode steps after
it.
``--train``: InternLM2-1.8B at full width and depth with random weights
from seed 0, ``build_train_step`` at float32 with remat 'full' on 4 x
1024 tokens (the traffic of ``chip_smoke.py`` phase 11): one warm step,
then one steady step profiled whole, then one split into its loss
forward, its backward (which holds the remat forward) and the AdamW
update, each ended by a synchronise, and last the blocks' forward alone
under ``no_grad``: the work the backward's remat recomputes.  For each
it prints, from ``torch.profiler``, the host wall time per step
(synchronised), the summed kernel time, the device idle share (1 -
kernel time / wall), the time per kernel family, and the heaviest
kernels.  Needs a GPU.
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
    ('w8a8_matmul (ours)', ('w8a8_matmul', 'w8a8_wgmma', 'w8a8_epilogue')),
    ('flash_attention (ours)', ('flash_attention',)),
    ('convolution', ('conv', 'implicit', 'wgrad', 'dgrad', 'winograd',
                     'fft')),
    ('matmul', ('gemm', 'cutlass', 'sm90_xmma', 'ampere', 'cublas')),
    ('sort / scan', ('sort', 'radix', 'scan')),
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


def profile_steps(torch, title: str, step, n: int) -> None:
    """Profile ``n`` calls of ``step`` and print the breakdown."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
    busy = sum(by_name.values())
    fams = collections.Counter()
    for name, ms in by_name.items():
        fams[family(name)] += ms
    print(f'\n[{title}] per step: wall {wall_ms:.3f} ms, kernels '
          f'{busy:.3f} ms, device idle '
          f'{(1 - busy / wall_ms) if busy else float("nan"):.1%}')
    if not kernels:
        print('  the profiler recorded no device activity')
        return
    for fam, ms in fams.most_common():
        print(f'  {fam:24s} {ms:9.3f} ms  {ms / busy:6.1%}')
    for name, ms in by_name.most_common(6):
        print(f'    {ms:8.3f} ms  {name[:90]}')


def profile_phases(torch, title: str, phases) -> None:
    """Run ``phases`` ((name, fn) pairs) once under the profiler, each in
    a ``record_function`` range ended by a synchronise, and print each
    one's kernel time by family; a kernel belongs to the range its start
    falls in."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in phases:
            with record_function(f'phase:{name}'):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = [(e.name[len('phase:'):], e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith('phase:')]
    fams = {name: collections.Counter() for name, _, _ in ranges}
    fams['(outside every range)'] = collections.Counter()
    for e in events:             # the ranges show on the device as well
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith('phase:'):
            continue
        where = next((n for n, lo, hi in ranges
                      if lo <= e.time_range.start <= hi),
                     '(outside every range)')
        fams[where][family(e.name)] += e.time_range.elapsed_us() / 1e3
    print(f'\n[{title}] kernel time by phase and family:')
    for name, fam in fams.items():
        total = sum(fam.values())
        if not total:
            continue
        print(f'  {name:24s} {total:9.3f} ms: ' + ', '.join(
            f'{f} {ms:.3f}' for f, ms in fam.most_common()))


def profile_train(torch, card: str) -> None:
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import TokenPipelineConfig, token_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw
    cfg = get('internlm2-1.8b')
    batch, seq = 4, 1024
    lm = ST.init_params(torch.Generator(device='cuda').manual_seed(0), cfg,
                        'cuda')
    params = list(ST.train_params(lm).values())
    oc = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    state = {'opt': init_adamw(params), 'step': 0}
    data = TokenPipelineConfig(cfg.vocab, seq, batch)
    step = ST.build_train_step(cfg, oc, dtype=torch.float32)

    def run_step():
        b = token_batch(data, state['step'], device='cuda')
        _, state['opt'], _ = step(lm, state['opt'], b)
        state['step'] += 1

    run_step()                                      # warm
    title = (f'{cfg.name} train step {batch}x{seq}, float32, remat '
             f'{cfg.remat}, {card}')
    profile_steps(torch, title, run_step, 1)
    b = token_batch(data, 9, device='cuda')

    def fwd():
        state['loss'] = ST.train_loss(lm, cfg, b, torch.float32)

    def bwd():
        state['grads'] = torch.autograd.grad(state.pop('loss'), params)

    def opt():
        _, state['opt'], _ = adamw_update(oc, state.pop('grads'),
                                          state['opt'], params)

    def blocks_forward():
        with torch.no_grad():
            T._apply_blocks(lm, cfg, L.embedding(lm.embed, b['tokens']))

    profile_phases(torch, title, [
        ('loss forward', fwd), ('backward (remat forward in it)', bwd),
        ('adamw update', opt), ('blocks forward alone', blocks_forward)])


def profile_lm(torch, card: str, arch: str, decode_steps: int) -> None:
    import numpy as np
    from repro_torch.configs.registry import get
    from repro_torch.launch import steps as ST
    cfg = get(arch)
    batch, prompt = 4, 1000
    lm = ST.init_params(torch.Generator(device='cuda').manual_seed(0), cfg,
                        'cuda')
    rng = np.random.default_rng(0)          # serve_lm's draws, in its order
    batch_in = {'tokens': torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt))).to('cuda', torch.int32)}
    if cfg.family == 'encdec':
        batch_in['frames'] = torch.from_numpy(rng.normal(
            size=(batch, prompt, cfg.d_model))).to('cuda', torch.float32)
    for quant in (False,) if cfg.family == 'encdec' else (False, True):
        tag = 'w8a8' if quant else 'fp32'
        prefill = ST.build_prefill_step(cfg, torch.float32, quant)
        decode = ST.build_decode_step(cfg, torch.float32, quant)
        state = ST.init_serve_state(cfg, batch, prompt + decode_steps + 2,
                                    torch.float32, 'cuda')
        out = {'pos': prompt}

        def run_prefill():
            out['tok'], out['state'] = prefill(lm, state, batch_in)

        def run_decode():
            out['tok'], out['state'] = decode(lm, out['state'], out['tok'],
                                              out['pos'])
            out['pos'] += 1

        run_prefill()                               # warm: kernels loaded
        profile_steps(torch, f'{cfg.name} {tag} prefill {batch}x{prompt}, '
                      f'{card}', run_prefill, 1)
        run_decode()                                # warm
        profile_steps(torch, f'{cfg.name} {tag} decode step, batch {batch},'
                      f' {card}', run_decode, decode_steps)


def profile_features(torch, pipe, ctx, card: str, args) -> None:
    """Noisy full ticks; then a DeepCache refresh tick and two skip ticks
    (w8a8, cadence 3), every slot busy and unguided."""
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest

    def filled(precision, **kw):
        engine = ContinuousBatchingEngine(pipe, slots=args.slots, context=ctx,
                                          quality_probe=0, **kw)
        for i in range(args.slots):
            engine.submit(GenerationRequest(i, seed=i, steps=args.ticks + 6,
                                            precision=precision))
        return engine

    engine = filled('w8a8+noise')
    engine.tick()                          # admission + a warm tick
    engine.tick()
    profile_steps(torch, f'w8a8+noise, guidance 0.0, {card}, {args.slots} '
                  'slots, tick', engine.tick, args.ticks)
    engine = filled('w8a8', cache_interval=3)
    for _ in range(3):                     # refresh, skip, skip (warm)
        engine.tick()
    profile_steps(torch, f'w8a8 DeepCache refresh, guidance 0.0, {card}, '
                  f'{args.slots} slots, tick', engine.tick, 1)
    profile_steps(torch, f'w8a8 DeepCache skip, guidance 0.0, {card}, '
                  f'{args.slots} slots, tick', engine.tick, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--ticks', type=int, default=3)
    ap.add_argument('--lm', action='store_true',
                    help='profile LM prefill and decode (see --arch)')
    ap.add_argument('--arch', action='append', default=None,
                    help='with --lm: the LM to profile, repeatable '
                         '(default internlm2-1.8b)')
    ap.add_argument('--features', action='store_true',
                    help='profile noisy, DeepCache refresh and skip ticks')
    ap.add_argument('--train', action='store_true',
                    help='profile a full-width InternLM2-1.8B train step')
    args = ap.parse_args()
    import torch
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
    if args.train:
        profile_train(torch, card)
        return 0
    if args.lm:
        for arch in args.arch or ['internlm2-1.8b']:
            profile_lm(torch, card, arch, args.ticks)
            torch.cuda.empty_cache()
        return 0
    pipe = DiffusionPipeline.init(0, SD_V1_4, device='cuda')
    ctx = torch.randn((args.slots, 77, SD_V1_4.context_dim),
                      generator=torch.Generator().manual_seed(1)).cuda()
    if args.features:
        profile_features(torch, pipe, ctx, card, args)
        return 0
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
            profile_steps(torch, f'{precision}, guidance {guidance}, '
                          f'{card}, {args.slots} slots, tick',
                          engine.tick, args.ticks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
