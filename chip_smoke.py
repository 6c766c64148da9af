#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: require CUDA, turn TF32 off for matmuls and cuDNN, print the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile both CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` each, in parallel) and print the seconds and ptxas's report;
3. kernels: find every shape the Stable Diffusion v1.4 UNet hands each
   kernel at batch = the engine's slot count (one w8a8 forward with and
   one without context), then at each shape hold the kernel against its
   plain PyTorch version (w8a8 exactly; GroupNorm+swish within
   ``GN_ATOL``) and time kernel, plain version and PyTorch yardstick
   (``time_ms``), beside the card's bound for the same work;
4. small width: serve a guided fp32, an unguided fp32 and a w8a8 request
   of a tiny SD-shaped model through the engine on the card and on the
   CPU from the same seeds, and compare the images;
5. full width: serve 8 requests (fp32 and w8a8, guided at 7.5 and not,
   10 DDIM steps) of SD v1.4 + the 512x512 VAE with random weights from
   seed 0 through the engine on 4 slots, check every image, and check
   with the kernels' launch counters that the main path ran through both
   kernels, as many times as its UNet evaluations require.

Before the last line it prints one JSON object ``{"kernels": [...]}``;
per kernel, ``ms`` / ``plain_ms`` / ``library_ms`` / ``bound_ms`` are the
times of one UNet evaluation's worth of that kernel's calls at batch 4
(the per-shape median times of phase 3, weighted by launches per
evaluation) and ``launches`` is the count from phase 5.  The last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the run
then exits non-zero with no result; so does a run without CUDA or without
the repository beside this file.
"""
from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SLOTS = 4
STEPS = 10
GUIDANCE = 7.5
# GroupNorm+swish: kernel and plain version sum the slab in different
# orders; the mean and rstd then differ in the last float32 bits, which
# moves outputs of order 1-10 by a few 1e-6.
GN_ATOL = 1e-5
# card vs CPU: cuDNN and the CPU sum convolutions in different orders
# (float32 rounding, ~1e-6 per evaluation, carried over the steps); under
# w8a8 such a difference can move one int8 rounding at a tie, worth about
# one LSB of an activation
FP32_ATOL = 1e-4
W8A8_ATOL = 1e-3

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12              # float32 outside the tensor cores
TPU_KERNELS = {
    'fused_gn_swish': ('src/repro_torch/csrc/fused_gn_swish.cu',
                       'src/repro/kernels/fused_gn_swish.py:31'),
    'w8a8_matmul': ('src/repro_torch/csrc/w8a8_matmul.cu',
                    'src/repro/kernels/w8a8_matmul.py:52'),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, reps: int = 20, calls: int = 10) -> float:
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs, after a
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def record_shapes(ops, fn):
    """Run ``fn`` with the kernel wrappers recording the shapes they are
    called with; returns {kernel: Counter(shape key)}."""
    seen = {'fused_gn_swish': collections.Counter(),
            'w8a8_matmul': collections.Counter()}
    gn, mm = ops.fused_gn_swish, ops.w8a8_matmul

    def gn_rec(x, scale, bias, *, groups=32):
        C = x.shape[-1]
        g = min(groups, C)
        while C % g:
            g -= 1
        seen['fused_gn_swish'][tuple(x.shape) + (g,)] += 1
        return gn(x, scale, bias, groups=groups)

    def mm_rec(x, w):
        seen['w8a8_matmul'][(x.numel() // x.shape[-1], x.shape[-1],
                             w.shape[-1])] += 1
        return mm(x, w)

    ops.fused_gn_swish, ops.w8a8_matmul = gn_rec, mm_rec
    try:
        fn()
    finally:
        ops.fused_gn_swish, ops.w8a8_matmul = gn, mm
    return seen


def phase_kernels(torch, ops, pipe, context):
    """Phase 3: every path shape, kernel vs plain, with times."""
    import torch.nn.functional as F
    from repro_torch.core.quantization import quantize, quantize_per_channel
    from repro_torch.kernels import fused_gn_swish as gnk
    from repro_torch.kernels import w8a8_matmul as mmk
    cfg = pipe.unet_cfg
    x = torch.randn((SLOTS, cfg.img_size, cfg.img_size, cfg.in_ch),
                    device='cuda')
    t = torch.full((SLOTS,), 500, device='cuda')
    with torch.no_grad():
        cond = record_shapes(ops, lambda: pipe.unet(x, t, context, 'w8a8'))
        unc = record_shapes(ops, lambda: pipe.unet(x, t, None, 'w8a8'))
    per_eval = {k: sum(v.values()) for k, v in cond.items()}
    per_eval['w8a8_matmul_uncond'] = sum(unc['w8a8_matmul'].values())
    print(f'[kernels] launches per UNet evaluation: {per_eval}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    summary = {}
    for name in ('fused_gn_swish', 'w8a8_matmul'):
        tot = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': 0.0}
        errs, bound_by = [], set()
        for shape, count in sorted(cond[name].items()):
            if name == 'fused_gn_swish':
                N, H, W, C, g = shape
                xg = torch.randn((N, H, W, C), device='cuda', generator=gen)
                sc = torch.randn(C, device='cuda', generator=gen)
                bi = torch.randn(C, device='cuda', generator=gen)
                out = gnk.fused_gn_swish_kernel(xg, sc, bi, g)
                ref = gnk.gn_swish_plain(xg, sc, bi, g)
                err = (out - ref).abs().max().item()
                check(err <= GN_ATOL, f'fused_gn_swish {shape}: max abs err '
                      f'{err} > {GN_ATOL}')
                xc = xg.permute(0, 3, 1, 2)
                row = {
                    'ms': time_ms(torch, lambda: gnk.fused_gn_swish_kernel(
                        xg, sc, bi, g)),
                    'plain_ms': time_ms(torch, lambda: gnk.gn_swish_plain(
                        xg, sc, bi, g)),
                    'library_ms': time_ms(torch, lambda: F.silu(
                        F.group_norm(xc, g, sc, bi, 1e-5))),
                }
                nbytes = 2 * N * H * W * C * 4 + 2 * C * 4
                b_bytes = nbytes / HBM_BYTES_PER_S
                # ~10 float operations per element: two sums, normalise,
                # affine, exp, add, divide
                b_ops = 10 * N * H * W * C / F32_OPS_PER_S
            else:
                M, K, Nn = shape
                xm = torch.randn((M, K), device='cuda', generator=gen)
                wm = torch.randn((K, Nn), device='cuda', generator=gen)
                xq, wq = quantize(xm, axis=(1,)), quantize_per_channel(wm)
                ws = wq.scale.reshape(1, Nn).contiguous()
                out = mmk.w8a8_matmul_kernel(xq.q, xq.scale, wq.q, ws)
                ref = mmk.w8a8_matmul_plain(xq.q, xq.scale, wq.q, ws)
                err = (out - ref).abs().max().item()
                check(torch.equal(out, ref), f'w8a8_matmul {shape}: not '
                      f'bit-exact, max abs err {err}')
                row = {
                    'ms': time_ms(torch, lambda: mmk.w8a8_matmul_kernel(
                        xq.q, xq.scale, wq.q, ws)),
                    'plain_ms': time_ms(torch, lambda: mmk.w8a8_matmul_plain(
                        xq.q, xq.scale, wq.q, ws)),
                }
                try:       # yardstick only: the port never calls it
                    row['library_ms'] = time_ms(
                        torch, lambda: torch._int_mm(xq.q, wq.q))
                except RuntimeError as e:
                    print(f'[kernels] torch._int_mm {shape}: {e}')
                    row['library_ms'] = None
                nbytes = M * K + K * Nn + 4 * M + 4 * Nn + 4 * M * Nn
                b_bytes = nbytes / HBM_BYTES_PER_S
                b_ops = 2 * M * Nn * K / INT8_OPS_PER_S
            row['bound_ms'] = max(b_bytes, b_ops) * 1e3
            row['bound_by'] = 'bytes' if b_bytes >= b_ops else 'operations'
            bound_by.add(row['bound_by'])
            errs.append(err)
            print('[kernels] shape ' + json.dumps(
                {'kernel': name, 'shape': list(shape), 'per_eval': count,
                 'max_abs_err': err, 'kernel_ms': row['ms'],
                 'plain_ms': row['plain_ms'], 'library_ms': row['library_ms'],
                 'bound_ms': row['bound_ms'], 'bound_by': row['bound_by']}))
            for k in tot:
                if tot[k] is None or row[k] is None:
                    tot[k] = None
                else:
                    tot[k] += count * row[k]
        summary[name] = dict(tot, max_abs_err=max(errs),
                             bound_by='bytes' if bound_by == {'bytes'}
                             else 'operations')
        print(f'[kernels] {name}: per UNet evaluation at batch {SLOTS}: '
              + json.dumps(summary[name]))
    return summary, per_eval


def serve(engine, reqs):
    """Submit every request at once and drive the engine to idle."""
    for r in reqs:
        check(engine.submit(r), f'request {r.request_id} rejected')
    return {r.request_id: r for r in engine.run_until_idle()}


def phase_small(torch, numpy):
    """Phase 4: the same tiny requests on the card and on the CPU."""
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.models.autoencoder import VAEConfig
    from repro_torch.models.unet import UNetConfig
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    cfg = UNetConfig('tiny-sd', img_size=8, in_ch=4, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(4,),
                     n_heads=4, context_dim=16, timesteps=16, latent=True)
    vae = VAEConfig(img_size=16, in_ch=3, z_ch=4, base_ch=16,
                    ch_mults=(1, 2), groups=8)
    cpu = DiffusionPipeline.init(1, cfg, vae, device='cpu')
    ctx = torch.randn((1, 5, 16), generator=torch.Generator().manual_seed(2))
    ctx = ctx.repeat(3, 1, 1)
    reqs = [GenerationRequest(0, seed=10, steps=4, guidance=GUIDANCE),
            GenerationRequest(1, seed=11, steps=4),
            GenerationRequest(2, seed=12, steps=4, precision='w8a8')]
    out = {}
    for dev, pipe in (('cuda', cpu.to('cuda')), ('cpu', cpu)):
        out[dev] = serve(ContinuousBatchingEngine(pipe, slots=3, context=ctx,
                                                  quality_probe=0), reqs)
    for r in reqs:
        a, b = out['cuda'][r.request_id].image, out['cpu'][r.request_id].image
        check(a.shape == (16, 16, 3) and numpy.isfinite(a).all(),
              f'small request {r.request_id}: bad image {a.shape}')
        err = float(numpy.abs(a - b).max())
        tol = W8A8_ATOL if r.precision == 'w8a8' else FP32_ATOL
        print(f'[small] request {r.request_id} {r.precision} guidance '
              f'{r.guidance}: card vs CPU max abs err {err:.3e} (tol {tol})')
        check(err <= tol, f'small request {r.request_id}: card vs CPU '
              f'{err} > {tol}')


def phase_full(torch, numpy, ops, pipe, context, per_eval, card):
    """Phase 5: 8 full-width requests through the engine."""
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    engine = ContinuousBatchingEngine(pipe, slots=SLOTS, context=context,
                                      quality_probe=1)
    warm = engine.warmup(precisions=('fp32', 'w8a8'))
    print(f'[full] warmup {warm:.2f} s (kernels loaded, every step variant '
          'run once)')
    mix = [('fp32', GUIDANCE), ('w8a8', 0.0), ('fp32', 0.0),
           ('w8a8', GUIDANCE), ('w8a8', GUIDANCE), ('fp32', 0.0),
           ('w8a8', 0.0), ('fp32', GUIDANCE)]
    reqs = [GenerationRequest(i, seed=100 + i, steps=STEPS, guidance=g,
                              precision=p) for i, (p, g) in enumerate(mix)]
    evals = collections.Counter()

    def count_eval(module, args, kwargs):
        x, t, ctx, pol = (list(args) + [None, None])[:4]
        evals[(str(getattr(pol, 'name', pol)), ctx is None)] += 1

    hook = pipe.unet.register_forward_pre_hook(count_eval, with_kwargs=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                  # the main path's run starts here
    t0 = time.perf_counter()
    try:
        results = serve(engine, reqs)
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()        # ... and ends here
    check(sorted(results) == list(range(len(reqs))),
          f'completed {sorted(results)} of {len(reqs)} requests')
    for r in reqs:
        img = results[r.request_id].image
        check(img.shape == (512, 512, 3) and numpy.isfinite(img).all(),
              f'request {r.request_id}: image {img.shape} not a finite '
              '512x512x3')
    n_evals = sum(evals.values())
    want_gn = per_eval['fused_gn_swish'] * n_evals
    want_mm = (per_eval['w8a8_matmul'] * evals[('w8a8', False)]
               + per_eval['w8a8_matmul_uncond'] * evals[('w8a8', True)])
    print(f'[full] UNet evaluations by (policy, unconditional): '
          f'{dict(evals)}; kernel launches {launches}, expected '
          f'fused_gn_swish {want_gn}, w8a8_matmul {want_mm}')
    check(launches['fused_gn_swish'] == want_gn > 0,
          'fused_gn_swish launches do not match the UNet evaluations')
    check(launches['w8a8_matmul'] == want_mm > 0,
          'w8a8_matmul launches do not match the w8a8 UNet evaluations')
    snap = engine.metrics.snapshot()
    psnr = {r.request_id: results[r.request_id].quality_psnr_db
            for r in reqs if r.precision == 'w8a8'}
    check(all(p is not None and p > 0 for p in psnr.values()),
          f'w8a8 quality probe missing: {psnr}')
    print(f'[full] {card}: {len(reqs)} requests SD v1.4 + VAE 512 at '
          f'{STEPS} steps on {SLOTS} slots: wall {wall:.3f} s, '
          f'{snap.requests_per_s:.4f} req/s, p50 latency '
          f'{snap.p50_latency_s:.3f} s, p95 {snap.p95_latency_s:.3f} s, '
          f'{snap.ticks} ticks, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    print(f'[full] {card}: w8a8 PSNR vs fp32 probe (dB): '
          + ', '.join(f'req {k}: {v:.2f}' for k, v in psnr.items()))
    return launches


def main() -> int:
    import numpy
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    if not (ROOT / 'src' / 'repro_torch' / 'csrc').is_dir():
        print(f'chip_smoke: no src/repro_torch beside {__file__}',
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / 'src'))
    from repro_torch.configs.diffusion import SD_V1_4, VAE_512
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.kernels import build, ops

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'[device] torch {torch.__version__} CUDA {torch.version.cuda}; '
          f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    card = smi.splitlines()[0]

    # phase 2: build
    t0 = time.perf_counter()
    build.build(TPU_KERNELS)
    print(f'[build] both kernels built in {time.perf_counter() - t0:.2f} s')
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}')

    # the full-width model, shared by phases 3 and 5
    t0 = time.perf_counter()
    pipe = DiffusionPipeline.init(0, SD_V1_4, VAE_512, device='cuda')
    ctx_gen = torch.Generator().manual_seed(1)
    context = torch.randn((SLOTS, 77, SD_V1_4.context_dim),
                          generator=ctx_gen).cuda()
    print(f'[full] SD v1.4 UNet '
          f'{sum(p.numel() for p in pipe.unet.parameters()):,} parameters + '
          f'VAE decoder built from seed 0 in {time.perf_counter() - t0:.1f} s')

    # phase 3: kernels at the path's shapes
    summary, per_eval = phase_kernels(torch, ops, pipe, context)
    check(per_eval['fused_gn_swish'] == 45 and per_eval['w8a8_matmul'] == 128,
          f'SD v1.4 launches per evaluation {per_eval}, expected 45 / 128')

    # phase 4: small width, card vs CPU
    phase_small(torch, numpy)

    # phase 5: full width through the engine
    launches = phase_full(torch, numpy, ops, pipe, context, per_eval, card)

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        s = summary[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches[name],
            'max_abs_err': s['max_abs_err'], 'ms': s['ms'],
            'plain_ms': s['plain_ms'], 'bound_ms': s['bound_ms'],
            'bound_by': s['bound_by'], 'library_ms': s['library_ms']})
    check(all(math.isfinite(k['ms']) for k in kernels), 'bad kernel times')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
