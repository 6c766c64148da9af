"""Continuous-batching diffusion serving demo on the PyTorch port, the
counterpart of ``examples/serve_diffusion.py``.

The engine multiplexes independent generation requests, each with its
own seed, DDIM step count, guidance and precision, into masked
mixed-timestep UNet steps, so a request is admitted the moment a slot
frees instead of waiting for the whole batch::

    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    pipe = DiffusionPipeline.init(0, unet_cfg)            # on the GPU
    engine = ContinuousBatchingEngine(pipe, slots=8)
    engine.warmup(precisions=('fp32', 'w8a8'))
    engine.submit(GenerationRequest(request_id=0, seed=42, steps=50,
                                    precision='w8a8'))
    while engine.busy:
        for res in engine.tick():
            print(res.request_id, res.latency_s, res.energy_j)

This demo replays a staggered arrival trace and compares it with serving
the same requests as one batch-at-once ``generate`` call:

    PYTHONPATH=src python examples/serve_diffusion_torch.py --requests 8 \\
        --slots 4 --precision w8a8                       # on the GPU
    PYTHONPATH=src python examples/serve_diffusion_torch.py --device cpu \\
        --requests 6 --slots 3 --steps 4 --img 16

``--cache-interval k`` turns on DeepCache-phased slotting and
``--exit-tol`` early exit; ``--overlap-decode`` runs each drained
request's decode behind the next tick; ``--trace`` / ``--log-json``
write the Chrome trace and the JSONL event log.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.diffusion.pipeline import DiffusionPipeline
from repro_torch.models.unet import UNetConfig
from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--requests', type=int, default=8)
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--steps', type=int, default=6)
    ap.add_argument('--img', type=int, default=32)
    ap.add_argument('--rate', type=float, default=0.0,
                    help='arrival rate req/s (0 = auto from step time)')
    ap.add_argument('--precision', default='w8a8',
                    choices=['fp32', 'w8a8', 'w8a8+noise'],
                    help='per-request precision policy')
    ap.add_argument('--cache-interval', type=int, default=1,
                    help='DeepCache refresh cadence (1 = off): full UNet '
                         'pass every k ticks, shallow passes in between')
    ap.add_argument('--exit-tol', type=float, default=None,
                    help='early-exit tolerance on the relative x0 delta '
                         '(None/0 = off)')
    ap.add_argument('--exit-patience', type=int, default=2,
                    help='consecutive converged ticks before draining')
    ap.add_argument('--overlap-decode', action='store_true',
                    help='decode each drained request behind the next tick')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (plain PyTorch kernels)")
    ap.add_argument('--trace', default=None, metavar='PATH',
                    help='record per-request tracing and write a Chrome/'
                         'Perfetto trace_event timeline here')
    ap.add_argument('--log-json', default=None, metavar='PATH',
                    help='write the structured JSONL event log here')
    args = ap.parse_args()
    precision = args.precision

    cfg = UNetConfig('serve-demo', img_size=args.img, in_ch=3, base_ch=64,
                     ch_mults=(1, 2), n_res_blocks=1,
                     attn_resolutions=(args.img // 2,), n_heads=4,
                     timesteps=100)
    pipe = DiffusionPipeline.init(0, cfg, device=args.device)
    N, steps = args.requests, args.steps

    def sync():
        if pipe.device.type == 'cuda':
            torch.cuda.synchronize(pipe.device)

    # --- naive batch-at-once baseline: wait for all N, one generate() ----
    print('[baseline] warmup...', flush=True)
    pipe.generate(1, batch=N, steps=steps, policy=precision)
    sync()
    t0 = time.perf_counter()
    img = pipe.generate(2, batch=N, steps=steps, policy=precision)
    sync()
    t_batch = time.perf_counter() - t0
    assert torch.isfinite(img).all()

    # --- continuous batching over a staggered trace ----------------------
    # quality probe off for the throughput race; see --help of
    # repro_torch.launch.serve for the probed frontier report
    tracer = None
    if args.trace or args.log_json:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    engine = ContinuousBatchingEngine(pipe, slots=args.slots,
                                      quality_probe=0,
                                      cache_interval=args.cache_interval,
                                      exit_tol=args.exit_tol,
                                      exit_patience=args.exit_patience,
                                      overlap_decode=args.overlap_decode,
                                      tracer=tracer)
    print('[engine] warmup...', flush=True)
    engine.warmup(precisions=(precision,))
    # arrivals spread over one baseline service window: batch-at-once can
    # only start when the last request lands; the engine starts at once
    rate = args.rate or N / max(t_batch, 1e-3)
    trace = [GenerationRequest(request_id=i, seed=100 + i, steps=steps,
                               arrival_time=i / rate, precision=precision)
             for i in range(N)]
    t0 = time.perf_counter()
    results = engine.replay(trace)
    makespan = time.perf_counter() - t0
    assert len(results) == N
    for r in results:
        assert np.all(np.isfinite(r.image))

    base_makespan = trace[-1].arrival_time + t_batch
    s = engine.metrics.summary()
    dev = str(pipe.device) + (f' ({torch.cuda.get_device_name(pipe.device)})'
                              if pipe.device.type == 'cuda' else '')
    print(f'[device]   {dev}')
    print(f'[baseline] batch-at-once: last arrival '
          f'{trace[-1].arrival_time:.2f}s + {t_batch:.2f}s batch = '
          f'{base_makespan:.2f}s ({N / base_makespan:.2f} img/s)')
    print(f'[engine]   continuous:   {makespan:.2f}s '
          f'({N / makespan:.2f} img/s, '
          f'p50={s["p50_latency_ms"]:.0f}ms p95={s["p95_latency_ms"]:.0f}ms, '
          f'overlapped decodes {int(s["overlapped_decodes"])})')
    print(f'[engine]   speedup vs batch-at-once: '
          f'{base_makespan / makespan:.2f}x')
    if args.cache_interval > 1 or s['steps_saved'] > 0:
        print(f'[sched]    cache_hit_rate={s["cache_hit_rate"]:.2f} '
              f'early_exits={int(s["early_exits"])} '
              f'steps_saved={int(s["steps_saved"])}')
    src = 'simulated DiffLight' if precision != 'fp32' \
        else 'GPU digital baseline'
    print(f'[energy]   {s["energy_per_request_mj"]:.2f} mJ/request '
          f'({s["total_energy_mj"]:.1f} mJ total, {src} '
          f'@ {results[0].epb_pj:.3f} pJ/bit, precision={precision})')
    if tracer is not None:
        from repro_torch.obs import write_chrome_trace, write_jsonl
        if args.trace:
            n = write_chrome_trace(tracer, args.trace)
            print(f'[obs]      chrome trace: {n} events -> {args.trace}')
        if args.log_json:
            n = write_jsonl(tracer, args.log_json)
            print(f'[obs]      event log: {n} lines -> {args.log_json}')


if __name__ == '__main__':
    main()
