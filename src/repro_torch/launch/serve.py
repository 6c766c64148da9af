"""Serving loop, port of ``repro/launch/serve.py``: batched LM decode
(``serve_lm``: one prefill, then greedy decode steps) or continuous-
batching diffusion generation (``serve_diffusion``).

    python -m repro_torch.launch.serve --arch internlm2-1.8b --preset full \\
        --batch 4 --prompt 1000 --tokens 32 [--w8a8]
    python -m repro_torch.launch.serve --arch whisper-base --preset smoke \\
        --device cpu
    python -m repro_torch.launch.serve --diffusion --model sd-v1.4 \\
        --requests 8 --rate 4 --slots 4 --steps 10 --precision w8a8 \\
        [--overlap-decode on] [--overload 5] [--trace t.json --prom t.prom]
    python -m repro_torch.launch.serve --diffusion --device cpu \\
        --requests 6 --rate 8 --slots 3 --steps 4 --img 16
    python -m repro_torch.launch.serve --diffusion --device cpu \\
        --devices 8 --slots-per-device 1 --requests 16 --rate 8 \\
        --steps 6 --resize-to 4 --resize-after 4

It runs on the GPU unless ``--device cpu`` is given, and raises when the
GPU it is asked for is missing.

The diffusion mode replays a Poisson arrival trace (``--rate`` req/s)
through ``ContinuousBatchingEngine.replay`` and reports req/s, p50/p95/
p99 latency, SLO violations, sheds, the energy per request and the
per-policy accuracy-vs-EPB frontier, with the reference's flags and
``[tag]`` lines (each tag a logger name; ``--log-level`` sets them).
``--model toy`` (the default) is the reference CLI's 16-px UNet
(``--img`` sizes it); ``--model sd-v1.4`` is ``SD_V1_4`` + ``VAE_512``
with one random ``(77, 768)`` context, shared by every slot, standing
in for the text encoder the repository does not have.  ``--overload X`` measures the
engine's capacity (``measure_tick_s``), offers X times it with a bounded
queue (``--queue-depth``, default 2x slots) under deadline-aware
shedding, and checks that completed + shed == offered.
``--overlap-decode on`` runs each drained request's VAE decode on a
second CUDA stream behind the next tick.  ``--trace`` / ``--log-json``
write the Chrome trace and the JSONL event log after reconciling the
trace with the metrics; ``--prom`` writes the Prometheus exposition;
``--report-every S`` prints a snapshot line every S seconds.

Sharded serving: ``--devices N`` shards the engine's slot axis over a
1-D mesh of the first N cards (with ``--device cpu``, N logical CPU
shards), ``--slots-per-device`` fixes the per-device budget, and decode
overlap defaults on; it logs the ``[mesh]`` layout, warns on
``[mesh]`` when the step monitor flags a straggler, and ends with a
``[mesh] stragglers:`` line.  ``--resize-to M`` resizes the mesh to M
devices mid-replay after ``--resize-after K`` completions (default half
the requests), keeping the results the resize flushes, and logs the
``[elastic]`` lines; parked requests re-enter and complete.

Cold start: ``--cache-dir PATH`` keeps the kernel libraries that
``nvcc`` builds in a persistent directory (``serving/compile_cache.py``),
so a restarted server loads them instead of building them; the
``[coldstart]`` line gives the warmup's seconds and whether the cache
was warm (``warm (loaded from cache)``) or cold (``cold (persisted N
executables)``, N the libraries in the directory).  ``--cache-max-mb``
bounds the directory, evicting the least recently used libraries.
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
from repro_torch.configs.diffusion import SD_V1_4, VAE_512
from repro_torch.configs.registry import get, smoke_config
from repro_torch.diffusion.pipeline import DiffusionPipeline, resolve_device
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import serving_mesh
from repro_torch.models.unet import UNetConfig
from repro_torch.obs import (SnapshotReporter, Tracer, render_exposition,
                             write_chrome_trace, write_jsonl)
from repro_torch.serving import (AdmissionQueue, ContinuousBatchingEngine,
                                 GenerationRequest, cache_entries,
                                 enable_persistent_cache, overload_factor)

log_serve = logging.getLogger('serve')
log_coldstart = logging.getLogger('coldstart')
log_overload = logging.getLogger('overload')
log_sched = logging.getLogger('sched')
log_energy = logging.getLogger('energy')
log_frontier = logging.getLogger('frontier')
log_obs = logging.getLogger('obs')
log_mesh = logging.getLogger('mesh')
log_elastic = logging.getLogger('elastic')

def setup_logging(level: str = 'info', stream=None) -> None:
    """Leveled stdout logging with the ``[tag]`` prefixes: each part logs
    through its own logger (``serve``, ``overload``, ...), and the
    formatter renders the logger's name as the line's prefix."""
    logging.basicConfig(
        level=getattr(logging, level.upper()),
        format='[%(name)s] %(message)s',
        stream=stream if stream is not None else sys.stdout,
        force=True)


def serve_lm(cfg: ArchConfig, batch: int, prompt_len: int, new_tokens: int,
             quant: bool = False, dtype: torch.dtype = torch.float32,
             device='cuda', params: Optional[torch.nn.Module] = None
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy generation for ``batch`` prompts of ``prompt_len`` token ids
    drawn by ``numpy.random.default_rng(0)``, with activations and cache
    in ``dtype``.  The encoder-decoder family also encodes ``prompt_len``
    stub frames (B, prompt_len, d_model), standard normals drawn from the
    same generator after the tokens, as the reference does (the published
    Whisper takes 1500 frames; the stub ties their count to the prompt).
    ``params``: the model to serve (default: initialised from seed 0 on
    ``device``).  Returns the ``(batch, new_tokens)`` int32
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
    batch_in = {'tokens': tokens.to(device=dev, dtype=torch.int32)}
    if cfg.family == 'encdec':
        frames = rng.normal(size=(batch, prompt_len, cfg.d_model))
        batch_in['frames'] = torch.from_numpy(frames).to(dev, dtype)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    tok, state = prefill(params, state, batch_in)
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


def poisson_trace(n: int, rate_hz: float, steps: int, seed: int = 0,
                  slo_ms=None, precision: str = 'fp32'):
    """Poisson arrival trace: n requests, exponential inter-arrivals
    (numpy's, so the arrivals are the reference's; an infinite rate puts
    every arrival at 0)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, n))
    return [GenerationRequest(request_id=i, seed=1000 + i, steps=steps,
                              arrival_time=float(a), slo_ms=slo_ms,
                              precision=precision)
            for i, a in enumerate(arrivals)]


def _diffusion_pipe(model: str, img: Optional[int], device):
    """The served pipeline, from seed 0: the reference CLI's toy UNet at
    ``img`` px (default 16), or SD v1.4 with the 512-px VAE decoder."""
    if model == 'sd-v1.4':
        if img not in (None, VAE_512.img_size):
            raise ValueError(f'sd-v1.4 serves {VAE_512.img_size}-px images; '
                             '--img sizes the toy model')
        return DiffusionPipeline.init(0, SD_V1_4, VAE_512, device=device)
    if model != 'toy':
        raise ValueError(f'unknown model {model!r}')
    img = 16 if img is None else img
    cfg = UNetConfig('serve-diffusion', img_size=img, in_ch=3, base_ch=64,
                     ch_mults=(1, 2), n_res_blocks=1,
                     attn_resolutions=(img // 2,), n_heads=4, timesteps=100)
    return DiffusionPipeline.init(0, cfg, device=device)


def serve_diffusion(img: Optional[int], steps: int, n_requests: int,
                    rate_hz: float, slots: int, precision: str = 'fp32',
                    seed: int = 0, slo_ms=None, quality_probe: int = 1,
                    cache_interval: int = 1, exit_tol=None,
                    exit_patience: int = 2, queue_depth=None,
                    shed_policy: str = 'reject-newest',
                    overload: float = 0.0, devices=None,
                    slots_per_device=None, overlap_decode=None,
                    resize_to=None, resize_after=None,
                    trace_path=None, log_json_path=None, prom_path=None,
                    report_every=None, cache_dir=None, cache_max_mb=None,
                    model: str = 'toy', device='cuda', pipe=None):
    """Replay a Poisson arrival trace through the continuous-batching
    engine and log the serving and energy report and the per-policy
    accuracy-vs-EPB frontier, as the reference's ``serve_diffusion``
    does.  ``pipe``: the pipeline to serve (default: ``model`` from seed
    0 on ``device``); a pipeline with a context dimension attends to a
    random ``(77, context_dim)`` context from seed 1 (row 0 of phase 5's
    in ``chip_smoke.py``), the same in every slot.

    ``overload > 0`` ignores ``rate_hz`` and offers ``overload`` times the
    measured capacity against a bounded queue (``queue_depth``, default
    ``2 * slots``) with deadline-aware shedding and a default SLO of 3x
    the zero-queue service time.  ``devices`` shards the slot axis over
    a 1-D mesh of the first N devices of ``device``'s kind (on the CPU, N
    logical shards); ``resize_to`` / ``resize_after`` resize it mid-replay
    after K completions (default half the requests), the results the
    resize flushes kept.  ``overlap_decode`` None: on exactly when
    sharded.  ``trace_path`` / ``log_json_path``
    trace the replay and write the Chrome trace / JSONL log, reconciled
    with the metrics first; ``prom_path`` writes the final Prometheus
    exposition; ``report_every`` logs a snapshot every that many seconds.
    ``cache_dir`` keeps the kernel libraries the warmup builds in a
    persistent directory (a restarted process loads them) and
    ``cache_max_mb`` bounds it.

    Returns the results and the metrics' ``summary()`` with the replay's
    wall seconds as ``makespan_s``."""
    if pipe is None:
        pipe = _diffusion_pipe(model, img, resolve_device(device))
    context = None
    if pipe.unet_cfg.context_dim is not None:
        # one conditioning row shared by every slot, so an image does not
        # depend on the slot the schedule gives its request
        gen = torch.Generator().manual_seed(1)
        context = torch.randn((slots, 77, pipe.unet_cfg.context_dim),
                              generator=gen)[:1].repeat(slots, 1, 1)
    queue = None
    if overload > 0:
        queue_depth = 2 * slots if queue_depth is None else queue_depth
        shed_policy = 'deadline-aware'
    if queue_depth is not None or shed_policy != 'reject-newest':
        queue = AdmissionQueue(max_depth=queue_depth,
                               shed_policy=shed_policy)
    mesh = None
    if devices is not None:
        mesh = serving_mesh(n_devices=devices, device=pipe.device.type)
    elif resize_to is not None:
        raise ValueError('resize_to resizes a mesh: pass devices too')
    tracer = Tracer() if (trace_path or log_json_path) else None
    reporter = None
    if report_every is not None and report_every > 0:
        reporter = SnapshotReporter(interval_s=report_every,
                                    emit=log_obs.info)

    def _on_straggler(report):
        log_mesh.warning('straggler flagged: hosts %s (median %.1fms, '
                         'threshold %.1fms) - %s', list(report.slow_hosts),
                         report.median_s * 1e3, report.threshold_s * 1e3,
                         report.recommendation)

    engine = ContinuousBatchingEngine(pipe, slots=slots, context=context,
                                      queue=queue,
                                      quality_probe=quality_probe,
                                      cache_interval=cache_interval,
                                      exit_tol=exit_tol,
                                      exit_patience=exit_patience,
                                      mesh=mesh,
                                      slots_per_device=slots_per_device,
                                      overlap_decode=overlap_decode,
                                      tracer=tracer, reporter=reporter,
                                      on_straggler=_on_straggler
                                      if mesh is not None else None)
    dev = pipe.device
    log_serve.info('%s (%s) on %s%s, overlap_decode=%s', pipe.unet_cfg.name,
                   'VAE decoder' if pipe.vae is not None else 'pixel space',
                   dev, f' ({torch.cuda.get_device_name(dev)})'
                   if dev.type == 'cuda' else '', engine.overlap_decode)
    if mesh is not None:
        log_mesh.info('slot axis sharded over %d devices (%s): %d slots '
                      '(%d/device), overlap_decode=%s', devices,
                      ', '.join(str(d) for d in mesh.devices), engine.slots,
                      engine.slots // devices, engine.overlap_decode)
    if cache_dir and cache_max_mb is not None:
        # enabled with its bound before warmup re-enables it (the bound is
        # process state the engine's trim_cache calls enforce)
        enable_persistent_cache(cache_dir,
                                max_bytes=int(cache_max_mb * 2 ** 20))
    entries_before = cache_entries(cache_dir) if cache_dir else 0
    log_serve.info('warmup (kernels, policy=%s%s)...', precision,
                   f', cache_dir={cache_dir}' if cache_dir else '')
    warmup_s = engine.warmup(precisions=(precision,), cache_dir=cache_dir)
    if cache_dir:
        entries = cache_entries(cache_dir)
        state = 'warm (loaded from cache)' if entries_before > 0 \
            else f'cold (persisted {entries} executables)'
        log_coldstart.info('warmup %.2fs - %s', warmup_s, state)
    else:
        log_coldstart.info('warmup %.2fs (no persistent cache)', warmup_s)
    if overload > 0:
        tick_s = engine.measure_tick_s(steps=steps)
        capacity_rps = engine.slots / (steps * tick_s)
        rate_hz = overload * capacity_rps
        if slo_ms is None:
            # 3x the zero-queue service time: generous for an uncontended
            # request, certain to shed under overload
            slo_ms = 3.0 * steps * tick_s * 1e3
        log_overload.info(
            'measured capacity %.2f req/s (%.1f ms/tick) -> offering '
            '%.2f req/s = %.1fx, queue_depth=%s, slo=%.0fms, '
            'shed_policy=%s', capacity_rps, tick_s * 1e3, rate_hz,
            overload_factor(rate_hz, tick_s, steps, engine.slots),
            queue_depth,
            slo_ms, shed_policy)
    trace = poisson_trace(n_requests, rate_hz, steps, seed, slo_ms=slo_ms,
                          precision=precision)
    sched = []
    if cache_interval > 1:
        sched.append(f'cache_interval={cache_interval}')
    if exit_tol is not None and exit_tol > 0:
        sched.append(f'exit_tol={exit_tol:g} patience={exit_patience}')
    log_serve.info('replaying %d requests at %.1f req/s (%d slots, %d '
                   'DDIM steps, precision=%s%s)', n_requests, rate_hz,
                   engine.slots, steps, precision,
                   ', ' + ', '.join(sched) if sched else '')
    resize_state = {'done': 0, 'fired': False, 'flushed': []}

    def _on_result(res):
        resize_state['done'] += 1
        k = resize_after if resize_after is not None else n_requests // 2
        if not resize_state['fired'] and resize_state['done'] >= k:
            resize_state['fired'] = True
            log_elastic.info('%d done -> resizing %s -> %d devices '
                             'mid-replay', resize_state['done'], devices,
                             resize_to)
            resize_state['flushed'].extend(engine.elastic_resize(
                n_devices=resize_to, precisions=(precision,)))
            log_elastic.info('rebuilt: %d slots on %d devices, %d parked',
                             engine.slots, resize_to, len(engine._parked))

    t0 = time.perf_counter()
    results = engine.replay(
        trace, on_result=_on_result if resize_to is not None else None)
    results.extend(resize_state['flushed'])
    makespan = time.perf_counter() - t0
    if engine.monitor is not None:
        report = engine.monitor.check()
        log_mesh.info('stragglers: %s',
                      report.recommendation if report else 'none detected')
    s = engine.metrics.summary()
    log_serve.info('%d done in %.2fs (%.2f req/s) p50=%.0fms p95=%.0fms '
                   'p99=%.0fms slo_viol=%d shed=%d', len(results),
                   makespan, s['requests_per_s'], s['p50_latency_ms'],
                   s['p95_latency_ms'], s['p99_latency_ms'],
                   int(s['slo_violations']), int(s['shed']))
    if overload > 0 or s['shed'] > 0:
        by = engine.metrics.shed_by_reason
        log_overload.info(
            'survived: queue peaked at %d%s, shed %d/%d (queue_full=%d '
            'evicted=%d expired=%d), queue wait p50=%.0fms p99=%.0fms',
            int(s['max_queue_depth']),
            f'/{queue_depth}' if queue_depth is not None else '',
            int(s['shed']), n_requests, by.get('queue_full', 0),
            by.get('deadline_evict', 0), by.get('expired', 0),
            s['p50_queue_wait_ms'], s['p99_queue_wait_ms'])
        if len(results) + int(s['shed']) != n_requests:
            raise AssertionError('requests lost: completed + shed != '
                                 'offered')
        if queue_depth is not None and s['max_queue_depth'] > queue_depth:
            raise AssertionError('queue bound broken')
    if cache_dir:
        from repro_torch.kernels import build
        log_coldstart.info('first tick %.2fs after the engine was built; '
                           '%d nvcc runs, %d kernel libraries loaded in '
                           'this process', s['first_tick_s'],
                           build.counts['nvcc'], build.counts['loads'])
    if cache_interval > 1 or s['steps_saved'] > 0:
        log_sched.info('cache_hit_rate=%.2f early_exits=%d steps_saved=%d',
                       s['cache_hit_rate'], int(s['early_exits']),
                       int(s['steps_saved']))
    src = 'simulated DiffLight' if precision != 'fp32' \
        else 'GPU digital baseline'
    log_energy.info('%.2f mJ/request (%.1f mJ total, %s)',
                    s['energy_per_request_mj'], s['total_energy_mj'], src)
    for name, pt in engine.metrics.frontier().items():
        quality = '' if pt['probed'] == 0 else (
            f'  psnr={pt["mean_psnr_db"]:.1f}dB mse={pt["mean_mse"]:.2e}'
            f' (vs fp32 reference, {int(pt["probed"])} probed)')
        sched_cols = ''
        if pt['cache_hit_rate'] > 0 or pt['early_exits'] > 0:
            sched_cols = (f'  hit_rate={pt["cache_hit_rate"]:.2f}'
                          f' steps={pt["mean_steps_executed"]:.1f}'
                          f'/{pt["mean_steps_requested"]:.1f}')
        log_frontier.info('%s: %.3f pJ/bit  %.2f mJ/request%s%s', name,
                          pt['mean_epb_pj'], pt['mean_energy_j'] * 1e3,
                          sched_cols, quality)
    if tracer is not None:
        _reconcile_trace(tracer, engine)
        if trace_path:
            n = write_chrome_trace(tracer, trace_path)
            log_obs.info('chrome trace: %d events -> %s (open in '
                         'chrome://tracing or ui.perfetto.dev)', n,
                         trace_path)
        if log_json_path:
            n = write_jsonl(tracer, log_json_path)
            log_obs.info('structured event log: %d lines -> %s', n,
                         log_json_path)
    if prom_path:
        with open(prom_path, 'w') as f:
            f.write(render_exposition(engine.metrics))
        log_obs.info('prometheus exposition -> %s', prom_path)
    return results, dict(s, makespan_s=makespan)


def _reconcile_trace(tracer, engine) -> None:
    """Check that the trace agrees with the metrics before export: one
    request span per completed request (each span's duration is the
    result's latency by construction: spans are stamped from the result's
    own timing fields) and one shed instant per shed request."""
    m = engine.metrics
    spans = tracer.spans('request')
    if len(spans) != m.completed:
        raise AssertionError(f'trace/metrics drift: {len(spans)} request '
                             f'spans vs {m.completed} completed')
    sheds = tracer.select('shed')
    total_shed = sum(m.shed_by_reason.values())
    if len(sheds) != total_shed:
        raise AssertionError(f'trace/metrics drift: {len(sheds)} shed '
                             f'events vs {total_shed} shed requests')
    log_obs.info('trace reconciled: %d request spans == %d completed, '
                 '%d shed events == %d shed (%d events total)',
                 len(spans), m.completed, len(sheds), total_shed,
                 len(tracer))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', default='internlm2-1.8b')
    ap.add_argument('--preset', default='smoke', choices=['smoke', 'full'])
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--prompt', type=int, default=16)
    ap.add_argument('--tokens', type=int, default=16)
    ap.add_argument('--w8a8', action='store_true',
                    help='LM mode: quantized (W8A8) projections and MLP '
                         '(the encoder-decoder ignores it, as the '
                         'reference); diffusion mode: alias for '
                         '--precision w8a8')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (plain PyTorch kernels)")
    ap.add_argument('--diffusion', action='store_true',
                    help='serve diffusion requests (continuous batching)')
    ap.add_argument('--model', default='toy', choices=['toy', 'sd-v1.4'],
                    help="diffusion model: the reference CLI's toy UNet "
                         '(--img px) or SD v1.4 + the 512-px VAE')
    ap.add_argument('--precision', default=None,
                    choices=['fp32', 'w8a8', 'w8a8+noise'],
                    help='diffusion request precision policy '
                         '(default fp32; overrides --w8a8)')
    ap.add_argument('--quality-probe', type=int, default=1,
                    help='probe every k-th quantized, cached or early-'
                         'exited request against the fp32 reference '
                         '(0 = off)')
    ap.add_argument('--requests', type=int, default=8)
    ap.add_argument('--rate', type=float, default=4.0,
                    help='Poisson arrival rate, req/s')
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--steps', type=int, default=6,
                    help='DDIM steps per request (diffusion mode)')
    ap.add_argument('--img', type=int, default=None,
                    help='image size of the toy model (default 16)')
    ap.add_argument('--slo-ms', type=float, default=None)
    ap.add_argument('--cache-interval', type=int, default=1,
                    help='DeepCache refresh cadence: full UNet pass every '
                         'k ticks, shallow cached passes in between '
                         '(1 = caching off)')
    ap.add_argument('--exit-tol', type=float, default=None,
                    help='speculative early exit: drain a request once its '
                         'x0 prediction moves less than this relative '
                         'tolerance (None/0 = off)')
    ap.add_argument('--exit-patience', type=int, default=2,
                    help='consecutive converged ticks before early exit')
    ap.add_argument('--queue-depth', type=int, default=None,
                    help='bound the admission queue (default: unbounded; '
                         '--overload defaults this to 2x slots)')
    ap.add_argument('--shed-policy', default='reject-newest',
                    choices=['reject-newest', 'deadline-aware'],
                    help='what to shed at the queue bound: the newest '
                         'arrival, or the entry with the least SLO slack')
    ap.add_argument('--overload', type=float, default=0.0,
                    help='offer this multiple of the measured service '
                         'capacity (ignores --rate; bounds the queue and '
                         'enables deadline-aware shedding)')
    ap.add_argument('--devices', type=int, default=None,
                    help='shard the slot axis over a 1-D mesh of the '
                         'first N cards (with --device cpu: N logical CPU '
                         'shards)')
    ap.add_argument('--slots-per-device', type=int, default=None,
                    help='per-device slot budget on the mesh (overrides '
                         '--slots; the invariant elastic resizes keep)')
    ap.add_argument('--overlap-decode', default='auto',
                    choices=['auto', 'on', 'off'],
                    help="run drained requests' VAE decodes behind the "
                         'next denoise tick, on a second CUDA stream of '
                         'each device (auto: on when sharded)')
    ap.add_argument('--resize-to', type=int, default=None,
                    help='elastic-resize the mesh to this many devices '
                         'mid-replay (the drop/rejoin survival demo)')
    ap.add_argument('--resize-after', type=int, default=None,
                    help='completions before the mid-replay resize '
                         '(default: half the requests)')
    ap.add_argument('--log-level', default='info',
                    choices=['debug', 'info', 'warning', 'error'],
                    help='stdout logging verbosity')
    ap.add_argument('--trace', default=None, metavar='PATH',
                    help='record per-request tracing and write a Chrome/'
                         'Perfetto trace_event timeline here (diffusion '
                         'mode)')
    ap.add_argument('--log-json', default=None, metavar='PATH',
                    help='write the structured JSONL event log here '
                         '(diffusion mode; same events as --trace)')
    ap.add_argument('--prom', default=None, metavar='PATH',
                    help='write the final Prometheus text exposition of '
                         'the serving metrics here (diffusion mode)')
    ap.add_argument('--report-every', type=float, default=None,
                    metavar='SECONDS',
                    help='print an in-run metrics snapshot line every '
                         'this many seconds (diffusion mode)')
    ap.add_argument('--cache-dir', default=None,
                    help='persistent kernel-library directory: a '
                         'restarted server loads the kernels it built '
                         'from here instead of running nvcc again')
    ap.add_argument('--cache-max-mb', type=float, default=None,
                    help='bound the persistent kernel-library directory; '
                         'least-recently-used libraries are evicted')
    args = ap.parse_args(argv)
    setup_logging(args.log_level)
    if args.diffusion:
        precision = args.precision or ('w8a8' if args.w8a8 else 'fp32')
        serve_diffusion(args.img, args.steps, args.requests, args.rate,
                        args.slots, precision=precision, slo_ms=args.slo_ms,
                        quality_probe=args.quality_probe,
                        cache_interval=args.cache_interval,
                        exit_tol=args.exit_tol,
                        exit_patience=args.exit_patience,
                        queue_depth=args.queue_depth,
                        shed_policy=args.shed_policy,
                        overload=args.overload,
                        devices=args.devices,
                        slots_per_device=args.slots_per_device,
                        overlap_decode={'auto': None, 'on': True,
                                        'off': False}[args.overlap_decode],
                        resize_to=args.resize_to,
                        resize_after=args.resize_after,
                        trace_path=args.trace,
                        log_json_path=args.log_json,
                        prom_path=args.prom,
                        report_every=args.report_every,
                        cache_dir=args.cache_dir,
                        cache_max_mb=args.cache_max_mb,
                        model=args.model, device=args.device)
        return
    cfg = smoke_config(args.arch) if args.preset == 'smoke' \
        else get(args.arch)
    seqs, _ = serve_lm(cfg, args.batch, args.prompt, args.tokens,
                       quant=args.w8a8, device=args.device)
    log_serve.info('sample token ids: %s', seqs[0, :12].cpu().numpy())


if __name__ == '__main__':
    main()
