"""Driver: text-to-image requests through the port's continuous-batching
engine (``repro_torch.serving.engine.ContinuousBatchingEngine``: ``submit``
and ``tick``), SD v1.4 + the 512-px VAE decoder.

Set-up makes the weights and one context row per slot from the seed on
the device (the context is the seeded stand-in for the text encoder's
output; a request takes its slot's row), builds the engine with the
quality probe, early exit and decode overlap off and a noise seed drawn
from the run's, and runs its ``warmup`` for the mix's precisions
(``traffic.precision``: one, or one drawn per request).  The window then
runs the mix:

* ``closed``: ``clients`` callers, each resubmitting when its image
  returns;
* ``poisson``: requests due on the mix's schedule, submitted once due;
  after the window closes the engine ticks on, up to ``drain_s``, until
  every request due in the window has its image.

Every time is ``time.perf_counter()``, the clock the engine stamps a
result's finish with after the image reached the host.  The engine's
tracer records each request's slot (``slot_assign``), from which the
tick it was admitted at follows; every occupied slot advances one step
a tick, so the steps a request ran inside the window, and the tick each
of its steps ran at, are known.  Its ``step`` events (one per precision
group a tick) give the traced slice's work.

End-to-end: ``images_per_s`` (each image credited with the share of its
planned steps that ran inside the window, over the window) and
``image_latency_p90_s`` (due to image, over every request due in the
window, an unfinished one a miss).  Correct: a sample of the finished
requests, drawn from the seed, generated again by the plain reference
(``reference/sd.py``) from the same seeds, context rows, steps,
guidance, DeepCache cadence and precision, a noisy request's
perturbation from the engine's noise seed, its slot and the ticks its
steps ran at (``reference/noise.py``), compared image by image: the
worst request's relative RMS distance and its largest pixel difference.
"""
from __future__ import annotations

import collections
import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from harness import common, traffic, weights
from harness import precision as PR
from harness.trace import Slice, host_range, prime
from reference import sd as ref
from reference.noise import Draws
from reference.numerics import FP32, no_tf32
from roofline import work as W

REF_BATCH = 8           # requests the reference generates at once


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _spec(cfg: dict) -> list:
    return ([('unet.' + n, *r) for n, *r in ref.unet_spec(cfg['unet'])]
            + [('vae.' + n, *r) for n, *r in ref.vae_decoder_spec(cfg['vae'])])


def _split(p: Dict[str, torch.Tensor], prefix: str):
    return {n[len(prefix):]: t for n, t in p.items() if n.startswith(prefix)}


def noise_seed(seed: int) -> int:
    """The engine's ``w8a8+noise`` seed, drawn from the run's."""
    return int(np.random.default_rng([seed, 6]).integers(0, 2 ** 31 - 1))


def _engine(cfg: dict, mix: dict, seed: int, dev):
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.diffusion.schedule import linear_schedule
    from repro_torch.models.autoencoder import VAEConfig, VAEDecoder
    from repro_torch.models.unet import UNet, UNetConfig
    from repro_torch.obs.tracer import Tracer
    from repro_torch.serving.engine import ContinuousBatchingEngine
    uc = UNetConfig(**_tuples(cfg['unet']))
    vc = VAEConfig(**_tuples(cfg['vae']))
    p = weights.make(_spec(cfg), seed, dev)
    unet = weights.install(UNet(uc, device='meta'), _split(p, 'unet.')).eval()
    vae = weights.install(VAEDecoder(vc, device='meta'),
                          _split(p, 'vae.')).eval()
    pipe = DiffusionPipeline(uc, unet, linear_schedule(uc.timesteps, device=dev),
                             vc, vae)
    context = ref.context_rows(seed, mix['slots'], cfg['context_tokens'],
                               cfg['unet']['context_dim'], dev)
    engine = ContinuousBatchingEngine(
        pipe, slots=mix['slots'], context=context, quality_probe=0,
        cache_interval=mix['cache_interval'], overlap_decode=False,
        tracer=Tracer(), noise_seed=noise_seed(seed))
    engine.warmup(precisions=traffic.precisions(mix))
    return engine


def _request(mix: dict, r: dict):
    from repro_torch.serving.api import GenerationRequest
    return GenerationRequest(request_id=r['id'], seed=r['seed'],
                             steps=mix['steps'], guidance=mix['guidance'],
                             precision=r['precision'],
                             cache_interval=mix['cache_interval'])


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _slice_work(cfg: dict, mix: dict, steps, ticks) -> W.Work:
    """The UNet evaluations of the engine ticks ``ticks``: per step (a
    plan entry: a precision group's refresh or skip pass), the slot
    buffer evaluated with the context and, when guided, without."""
    w = W.Work()
    for e in steps:
        if e.tick in ticks:
            gemm = PR.of(e.args['precision']).int8_gemm
            full = e.args['refresh']
            w.add(W.sd_unet_eval(cfg['unet'], mix['slots'],
                                 cfg['context_tokens'], gemm, full))
            if e.args['guided']:
                w.add(W.sd_unet_eval(cfg['unet'], mix['slots'], 0, gemm,
                                     full))
    return w


def image_credit(admitted_ticks, steps: int, window_ticks: int) -> float:
    """Images delivered in a window of ``window_ticks`` ticks, each
    request admitted at tick ``a`` credited with the share of its
    ``steps`` that ran by the window's last tick (one step a tick)."""
    return sum((min(a + steps, window_ticks) - a) / steps
               for a in admitted_ticks if a < window_ticks)


def run(r: common.Run) -> common.Outcome:
    cfg, mix, dev = r.cell.config, r.cell.traffic, torch.device(r.device)
    no_tf32()
    engine = _engine(cfg, mix, r.seed, dev)
    reqs = traffic.image_requests(mix, r.seed, r.seconds)
    # the slice: ``trace_ticks`` ticks from tick ``trace_from_tick``, or
    # (``trace_last_s``) the window's last seconds, so that stopping the
    # profiler, which takes seconds, holds up only the window's last
    # requests and not the queue of every request after the slice
    trace_from, trace_n = mix.get('trace_from_tick'), mix.get('trace_ticks')
    if r.trace:
        prime(dev)
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = common.process_age_s()
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    tick_at: Dict[float, int] = {}          # a tick's `now` -> its index
    eng_tick: List[int] = []                # a tick's index -> the engine's
    window_ticks = 0
    t_end = None
    results = {}
    submitted: Dict[int, dict] = {}
    closed = mix['arrivals'] == 'closed'
    pending = None if closed else list(reqs)
    due_in_window = [] if closed else [q for q in pending
                                       if q['due'] < r.seconds]
    in_flight = 0
    layers = None
    sl = None
    trace_end = None

    def submit(q, now):
        q['precision'] = traffic.precision(mix, r.seed, q['id'])
        submitted[q['id']] = q
        engine.submit(_request(mix, q), now=now)

    while True:
        now = time.perf_counter()
        if t_end is None and now >= deadline:
            _sync(dev)
            t_end = time.perf_counter()
            window_ticks = len(tick_at)
            if sl is not None:      # the window closed inside the slice
                sl.end()
                trace_end = window_ticks
                layers = common.Layers(sl, None,
                                       {'ticks': window_ticks - trace_from})
                sl = None
            # every request due in the window is sent, the last ones now
            while pending and pending[0]['due'] < r.seconds:
                submit(pending.pop(0), now)
        if t_end is not None:
            if closed or all(q['id'] in results for q in due_in_window) \
                    or now > t_end + mix['drain_s']:
                break
        if closed and t_end is None:
            while in_flight < mix['clients']:
                submit(next(reqs), now)
                in_flight += 1
        elif not closed and t_end is None:
            while pending and t0 + pending[0]['due'] <= now:
                submit(pending.pop(0), now)
        if not engine.busy:
            if t_end is None:
                nxt = t0 + pending[0]['due'] if pending else deadline
                time.sleep(max(0.0, min(nxt, deadline) - now))
                continue
            break
        k = len(tick_at)
        if r.trace and sl is None and layers is None and t_end is None and (
                k == trace_from if trace_from is not None
                else now >= deadline - mix['trace_last_s']):
            trace_from = k
            sl = Slice(dev).start()
        tick_at[now] = k
        eng_tick.append(engine.metrics.ticks)
        with host_range('engine.tick'):
            out = engine.tick(now=now, wall_clock=True)
        for res in out:
            results[res.request_id] = res
            in_flight -= 1
        if sl is not None and trace_n is not None \
                and k + 1 == trace_from + trace_n:
            sl.end()
            trace_end = k + 1
            layers = common.Layers(sl, None, {'ticks': trace_n})
            sl = None
    _sync(dev)
    if layers is not None:
        # reduced only now: its seconds of work would hold up requests
        layers.slice.stop()
        layers.work = _slice_work(cfg, mix, engine.tracer.select(name='step'),
                                  set(eng_tick[trace_from:trace_end]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0

    # the window's numbers
    admitted = {e.rid: (tick_at[e.ts], e.slot)
                for e in engine.tracer.select(name='slot_assign')}
    steps = mix['steps']
    credit = image_credit([a for a, _ in admitted.values()], steps,
                          window_ticks)
    e2e = {'images_per_s': credit / (t_end - t0)}
    notes = [f'window {t_end - t0:.3f} s, {window_ticks} ticks, '
             f'{len(results)} images, credit {credit:.3f}']
    # an image due by the window's last tick that never came
    failed = sum(1 for rid, (a, _) in admitted.items()
                 if a + steps <= window_ticks and rid not in results)
    if not closed:
        lat = [results[q['id']].finish_time - (t0 + q['due'])
               if q['id'] in results else math.inf for q in due_in_window]
        failed = max(failed, sum(1 for v in lat if math.isinf(v)))
        e2e['image_latency_p90_s'] = common.nearest_rank(lat, 0.9)
        notes.append(f'latency p90 over {len(lat)} requests due in the '
                     f'window, {failed} unfinished')
        waits = [results[q['id']].queue_delay_s for q in due_in_window
                 if q['id'] in results]
        notes.append(f'queue wait p50 {common.nearest_rank(waits, 0.5)!r} s')
        if layers is not None:
            layers.counts['queue_waits'] = waits
    attempted = len(due_in_window) if not closed else len(submitted)

    # the comparison, once the program's state is freed
    rng = np.random.default_rng([r.seed, 5])
    done = sorted(results)
    pick = sorted(rng.choice(done, size=min(mix['check_requests'], len(done)),
                             replace=False).tolist()) if done else []
    served = {i: results[i].image for i in pick}
    slot_of = {i: admitted[i][1] for i in pick}
    seed_of = {i: submitted[i]['seed'] for i in pick}
    prec_of = {i: submitted[i]['precision'] for i in pick}
    draws = _draws(noise_seed(r.seed), pick, admitted, eng_tick, steps)
    del engine, results
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, readings = _compare(r, cfg, mix, dev, pick, served, slot_of,
                                seed_of, prec_of, draws)
    if not pick:
        checks = [common.Check(c.name, math.inf, c.limit) for c in checks]
    notes.append(f'compared {len(pick)} images with the reference in '
                 f'{time.perf_counter() - t_ref:.1f} s')
    return common.Outcome(setup_s, e2e, checks, attempted, failed, peak,
                          layers, readings, notes)


def _draws(seed: int, pick, admitted, eng_tick: List[int],
           steps: int) -> Dict[int, Draws]:
    """Per picked request, what a noisy one's perturbation is drawn from:
    the engine tick of each of its steps, its slot, and at those ticks
    the step index of the request then in slot 0 (its timestep is folded
    into the keys)."""
    slot0: Dict[int, int] = {}
    for a, s in admitted.values():
        if s == 0:
            for i in range(min(steps, len(eng_tick) - a)):
                slot0[eng_tick[a + i]] = i
    out = {}
    for rid in pick:
        a, s = admitted[rid]
        ticks = [eng_tick[a + i] for i in range(steps)]
        out[rid] = Draws(seed, ticks, s,
                         {k: slot0[k] for k in ticks if k in slot0})
    return out


def _compare(r, cfg, mix, dev, pick, served, slot_of, seed_of, prec_of,
             draws):
    p = weights.make(_spec(cfg), r.seed, dev)
    up, vp = _split(p, 'unet.'), _split(p, 'vae.')
    context = ref.context_rows(r.seed, mix['slots'], cfg['context_tokens'],
                               cfg['unet']['context_dim'], dev)
    groups = collections.defaultdict(list)
    for i in pick:
        groups[prec_of[i]].append(i)
    # the worst request's distance; each control's, in the program's place
    worst = collections.defaultdict(float)

    def note(prefix, a, b):
        rel, mx = ref.image_errors(a, b)
        worst[prefix + 'image_rel_rms'] = max(worst[prefix + 'image_rel_rms'],
                                              rel)
        worst[prefix + 'image_max_abs'] = max(worst[prefix + 'image_max_abs'],
                                              mx)

    # a noisy group in one call, whose requests' steps share each tick's
    # draws; the others REF_BATCH at a time
    batches = [(pr, ids[lo:lo + size]) for pr, ids in sorted(groups.items())
               for size in [len(ids) if PR.of(pr).noisy else REF_BATCH]
               for lo in range(0, len(ids), size)]
    for pr, ids in batches:
        P = PR.of(pr)
        ctx = context[[slot_of[i] for i in ids]]
        args = (up, vp, cfg, [seed_of[i] for i in ids], ctx, mix['steps'],
                mix['guidance'], P.quant, mix['cache_interval'],
                [draws[i] for i in ids] if P.noisy else None)
        images = ref.generate(FP32, *args)
        for j, i in enumerate(ids):
            note('', torch.from_numpy(served[i]).to(dev), images[j])
        for name, num in r.controls.items():
            ctl = ref.generate(num, *args)
            for j in range(len(ids)):
                note(f'control_{name}_', ctl[j], images[j])
            del ctl
        del images
    # the numbers the cell states a limit for
    checks = [common.Check(n, worst[n], r.cell.limit(n))
              for n in ('image_rel_rms', 'image_max_abs')
              if n in r.cell.workload['limits']]
    return checks, dict(worst)
