"""Driver: the port's training step (``repro_torch.launch.steps.
build_train_step``: ``lm_loss`` under autograd with the configuration's
remat, then ``optim/adamw.adamw_update``), float32, on one device.

The configuration's model family (``harness/families/``) gives the
port's ``ArchConfig``, the weights' layout, the reference's forward and
the step's work count.  Set-up makes the weights from the seed on the
device, builds the step
and its AdamW state once, and drives that same object through the first
three steps of the mix's batches (``traffic.train_batch``, rows that all
differ), reading what the comparison needs: each step's loss, each
leaf's norm of the first gradient as the optimizer took it (its first
moment after step 1 over ``1 - b1``), and each leaf's norm of the change
over the three steps (against the weights drawn again from the seed).
The window then runs steps 4, 5, ... until it closes.

End-to-end: ``train_tokens_per_s``, the tokens of the window's steps
over the time from the first one's start to the last one's end (every
step issued runs to its end).  Correct: the plain reference
(``reference/train.py``) runs the same three steps from the same weights
and batches, and ``reference.train.gaps`` compares.
"""
from __future__ import annotations

import gc
import time

import torch

from harness import common, traffic, weights
from harness.trace import Slice, host_range, prime
from reference import train as ref
from reference.numerics import FP32, no_tf32
from roofline import work as W

CHECKED_STEPS = 3


def train_rate(steps: int, tokens_per_step: int, t_start: float,
               t_end: float) -> float:
    """Tokens of ``steps`` whole steps over the time they took."""
    return steps * tokens_per_step / (t_end - t_start)


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def run(r: common.Run) -> common.Outcome:
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    cfg, mix, dev = r.cell.config, r.cell.traffic, torch.device(r.device)
    no_tf32()
    fam = common.family(cfg['family'])
    arch = fam.arch_config(cfg)
    spec = fam.param_spec(cfg)
    model = weights.install(T.LM(arch, device='meta'),
                            weights.make(spec, r.seed, dev))
    opt_cfg = AdamWConfig(**mix['adamw'])
    params = ST.train_params(model)
    opt = init_adamw(list(params.values()))
    step = ST.build_train_step(arch, opt_cfg, dtype=torch.float32)
    vocab = cfg['vocab_size']

    def batch(k):
        b = traffic.train_batch(mix, r.seed, k, vocab)
        return {n: t.to(dev) for n, t in b.items()}

    prog = {'loss': []}
    for k in range(CHECKED_STEPS):
        model, opt, met = step(model, opt, batch(k))
        prog['loss'].append(float(met['loss']))
        if k == 0:
            prog['grad'] = {n: float(m.norm()) / (1 - opt_cfg.b1)
                            for n, m in zip(params, opt.m)}
    p0 = weights.make(spec, r.seed, dev)
    with torch.no_grad():
        prog['change'] = {n: float((w - p0[n]).norm())
                          for n, w in params.items()}
    del p0
    if r.trace:
        prime(dev)
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = common.process_age_s()
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    k = CHECKED_STEPS
    layers = sl = None
    trace_from = CHECKED_STEPS + mix['trace_from_step']

    def close(n):
        sl.end()
        sl.stop()
        w = W.Work()
        for _ in range(n):
            w.add(fam.train_work(cfg, mix['rows'], mix['seq_len']))
        return common.Layers(sl, w, {'steps': n})

    while time.perf_counter() < deadline:
        if r.trace and k == trace_from:
            sl = Slice(dev).start()
        with host_range('train_step'):
            model, opt, _ = step(model, opt, batch(k))
        k += 1
        if sl is not None and k == trace_from + mix['trace_steps']:
            layers, sl = close(mix['trace_steps']), None
    if sl is not None:          # the window closed inside the slice
        layers = close(k - trace_from)
    _sync(dev)
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    steps = k - CHECKED_STEPS
    e2e = {'train_tokens_per_s': train_rate(
        steps, mix['rows'] * mix['seq_len'], t0, t_end)}
    notes = [f'window {t_end - t0:.3f} s, {steps} steps; set-up losses '
             f'{prog["loss"]}']

    del model, opt, step, params
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    batches = [batch(i) for i in range(CHECKED_STEPS)]
    p0 = weights.make(spec, r.seed, dev)
    want = ref.train(FP32, fam.forward, p0, cfg, mix['adamw'], batches)
    got = ref.gaps(prog, want)
    checks = [common.Check(n, v, r.cell.limit(n)) for n, v in got.items()]
    readings = dict(got)
    for name, num in r.controls.items():
        ctl = ref.train(num, fam.forward, p0, cfg, mix['adamw'], batches)
        readings.update({f'control_{name}_{n}': v
                         for n, v in ref.gaps(ctl, want).items()})
    notes.append(f'reference losses {want["loss"]}')
    return common.Outcome(setup_s, e2e, checks, steps, 0, peak, layers,
                          readings, notes)
