"""Driver: greedy generation through the port's serving steps
(``repro_torch.launch.steps``: ``init_serve_state``,
``build_prefill_step``, ``build_decode_step``), batch after batch, as
``launch/serve.py::serve_lm`` runs them: a device sync before and after
the prefill and after the decode loop, activations and cache in the
configuration's float32.

The configuration names its model family (``harness/families/``), which
gives the port's ``ArchConfig``, the weights' layout, the reference, the
cache rows compared and the work counts.  Set-up makes the weights from
the seed on the device and warms one prefill and two decode steps at
each prompt length of the mix.  The
window runs batches of the mix's prompts (``traffic.prompts``) until it
closes; the batch in flight then stops after the decode step under way.

End-to-end: ``lm_tokens_per_s``, every generated token (the prefill's
and each decode step's, a cut batch's included) over the window.
Correct: a sample of the finished batches' sequences, drawn from the
seed, run through the family's plain reference over prompt + served
tokens.  Two numbers: ``served_gap``, the widest gap by which
a served token's logit lies below the reference's best at its position;
and ``kv_rel_rms.L<i>`` for each layer i of ``KV_CHECKED``, the cache
the window's prefill and decode steps wrote for one row of each
finished batch (kept as the batch ends, the row drawn from the seed)
against the keys and values the reference computes over the same
tokens: the worst relative RMS distance, keys or values.  A served
token moves only where rounding tips a near tie, so ``served_gap``
reads the int8 roundings' rare flips alike at float32 and a step below;
the first layers' cache, upstream of most int8 roundings, reads the
float precision itself (layer 0: its projections, norm and cache;
layer 1: also layer 0's attention, W8A8 products and MLP).  Each of the
layer's cached tensors (the dense family's keys and values) reads apart,
``kv_rel_rms.L<i>.<name>``, and the check takes the worst.
"""
from __future__ import annotations

import collections
import gc
import math
import time
from typing import List

import numpy as np
import torch

from harness import common, traffic, weights
from harness.trace import Slice, host_range, prime
from reference.numerics import FP32, no_tf32

#: layers whose cache rows are kept for the comparison (negative: from
#: the last), and those of them whose distance is a checked number
KV_KEPT = (0, 1, 2, 3, -1)
KV_CHECKED = (0, 1)


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def run(r: common.Run) -> common.Outcome:
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    cfg, mix, dev = r.cell.config, r.cell.traffic, torch.device(r.device)
    no_tf32()
    fam = common.family(cfg['family'])
    arch = fam.arch_config(cfg)
    model = weights.install(T.LM(arch, device='meta'),
                            weights.make(fam.param_spec(cfg), r.seed, dev))
    dt, B, new = torch.float32, mix['batch'], mix['new_tokens']
    prefill = ST.build_prefill_step(arch, dtype=dt, quant=mix['quant'])
    decode = ST.build_decode_step(arch, dtype=dt, quant=mix['quant'])
    for n in sorted(set(mix['prompt_lengths'])):
        ids = torch.zeros((B, n), dtype=torch.int32, device=dev)
        state = ST.init_serve_state(arch, B, n + new, cache_dtype=dt, device=dev)
        tok, state = prefill(model, state, {'tokens': ids})
        for i in range(2):
            tok, state = decode(model, state, tok, n + i)
        del state
    if r.trace:
        prime(dev)
    _sync(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = common.process_age_s()
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    tokens = decode_steps = 0
    decode_s = 0.0
    finished = []       # (batch, prompts, served, kept row, its cache)
    walls = []          # (prompt length, seconds, traced) of whole batches
    layers = None
    b = 0
    while time.perf_counter() < deadline:
        ids = traffic.prompts(mix, r.seed, b, cfg['vocab_size'])
        n = ids.shape[1]
        traced = r.trace and b == mix['trace_batch']
        sl = Slice(dev).start() if traced else None
        tb = time.perf_counter()
        state = ST.init_serve_state(arch, B, n + new, cache_dtype=dt, device=dev)
        _sync(dev)
        with host_range('prefill'):
            tok, state = prefill(model, state, {'tokens': ids.to(dev)})
        _sync(dev)
        out = [tok]
        td = time.perf_counter()
        for i in range(new - 1):
            if not traced and time.perf_counter() >= deadline:
                break
            with host_range('decode_step'):
                tok, state = decode(model, state, tok, n + i)
            out.append(tok)
        _sync(dev)
        if len(out) == new:
            walls.append((n, time.perf_counter() - tb, traced))
        if sl is not None:
            sl.end()
            work = fam.prefill_work(cfg, B, n, mix['quant'])
            for i in range(len(out) - 1):
                work.add(fam.decode_work(cfg, B, n + i, mix['quant']))
            # the same prompts' batch as it runs untraced, for the readers
            # that set the device's time against the batch's wall
            same = [w for m, w, t in walls if m == n and not t]
            layers = common.Layers(sl, work, {
                'untraced_wall_s': same[-1] if same else None})
        else:
            decode_s += time.perf_counter() - td
            decode_steps += len(out) - 1
        tokens += B * len(out)
        if len(out) == new:
            j = int(np.random.default_rng([r.seed, 7, b]).integers(B))
            finished.append((b, ids, torch.cat(out, dim=1).cpu(), j,
                             fam.cache_rows(state['cache'], arch, j,
                                            n + new - 1,
                                            _layers(len(state['cache']),
                                                    KV_KEPT))))
        del state
        b += 1
    t_end = time.perf_counter()
    if layers is not None:
        # reduced only now: that takes seconds of the host
        layers.slice.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    e2e = {'lm_tokens_per_s': tokens / (t_end - t0)}
    if layers is not None:
        layers.counts.update(decode_steps=decode_steps, decode_s=decode_s)
    notes = [f'window {t_end - t0:.3f} s, {b} batches ({len(finished)} '
             f'finished), {tokens} tokens, {decode_steps} untraced decode '
             f'steps in {decode_s:.3f} s']
    traced = [(n, w) for n, w, t in walls if t]
    if traced:          # what the profiler costs: the same prompts' walls
        n_t = traced[0][0]
        notes.append(f'traced batch of {n_t}-token prompts {traced[0][1]:.3f} '
                     f's; untraced ones ' + ', '.join(
                         f'{w:.3f}' for n, w, t in walls if n == n_t and not t))

    del model, prefill, decode
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    checks, readings, compared = _compare(r, fam, cfg, mix, dev, finished)
    notes.append(f'compared {compared} served tokens with the reference')
    return common.Outcome(setup_s, e2e, checks, b * B, 0, peak, layers,
                          readings, notes)


def _layers(n_layers: int, which) -> List[int]:
    return sorted({i % n_layers for i in which})


def _sample(mix: dict, seed: int, finished) -> List[tuple]:
    """(prompt, served, kept cache or None): the row kept of each finished
    batch (the longest prompts among them), then others at random,
    ``check_sequences`` in all."""
    rng = np.random.default_rng([seed, 5])
    kept = [(i, f[3]) for i, f in enumerate(finished)]
    rest = [(i, j) for i, f in enumerate(finished)
            for j in range(f[1].shape[0]) if j != f[3]]
    k = max(0, min(mix['check_sequences'] - len(kept), len(rest)))
    pick = kept + [rest[i] for i in rng.choice(len(rest), size=k,
                                               replace=False)]
    return [(finished[i][1][j], finished[i][2][j],
             finished[i][4] if j == finished[i][3] else None)
            for i, j in pick]


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS distance of ``a`` from ``b`` over the RMS of ``b``."""
    b = b.float()
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best
    at its position: ref_logits (N, vocab), served (N,) -> (N,)."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, served[:, None].long())[:, 0]


def _kv_gaps(got: dict, want: list) -> dict:
    """Per kept layer and cached tensor, the relative RMS distance from
    ``want`` (the reference's per-layer ``{name: tensor}``, batch of
    one)."""
    return {f'L{i}.{n}': _rel_rms(t.to(want[i][n].device), want[i][n][0])
            for i, row in got.items() for n, t in row.items()}


def _compare(r, fam, cfg, mix, dev, finished):
    sample = _sample(mix, r.seed, finished)
    p = weights.make(fam.param_spec(cfg), r.seed, dev)
    new = mix['new_tokens']
    checked = _layers(cfg['num_hidden_layers'], KV_CHECKED)
    worst = collections.defaultdict(float)

    def note(key, v):
        worst[key] = max(worst[key], v)

    for prompt, served, kept in sample:
        seq = torch.cat([prompt, served[:-1]]).to(dev)[None].long()
        served = served.to(dev)
        kv = [] if kept is not None else None
        logits = fam.logits(FP32, p, cfg, seq, mix['quant'], last=new,
                            kv=kv)[0]
        note('served_gap', float(served_gaps(logits, served).max()))
        if kept is not None:
            for key, v in _kv_gaps(kept, kv).items():
                note(f'kv_rel_rms.{key}', v)
        # a control in the program's place: the token it puts first, and
        # the cache it would write
        for name, num in r.controls.items():
            ckv = [] if kept is not None else None
            first = fam.logits(num, p, cfg, seq, mix['quant'], last=new,
                               kv=ckv)[0].argmax(dim=-1)
            note(f'control_{name}_served_gap',
                 float(served_gaps(logits, first).max()))
            if kept is not None:
                mine = {i: {n: t[0] for n, t in ckv[i].items()}
                        for i in kept}
                for key, v in _kv_gaps(mine, kv).items():
                    note(f'control_{name}_kv_rel_rms.{key}', v)
            del ckv
        del logits, kv
    names = ['served_gap'] + [f'kv_rel_rms.L{i}' for i in checked]
    for pre in [''] + [f'control_{n}_' for n in r.controls]:
        for i in checked:
            parts = [v for k, v in worst.items()
                     if k.startswith(f'{pre}kv_rel_rms.L{i}.')]
            worst[f'{pre}kv_rel_rms.L{i}'] = max(parts, default=0.0)
    if not any(kept is not None for _, _, kept in sample):
        worst.update({n: math.inf for n in names})
    checks = [common.Check(n, worst[n], r.cell.limit(n)) for n in names
              if n in r.cell.workload['limits']]
    return checks, dict(worst), len(sample) * new
