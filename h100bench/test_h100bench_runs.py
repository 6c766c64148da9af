"""CPU tests that drive the harness end to end at a size a test run holds:
the plain references against ``repro_torch``, a run of each driver
through ``run.result`` with its comparison, the same runs with the
timed path broken underneath (each must come out not correct), and a
cell, configuration, mix and per-layer metric added as files only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from harness import common, weights
from reference import lm as lm_ref
from reference import prng as ref_prng
from reference import sd as sd_ref
from reference.noise import Draws
from reference.numerics import FP32, Numerics
from reference.prng import initial_noise

HERE = Path(__file__).resolve().parent
RUN = common.load_module(HERE / 'run.py', 'h100bench_run_under_test')

UNET = dict(name='t', img_size=16, in_ch=4, base_ch=32, ch_mults=[1, 2],
            n_res_blocks=1, attn_resolutions=[8], n_heads=4, context_dim=24,
            timesteps=100, latent=True, groups=8)
VAE = dict(img_size=32, in_ch=3, z_ch=4, base_ch=16, ch_mults=[1, 2],
           groups=8)
SD = {'name': 'tiny-sd', 'unet': UNET, 'vae': VAE, 'context_tokens': 7}
LM = dict(name='tiny-lm', family='dense', num_hidden_layers=2, hidden_size=64,
          num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
          vocab_size=97, rms_norm_eps=1e-6, rope_theta=10000.0, kv_repeat=2)
SD_MIX = dict(driver='sd_engine', arrivals='closed', clients=3, slots=3,
              precision='w8a8', guidance=7.5, steps=3, cache_interval=1,
              check_requests=16, trace_from_tick=1, trace_ticks=2)
POISSON_MIX = dict(SD_MIX, arrivals='poisson', rate=4.0,
                   drain_s=120.0, cache_interval=2, steps=4)
NOISE_MIX = dict(POISSON_MIX, precision='w8a8+noise', cache_interval=1,
                 slots=2, rate=3.0, steps=3)
MIXED_MIX = dict(POISSON_MIX, precision={'fp32': 1, 'w8a8': 1,
                                         'w8a8+noise': 2})
LM_MIX = dict(driver='lm_generate', arrivals='batches', batch=3,
              prompt_lengths=[5, 9, 17, 9], new_tokens=6, quant=True,
              check_sequences=16, trace_batch=3)
# limits for these tiny models: their sound runs read under a tenth of
# them on the CPU (rounding moves a few int8 roundings), a fault reads
# well over
SD_LIMITS = {'image_rel_rms': 1e-2, 'image_max_abs': 2e-2}
# the tiny model's attention moves its images little, so its noise moves
# them little: sound noisy runs read 4.3e-4-9.0e-4 (largest pixel up to
# 1.5e-3) on the CPU; the perturbation left out, drawn at the next tick's
# keys or at slot 0's rows for every slot, 2.9e-3 (5.0e-3) and more
NOISE_LIMITS = {'image_rel_rms': 2e-3, 'image_max_abs': 4e-3}
LM_LIMITS = {'served_gap': 1e-2, 'kv_rel_rms.L0': 1e-4, 'kv_rel_rms.L1': 2e-2}
# windows long enough that a CPU shared with other test workers still
# finishes requests, batches and steps in them
SD_SECONDS, LM_SECONDS, TRAIN_SECONDS = 6.0, 4.0, 3.0


@pytest.fixture(autouse=True)
def _few_threads():
    """Few intra-op threads, so that test workers sharing the CPU do not
    starve each other's windows."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cell(config, mix, limits, per_layer=None):
    return common.Cell('tiny', {'chips': 1, 'limits': limits,
                                'end_to_end': {}, 'per_layer': per_layer or {}},
                       config, mix)


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


# --- the plain references against the port ---------------------------------

@pytest.mark.parametrize('quant', [False, True])
def test_sd_reference_matches_the_port(quant):
    from repro_torch.diffusion.deepcache import unet_apply_cached
    from repro_torch.models.autoencoder import VAEConfig, VAEDecoder
    from repro_torch.models.unet import UNet, UNetConfig
    cfg = UNetConfig(**_tuples(UNET))
    p = weights.make(sd_ref.unet_spec(UNET), 123, 'cpu')
    m = weights.install(UNet(cfg, device='meta'), p)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 16, 4, generator=g)
    ctx = torch.randn(2, 7, 24, generator=g)
    t = torch.tensor([5, 50])
    pol = 'w8a8' if quant else None
    # quantized: a float32 difference in the last bit can move an int8
    # rounding at a tie (one step of one activation)
    tol = 2e-3 if quant else 1e-5
    with torch.no_grad():
        eps, deep = sd_ref.unet(FP32, p, UNET, x, t, ctx, quant)
        assert (m(x, t, ctx, pol) - eps).abs().max() < tol
        e, cache = unet_apply_cached(m, cfg, x, t, None, True, ctx, pol)
        e2, _ = unet_apply_cached(m, cfg, x, t, cache, False, ctx, pol)
        skip, _ = sd_ref.unet(FP32, p, UNET, x, t, ctx, quant, deep)
        assert (cache - deep).abs().max() < tol
        assert (e2 - skip).abs().max() < tol
    vp = weights.make(sd_ref.vae_decoder_spec(VAE), 7, 'cpu')
    vm = weights.install(VAEDecoder(VAEConfig(**_tuples(VAE)), device='meta'),
                         vp)
    z = torch.randn(2, 16, 16, 4, generator=g)
    with torch.no_grad():
        assert (vm(z) - sd_ref.vae_decode(FP32, vp, VAE, z)).abs().max() < 1e-5


@pytest.mark.parametrize('seed', [0, 5, 2 ** 31 + 12345])
def test_initial_noise_is_the_ports_bit_for_bit(seed):
    from repro_torch.diffusion.pipeline import initial_noise as port_noise
    assert torch.equal(port_noise(seed, (1, 16, 16, 4), 'cpu'),
                       initial_noise(seed, (1, 16, 16, 4)))


@pytest.mark.parametrize('offset', [0, 12345])
def test_reference_normal_is_the_ports_bit_for_bit(offset):
    from repro_torch.core import prng
    key = prng.fold_in(prng.PRNGKey(2 ** 31 + 7), 5)
    assert ref_prng.fold_in(ref_prng.PRNGKey(2 ** 31 + 7), 5) == key
    want = prng.normal(key, (6, 37), device='cpu', offset=offset)
    assert torch.equal(ref_prng.normal(key, (6, 37), offset=offset), want)
    # rows 1 and 4 alone, by their counters
    idx = offset + torch.tensor([37 + i for i in range(37)]
                                + [4 * 37 + i for i in range(37)])
    assert torch.equal(ref_prng.normal_at(key, idx), want[[1, 4]].reshape(-1))


def test_noisy_reference_matches_the_ports_engine():
    """Three noisy requests through a 2-slot engine, admitted at ticks 0,
    1 and 3, the third into slot 0 again: the reference draws each one's
    perturbation from its own ticks and slot and reproduces its image;
    without the perturbation, or at the next tick's keys, it does not."""
    drv = common.driver('sd_engine')
    mix = dict(NOISE_MIX, steps=3)
    seed, dev = 11, torch.device('cpu')
    engine = drv._engine(SD, mix, seed, dev)
    reqs = [dict(id=i, seed=100 + i, precision='w8a8+noise')
            for i in range(3)]
    results, eng_tick = {}, []
    for k in range(6):
        if k < 3:
            engine.submit(drv._request(mix, reqs[k]), now=float(k))
        eng_tick.append(engine.metrics.ticks)
        for res in engine.tick(now=float(k)):
            results[res.request_id] = res
    admitted = {e.rid: (int(e.ts), e.slot)
                for e in engine.tracer.select(name='slot_assign')}
    assert admitted == {0: (0, 0), 1: (1, 1), 2: (3, 0)}
    assert sorted(results) == [0, 1, 2]
    slot0 = {0: 0, 1: 1, 2: 2, 3: 0, 4: 1, 5: 2}
    draws = [Draws(drv.noise_seed(seed), ticks, slot,
                   {k: slot0[k] for k in ticks})
             for ticks, slot in (([0, 1, 2], 0), ([1, 2, 3], 1),
                                 ([3, 4, 5], 0))]
    assert list(drv._draws(drv.noise_seed(seed), [0, 1, 2], admitted,
                           eng_tick, 3).values()) == draws
    p = weights.make(drv._spec(SD), seed, 'cpu')
    up, vp = drv._split(p, 'unet.'), drv._split(p, 'vae.')
    ctx = sd_ref.context_rows(seed, 2, 7, 24, 'cpu')[[0, 1, 0]]

    def worst(num):
        want = sd_ref.generate(num, up, vp, SD, [100, 101, 102], ctx, 3,
                               7.5, True, 1, draws)
        return max(sd_ref.image_errors(torch.from_numpy(results[i].image),
                                       want[i])[0] for i in range(3))
    sound = worst(FP32)
    assert sound < NOISE_LIMITS['image_rel_rms'] / 2
    for control in (Numerics(analog=False), Numerics(tick_shift=1)):
        assert worst(control) > 3 * sound


@pytest.mark.parametrize('quant', [False, True])
def test_lm_reference_matches_the_port(quant):
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    arch = common.family('dense').arch_config(LM)
    p = weights.make(lm_ref.param_spec(LM), 5, 'cpu')
    m = weights.install(T.LM(arch, device='meta'), p)
    tok = torch.randint(0, 97, (2, 11), generator=torch.Generator().manual_seed(1))
    ref = lm_ref.logits(FP32, p, LM, tok, quant)
    assert (T.lm_apply(m, arch, tok, quant=quant) - ref).abs().max() < 1e-5
    state = ST.init_serve_state(arch, 2, 17, cache_dtype=torch.float32,
                                device='cpu')
    pre = ST.build_prefill_step(arch, dtype=torch.float32, quant=quant)
    dec = ST.build_decode_step(arch, dtype=torch.float32, quant=quant)
    t, state = pre(m, state, {'tokens': tok.int()})
    out = [t]
    for i in range(5):
        t, state = dec(m, state, t, 11 + i)
        out.append(t)
    served = torch.cat(out, 1)
    full = torch.cat([tok, served[:, :-1]], 1)
    last = lm_ref.logits(FP32, p, LM, full, quant, last=6)
    assert torch.equal(last.argmax(-1).int(), served)
    gaps = common.driver('lm_generate').served_gaps
    assert (gaps(last.reshape(-1, 97), served.reshape(-1)) == 0).all()


# --- runs through the harness, sound and broken ----------------------------

def _run(cell, trace=False, seconds=SD_SECONDS, seed=2 ** 31 + 99):
    line, out = RUN.result(cell, seed, seconds, trace, 'cpu')
    json.dumps(line)                     # the line is plain JSON
    return line, out


@pytest.mark.parametrize('mix', [SD_MIX, POISSON_MIX], ids=['closed',
                                                            'poisson'])
def test_sd_run_is_correct(mix):
    line, out = _run(_cell(SD, mix, SD_LIMITS))
    assert line['correct'], out.checks
    assert out.checks[0].value < SD_LIMITS['image_rel_rms'] / 10
    assert line['metrics']['setup_s']['value'] > 0
    assert list(line)[-1] == 'checks'


@pytest.mark.parametrize('mix', [NOISE_MIX, MIXED_MIX], ids=['noise',
                                                          'mixed'])
def test_sd_noisy_and_mixed_runs_are_correct(mix):
    """A noisy mix, and one whose requests each draw fp32, w8a8 or
    w8a8+noise: the comparison takes each request at its precision."""
    line, out = _run(_cell(SD, mix, NOISE_LIMITS))
    assert line['correct'], out.checks


def test_noise_controls_read_above_the_sound_run():
    """The noisy cell's controls in the program's place (the perturbation
    left out; drawn at the next tick's keys) read well above the program,
    here as on the card."""
    out = common.driver('sd_engine').run(common.Run(
        _cell(SD, NOISE_MIX, NOISE_LIMITS), 7, SD_SECONDS, False, 'cpu',
        {'noise_off': Numerics(analog=False),
         'tick_shift': Numerics(tick_shift=1)}))
    for name in ('noise_off', 'tick_shift'):
        for n, limit in NOISE_LIMITS.items():
            assert out.readings[f'control_{name}_{n}'] > limit
            assert out.readings[f'control_{name}_{n}'] > 3 * out.readings[n]


def test_poisson_run_traces_the_window_s_last_seconds():
    mix = {k: v for k, v in POISSON_MIX.items()
           if k not in ('trace_from_tick', 'trace_ticks')}
    mix['trace_last_s'] = SD_SECONDS / 2
    cell = _cell(SD, mix, SD_LIMITS, {'tick_ms.poisson': 'ms',
                                      'queue_wait_p50_s.poisson': 's'})
    line, out = _run(cell, trace=True)
    assert line['correct'], out.checks
    assert set(line['metrics']) == {'tick_ms.poisson',
                                    'queue_wait_p50_s.poisson'}
    assert 0 < line['device']['window_s'] <= SD_SECONDS / 2 + 1


def test_lm_run_is_correct_and_traced():
    cell = _cell(LM, LM_MIX, LM_LIMITS,
                 {'decode_step_ms.generate': 'ms', 'lm_mfu.generate': '%',
                  'device_idle.generate': '%'})
    line, out = _run(cell, trace=True, seconds=LM_SECONDS)
    assert line['correct'], out.checks
    assert set(line['metrics']) == {'decode_step_ms.generate',
                                    'lm_mfu.generate', 'device_idle.generate'}
    assert line['device']['window_s'] > 0
    assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}


def _unchanged_state(monkeypatch):
    from repro_torch.serving.engine import ContinuousBatchingEngine as E

    def finish(sched, eps, x, x0p, t, t_prev, active):
        return x, x0p, torch.zeros(x.shape[0])
    monkeypatch.setattr(E, '_finish_step', staticmethod(finish))


def _half_batch(monkeypatch):
    from repro_torch.serving.engine import ContinuousBatchingEngine as E
    orig = E._finish_step

    def finish(sched, eps, x, x0p, t, t_prev, active):
        half = active.clone()
        half[x.shape[0] // 2:] = False
        return orig(sched, eps, x, x0p, t, t_prev, half)
    monkeypatch.setattr(E, '_finish_step', staticmethod(finish))


def _altered_answer(monkeypatch):
    from repro_torch.diffusion.pipeline import DiffusionPipeline as P
    orig = P.decode

    def decode(self, z):
        img = orig(self, z).clone()
        img[:, 0, 0, 0] += 1.0
        return img
    monkeypatch.setattr(P, 'decode', decode)


def _noise_dropped(monkeypatch):
    """A noisy projection on the plain W8A8 rule."""
    from repro_torch.core.photonic import noise
    from repro_torch.kernels import ops

    def matmul(key, x, w, *a, **k):
        return ops.w8a8_matmul(x, w)
    monkeypatch.setattr(noise, 'noisy_w8a8_matmul', matmul)


def _tick_key_off_by_one(monkeypatch):
    from repro_torch.serving.engine import ContinuousBatchingEngine as E
    orig = E._tick_key
    monkeypatch.setattr(E, '_tick_key',
                        lambda self, pol, tick: orig(self, pol, tick + 1))


def _slot_offset_dropped(monkeypatch):
    """Every slot draws the perturbation of slot 0's rows."""
    from repro_torch.core.photonic import noise
    orig = noise.noisy_w8a8_matmul

    def matmul(key, x, w, model=noise.NoiseModel(), n_channels=36,
               first_sample=0):
        return torch.cat([orig(key, x[i:i + 1], w, model, n_channels)
                          for i in range(x.shape[0])])
    monkeypatch.setattr(noise, 'noisy_w8a8_matmul', matmul)


NOISE_FAULTS = (_noise_dropped, _tick_key_off_by_one, _slot_offset_dropped)


@pytest.mark.parametrize('fault', [_unchanged_state, _half_batch,
                                   _altered_answer, *NOISE_FAULTS])
def test_sd_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell = _cell(SD, NOISE_MIX, NOISE_LIMITS) if fault in NOISE_FAULTS \
        else _cell(SD, SD_MIX, SD_LIMITS)
    line, _ = _run(cell)
    assert not line['correct']


def _decode_fault(monkeypatch, broken):
    from repro_torch.launch import steps as ST
    orig = ST.build_decode_step

    def build(*a, **k):
        step = orig(*a, **k)

        def decode(params, state, token, pos):
            tok, new = step(params, state, token, pos)
            return broken(token, tok, state, new)
        return decode
    monkeypatch.setattr(ST, 'build_decode_step', build)


def _bf16_cache(state):
    """A cache held a precision lower: every entry rounded to bfloat16."""
    for block in state['cache']:
        for sub in block.values():
            for t in sub.values():
                t.copy_(t.bfloat16())
    return state


LM_FAULTS = {
    'unchanged_state': lambda prev, tok, state, new: (prev, state),
    'half_batch': lambda prev, tok, state, new: (
        torch.cat([tok[:tok.shape[0] // 2],
                   torch.zeros_like(tok[tok.shape[0] // 2:])]), new),
    'altered_token': lambda prev, tok, state, new: ((tok + 1) % 97, new),
    'bf16_cache': lambda prev, tok, state, new: (tok, _bf16_cache(new)),
}


@pytest.mark.parametrize('name', sorted(LM_FAULTS))
def test_lm_faults_are_not_correct(name, monkeypatch):
    _decode_fault(monkeypatch, LM_FAULTS[name])
    line, _ = _run(_cell(LM, LM_MIX, LM_LIMITS), seconds=LM_SECONDS)
    assert not line['correct']


def test_controls_read_above_the_sound_run():
    """The controls (the reference one precision lower, in the program's
    place) read well above what the program reads, here as on the card."""
    drv = common.driver('lm_generate')
    out = drv.run(common.Run(_cell(LM, LM_MIX, LM_LIMITS), 7, LM_SECONDS,
                             False, 'cpu', {'int4': Numerics(qbits=4),
                                            'tf32': Numerics(float_mode='tf32')}))
    assert out.readings['control_int4_served_gap'] > LM_LIMITS['served_gap']
    # the first layer's cache reads the float precision: float32 against
    # float32 agrees to rounding, TF32 does not
    for t in 'kv':
        assert out.readings[f'control_tf32_kv_rel_rms.L0.{t}'] > \
            100 * out.readings[f'kv_rel_rms.L0.{t}'] + 1e-5
    sd = common.driver('sd_engine').run(common.Run(
        _cell(SD, SD_MIX, SD_LIMITS), 7, SD_SECONDS, False, 'cpu',
        {'int4': Numerics(qbits=4)}))
    assert sd.readings['control_int4_image_rel_rms'] > \
        3 * sd.readings['image_rel_rms']


# --- a cell added as files only ---------------------------------------------

#: a model family that exists only as a new file: the dense one, its
#: cache compared under names of its own (the planted difference that
#: shows it was the one run)
NEW_FAMILY = '''
from harness import common

_dense = common.family('dense')
arch_config, param_spec, forward = (_dense.arch_config, _dense.param_spec,
                                    _dense.forward)
prefill_work, decode_work, train_work = (_dense.prefill_work,
                                         _dense.decode_work,
                                         _dense.train_work)
NAMES = {'k': 'key', 'v': 'value'}


def logits(num, p, c, tokens, quant, last=None, kv=None):
    mine = [] if kv is not None else None
    out = _dense.logits(num, p, c, tokens, quant, last, mine)
    if kv is not None:
        kv.extend({NAMES[n]: t for n, t in d.items()} for d in mine)
    return out


def cache_rows(cache, arch, j, T, layers):
    return {i: {NAMES[n]: t for n, t in d.items()}
            for i, d in _dense.cache_rows(cache, arch, j, T, layers).items()}
'''


def test_new_cell_config_mix_and_metric_are_found_by_name(tmp_path,
                                                          monkeypatch):
    for d in ('metrics', 'reference', 'roofline'):
        (tmp_path / d).symlink_to(HERE / d)
    for d in ('workloads', 'configs', 'traffic', 'harness',
              'harness/families'):
        (tmp_path / d).mkdir()
    for f in (HERE / 'harness').iterdir():
        if f.name != 'families':
            (tmp_path / 'harness' / f.name).symlink_to(f)
    (tmp_path / 'harness' / 'families' / 'dense.py').symlink_to(
        HERE / 'harness' / 'families' / 'dense.py')
    (tmp_path / 'harness' / 'families' / 'tiny-family.py').write_text(
        NEW_FAMILY)
    (tmp_path / 'configs' / 'tiny-lm.json').write_text(json.dumps(
        dict(LM, family='tiny-family')))
    (tmp_path / 'traffic' / 'tiny-batches.json').write_text(json.dumps(LM_MIX))
    (tmp_path / 'workloads' / 'tiny-generate.json').write_text(json.dumps({
        'config': 'tiny-lm', 'traffic': 'tiny-batches', 'chips': 1,
        'end_to_end': {'lm_tokens_per_s': 'tokens/s'},
        'per_layer': {'lm_mfu.generate': '%', 'slice_ms.new': 'ms'},
        'limits': LM_LIMITS}))
    metrics = tmp_path / 'new-metrics'
    metrics.mkdir()
    for f in (HERE / 'metrics').glob('*.py'):
        shutil.copy(f, metrics)
    (metrics / 'slice_ms.py').write_text(
        'def read(layers):\n    return 1000.0 * layers.slice.window_s\n')
    (tmp_path / 'metrics').unlink()
    metrics.rename(tmp_path / 'metrics')
    monkeypatch.setattr(common, 'HERE', tmp_path)
    cell = common.Cell.load('tiny-generate')
    line, out = RUN.result(cell, 3, LM_SECONDS, False, 'cpu')
    assert line['correct'] and line['metrics']['lm_tokens_per_s']['value'] > 0
    assert {'kv_rel_rms.L0.key', 'kv_rel_rms.L0.value'} <= set(out.readings)
    assert 'kv_rel_rms.L0.k' not in out.readings
    line, _ = RUN.result(cell, 3, LM_SECONDS, True, 'cpu')
    assert line['metrics']['slice_ms.new']['value'] > 0
    assert 'lm_mfu.generate' in line['metrics']


# --- training ---------------------------------------------------------------

TRAIN_MIX = dict(driver='lm_train', arrivals='train', rows=2, seq_len=32,
                 adamw=dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                            weight_decay=0.1, grad_clip=1.0,
                            warmup_steps=100, total_steps=10000,
                            min_lr_frac=0.1),
                 trace_from_step=1, trace_steps=2)
TRAIN_LIMITS = {'loss_gap': 1e-4, 'grad_gap': 1e-3, 'update_gap': 1e-2}


def test_train_run_is_correct_and_traced():
    cell = _cell(dict(LM, remat='full'), TRAIN_MIX, TRAIN_LIMITS,
                 {'train_mfu.train': '%', 'device_idle.train': '%'})
    line, out = _run(cell, seconds=TRAIN_SECONDS)
    assert line['correct'], out.checks
    assert all(c.value < c.limit / 10 for c in out.checks)
    line, _ = _run(cell, trace=True, seconds=TRAIN_SECONDS)
    assert 'train_mfu.train' in line['metrics']


def _frozen_step(monkeypatch):
    from repro_torch.launch import steps as ST

    def update(cfg, grads, state, params):
        return params, state, torch.zeros(())
    monkeypatch.setattr(ST, 'adamw_update', update)


def _half_rows(monkeypatch):
    from repro_torch.launch import steps as ST
    orig = ST.train_loss

    def loss(model, cfg, batch, *a, **k):
        half = {n: t[:t.shape[0] // 2] for n, t in batch.items()}
        return orig(model, cfg, half, *a, **k)
    monkeypatch.setattr(ST, 'train_loss', loss)


@pytest.mark.parametrize('fault', [_frozen_step, _half_rows])
def test_train_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line, _ = _run(_cell(dict(LM, remat='full'), TRAIN_MIX, TRAIN_LIMITS),
                   seconds=TRAIN_SECONDS)
    assert not line['correct']
