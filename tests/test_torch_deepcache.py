"""The port's DeepCache pass, noisy pipeline and serving engine against the
reference, from the same parameters (``bridge.load_jax_params``) and the
same seeds: the port draws the reference's initial noise and analog noise
(``core/prng``), so images compare directly.

Tolerances: fp32 1e-4 (float32 convolutions summed in another order,
~1e-6 per layer); w8a8 and w8a8+noise 1e-3 (a ~1e-7 difference can move
one int8 rounding at a tie, worth one LSB; the noise draws agree to
``prng.NORMAL_RTOL``).  The engine's images, early-exited x0 predictions
among them, hold the w8a8 tolerance (measured 1.5e-4).  Eval tallies,
exits and energies are exact (energy to 1e-12 relative).

The paper's noise model moves a tiny-width image by about 1e-3 (another
seed: 2.2e-3 through ``generate``, 0.9e-3 and 2.0e-3 through the engine),
too little for the 1e-3 tolerance to tell a wrong key chain from the
right one.  So the key chain is also held under an amplified model, the
paper's with every sigma thirty times larger: the right chain stays
within the tolerance there (measured 2.3e-4), and each wrong one
(another noise seed; a fold dropped or added; the tick index shifted)
must move a noisy image by ``WRONG_CHAIN_MARGIN`` times it (measured
6.5e-3 to 6.5e-2).  With caching off (every step through the engine's
``_step``, whose keys fold in slot 0's timestep) the right chain measured
1.0e-4 under the paper's model and 1.1e-4 under the amplified one;
folding in slot 1's timestep instead moved the noisy images that shared
a tick with another timestep by 1.4e-2 to 3.2e-2."""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.photonic.noise import NoiseModel as JNoise
from repro.core.precision import PrecisionPolicy as JP
from repro.diffusion import deepcache as jdc
from repro.diffusion.pipeline import DiffusionPipeline as JPipe
from repro.diffusion.schedule import linear_schedule
from repro.models import unet as ju
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import GenerationRequest as JReq
from repro_torch.bridge import load_jax_params
from repro_torch.core import precision as tprecision
from repro_torch.core import prng
from repro_torch.core.photonic.noise import NoiseModel as TNoise
from repro_torch.core.precision import PrecisionPolicy as TP
from repro_torch.diffusion import deepcache as tdc
from repro_torch.diffusion import pipeline as tpipeline
from repro_torch.diffusion.pipeline import DiffusionPipeline as TPipe
from repro_torch.models import unet as tu
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import GenerationRequest as TReq
from repro_torch.serving import engine as tengine

JCFG = ju.UNetConfig('tiny-sdm', img_size=16, in_ch=3, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(16,),
                     n_heads=4, timesteps=16, context_dim=8)
TCFG = tu.UNetConfig(**vars(JCFG))
POLICIES = {'fp32': (JP.fp32(), 'fp32', 1e-4),
            'w8a8': (JP.w8a8(), 'w8a8', 1e-3),
            'w8a8+noise': (JP.w8a8_noise(noise_seed=3), None, 1e-3)}
ENGINE_ATOL = 1e-3
WRONG_CHAIN_MARGIN = 5
# the paper's model (None: the default) and one thirty times as loud, in
# each package's NoiseModel (crosstalk +30 dB: its sigma times 31.6)
_LOUD = dict(sigma_w_lsb=9.0, sigma_x_lsb=6.0, sigma_pd_lsb=15.0,
             crosstalk_db_per_channel=2.0)
NOISE = {'paper': (None, None), 'amplified': (JNoise(**_LOUD),
                                              TNoise(**_LOUD))}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope='module')
def jpipe():
    params = jax.jit(lambda k: ju.init_unet(k, JCFG))(jax.random.PRNGKey(0))
    return JPipe(JCFG, params, linear_schedule(JCFG.timesteps))


@pytest.fixture(scope='module')
def tpipe(jpipe):
    pipe = TPipe.init(0, TCFG, device='cpu')
    load_jax_params(pipe.unet, jax.tree_util.tree_map(np.asarray,
                                                      jpipe.unet_params))
    return pipe


def _noisy_pols(noise='paper', noise_seed=3):
    """The w8a8+noise policy of each package under one noise model."""
    jm, tm = NOISE[noise]
    return (JP.w8a8_noise(model=jm, noise_seed=noise_seed),
            TP.w8a8_noise(model=tm, noise_seed=noise_seed))


def _tpol(name):
    return POLICIES[name][1] or _noisy_pols()[1]


def _prng_folding(fold_in):
    """``core/prng`` as a module sees it, with ``fold_in`` replaced: the
    means of altering one link of a key chain."""
    return types.SimpleNamespace(
        Key=prng.Key, PRNGKey=prng.PRNGKey, split=prng.split,
        normal=prng.normal, fold_in=fold_in)


def _fold_only_into(anchor):
    """A ``fold_in`` that folds only into ``anchor`` and leaves every
    other key as it is."""
    return lambda key, data: prng.fold_in(key, data) if key == anchor \
        else key


def _fold_dropping(which):
    """A ``fold_in`` for the pipeline's key chain, which folds in pairs
    (the timestep, then the branch): it drops link ``which`` (0 or 1) of
    every pair."""
    calls = itertools.count()
    return lambda key, data: key if next(calls) % 2 == which \
        else prng.fold_in(key, data)


def _assert_moved(got, want, what):
    gap = float(np.abs(got - np.asarray(want)).max())
    assert gap > WRONG_CHAIN_MARGIN * ENGINE_ATOL, (what, gap)


@pytest.mark.parametrize('policy', sorted(POLICIES))
@pytest.mark.parametrize('with_context', [True, False])
def test_unet_apply_cached_refresh_and_skip_match_reference(
        jpipe, tpipe, policy, with_context):
    """The refresh pass (eps and the cache it returns) and a skip pass
    splicing in a given cache, on the same inputs and noise key.  Level 0
    of this config has attention, so a skip pass draws noise too."""
    jpol, _, atol = POLICIES[policy]
    x = _np((2, 16, 16, 3), 1)
    t = np.array([3, 11], np.int32)
    ctx = _np((2, 5, 8), 2) if with_context else None
    cache = _np((2, 16, 16, 64), 3)
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    for refresh in (True, False):
        fn = jax.jit(lambda p, xx, tt, cc, cx: jdc.unet_apply_cached(
            p, JCFG, xx, tt, cc, refresh, cx, jpol,
            noise_key=jax.random.PRNGKey(9)))
        je, jc = fn(jpipe.unet_params, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(cache), jctx)
        with torch.no_grad():
            te, tc = tdc.unet_apply_cached(
                tpipe.unet, TCFG, torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(cache), refresh, tctx, _tpol(policy),
                noise_key=prng.PRNGKey(9))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=atol)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol)
        if not refresh:
            np.testing.assert_array_equal(tc.numpy(), cache)


def test_noisy_forward_draws_per_projection_keys(tpipe):
    """Under a noisy policy each projection draws from its own key: the
    same key reproduces the output, another key moves it, and the noise-
    free w8a8 output differs from both."""
    x = torch.from_numpy(_np((1, 16, 16, 3), 4))
    t = torch.tensor([5])
    ctx = torch.from_numpy(_np((1, 5, 8), 5))
    pol = _tpol('w8a8+noise')
    with torch.no_grad():
        a = tpipe.unet(x, t, ctx, pol, prng.PRNGKey(1))
        b = tpipe.unet(x, t, ctx, pol, prng.PRNGKey(1))
        c = tpipe.unet(x, t, ctx, pol, prng.PRNGKey(2))
        q = tpipe.unet(x, t, ctx, 'w8a8')
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, q)


@pytest.fixture(scope='module')
def reference_generate(jpipe):
    """The reference's ``generate`` for seed 21 under a policy name (and a
    noise model for w8a8+noise), memoised; and its context."""
    ctx = _np((1, 5, 8), 6)
    memo = {}

    def get(policy, guidance, noise='paper'):
        if (policy, guidance, noise) not in memo:
            jpol = _noisy_pols(noise)[0] if policy == 'w8a8+noise' \
                else POLICIES[policy][0]
            with jax.threefry_partitionable(True):
                memo[policy, guidance, noise] = np.asarray(jpipe.generate(
                    jax.random.PRNGKey(21), batch=1, steps=3,
                    context=jnp.asarray(ctx), guidance=guidance,
                    policy=jpol))
        return memo[policy, guidance, noise]
    return ctx, get


@pytest.mark.parametrize('policy,guidance,noise',
                         [('fp32', 0.0, 'paper'),
                          ('w8a8+noise', 2.5, 'paper'),
                          ('w8a8+noise', 2.5, 'amplified')])
def test_generate_matches_reference(tpipe, reference_generate, policy,
                                    guidance, noise):
    """``generate`` from a seed: the same initial noise and, under the
    noisy policy, the per-evaluation keys fold in the timestep and the
    guidance branch as the reference's do."""
    ctx, reference = reference_generate
    atol = POLICIES[policy][2]
    pol = _noisy_pols(noise)[1] if policy == 'w8a8+noise' else policy
    got = tpipe.generate(21, batch=1, steps=3, context=torch.from_numpy(ctx),
                         guidance=guidance, policy=pol)
    np.testing.assert_allclose(got.numpy(),
                               reference(policy, guidance, noise), atol=atol)


@pytest.mark.parametrize('wrong', ['other_seed', 'timestep_unfolded',
                                   'branch_unfolded'])
def test_generate_tolerance_fails_a_wrong_key_chain(
        tpipe, reference_generate, monkeypatch, wrong):
    """Under the amplified noise model, the port's ``generate`` with
    another noise seed, without the timestep fold or without the branch
    fold moves the image far beyond the tolerance that
    ``test_generate_matches_reference`` holds the right chain to."""
    ctx, reference = reference_generate
    seed = 4 if wrong == 'other_seed' else 3
    if wrong != 'other_seed':
        monkeypatch.setattr(tpipeline, 'prng', _prng_folding(
            _fold_dropping(0 if wrong == 'timestep_unfolded' else 1)))
    got = tpipe.generate(21, batch=1, steps=3, context=torch.from_numpy(ctx),
                         guidance=2.5,
                         policy=_noisy_pols('amplified', seed)[1])
    _assert_moved(got.numpy(), reference('w8a8+noise', 2.5, 'amplified'),
                  wrong)


# the request sequence both engines serve: a cached guided fp32 request,
# a cached noisy one, a w8a8 one opting out of caching, early exit on for
# some and off (exit_tol 0) for one, one admitted mid-flight (held for
# the cadence's phase 0)
SEQ = [dict(request_id=0, seed=31, steps=8, guidance=2.5),
       dict(request_id=1, seed=32, steps=7, precision='w8a8+noise'),
       dict(request_id=2, seed=33, steps=6, precision='w8a8',
            cache_interval=1),
       dict(request_id=3, seed=34, steps=5, precision='w8a8+noise',
            guidance=2.5, exit_tol=0.0)]
LATE = {1: [3]}                    # tick -> requests submitted before it


# the uncached sequence (caching off, so every step goes through the
# engine's ``_step`` and its ``t_first``): noisy requests, one guided,
# the one in slot 0 draining after 2 steps so that a request two steps
# behind the others takes slot 0.  The guided request outlasts the rest,
# so every tick runs the one guided step (one compile of the reference's)
SEQ_UNCACHED = [dict(request_id=0, seed=41, steps=2,
                     precision='w8a8+noise'),
                dict(request_id=1, seed=42, steps=6, precision='w8a8+noise',
                     guidance=2.5),
                dict(request_id=2, seed=43, steps=4, precision='w8a8+noise'),
                dict(request_id=3, seed=44, steps=3, precision='w8a8+noise')]
LATE_UNCACHED = {1: [3]}


def _serve(engine, make_req, slots=3, seq=SEQ, late=LATE):
    results, now = [], 0.0
    for r in seq[:slots]:
        assert engine.submit(make_req(**r), now=now)
    for k in range(100):
        for i in late.get(k, ()):
            assert engine.submit(make_req(**seq[i]), now=now)
        results.extend(engine.tick(now=now))
        now += 1.0
        if not engine.busy and k >= max(late):
            return {r.request_id: r for r in results}
    raise AssertionError('engine did not drain')


ENGINE_KW = dict(slots=3, cache_interval=3, exit_tol=0.01, exit_patience=2,
                 noise_seed=5, quality_probe=0)
NOISY = [i for i, r in enumerate(SEQ) if r.get('precision') == 'w8a8+noise']
GUIDED_NOISY = [i for i in NOISY if SEQ[i].get('guidance', 0.0) > 0.0]
# each engine run: (engine keywords, request sequence, late submissions)
RUNS = {'cached': (ENGINE_KW, SEQ, LATE),
        'uncached': (dict(ENGINE_KW, cache_interval=1, exit_tol=None),
                     SEQ_UNCACHED, LATE_UNCACHED)}


@pytest.fixture(scope='module')
def engine_ctx():
    return _np((3, 5, 8), 7)


@pytest.fixture(scope='module')
def reference_engine(jpipe, engine_ctx):
    """The JAX engine after a run of ``RUNS`` (default: serving ``SEQ``)
    under a noise model, and its results by id, memoised.  (The
    reference's engine takes the model; the port's serves the default
    one, see ``_port_engine``.)"""
    memo = {}

    def get(noise, run='cached'):
        if (noise, run) not in memo:
            kw, seq, late = RUNS[run]
            with jax.threefry_partitionable(True):
                jeng = JEngine(jpipe, context=jnp.asarray(engine_ctx),
                               noise_model=NOISE[noise][0], **kw)
                memo[noise, run] = jeng, _serve(jeng, JReq, seq=seq,
                                                late=late)
        return memo[noise, run]
    return get


def _port_engine(tpipe, ctx, noise, monkeypatch, **kw):
    """The port's engine over ``ctx``, its noisy policy under ``noise``:
    the engine builds that policy with ``NoiseModel()``, so the amplified
    model stands in for the default while it runs."""
    if noise == 'amplified':
        monkeypatch.setattr(tprecision, 'NoiseModel',
                            lambda: NOISE['amplified'][1])
    return TEngine(tpipe, context=ctx if ctx is None else
                   torch.from_numpy(ctx), **kw)


@pytest.mark.parametrize('noise,run', [
    ('amplified', 'cached'), ('paper', 'cached'),
    ('amplified', 'uncached'), ('paper', 'uncached')],
    ids=['amplified', 'paper', 'amplified-uncached', 'paper-uncached'])
def test_engine_matches_reference_engine(tpipe, engine_ctx,
                                         reference_engine, noise, run,
                                         monkeypatch):
    """DeepCache phasing, early exit, w8a8+noise and guidance together,
    through both engines on the same request sequence: the same images,
    eval tallies, exits and energies.  The uncached run holds the noisy
    ``_step`` path (slot 0's timestep folded into each key) against the
    reference."""
    jeng, want = reference_engine(noise, run)
    kw, seq, late = RUNS[run]
    teng = _port_engine(tpipe, engine_ctx, noise, monkeypatch, **kw)
    got = _serve(teng, TReq, seq=seq, late=late)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid, w in want.items():
        g = got[rid]
        assert (g.steps_executed, g.full_evals, g.cached_evals,
                g.early_exit) == (w.steps_executed, w.full_evals,
                                  w.cached_evals, w.early_exit), rid
        assert g.energy_j == pytest.approx(w.energy_j, rel=1e-12)
        assert g.epb_pj == pytest.approx(w.epb_pj, rel=1e-12)
        np.testing.assert_allclose(g.image, np.asarray(w.image),
                                   atol=ENGINE_ATOL, err_msg=str(rid))
    # the sequence exercises what it claims to
    if run == 'cached':
        assert any(r.early_exit for r in want.values())
        assert not want[3].early_exit and want[3].cached_evals > 0
        assert want[2].cached_evals == 0
    else:
        assert not any(r.early_exit or r.cached_evals for r in want.values())
        # the late request took slot 0 one tick behind the others
        assert want[0].finish_time == 1.0 and want[3].start_time == 2.0
    js, ts = jeng.metrics.snapshot(), teng.metrics.snapshot()
    for f in ('ticks', 'unet_steps', 'full_steps', 'cached_steps',
              'mixed_ticks', 'early_exits', 'steps_saved'):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.total_energy_j == pytest.approx(js.total_energy_j, rel=1e-12)


@pytest.mark.parametrize('wrong', ['other_seed', 'tick_shifted',
                                   'branch_unfolded', 'timestep_folded'])
def test_engine_tolerance_fails_a_wrong_key_chain(
        tpipe, engine_ctx, reference_engine, monkeypatch, wrong):
    """Under the amplified noise model, the port's engine serving ``SEQ``
    with another noise seed, with the tick index shifted by one, with the
    unconditional pass on the conditional key, or with the cached path
    folding the timestep in (as the uncached pipeline does): each noisy
    image the change reaches (the unconditional key only the guided ones)
    moves far beyond the tolerance the parity test holds it to."""
    _, want = reference_engine('amplified')
    kw = dict(ENGINE_KW)
    anchor = prng.PRNGKey(kw['noise_seed'])
    if wrong == 'other_seed':
        kw['noise_seed'] += 1
    elif wrong == 'tick_shifted':
        tick_key = TEngine._tick_key
        monkeypatch.setattr(TEngine, '_tick_key',
                            lambda self, pol, i: tick_key(self, pol, i + 1))
    elif wrong == 'branch_unfolded':
        monkeypatch.setattr(tengine, 'prng',
                            _prng_folding(_fold_only_into(anchor)))
    else:
        cached = tengine.unet_apply_cached

        def folding_t(unet, cfg, x, t, *a, noise_key=None, **kw):
            if noise_key is not None:
                noise_key = prng.fold_in(noise_key, int(t[0]))
            return cached(unet, cfg, x, t, *a, noise_key=noise_key, **kw)
        monkeypatch.setattr(tengine, 'unet_apply_cached', folding_t)
    teng = _port_engine(tpipe, engine_ctx, 'amplified', monkeypatch, **kw)
    got = _serve(teng, TReq)
    for rid in GUIDED_NOISY if wrong == 'branch_unfolded' else NOISY:
        _assert_moved(got[rid].image, want[rid].image, (wrong, rid))


def test_uncached_engine_tolerance_fails_a_wrong_t_first(
        tpipe, engine_ctx, reference_engine, monkeypatch):
    """Under the amplified noise model, the port's engine serving the
    uncached sequence with each step's key folding in slot 1's timestep
    instead of slot 0's moves every noisy image that shared a tick with
    a slot 0 at another timestep far beyond the parity tolerance."""
    _, want = reference_engine('amplified', 'uncached')
    step = TEngine._step

    def other_slot(self, sh, pol, guided, t, t_prev, active, guidance, key,
                   t_first):
        return step(self, sh, pol, guided, t, t_prev, active, guidance, key,
                    int(t[1]))
    monkeypatch.setattr(TEngine, '_step', other_slot)
    kw, seq, late = RUNS['uncached']
    teng = _port_engine(tpipe, engine_ctx, 'amplified', monkeypatch, **kw)
    got = _serve(teng, TReq, seq=seq, late=late)
    for rid in (1, 2, 3):
        _assert_moved(got[rid].image, want[rid].image, ('t_first', rid))


def test_noisy_engine_is_deterministic_under_its_seed(tpipe, monkeypatch):
    """Two engines with one noise seed give identical noisy images; another
    seed gives others (under the amplified model, by the margin of a wrong
    key chain); the fp32 request beside them is untouched."""
    def run(seed):
        eng = _port_engine(tpipe, None, 'amplified', monkeypatch, slots=2,
                           noise_seed=seed, quality_probe=0)
        for r in (TReq(0, seed=1, steps=3, precision='w8a8+noise'),
                  TReq(1, seed=2, steps=3)):
            eng.submit(r, now=0.0)
        return {r.request_id: r.image for r in eng.run_until_idle(now=0.0)}
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a[0], b[0])
    _assert_moved(c[0], a[0], 'seed 1 vs 0')
    np.testing.assert_array_equal(a[1], c[1])
