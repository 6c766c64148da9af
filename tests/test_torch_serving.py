"""The port's serving engine against the port's standalone pipeline (the
engine and ``DiffusionPipeline.generate`` draw a request's initial noise
the same way, so a served request must equal its own batch-1 run), as
the reference's ``tests/test_serving.py`` holds its engine; the DeepCache
and early-exit scheduler as the reference's ``tests/test_cache_serving.py``
holds its own; plus the host-side queue/batcher/metrics."""
import numpy as np
import pytest
import torch

from repro_torch.diffusion.pipeline import DiffusionPipeline
from repro_torch.models.autoencoder import VAEConfig
from repro_torch.models.unet import UNetConfig
from repro_torch.serving import (AdmissionQueue, ContinuousBatchingEngine,
                                 GenerationRequest, PhotonicAccountant,
                                 group_by_precision, plan_tick,
                                 split_cache_phase)

TINY = UNetConfig('tiny-serve', img_size=16, in_ch=3, base_ch=32,
                  ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                  n_heads=4, timesteps=16)
TINY_SD = UNetConfig('tiny-sdm', img_size=16, in_ch=3, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                     n_heads=4, timesteps=16, context_dim=8)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def pipe():
    return DiffusionPipeline.init(0, TINY, device='cpu')


def _drive(engine, submits, max_ticks=200):
    """Logical-clock loop: ``submits`` maps tick index -> requests."""
    results, now = [], 0.0
    for k in range(max_ticks):
        for req in submits.get(k, ()):
            assert engine.submit(req, now=now)
        results.extend(engine.tick(now=now))
        now += 1.0
        if not engine.busy and all(t <= k for t in submits):
            return results
    raise AssertionError('engine did not drain')


def test_mixed_timestep_equals_sequential_sampling(pipe):
    """Staggered requests with different step counts, multiplexed through
    shared mixed-timestep steps, match per-request DDIM at 1e-5 (float32
    rounding of batch-4 vs batch-1 convolutions)."""
    engine = ContinuousBatchingEngine(pipe, slots=3)
    reqs = [GenerationRequest(i, seed=100 + i, steps=s)
            for i, s in enumerate([3, 5, 4, 2])]
    engine.submit(reqs[0], now=0.0)
    engine.tick(now=0.0)
    engine.tick(now=0.0)
    # the per-slot x0 movement of the last step: positive where a slot
    # stepped, zero where none is active
    assert float(engine.delta[0]) > 0
    assert float(engine.delta[1:].abs().max()) == 0
    engine = ContinuousBatchingEngine(pipe, slots=3)
    results = _drive(engine, {0: reqs[:2], 1: [reqs[2]], 3: [reqs[3]]})
    assert sorted(r.request_id for r in results) == [0, 1, 2, 3]
    for r in results:
        ref = pipe.generate(100 + r.request_id, batch=1, steps=r.steps)
        np.testing.assert_allclose(r.image, ref[0].numpy(), atol=1e-5)
        # priced by the photonic accountant: fp32 at the GPU anchor
        want = PhotonicAccountant(TINY).energy(r.steps, precision='fp32')
        assert (r.energy_j, r.epb_pj) == want and r.energy_j > 0


def test_engine_guided_slots_match_pipeline_guidance():
    """A guided and an unguided request sharing ticks each match their
    sequential counterpart."""
    p = DiffusionPipeline.init(0, TINY_SD, device='cpu')
    ctx1 = torch.randn((1, 4, 8), generator=torch.Generator().manual_seed(9))
    engine = ContinuousBatchingEngine(p, slots=2, context=ctx1.repeat(2, 1, 1))
    reqs = [GenerationRequest(0, seed=11, steps=3, guidance=2.5),
            GenerationRequest(1, seed=12, steps=3)]
    for r in _drive(engine, {0: reqs}):
        req = reqs[r.request_id]
        ref = p.generate(req.seed, batch=1, steps=req.steps, context=ctx1,
                         guidance=req.guidance)
        np.testing.assert_allclose(r.image, ref[0].numpy(), atol=1e-5)


def test_engine_with_vae_matches_pipeline():
    vae = VAEConfig(img_size=16, in_ch=3, z_ch=4, base_ch=16,
                    ch_mults=(1, 2), groups=8)
    unet = UNetConfig('tiny-ldm', img_size=8, in_ch=4, base_ch=32,
                      ch_mults=(1, 2), n_res_blocks=1,
                      attn_resolutions=(4,), n_heads=4, timesteps=16,
                      latent=True)
    p = DiffusionPipeline.init(0, unet, vae, device='cpu')
    engine = ContinuousBatchingEngine(p, slots=2)
    results = _drive(engine, {0: [GenerationRequest(0, seed=7, steps=3)]})
    ref = p.generate(7, batch=1, steps=3)
    assert results[0].image.shape == (16, 16, 3)
    np.testing.assert_allclose(results[0].image, ref[0].numpy(), atol=1e-5)


def test_w8a8_engine_matches_standalone_w8a8(pipe):
    """w8a8 through the engine matches the standalone w8a8 pipeline to
    ~1 LSB (atol 1e-3): per-row activation scales keep batch rows
    independent, but a ~1e-7 float difference between the slot-batch and
    batch-1 convolutions can move one int8 rounding at a tie.  And the
    request really ran the quantized path: it is closer to the w8a8
    reference than to fp32, and carries the fp32 quality probe."""
    engine = ContinuousBatchingEngine(pipe, slots=2)
    reqs = [GenerationRequest(i, seed=40 + i, steps=s, precision='w8a8')
            for i, s in enumerate([3, 5, 2])]
    results = _drive(engine, {0: reqs[:2], 2: [reqs[2]]})
    assert sorted(r.request_id for r in results) == [0, 1, 2]
    for r in results:
        ref = pipe.generate(40 + r.request_id, steps=r.steps, policy='w8a8')
        np.testing.assert_allclose(r.image, ref[0].numpy(), atol=1e-3)
        fp = pipe.generate(40 + r.request_id, steps=r.steps)
        d_quant = float(np.abs(r.image - ref[0].numpy()).max())
        d_fp32 = float(np.abs(r.image - fp[0].numpy()).max())
        assert d_quant < d_fp32
        assert r.precision == 'w8a8' and r.policy.quantized
        assert r.quality_psnr_db is not None and r.quality_psnr_db > 10
    front = engine.metrics.snapshot().frontier['w8a8']
    assert front['completed'] == 3 and front['probed'] == 3


def test_mixed_precision_ticks_group_by_precision(pipe):
    """fp32 and w8a8 requests side by side: one masked step per precision
    group per tick, each request equal to its own standalone run."""
    engine = ContinuousBatchingEngine(pipe, slots=3, quality_probe=0)
    engine.warmup(precisions=('fp32', 'w8a8'))
    assert engine.metrics.submitted == 0          # warmup left no trace
    reqs = [GenerationRequest(i, seed=60 + i, steps=2 + (i % 2),
                              precision=('fp32', 'w8a8')[i % 2])
            for i in range(4)]
    results = _drive(engine, {0: reqs[:3], 1: reqs[3:]})
    assert len(results) == 4
    for r in results:
        ref = pipe.generate(60 + r.request_id, steps=r.steps,
                            policy=r.precision)
        tol = 1e-3 if r.precision == 'w8a8' else 1e-5
        np.testing.assert_allclose(r.image, ref[0].numpy(), atol=tol)
        assert r.quality_psnr_db is None              # probe disabled


@pytest.mark.parametrize('kwargs', [
    {'precision': 'w8a8+noise'},
    {'cache_interval': 3},
    {'exit_tol': 0.5},
])
def test_requests_of_every_kind_are_served(pipe, kwargs):
    """Each request kind of the serving features (a noisy precision,
    DeepCache participation, early exit) is admitted and completes, with
    nonzero photonic energy."""
    engine = ContinuousBatchingEngine(pipe, slots=1, cache_interval=3,
                                      quality_probe=0)
    assert engine.submit(GenerationRequest(0, seed=0, steps=4, **kwargs),
                         now=0.0)
    (r,) = engine.run_until_idle(now=0.0)
    assert not engine.busy and engine.metrics.completed == 1
    assert np.isfinite(r.image).all() and r.energy_j > 0
    assert r.steps_executed == r.full_evals + r.cached_evals
    if 'exit_tol' in kwargs:
        assert r.early_exit and r.steps_executed < 4
    if 'cache_interval' in kwargs:
        assert (r.full_evals, r.cached_evals) == (2, 2)


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        DiffusionPipeline.init(0, TINY)


def test_deadline_expiry_sheds_before_admission(pipe):
    """A queued request whose SLO passed is shed at admission, never
    occupying a slot; the shed is tallied by cause."""
    engine = ContinuousBatchingEngine(pipe, slots=1,
                                      queue=AdmissionQueue(max_depth=4))
    engine.submit(GenerationRequest(0, seed=1, steps=2), now=0.0)
    engine.submit(GenerationRequest(1, seed=2, steps=2, slo_ms=500.0),
                  now=0.0)
    done = engine.run_until_idle(now=0.0, tick_dt=1.0)
    assert [r.request_id for r in done] == [0]
    snap = engine.metrics.snapshot()
    assert snap.shed == 1 and snap.shed_by_reason == {'expired': 1}
    assert snap.completed == 1 and snap.ticks == 2


def test_plan_tick_orders_precision_groups():
    precisions = ['w8a8', None, 'fp32', 'w8a8']
    groups = group_by_precision(precisions)
    assert sorted(groups) == ['fp32', 'w8a8']
    np.testing.assert_array_equal(groups['w8a8'], [True, False, False, True])
    plan = plan_tick(precisions, np.ones(4, bool), caching=False)
    assert [(name, refresh) for name, refresh, _ in plan] == [
        ('fp32', True), ('w8a8', True)]
    np.testing.assert_array_equal(plan[0][2], [False, False, True, False])
    assert plan_tick([None, None], np.ones(2, bool), caching=False) == []
    # with caching each group splits into its refresh and skip slots
    plan = plan_tick(precisions, np.array([True, True, False, False]),
                     caching=True)
    assert [(name, refresh, m.tolist()) for name, refresh, m in plan] == [
        ('fp32', False, [False, False, True, False]),
        ('w8a8', True, [True, False, False, False]),
        ('w8a8', False, [False, False, False, True])]


def test_split_cache_phase():
    r, s = split_cache_phase(np.array([True, True, False, True]),
                             np.array([True, False, True, False]))
    assert r.tolist() == [True, False, False, False]
    assert s.tolist() == [False, True, False, True]


# -- DeepCache phasing and early exit (the reference's
#    tests/test_cache_serving.py, on the port's engine) --------------------

def _req(i, steps=7, **kw):
    return GenerationRequest(request_id=i, seed=100 + i, steps=steps, **kw)


def test_cached_engine_follows_the_shared_cadence(pipe):
    """Every skip tick is whole-batch (phase alignment) and per-request
    eval counts follow the cadence: interval 3 from phase 0 refreshes at
    ticks 0, 3, 6."""
    eng = ContinuousBatchingEngine(pipe, slots=4, cache_interval=3,
                                   quality_probe=0)
    for i in range(4):
        eng.submit(_req(i, steps=7), now=0.0)
    results = eng.run_until_idle(now=0.0)
    assert len(results) == 4
    for r in results:
        assert (r.full_evals, r.cached_evals, r.steps_executed) == (3, 4, 7)
        assert not r.early_exit and np.isfinite(r.image).all()
    snap = eng.metrics.snapshot()
    assert snap.mixed_ticks == 0
    assert (snap.full_steps, snap.cached_steps) == (12, 16)
    assert snap.cache_hit_rate == pytest.approx(16 / 28)


def test_opt_out_matches_plain_engine(pipe):
    """A request opting out of caching (``cache_interval=1``) on a caching
    engine takes only full passes and equals the plain engine's image."""
    eng = ContinuousBatchingEngine(pipe, slots=2, cache_interval=3,
                                   quality_probe=0)
    eng.submit(_req(0, steps=5, cache_interval=1), now=0.0)
    (r,) = eng.run_until_idle(now=0.0)
    plain = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0)
    plain.submit(_req(0, steps=5), now=0.0)
    (p,) = plain.run_until_idle(now=0.0)
    assert (r.full_evals, r.cached_evals) == (5, 0)
    np.testing.assert_array_equal(r.image, p.image)


def test_phase_aligned_admission_mid_flight(pipe):
    """A request arriving mid-cadence waits for the next refresh tick, and
    the cadence re-anchors once no cached slot is active."""
    eng = ContinuousBatchingEngine(pipe, slots=2, cache_interval=3,
                                   quality_probe=0)
    eng.submit(_req(0, steps=6), now=0.0)
    eng.tick(now=0.0)                       # phase 0 -> 1
    eng.submit(_req(1, steps=3), now=1.0)
    eng.tick(now=1.0)                       # held: phase 1
    assert eng.active_count == 1 and len(eng.queue) == 1
    eng.tick(now=2.0)                       # held: phase 2
    assert eng.active_count == 1
    eng.tick(now=3.0)                       # phase 0: admitted
    assert eng.active_count == 2
    done = {r.request_id: r for r in eng.run_until_idle(now=4.0)}
    assert (done[1].full_evals, done[1].cached_evals) == (1, 2)
    assert eng.metrics.snapshot().mixed_ticks == 0
    eng.submit(_req(2, steps=2), now=9.0)   # idle engine: re-anchored
    eng.tick(now=9.0)
    assert eng.active_count == 1


def test_early_exit_drains_converged_slots(pipe):
    """A loose tolerance drains a slot at ``EXIT_MIN_STEPS`` +
    ``exit_patience`` - 1 steps with its x0 prediction; the freed slot is
    refilled; steps saved and early exits are tallied."""
    eng = ContinuousBatchingEngine(pipe, slots=1, exit_tol=10.0,
                                   exit_patience=2, quality_probe=0)
    eng.submit(_req(0, steps=8), now=0.0)
    eng.submit(_req(1, steps=8, exit_tol=0.0), now=0.0)
    done = {r.request_id: r for r in eng.run_until_idle(now=0.0)}
    assert done[0].early_exit and done[0].steps_executed == 3
    assert not done[1].early_exit and done[1].steps_executed == 8
    snap = eng.metrics.snapshot()
    assert snap.early_exits == 1 and snap.steps_saved == 5
    assert snap.steps_saved_hist == {5: 1, 0: 1}
    # the committed image is the x0 prediction, not the noisy latent
    assert np.abs(done[0].image).max() < 10


def test_exit_tol_zero_disables_early_exit(pipe):
    eng = ContinuousBatchingEngine(pipe, slots=1, exit_tol=0.0,
                                   quality_probe=0)
    eng.submit(_req(0, steps=4), now=0.0)
    (r,) = eng.run_until_idle(now=0.0)
    assert not r.early_exit and r.steps_executed == 4


def test_skip_ticks_billed_shallow(pipe):
    """Energy follows the request's own full/cached tallies: a cached
    request costs less than the same steps at full passes."""
    acc = PhotonicAccountant(TINY)
    eng = ContinuousBatchingEngine(pipe, slots=1, cache_interval=3,
                                   quality_probe=0)
    eng.submit(_req(0, steps=6, precision='w8a8'), now=0.0)
    (r,) = eng.run_until_idle(now=0.0)
    assert (r.full_evals, r.cached_evals) == (2, 4)
    assert (r.energy_j, r.epb_pj) == acc.energy_evals(2, 4,
                                                       precision='w8a8')
    assert r.energy_j < acc.energy(6, precision='w8a8')[0]
    assert 0 < acc.shallow_fraction < 1


def test_probe_covers_cached_and_early_exited_requests(pipe):
    """Cached or early-exited requests are probed against the full-step
    fp32 image at any precision; a full-step fp32 request is not."""
    eng = ContinuousBatchingEngine(pipe, slots=3, cache_interval=2)
    eng.submit(_req(0, steps=4), now=0.0)
    eng.submit(_req(1, steps=4, cache_interval=1, exit_tol=10.0), now=0.0)
    eng.submit(_req(2, steps=4, cache_interval=1), now=0.0)
    done = {r.request_id: r for r in eng.run_until_idle(now=0.0)}
    assert done[0].cached_evals > 0 and done[0].quality_psnr_db is not None
    assert done[1].early_exit and done[1].quality_psnr_db is not None
    assert done[2].quality_psnr_db is None


def test_frontier_reports_scheduler_columns(pipe):
    eng = ContinuousBatchingEngine(pipe, slots=2, cache_interval=2,
                                   quality_probe=0)
    eng.submit(_req(0, steps=4, precision='w8a8+noise'), now=0.0)
    eng.submit(_req(1, steps=4, precision='w8a8+noise', exit_tol=10.0),
               now=0.0)
    eng.run_until_idle(now=0.0)
    f = eng.metrics.snapshot().frontier['w8a8+noise']
    assert f['completed'] == 2 and f['early_exits'] == 1
    assert f['mean_steps_requested'] == 4
    assert f['mean_steps_executed'] == pytest.approx((4 + 3) / 2)
    assert f['mean_steps_saved'] == pytest.approx(0.5)
    assert 0 < f['cache_hit_rate'] < 1


def test_noisy_requests_match_the_noisy_pipeline_step_by_step(pipe):
    """A lone noisy request through the engine equals ``denoise_step``
    driven with the engine's key chain: tick key ``fold_in(PRNGKey(seed),
    tick)``, then the slot-0 timestep and branch 0 inside the step."""
    from repro_torch.core import prng
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.diffusion import samplers
    from repro_torch.diffusion.pipeline import initial_noise
    eng = ContinuousBatchingEngine(pipe, slots=1, noise_seed=4,
                                   quality_probe=0)
    eng.submit(_req(0, steps=3, precision='w8a8+noise'), now=0.0)
    (r,) = eng.run_until_idle(now=0.0)
    pol = PrecisionPolicy.w8a8_noise(noise_seed=4)
    ts = samplers.ddim_timesteps(pipe.sched, 3)
    x = initial_noise(100, (1, 16, 16, 3), 'cpu')
    for i, t in enumerate(ts):
        t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
        x = pipe.denoise_step(x, int(t), t_prev, policy=pol,
                              noise_key=prng.fold_in(prng.PRNGKey(4), i))
    np.testing.assert_allclose(r.image, x[0].numpy(), atol=1e-3)
