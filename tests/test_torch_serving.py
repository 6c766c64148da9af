"""The port's serving engine against the port's standalone pipeline (the
engine and ``DiffusionPipeline.generate`` draw a request's initial noise
the same way, so a served request must equal its own batch-1 run), as
the reference's ``tests/test_serving.py`` holds its engine; plus the
requests this slice refuses and the host-side queue/batcher/metrics."""
import numpy as np
import pytest
import torch

from repro_torch.diffusion.pipeline import DiffusionPipeline
from repro_torch.models.autoencoder import VAEConfig
from repro_torch.models.unet import UNetConfig
from repro_torch.serving import (AdmissionQueue, ContinuousBatchingEngine,
                                 GenerationRequest, group_by_precision,
                                 plan_tick)

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
        assert r.energy_j == 0.0 and r.epb_pj == 0.0   # no accountant yet


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


@pytest.mark.parametrize('kwargs,match', [
    ({'precision': 'w8a8+noise'}, 'threefry'),
    ({'cache_interval': 3}, 'DeepCache'),
    ({'exit_tol': 0.01}, 'early exit'),
])
def test_requests_this_slice_cannot_serve_are_refused(pipe, kwargs, match):
    engine = ContinuousBatchingEngine(pipe, slots=1)
    with pytest.raises(ValueError, match=match):
        engine.submit(GenerationRequest(0, seed=0, steps=2, **kwargs))
    assert not engine.busy and engine.metrics.submitted == 0


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
    plan = plan_tick(precisions)
    assert [name for name, _ in plan] == ['fp32', 'w8a8']
    np.testing.assert_array_equal(plan[0][1], [False, False, True, False])
    assert plan_tick([None, None]) == []
