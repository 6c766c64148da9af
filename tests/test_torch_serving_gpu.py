"""The serving features on the card against the CPU: the threefry
generator's bits (bit for bit) and normals (``prng.NORMAL_RTOL``), the
noisy W8A8 matmul on one key (1e-5 of its largest output: the same draws,
a float32 product summed in another order), and a tiny engine serving a
noisy, a DeepCache and an early-exit request (the same tallies; images
within the W8A8 tolerance, 1e-3); decode overlap on a second stream
against the CPU's in-order decode (1e-3) and the card's (1e-6), through
the engine and ``serve_diffusion``; the smoke LMs of the MoE, MLA, SSM
and hybrid families, a prefill and decode steps on the card against the
CPU (logits 1e-4: float32 sums in another order).

Imports neither ``jax`` nor the JAX package, so it runs on the GPU
machine: ``python -m pytest -m gpu tests/test_torch_serving_gpu.py``.
Every test skips where there is no CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.photonic.noise import noisy_w8a8_matmul

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


@pytest.mark.parametrize('shape', [(1,), (7,), (100_003,), (3, 5, 7),
                                   (1360, 1360)])
def test_prng_on_card_matches_cpu(cuda, shape):
    key = prng.fold_in(prng.PRNGKey(11), 3)
    assert torch.equal(prng.random_bits(key, shape, device=cuda).cpu(),
                       prng.random_bits(key, shape, device='cpu'))
    assert torch.equal(prng.uniform(key, shape, -2.0, 3.0, device=cuda).cpu(),
                       prng.uniform(key, shape, -2.0, 3.0, device='cpu'))
    torch.testing.assert_close(prng.normal(key, shape, device=cuda).cpu(),
                               prng.normal(key, shape, device='cpu'),
                               rtol=prng.NORMAL_RTOL, atol=prng.NORMAL_ATOL)


@pytest.mark.parametrize('M,K,N', [(7, 40, 24), (4096, 680, 680)])
def test_noisy_w8a8_on_card_matches_cpu(cuda, M, K, N):
    g = torch.Generator().manual_seed(M)
    x, w = torch.randn((M, K), generator=g), torch.randn((K, N), generator=g)
    key = prng.PRNGKey(M)
    want = noisy_w8a8_matmul(key, x, w)
    got = noisy_w8a8_matmul(key, x.to(cuda), w.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_engine_features_on_card_match_cpu(cuda):
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.models.unet import UNetConfig
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    cfg = UNetConfig('tiny-sd', img_size=8, in_ch=4, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                     n_heads=4, context_dim=16, timesteps=16, latent=True)
    cpu = DiffusionPipeline.init(1, cfg, device='cpu')
    ctx = torch.randn((3, 5, 16), generator=torch.Generator().manual_seed(2))
    reqs = [GenerationRequest(0, seed=5, steps=5, precision='w8a8+noise'),
            GenerationRequest(1, seed=6, steps=5, guidance=2.0),
            GenerationRequest(2, seed=7, steps=5, exit_tol=10.0)]
    out = {}
    for dev, pipe in (('cuda', cpu.to(cuda)), ('cpu', cpu)):
        eng = ContinuousBatchingEngine(pipe, slots=3, context=ctx,
                                       cache_interval=2, quality_probe=0)
        for r in reqs:
            eng.submit(r, now=0.0)
        out[dev] = {r.request_id: r for r in eng.run_until_idle(now=0.0)}
    for rid, a in out['cuda'].items():
        b = out['cpu'][rid]
        assert (a.full_evals, a.cached_evals, a.early_exit) == (
            b.full_evals, b.cached_evals, b.early_exit)
        assert a.energy_j == b.energy_j > 0
        np.testing.assert_allclose(a.image, b.image, atol=1e-3)
    assert out['cpu'][1].cached_evals > 0 and out['cpu'][2].early_exit


def _tiny_latent_pipe():
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.models.autoencoder import VAEConfig
    from repro_torch.models.unet import UNetConfig
    cfg = UNetConfig('tiny-ldm', img_size=8, in_ch=4, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(4,),
                     n_heads=4, timesteps=16, latent=True)
    vae = VAEConfig(img_size=16, in_ch=3, z_ch=4, base_ch=16,
                    ch_mults=(1, 2), groups=8)
    return DiffusionPipeline.init(3, cfg, vae, device='cpu')


def test_overlapped_decode_runs_on_a_second_stream(cuda):
    """On the card each drained request's VAE decode runs on the engine's
    decode stream, not the main one; its result surfaces a tick later and
    equals the card's in-order decode (1e-6: the same kernels on the same
    inputs, only the decode's stream differs)."""
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    cpu = _tiny_latent_pipe()
    pipe = cpu.to(cuda)
    streams = []
    decode = pipe.decode

    def recording(z):
        streams.append(torch.cuda.current_stream(cuda))
        return decode(z)
    pipe.decode = recording
    reqs = [GenerationRequest(0, seed=1, steps=2, precision='w8a8'),
            GenerationRequest(1, seed=2, steps=3)]
    engines, surfaced, images = {}, {}, {}
    for dev, overlap in (('cuda', True), ('in order', False)):
        eng = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0,
                                       overlap_decode=overlap)
        assert (eng.device in eng._sides) == overlap
        for r in reqs:
            eng.submit(r, now=0.0)
        ticks = []
        while eng.busy:
            done = eng.tick(now=0.0)
            ticks.append([r.request_id for r in done])
            images.update({(dev, r.request_id): r.image for r in done})
        engines[dev], surfaced[dev] = eng, ticks
    assert surfaced['in order'] == [[], [0], [1]]
    assert surfaced['cuda'] == [[], [], [0], [1]]
    assert len(streams) == 4
    side = engines['cuda']._sides[pipe.device]
    assert all(s == side for s in streams[:2])
    assert all(s != side for s in streams[2:])
    assert side != torch.cuda.default_stream(cuda)
    assert engines['cuda'].metrics.overlapped_decodes == 1
    for rid in (0, 1):
        np.testing.assert_allclose(images['cuda', rid],
                                   images['in order', rid], atol=1e-6)


def test_overlapped_decode_images_match_cpu(cuda):
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    cpu = _tiny_latent_pipe()
    reqs = [GenerationRequest(i, seed=10 + i, steps=s, precision=p)
            for i, (s, p) in enumerate([(2, 'fp32'), (3, 'w8a8'),
                                        (2, 'w8a8+noise'), (4, 'fp32')])]
    out = {}
    for dev, pipe, overlap in (('cuda', cpu.to(cuda), True),
                               ('cpu', cpu, False)):
        eng = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0,
                                       overlap_decode=overlap)
        for r in reqs:
            eng.submit(r, now=0.0)
        out[dev] = {r.request_id: r
                    for r in eng.run_until_idle(now=0.0, tick_dt=1.0)}
    assert sorted(out['cuda']) == sorted(out['cpu']) == [0, 1, 2, 3]
    for rid, a in out['cuda'].items():
        b = out['cpu'][rid]
        assert a.image.shape == (16, 16, 3)
        assert (a.full_evals, a.energy_j) == (b.full_evals, b.energy_j)
        np.testing.assert_allclose(a.image, b.image, atol=1e-3)


def test_serve_diffusion_with_overlap_on_card(cuda):
    """``serve_diffusion`` on the card, every arrival at t=0, with decode
    overlap and without: decodes overlapped, and the same images (1e-6,
    as above) and energies."""
    from repro_torch.launch import serve
    out = {}
    for overlap in (True, False):
        results, s = serve.serve_diffusion(
            16, 3, 4, float('inf'), 2, precision='w8a8', quality_probe=0,
            overlap_decode=overlap, device='cuda')
        out[overlap] = ({r.request_id: r for r in results}, s)
    (on, s_on), (off, s_off) = out[True], out[False]
    assert s_on['overlapped_decodes'] >= 1 and s_off['overlapped_decodes'] == 0
    assert sorted(on) == sorted(off) == [0, 1, 2, 3]
    for rid, a in on.items():
        assert a.energy_j == off[rid].energy_j
        np.testing.assert_allclose(a.image, off[rid].image, atol=1e-6)


@pytest.mark.parametrize('arch', ['granite-moe-1b-a400m',
                                  'deepseek-v2-lite-16b', 'mamba2-2.7b',
                                  'jamba-1.5-large-398b'])
def test_lm_families_on_card_match_cpu(cuda, arch):
    import copy

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.steps import init_params
    from repro_torch.models import transformer as T
    cfg = smoke_config(arch)
    lms = {'cpu': init_params(torch.Generator().manual_seed(0), cfg, 'cpu')}
    lms['cuda'] = copy.deepcopy(lms['cpu']).to(cuda)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 21)))
    caches = {d: T.init_lm_cache(cfg, 2, 24, torch.float32, d) for d in lms}
    with torch.no_grad():
        out = {d: T.lm_prefill(lms[d], cfg, tok.to(d), caches[d],
                               dtype=torch.float32)[0] for d in lms}
        for step in range(3):
            assert (out['cuda'].cpu() - out['cpu']).abs().max() <= 1e-4
            nxt = out['cpu'].argmax(-1).to(torch.int32)
            out = {d: T.lm_decode(lms[d], cfg, nxt.to(d), caches[d],
                                  21 + step, dtype=torch.float32)[0]
                   for d in lms}
