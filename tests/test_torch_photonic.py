"""The port's photonic model against the reference: workload counts, the
DiffLight simulator, its ablation and design-space score, the published
baselines, the DeepCache workload transform and the serving accountant
are pure float64 arithmetic on the same counts, so they agree to 1e-12
relative; the noisy W8A8 matmul on the same key draws the same noise
(normals within ``prng.NORMAL_RTOL``) and then sums a float32 product
in another order, so it agrees to 1e-5 of its largest output."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import diffusion as jconfigs
from repro.core.photonic import arch as jarch
from repro.core.photonic import baselines as jbase
from repro.core.photonic import noise as jnoise
from repro.core.photonic import simulator as jsim
from repro.core.photonic import workload as jwork
from repro.core.quantization import quantize_per_channel as jqpc
from repro.diffusion import deepcache as jdc
from repro.models.unet import UNetConfig as JCfg
from repro.serving.metrics import PhotonicAccountant as JAcc
from repro_torch.configs import diffusion as tconfigs
from repro_torch.core import prng
from repro_torch.core.photonic import arch as tarch
from repro_torch.core.photonic import baselines as tbase
from repro_torch.core.photonic import noise as tnoise
from repro_torch.core.photonic import simulator as tsim
from repro_torch.core.photonic import workload as twork
from repro_torch.core.quantization import QTensor
from repro_torch.diffusion import deepcache as tdc
from repro_torch.models.unet import UNetConfig as TCfg
from repro_torch.serving import PhotonicAccountant as TAcc

REL = 1e-12
TINY = dict(name='tiny-sdm', img_size=16, in_ch=3, base_ch=32,
            ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
            n_heads=4, timesteps=16, context_dim=8)
CONFIGS = {'sd_v1_4': (jconfigs.SD_V1_4, tconfigs.SD_V1_4),
           'tiny': (JCfg(**TINY), TCfg(**TINY))}


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


def _same_report(j, t):
    assert j.name == t.name
    for f in ('latency_s', 'energy_j', 'ops', 'gops', 'epb_pj'):
        _close(getattr(t, f), getattr(j, f))
    for d in ('unit_latency', 'unit_energy'):
        jd, td = getattr(j, d), getattr(t, d)
        assert jd.keys() == td.keys()
        for k in jd:
            _close(td[k], jd[k])


def _same_workload(j, t):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, float):
            _close(b, a)
        else:
            assert a == b
    _close(t.total_macs_dense, j.total_macs_dense)
    for sparse in (True, False):
        _close(t.total_macs(sparse), j.total_macs(sparse))


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
@pytest.mark.parametrize('batch,ctx_len', [(1, 77), (4, 77), (1, None)])
def test_unet_workload_matches_reference(cfg, batch, ctx_len):
    jc, tc = CONFIGS[cfg]
    _same_workload(jwork.unet_workload(jc, batch, ctx_len),
                   twork.unet_workload(tc, batch, ctx_len))


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
@pytest.mark.parametrize('arch', ['PAPER_OPTIMUM', 'BASELINE', 'tiles4'])
def test_simulate_matches_reference(cfg, arch):
    jc, tc = CONFIGS[cfg]
    if arch == 'tiles4':
        ja = dataclasses.replace(jarch.PAPER_OPTIMUM, tiles=4, N=8)
        ta = dataclasses.replace(tarch.PAPER_OPTIMUM, tiles=4, N=8)
    else:
        ja, ta = getattr(jarch, arch), getattr(tarch, arch)
    _same_report(jsim.simulate(jwork.unet_workload(jc), ja),
                 tsim.simulate(twork.unet_workload(tc), ta))
    _close(tsim.dse_score(twork.unet_workload(tc), ta),
           jsim.dse_score(jwork.unet_workload(jc), ja))


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_ablation_matches_reference(cfg):
    jc, tc = CONFIGS[cfg]
    ja = jsim.ablation(jwork.unet_workload(jc))
    ta = tsim.ablation(twork.unet_workload(tc))
    assert list(ja) == list(ta)
    for k in ja:
        _same_report(ja[k], ta[k])


def test_design_space_and_baselines_match_reference():
    j = list(jarch.dse_space())
    t = list(tarch.dse_space())
    assert [dataclasses.astuple(c) for c in t] == \
        [dataclasses.astuple(c) for c in j]
    jb, tb = (m.derive_baselines(123.4, 0.56) for m in (jbase, tbase))
    assert list(jb) == list(tb)
    for k in jb:
        _close(tb[k].gops, jb[k].gops)
        _close(tb[k].epb_pj, jb[k].epb_pj)


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_deepcache_workload_transform_matches_reference(cfg):
    jc, tc = CONFIGS[cfg]
    _close(tdc.shallow_workload_fraction(tc), jdc.shallow_workload_fraction(jc))
    for interval in (2, 3, 5):
        _close(tdc.deepcache_workload_factor(tc, interval),
               jdc.deepcache_workload_factor(jc, interval))


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
@pytest.mark.parametrize('precision', ['fp32', 'w8a8', 'w8a8+noise'])
def test_accountant_energy_matches_reference(cfg, precision):
    jc, tc = CONFIGS[cfg]
    ja, ta = JAcc(jc), TAcc(tc)
    _close(ta.shallow_fraction, ja.shallow_fraction)
    for steps, guided in ((10, False), (10, True), (3, True)):
        for a, b in zip(ta.energy(steps, guided, precision),
                        ja.energy(steps, guided, precision)):
            _close(a, b)
    for full, cached, guided in ((4, 6, False), (4, 6, True), (1, 0, False),
                                 (0, 3, True)):
        for a, b in zip(ta.energy_evals(full, cached, guided, precision),
                        ja.energy_evals(full, cached, guided, precision)):
            _close(a, b)


def test_crosstalk_matches_reference():
    for n in (1, 2, 36, 64):
        _close(tnoise.crosstalk_sigma_lsb(n, tnoise.NoiseModel()),
               jnoise.crosstalk_sigma_lsb(n, jnoise.NoiseModel()))


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize('prequantized', [False, True])
@pytest.mark.parametrize('seed,lead,K,N', [(0, (5,), 24, 16),
                                           (7, (2, 3), 40, 9)])
def test_noisy_w8a8_matmul_matches_reference(prequantized, seed, lead, K, N):
    x, w = _np(lead + (K,), seed), _np((K, N), seed + 1, 0.2)
    model = jnoise.NoiseModel(sigma_w_lsb=0.5, sigma_x_lsb=0.4,
                              sigma_pd_lsb=1.0)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if prequantized:
        q = jqpc(jw)
        jw = q
        tw = QTensor(torch.from_numpy(np.array(q.q)),
                     torch.from_numpy(np.array(q.scale)))
    want = np.asarray(jnoise.noisy_w8a8_matmul(
        jax.random.PRNGKey(seed), jnp.asarray(x), jw, model, 24))
    got = tnoise.noisy_w8a8_matmul(
        prng.PRNGKey(seed), torch.from_numpy(x), tw,
        tnoise.NoiseModel(**dataclasses.asdict(model)), 24)
    assert got.shape == want.shape == lead + (N,)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    # the draw is really there: another key moves the output
    other = tnoise.noisy_w8a8_matmul(prng.PRNGKey(seed + 100),
                                     torch.from_numpy(x), tw)
    assert not torch.allclose(other, got)


def test_robustness_sweep_matches_reference():
    x, w = _np((6, 32), 3), _np((32, 12), 4)
    want = jnoise.robustness_sweep(jax.random.PRNGKey(2), jnp.asarray(x),
                                   jnp.asarray(w), channel_counts=(2, 36, 64))
    got = tnoise.robustness_sweep(prng.PRNGKey(2), torch.from_numpy(x),
                                  torch.from_numpy(w),
                                  channel_counts=(2, 36, 64))
    assert list(got) == list(want)
    for n in want:
        assert got[n] == pytest.approx(want[n], rel=1e-4)
