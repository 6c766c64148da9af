"""The port's cold start, the counterpart of ``tests/test_coldstart.py``:
the persistent cache of kernel libraries (``serving/compile_cache.py``
over ``kernels/build.py``), the engine's ``step_variants``,
``aot_warmup`` and ``compile_stats`` held against the reference engine's,
warmup and first-tick accounting, the serving CLI's ``--cache-dir``
and ``--cache-max-mb``, and a cold-then-warm restart on the card
(marked ``gpu``: the CPU builds no kernel).

The size bound's tests run the reference's scenario on both packages'
``compile_cache`` over the same files (library names, ``.so``)."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.diffusion.pipeline import DiffusionPipeline
from repro_torch.kernels import build
from repro_torch.launch import serve as tserve
from repro_torch.models.unet import UNetConfig
from repro_torch.serving import (ContinuousBatchingEngine, GenerationRequest,
                                 active_cache_dir, cache_entries,
                                 disable_persistent_cache,
                                 enable_persistent_cache)
from repro_torch.serving import compile_cache as tcc

TINY = UNetConfig('tiny-cold', img_size=16, in_ch=3, base_ch=32,
                  ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                  n_heads=4, timesteps=16)
TINY_CTX = UNetConfig('tiny-cold-ctx', img_size=16, in_ch=3, base_ch=32,
                      ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                      n_heads=4, timesteps=16, context_dim=8)


@pytest.fixture(scope='module')
def pipe():
    return DiffusionPipeline.init(0, TINY, device='cpu')


@pytest.fixture(scope='module')
def cpipe():
    return DiffusionPipeline.init(0, TINY_CTX, device='cpu')


@pytest.fixture(scope='module')
def jax_pipes():
    import jax

    from repro.diffusion.pipeline import DiffusionPipeline as JPipe
    from repro.models.unet import UNetConfig as JCfg
    cfgs = [JCfg(**{f: getattr(c, f) for f in c.__dataclass_fields__})
            for c in (TINY, TINY_CTX)]
    return [JPipe.init(jax.random.PRNGKey(0), c) for c in cfgs]


@pytest.fixture(autouse=True)
def _no_cache_left():
    yield
    disable_persistent_cache()


def _ctx(slots=2):
    return torch.randn((slots, 4, 8), generator=torch.Generator()
                       .manual_seed(9))[:1].repeat(slots, 1, 1)


def _jctx(slots=2):
    import jax.numpy as jnp
    return jnp.asarray(_ctx(slots).numpy())


# ---------------------------------------------------------------------------
# compile_cache wiring
# ---------------------------------------------------------------------------

def test_enable_routes_the_kernel_builds(tmp_path):
    target = str(tmp_path / 'kernels')
    path = enable_persistent_cache(target)
    assert os.path.isdir(path) and active_cache_dir() == path
    assert build.build_dir() == build.Path(path)
    assert cache_entries() == 0                  # enabled, nothing stored
    disable_persistent_cache()
    assert active_cache_dir() is None
    assert build.build_dir() == build.BUILD_DIR


def test_cache_entries_handles_missing_and_inactive():
    assert cache_entries('/nonexistent/no-such-cache-dir') == 0
    assert active_cache_dir() is None
    assert cache_entries() == 0                  # nothing active


def test_entries_are_the_libraries(tmp_path):
    """A library counts; a build still under its hidden temporary name
    does not, nor does anything else in the directory."""
    d = str(tmp_path)
    _fake_entry(d, 'fused_gn_swish-0123456789abcdef.so', 10, 0)
    _fake_entry(d, '.w8a8_matmul-x1y2.tmp', 10, 0)
    _fake_entry(d, 'notes.txt', 10, 0)
    assert cache_entries(d) == 1


def test_the_thresholds_are_accepted_and_kept(tmp_path):
    enable_persistent_cache(str(tmp_path), min_entry_size_bytes=0,
                            min_compile_time_secs=1.0)
    assert tcc._THRESHOLDS == {'min_entry_size_bytes': 0,
                               'min_compile_time_secs': 1.0}


# ---------------------------------------------------------------------------
# the size bound, the reference's scenario on both packages
# ---------------------------------------------------------------------------

def _fake_entry(d, name, size, age_s):
    """A file ``age_s`` old (atime == mtime == now - age_s)."""
    path = os.path.join(d, name)
    with open(path, 'wb') as f:
        f.write(b'\0' * size)
    t = time.time() - age_s
    os.utime(path, (t, t))
    return path


def _cc(package):
    if package == 'repro':
        from repro.serving import compile_cache
        return compile_cache
    return tcc


@pytest.mark.parametrize('package', ['repro', 'repro_torch'])
def test_trim_cache_evicts_lru_until_under_budget(tmp_path, package):
    cc = _cc(package)
    d = str(tmp_path)
    _fake_entry(d, 'oldest.so', 400, age_s=300)
    _fake_entry(d, 'middle.so', 400, age_s=200)
    _fake_entry(d, 'newest.so', 400, age_s=100)
    ev0 = cc.cache_evictions()
    assert cc.trim_cache(d, max_bytes=2000) == 0          # already fits
    assert cc.trim_cache(d, max_bytes=800) == 1           # oldest goes
    assert sorted(os.listdir(d)) == ['middle.so', 'newest.so']
    assert cc.trim_cache(d, max_bytes=100) == 2           # both go
    assert os.listdir(d) == []
    n, evicted = cc.cache_entries(d, with_evictions=True)
    assert n == 0 and evicted - ev0 == 3


@pytest.mark.parametrize('package', ['repro', 'repro_torch'])
def test_trim_cache_noop_without_bound_or_dir(tmp_path, package):
    cc = _cc(package)
    _fake_entry(str(tmp_path), 'a.so', 600, age_s=60)
    assert cc.trim_cache(str(tmp_path), max_bytes=None) == 0
    assert cc.trim_cache(str(tmp_path / 'missing'), max_bytes=10) == 0
    assert os.listdir(str(tmp_path)) == ['a.so']


@pytest.mark.parametrize('package', ['repro', 'repro_torch'])
def test_enable_with_max_bytes_trims_and_keeps_the_bound(tmp_path, package):
    """A bound trims at once, and a re-enable without one (what warmup
    does) keeps it."""
    cc = _cc(package)
    d = str(tmp_path / 'cache')
    os.makedirs(d)
    _fake_entry(d, 'a.so', 600, age_s=60)
    _fake_entry(d, 'b.so', 600, age_s=30)
    try:
        cc.enable_persistent_cache(d, max_bytes=700)
        assert os.listdir(d) == ['b.so']                 # trimmed on enable
        cc.enable_persistent_cache(d)                    # warmup's re-enable
        _fake_entry(d, 'c.so', 600, age_s=0)
        cc.trim_cache()                                  # the bound holds
        assert os.listdir(d) == ['c.so']
    finally:
        cc.disable_persistent_cache()


def test_a_load_stamps_the_use_the_bound_evicts_by(tmp_path, monkeypatch):
    """``build.load`` stamps a library's access time, so a library in use
    outlives one built later but not loaded since."""
    d = str(tmp_path)
    old = _fake_entry(d, 'gn-1.so', 400, age_s=300)
    _fake_entry(d, 'mm-2.so', 400, age_s=100)
    monkeypatch.setattr(build, 'build', lambda names: {
        n: build.Path(old) for n in names})
    monkeypatch.setattr(build.ctypes, 'CDLL', lambda path: object())
    monkeypatch.setattr(build, '_loaded', {})
    n0 = build.counts['loads']
    build.load('gn')
    assert build.counts['loads'] == n0 + 1
    assert tcc.trim_cache(d, max_bytes=500) == 1
    assert os.listdir(d) == ['gn-1.so']


# ---------------------------------------------------------------------------
# step variants, AOT warmup, compile stats: against the reference engine
# ---------------------------------------------------------------------------

def _engines(pipe, cpipe, jax_pipes):
    """The plain, cached and guided engines of both packages."""
    from repro.serving import ContinuousBatchingEngine as JEngine
    jp, jcp = jax_pipes
    mk = lambda E, p, **k: E(p, slots=2, quality_probe=0, **k)  # noqa: E731
    return [
        (mk(JEngine, jp), mk(ContinuousBatchingEngine, pipe)),
        (mk(JEngine, jp, cache_interval=2),
         mk(ContinuousBatchingEngine, pipe, cache_interval=2)),
        (mk(JEngine, jcp, context=_jctx(), cache_interval=2),
         mk(ContinuousBatchingEngine, cpipe, context=_ctx(),
            cache_interval=2))]


def test_step_variants_equal_the_reference(pipe, cpipe, jax_pipes):
    for ref, eng in _engines(pipe, cpipe, jax_pipes):
        for precisions in (('fp32',), ('fp32', 'w8a8'),
                           ('w8a8', 'w8a8+noise')):
            assert eng.step_variants(precisions) == \
                ref.step_variants(precisions)
    ref, eng = _engines(pipe, cpipe, jax_pipes)[2]
    assert eng.step_variants(('fp32',)) == [('fp32', False, True),
                                            ('fp32', False, False),
                                            ('fp32', True, True),
                                            ('fp32', True, False)]
    # 2 precisions x {unguided, guided} x {refresh, skip}
    assert len(eng.step_variants(('fp32', 'w8a8'))) == 8


def test_aot_warmup_count_and_labels_equal_the_reference(pipe, cpipe,
                                                         jax_pipes):
    """The count: the reference's AOT warmup of the plain engine, and its
    own arithmetic (variants + 3 helpers + the decode with a VAE) for the
    others.  The labels: the reference's ``compile_stats`` once every
    variant's jitted step exists (created, not compiled)."""
    engines = _engines(pipe, cpipe, jax_pipes)
    ref, eng = engines[0]
    assert eng.aot_warmup(('fp32',))['variants'] == \
        ref.aot_warmup(('fp32',))['variants'] == 4
    for ref, eng in engines[1:]:
        precisions = ('fp32', 'w8a8')
        n0 = dict(build.counts)
        info = eng.aot_warmup(precisions)
        assert build.counts == n0                 # the CPU builds nothing
        variants = ref.step_variants(precisions)
        assert info['variants'] == len(variants) + 3
        assert info['seconds'] >= 0.0
        for p, g, r in variants:
            ref._get_cached_step(p, g, r)
        assert list(eng.compile_stats()) == list(ref.compile_stats())
        # every variant prepared once, every helper once
        assert set(eng.compile_stats().values()) == {1}


def test_compile_stats_after_warmup_equal_the_reference_and_stay(
        pipe, jax_pipes):
    from repro.serving import ContinuousBatchingEngine as JEngine
    ref = JEngine(jax_pipes[0], slots=2, quality_probe=0)
    eng = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0)
    ref.warmup(('fp32', 'w8a8'))
    eng.warmup(('fp32', 'w8a8'))
    want = ref.compile_stats()
    assert list(eng.compile_stats()) == list(want)
    assert eng.compile_stats() == want == {
        '_step': 1, '_step[w8a8]': 1, '_init_noise': 1, '_place': 1,
        '_take': 1}
    for i, p in enumerate(('fp32', 'w8a8', 'fp32')):
        eng.submit(GenerationRequest(request_id=i, seed=i, steps=3,
                                     precision=p), now=0.0)
    assert len(eng.run_until_idle(now=0.0)) == 3
    assert eng.compile_stats() == want           # no new signature


def test_aot_warmup_then_serving_adds_no_signature(pipe):
    eng = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0,
                                   cache_interval=2)
    eng.aot_warmup(('fp32', 'w8a8'))
    before = eng.compile_stats()
    for i, p in enumerate(('fp32', 'w8a8')):
        eng.submit(GenerationRequest(request_id=i, seed=i, steps=4,
                                     precision=p), now=0.0)
    assert len(eng.run_until_idle(now=0.0)) == 2
    assert eng.compile_stats() == before


def test_elastic_resize_warms_ahead_of_time(pipe):
    """``elastic_resize(warm=True)`` runs ``aot_warmup`` on the new
    shards: their signatures are prepared before any tick."""
    from repro_torch.launch.mesh import serving_mesh
    eng = ContinuousBatchingEngine(pipe, mesh=serving_mesh(2, device='cpu'),
                                   slots_per_device=1, quality_probe=0)
    eng.warmup(('fp32',))
    assert eng.compile_stats()['_step'] == 1       # two shards, one shape
    eng.elastic_resize(n_devices=1, precisions=('fp32', 'w8a8'))
    assert eng.compile_stats()['_step[w8a8]'] == 1
    eng.submit(GenerationRequest(request_id=0, seed=1, steps=2,
                                 precision='w8a8'), now=0.0)
    assert len(eng.run_until_idle(now=0.0)) == 1
    assert set(eng.compile_stats().values()) == {1}


def test_aot_warmup_writes_its_span(pipe):
    from repro_torch.obs import Tracer
    eng = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0,
                                   tracer=Tracer())
    info = eng.aot_warmup(('fp32',))
    (span,) = eng.tracer.spans('aot_warmup')
    assert span.args['variants'] == info['variants'] == 4


# ---------------------------------------------------------------------------
# warmup / first-tick accounting
# ---------------------------------------------------------------------------

def test_warmup_and_first_tick_recorded(pipe):
    engine = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0)
    dt = engine.warmup()
    assert dt > 0.0
    assert engine.metrics.warmup_s == pytest.approx(dt)
    assert engine.metrics.first_tick_s is None   # nothing served yet
    engine.submit(GenerationRequest(request_id=0, seed=1, steps=2), now=0.0)
    engine.run_until_idle(now=0.0)
    first = engine.metrics.first_tick_s
    assert first is not None and first > 0.0
    # only the first served tick defines time-to-first-tick
    engine.submit(GenerationRequest(request_id=1, seed=2, steps=2), now=0.0)
    engine.run_until_idle(now=0.0)
    assert engine.metrics.first_tick_s == first
    s = engine.metrics.summary()
    assert s['warmup_s'] == pytest.approx(dt)
    assert s['first_tick_s'] == pytest.approx(first)


def test_warmup_enables_the_cache_and_trims_it_last(pipe, tmp_path):
    d = str(tmp_path / 'kernels')
    os.makedirs(d)
    _fake_entry(d, 'stale.so', 600, age_s=60)
    enable_persistent_cache(d, max_bytes=100)      # trims 'stale' at once
    _fake_entry(d, 'late.so', 600, age_s=0)
    engine = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0)
    engine.warmup(cache_dir=d)                     # re-enable keeps 100 B
    assert active_cache_dir() == d
    assert cache_entries(d, with_evictions=True)[0] == 0


# ---------------------------------------------------------------------------
# the serving CLI's flags on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bound', [None, 0.001],
                         ids=['cache-dir', 'cache-dir+cache-max-mb'])
def test_cli_serves_the_cache_flags(capsys, tmp_path, bound):
    """``--cache-dir`` and ``--cache-max-mb`` are served as the
    reference's, twice on one directory that already holds a library
    (the CPU builds none): the warmup routes the kernel builds to the
    directory and logs its ``[coldstart]`` line, warm while the library
    is there; the bound evicts it, and the start is then cold with none
    persisted."""
    d = tmp_path / 'kernels'
    d.mkdir()
    (d / 'stale-0123.so').write_bytes(b'\0' * 4096)
    flags = ['--cache-dir', str(d)]
    if bound is not None:
        flags += ['--cache-max-mb', str(bound)]
    try:
        for _ in range(2):
            tserve.main(['--diffusion', '--device', 'cpu', '--requests',
                         '2', '--rate', '50', '--slots', '2', '--steps',
                         '2'] + flags)
            out = capsys.readouterr().out
            assert '[serve] 2 done in' in out
            assert f'cache_dir={d}' in out
    finally:
        disable_persistent_cache()
    if bound is None:
        assert '- warm (loaded from cache)' in out
        assert cache_entries(str(d)) == 1
    else:
        assert '- cold (persisted 0 executables)' in out
        assert cache_entries(str(d)) == 0


# ---------------------------------------------------------------------------
# a real restart on the card
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys, torch
from repro_torch.diffusion.pipeline import DiffusionPipeline
from repro_torch.kernels import build, ops
from repro_torch.models.unet import UNetConfig
from repro_torch.serving import (ContinuousBatchingEngine, GenerationRequest,
                                 cache_entries)
cfg = UNetConfig('tiny-cold', img_size=16, in_ch=3, base_ch=32,
                 ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                 n_heads=4, timesteps=16)
pipe = DiffusionPipeline.init(0, cfg, device='cuda')
engine = ContinuousBatchingEngine(pipe, slots=2, quality_probe=0)
warmup_s = engine.warmup(('w8a8',), cache_dir=sys.argv[1])
ops.reset_launches()
engine.submit(GenerationRequest(request_id=0, seed=1, steps=2,
                                precision='w8a8'), now=0.0)
assert len(engine.run_until_idle(now=0.0)) == 1
print(json.dumps({'warmup_s': warmup_s, 'nvcc': build.counts['nvcc'],
                  'entries': cache_entries(sys.argv[1]),
                  'launches': ops.launch_counts()}))
"""


def _restart(cache_dir):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), '..', 'src')
    env['PYTHONPATH'] = os.path.abspath(src) + (
        os.pathsep + env['PYTHONPATH'] if env.get('PYTHONPATH') else '')
    out = subprocess.run([sys.executable, '-c', _CHILD, cache_dir],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason='needs a GPU')
def test_cold_then_warm_restart_on_the_card(tmp_path):
    """Two fresh processes share one empty cache directory: the cold one
    runs ``nvcc`` for GroupNorm+swish, W8A8 and the convolution and
    persists the three, the warm one runs none, adds none and warms up
    faster; both serve through the kernels."""
    d = str(tmp_path / 'kernels')
    cold = _restart(d)
    assert cold['nvcc'] == 3 and cold['entries'] == 3, cold
    warm = _restart(d)
    assert warm['nvcc'] == 0 and warm['entries'] == 3, warm
    assert warm['warmup_s'] < cold['warmup_s'], (cold, warm)
    for run in (cold, warm):
        assert run['launches']['fused_gn_swish'] > 0
        assert run['launches']['w8a8_matmul'] > 0
        assert run['launches']['conv2d_nhwc'] > 0
    assert np.isfinite(warm['warmup_s'])
