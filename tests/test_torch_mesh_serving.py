"""The port's slot-sharded engine (``mesh=``, ``elastic_resize``,
stragglers) on a mesh of 8 logical CPU shards (``serving_mesh(8,
device='cpu')``), held to the scenarios of the reference's
``tests/test_dist_serving.py`` and, per request, to the port's own
single-device engine and to the reference's single-device engine run in
this process (its mesh needs XLA's forced device count, which a process
fixes at its first JAX call).  The weights are the reference's
``PRNGKey(0)`` pipeline's (``bridge.load_jax_params``).

Tolerances.  Sharded against single-device, both the port's: fp32 and
DeepCache 1e-5, the reference's own (batch-1 against batch-8 float32
convolutions; measured 1.2e-6 and 2.7e-6); w8a8 and w8a8+noise 1e-3, the
tolerance the reference's and the port's engine tests give w8a8 (a
~1e-7 difference can move one int8 rounding at a tie, worth one LSB;
measured 4.8e-5).  Against the reference's engine: fp32 1e-4 and
quantized 1e-3, the engine parity tests' (``test_torch_deepcache``).
The noisy runs use the paper's noise model thirty times as loud, as the
engine's key-chain tests do, so that a shard drawing its noise at its
own shape (every shard the rows of shard 0) moves an image by many
times the tolerance."""
import jax
import numpy as np
import pytest
import torch

import repro.serving
from repro.core.photonic.noise import NoiseModel as JNoise
from repro.diffusion.pipeline import DiffusionPipeline as JPipe
from repro.models import unet as ju
from repro_torch.bridge import load_jax_params
from repro_torch.core import precision as tprecision
from repro_torch.core import prng
from repro_torch.core.photonic import noise as tnoise
from repro_torch.core.photonic.noise import NoiseModel as TNoise
from repro_torch.core.photonic.noise import noisy_w8a8_matmul
from repro_torch.diffusion.pipeline import DiffusionPipeline as TPipe
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import serving_mesh
from repro_torch.models import unet as tu
from repro_torch.obs import Tracer
from repro_torch.serving import (AdmissionQueue, Bucket, BucketRouter,
                                 ContinuousBatchingEngine, GenerationRequest,
                                 bucket_for)

JTINY = ju.UNetConfig('tiny-dist', img_size=16, in_ch=3, base_ch=32,
                      ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                      n_heads=4, timesteps=16)
JTINY_SD = ju.UNetConfig('tiny-dist-sd', img_size=16, in_ch=3, base_ch=32,
                         ch_mults=(1, 2), n_res_blocks=1,
                         attn_resolutions=(8,), n_heads=4, timesteps=16,
                         context_dim=8)
NDEV = 8
MESH_ATOL = {'fp32': 1e-5, 'w8a8': 1e-3, 'w8a8+noise': 1e-3,
             'deepcache': 1e-5}
REF_ATOL = {'fp32': 1e-4, 'w8a8': 1e-3, 'w8a8+noise': 1e-3,
            'deepcache': 1e-4}
WRONG_DRAW_MARGIN = 5
CACHE_INTERVAL = 2
_LOUD = dict(sigma_w_lsb=9.0, sigma_x_lsb=6.0, sigma_pd_lsb=15.0,
             crosstalk_db_per_channel=2.0)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _loud_noise(monkeypatch):
    """The port's engine builds its noisy policy with ``NoiseModel()``:
    the amplified model stands in for it."""
    monkeypatch.setattr(tprecision, 'NoiseModel', lambda: TNoise(**_LOUD))


def _pipes(jcfg):
    with jax.threefry_partitionable(True):
        jpipe = JPipe.init(jax.random.PRNGKey(0), jcfg)
    tpipe = TPipe.init(0, tu.UNetConfig(**vars(jcfg)), device='cpu')
    load_jax_params(tpipe.unet, jax.tree_util.tree_map(np.asarray,
                                                       jpipe.unet_params))
    return jpipe, tpipe


@pytest.fixture(scope='module')
def pipes():
    return _pipes(JTINY)


@pytest.fixture(scope='module')
def sd_pipes():
    return _pipes(JTINY_SD)


@pytest.fixture(scope='module')
def context():
    """One conditioning row shared by every slot, as ``serve_diffusion``
    builds it."""
    row = np.random.default_rng(3).normal(size=(1, 5, 8)).astype(np.float32)
    return np.repeat(row, NDEV, axis=0)


def _reqs(n, start=0, steps=None, **kw):
    """Staggered step counts by default, so drains happen while other
    slots still step (the decode-overlap window)."""
    return [GenerationRequest(
        request_id=start + i, seed=100 + start + i,
        steps=4 + i % 3 if steps is None else steps, exit_tol=0.0, **kw)
        for i in range(n)]


def _case(name):
    """(requests, engine keywords) of a parity case."""
    if name == 'deepcache':
        reqs = _reqs(6)
        reqs[1] = GenerationRequest(request_id=1, seed=101, steps=5,
                                    guidance=7.5, exit_tol=0.0)
        return reqs, dict(cache_interval=CACHE_INTERVAL)
    return _reqs(6, precision=name), {}


def _serve(engine, reqs, now=0.0):
    for r in reqs:
        assert engine.submit(r, now=now)
    return {r.request_id: r for r in engine.run_until_idle(now=now)}


def _images(results):
    return {rid: r.image for rid, r in results.items()}


def _gap(a, b):
    assert sorted(a) == sorted(b)
    return max(float(np.abs(np.asarray(a[i]) - np.asarray(b[i])).max())
               for i in a)


@pytest.fixture(scope='module')
def reference(pipes, sd_pipes, context):
    """The reference's single-device engines, one per model, reused for
    every case: each case's run starts from fresh metrics (tick 0, the
    noise keys' index) and returns {request id: image}."""
    engines = {}
    memo = {}

    def get(name):
        if name not in memo:
            cond = name == 'deepcache'
            if cond not in engines:
                kw = dict(context=jax.numpy.asarray(context),
                          cache_interval=CACHE_INTERVAL) if cond else {}
                engines[cond] = repro.serving.ContinuousBatchingEngine(
                    (sd_pipes if cond else pipes)[0], slots=NDEV,
                    quality_probe=0, noise_model=JNoise(**_LOUD),
                    noise_seed=0, **kw)
            eng = engines[cond]
            eng.metrics = repro.serving.ServingMetrics()
            reqs, _ = _case(name)
            with jax.threefry_partitionable(True):
                res = _serve(eng, [repro.serving.GenerationRequest(
                    **{f: getattr(r, f) for f in (
                        'request_id', 'seed', 'steps', 'guidance',
                        'exit_tol', 'precision')}) for r in reqs])
            memo[name] = {rid: np.asarray(r.image) for rid, r in res.items()}
        return memo[name]
    return get


def _port(tpipe, name, context=None, mesh=True, **kw):
    _, ekw = _case(name)
    if name == 'deepcache':
        ekw['context'] = torch.from_numpy(context)
    if mesh:
        ekw.update(mesh=serving_mesh(NDEV, device='cpu'), slots_per_device=1)
    else:
        ekw.update(slots=NDEV)
    return ContinuousBatchingEngine(tpipe, quality_probe=0, **ekw, **kw)


@pytest.mark.parametrize('first,rows', [(0, 3), (3, 2), (7, 1)])
def test_a_shard_draws_its_rows_of_the_global_draw(first, rows):
    """``prng``'s ``offset`` gives rows ``first ...`` of the draw over the
    whole batch, bit for bit, and ``jax.random``'s within prng's stated
    tolerance; the noisy matmul with ``first_sample`` gives those rows of
    the batch's product, and without it (each shard at its own shape)
    other ones."""
    key = prng.fold_in(prng.PRNGKey(5), 17)
    whole = prng.normal(key, (NDEV, 6, 5), device='cpu')
    part = prng.normal(key, (rows, 6, 5), device='cpu', offset=first * 30)
    assert torch.equal(part, whole[first:first + rows])
    with jax.threefry_partitionable(True):
        want = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(5),
                                                    17), (NDEV, 6, 5))
    np.testing.assert_allclose(part.numpy(),
                               np.asarray(want)[first:first + rows],
                               rtol=prng.NORMAL_RTOL, atol=prng.NORMAL_ATOL)
    gen = torch.Generator().manual_seed(first)
    x = torch.randn((NDEV, 6, 5), generator=gen)
    w = torch.randn((5, 7), generator=gen)
    batch = noisy_w8a8_matmul(key, x, w)[first:first + rows]
    shard = noisy_w8a8_matmul(key, x[first:first + rows], w,
                              first_sample=first)
    torch.testing.assert_close(shard, batch)
    own = noisy_w8a8_matmul(key, x[first:first + rows], w)
    assert torch.equal(own, shard) == (first == 0)


@pytest.mark.parametrize('name', ['fp32', 'w8a8', 'w8a8+noise', 'deepcache'])
def test_sharded_matches_single_device_and_reference(pipes, sd_pipes,
                                                     context, reference,
                                                     name):
    """Per request: the sharded engine (8 shards of one slot) against the
    port's single-device engine and the reference's; two sharded runs
    bitwise identical; decode overlap on by default and overlapping."""
    tpipe = (sd_pipes if name == 'deepcache' else pipes)[1]
    reqs, _ = _case(name)
    single = _serve(_port(tpipe, name, context, mesh=False), reqs)
    runs = []
    for _ in range(2):
        eng = _port(tpipe, name, context)
        runs.append(_serve(eng, reqs))
        assert eng.slots == NDEV and eng.overlap_decode
        assert eng.metrics.overlapped_decodes > 0
        assert eng.metrics.snapshot().devices == NDEV
    sharded = runs[0]
    assert sorted(sharded) == [r.request_id for r in reqs]
    assert _gap(_images(sharded), _images(single)) < MESH_ATOL[name]
    assert all(np.array_equal(sharded[i].image, runs[1][i].image)
               for i in sharded)
    assert _gap(_images(sharded), reference(name)) < REF_ATOL[name]
    for rid, r in sharded.items():
        s = single[rid]
        assert (r.steps_executed, r.full_evals, r.cached_evals) == \
            (s.steps_executed, s.full_evals, s.cached_evals)
        assert r.energy_j == s.energy_j
    if name == 'deepcache':
        assert any(r.cached_evals > 0 for r in sharded.values())


def test_noisy_draws_at_each_shards_own_shape_miss(pipes, reference,
                                                   monkeypatch):
    """The negative control: shards that draw their noise at their own
    shape (the noisy matmul without ``first_sample``: each shard the rows
    of shard 0) move every request off slot 0 by many times the tolerance
    the parity test holds the right draws to; the request on slot 0 draws
    its own rows either way."""
    def own_shape(*args, first_sample=0, **kw):
        return noisy_w8a8_matmul(*args, **kw)

    monkeypatch.setattr(tnoise, 'noisy_w8a8_matmul', own_shape)
    got = _images(_serve(_port(pipes[1], 'w8a8+noise'),
                         _case('w8a8+noise')[0]))
    want = reference('w8a8+noise')
    tol = MESH_ATOL['w8a8+noise']
    assert float(np.abs(got[0] - want[0]).max()) < tol
    for rid in range(1, 6):
        gap = float(np.abs(got[rid] - want[rid]).max())
        assert gap > WRONG_DRAW_MARGIN * tol, (rid, gap)


def test_elastic_resize_parks_and_completes_in_flight(pipes):
    """8 -> 4 after two ticks: the slot buffer shrinks to the per-device
    budget, 4 requests park and re-enter ahead of the queued ones, every
    request completes with the image an engine that never resized gives
    it; then 4 -> 8 grows back and serves 8 more."""
    tpipe = pipes[1]
    first, queued = _reqs(8, start=50, steps=6), _reqs(2, start=58, steps=3)
    never = _serve(ContinuousBatchingEngine(
        tpipe, mesh=serving_mesh(NDEV, device='cpu'), slots_per_device=1,
        quality_probe=0), first + queued)
    tracer = Tracer()
    ee = ContinuousBatchingEngine(tpipe, mesh=serving_mesh(NDEV, device='cpu'),
                                  slots_per_device=1, quality_probe=0,
                                  tracer=tracer)
    for r in first + queued:
        assert ee.submit(r, now=0.0)
    done = ee.tick(now=0.0) + ee.tick(now=0.0)    # all 8 slots 2 steps deep
    done += ee.elastic_resize(n_devices=4)         # 4 keep running, 4 park
    assert ee.slots == 4 and len(ee._parked) == 4 and ee.mesh.size == 4
    assert [sh.x.shape[0] for sh in ee._shards] == [1] * 4
    done += ee.run_until_idle(now=0.0)
    got = {r.request_id: r for r in done}
    assert sorted(got) == list(range(50, 60))
    assert _gap(_images(got), _images(never)) < MESH_ATOL['fp32']
    assert all(got[i].steps_executed == 6 for i in range(50, 58))
    names = [(e.name, e.rid) for e in tracer.events
             if e.name in ('unpark', 'slot_assign')]
    unparked = [rid for name, rid in names if name == 'unpark']
    assert sorted(unparked) == list(range(50, 58))
    last_unpark = max(i for i, (name, _) in enumerate(names)
                      if name == 'unpark')
    assert all(i > last_unpark for i, (name, rid) in enumerate(names)
               if rid in (58, 59))
    # the event counts what parked before the new slots took their share
    assert [e.args['parked'] for e in tracer.select('elastic_resize')] == [8]
    ee.elastic_resize(n_devices=NDEV)             # devices rejoin
    grown = _serve(ee, _reqs(8, start=70, steps=3))
    assert ee.slots == NDEV and len(grown) == 8
    snap = ee.metrics.snapshot()
    assert snap.resizes == 2 and snap.devices == NDEV
    assert ee.metrics.resizes == [(NDEV, 4), (4, NDEV)]


def test_shed_accounting_reconciles_on_mesh(pipes):
    """No request is lost on the mesh: completed + shed == offered under
    a bounded deadline-aware queue, and under service-time-aware expiry
    every shed is 'expired'."""
    def sharded(queue):
        return ContinuousBatchingEngine(
            pipes[1], mesh=serving_mesh(NDEV, device='cpu'),
            slots_per_device=1, quality_probe=0, queue=queue)

    es = sharded(AdmissionQueue(max_depth=4, shed_policy='deadline-aware'))
    for r in _reqs(20, start=200, steps=4, slo_ms=60_000.0):
        es.submit(r, now=0.0)                  # 8 slots, 4 queued, 8 shed
    completed = es.run_until_idle(now=0.0)
    shed = int(es.metrics.summary()['shed'])
    assert len(completed) + shed == 20 and shed > 0
    ex = sharded(AdmissionQueue())
    for r in _reqs(12, start=300, steps=4, slo_ms=10_000.0):
        ex.submit(r, now=0.0)                  # 8 active, 4 queued
    ex.tick_s_estimate = 1e6                   # the 4 queued never finish
    completed = ex.run_until_idle(now=0.0)
    shed = int(ex.metrics.summary()['shed'])
    assert len(completed) + shed == 12
    assert ex.metrics.shed_by_reason.get('expired') == shed > 0


def test_straggler_fires_once_per_flagged_set(pipes):
    """A device recorded slow into the monitor raises one ``straggler``
    event and one callback; the same flagged set does not fire again (a
    tick polls too), another set does."""
    reports, tracer = [], Tracer()
    eng = ContinuousBatchingEngine(
        pipes[1], mesh=serving_mesh(4, device='cpu'), slots_per_device=1,
        quality_probe=0, tracer=tracer, on_straggler=reports.append)
    assert eng.monitor.n_hosts == 4

    def record(slow):
        for _ in range(eng.monitor.window):     # the whole window
            for dev in range(4):
                eng.monitor.record(dev, 1.0 if dev in slow else 0.01)

    assert eng._poll_straggler() is None and not reports
    record({2})
    assert eng._poll_straggler().slow_hosts == [2]
    eng._poll_straggler()
    _serve(eng, _reqs(1, steps=1))
    assert [r.slow_hosts for r in reports] == [[2]]
    assert [e.args['slow_devices'] for e in tracer.select('straggler')] == \
        [[2]]
    record({3})
    eng._poll_straggler()
    assert [r.slow_hosts for r in reports] == [[2], [3]]


def test_bucket_router_routes_and_ticks(pipes):
    """The reference's router cases: one engine per bucket, routing to the
    only engine, a second engine for a taken bucket refused; with two
    buckets a submission must name its bucket."""
    tpipe = pipes[1]
    router = BucketRouter()
    b = router.register(ContinuousBatchingEngine(tpipe, slots=1))
    assert b == bucket_for(tpipe.unet_cfg) == Bucket('tiny-dist', 16, 3)
    assert router.submit(GenerationRequest(0, seed=3, steps=2), now=0.0)
    out = []
    for k in range(20):
        out.extend(router.tick(now=float(k)))
        if not router.busy:
            break
    assert [r.request_id for r in out] == [0]
    with pytest.raises(ValueError, match='already registered'):
        router.register(ContinuousBatchingEngine(tpipe, slots=1))
    small = TPipe.init(0, tu.UNetConfig(**dict(vars(JTINY), img_size=8,
                                               attn_resolutions=(4,))),
                       device='cpu')
    b8 = router.register(ContinuousBatchingEngine(small, slots=1))
    assert router.buckets == [b, b8] and router.engine(b8).pipe is small
    with pytest.raises(ValueError, match='ambiguous routing'):
        router.submit(GenerationRequest(1, seed=4, steps=1))
    assert router.submit(GenerationRequest(1, seed=4, steps=1), bucket=b8,
                         now=0.0)
    out = []
    while router.busy:
        out.extend(router.tick(now=0.0))
    assert [r.image.shape for r in out] == [(8, 8, 3)]


def test_resize_retiles_a_shared_context_and_refuses_distinct_rows(
        sd_pipes, context):
    """A context whose rows are all equal is re-tiled to the new slot
    count and the guided work completes; rows that differ cannot follow
    their requests, so the resize raises and leaves the engine as it
    was: to fewer slots, and to as many when a gap among the live slots
    would move a request to another slot (and another row)."""
    tpipe = sd_pipes[1]
    reqs = _reqs(8, steps=3, guidance=7.5)
    eng = ContinuousBatchingEngine(
        tpipe, mesh=serving_mesh(NDEV, device='cpu'), slots_per_device=1,
        quality_probe=0, context=torch.from_numpy(context))
    for r in reqs:
        eng.submit(r, now=0.0)
    done = eng.tick(now=0.0) + eng.elastic_resize(n_devices=2, warm=False)
    assert eng.context.shape == (2, 5, 8)
    assert [sh.context.shape[0] for sh in eng._shards] == [1, 1]
    done += eng.run_until_idle(now=0.0)
    assert sorted(r.request_id for r in done) == list(range(8))
    distinct = np.random.default_rng(4).normal(size=context.shape)
    eng = ContinuousBatchingEngine(
        tpipe, mesh=serving_mesh(NDEV, device='cpu'), slots_per_device=1,
        quality_probe=0, context=torch.from_numpy(distinct).float())
    eng.submit(reqs[0], now=0.0)
    eng.tick(now=0.0)
    with pytest.raises(ValueError, match='distinct rows'):
        eng.elastic_resize(n_devices=4)
    assert eng.slots == NDEV and eng.active_count == 1
    assert not eng._parked
    # slot 0 drains after one step, slot 1 stays live: a resize to the
    # same count would re-pack it into slot 0, which attends to row 0
    gap = ContinuousBatchingEngine(
        tpipe, mesh=serving_mesh(NDEV, device='cpu'), slots_per_device=1,
        quality_probe=0, context=torch.from_numpy(distinct).float())
    gap.submit(_reqs(1, steps=1)[0], now=0.0)
    gap.submit(_reqs(1, start=1, steps=3)[0], now=0.0)
    done = gap.tick(now=0.0)
    assert [a is not None for a in gap._slot[:2]] == [False, True]
    with pytest.raises(ValueError, match='distinct rows'):
        gap.elastic_resize(n_devices=NDEV)
    assert gap.slots == NDEV and gap._slot[1] is not None
    assert not gap._parked
    done += gap.run_until_idle(now=0.0)
    assert sorted(r.request_id for r in done) == [0, 1]


def test_mesh_and_resize_guards(pipes, monkeypatch):
    """``serving_mesh`` takes 1..k cards and raises outside, as the
    reference does; logical shards on the CPU and a device named twice;
    ``elastic_resize`` needs a sharded engine and a target."""
    monkeypatch.setattr(tmesh.torch.cuda, 'device_count', lambda: 2)
    with pytest.raises(ValueError, match='need 1..2 devices, got 3'):
        serving_mesh(3)
    with pytest.raises(ValueError, match='need 1..2 devices, got 0'):
        serving_mesh(0)
    assert serving_mesh(2).devices == (torch.device('cuda', 0),
                                       torch.device('cuda', 1))
    cpu = serving_mesh(3, device='cpu')
    assert cpu.devices == (torch.device('cpu'),) * 3
    assert cpu.size == 3
    assert serving_mesh(devices=['cpu', 'cpu']).size == 2
    assert serving_mesh(1, devices=['cpu', 'cpu']).size == 1
    single = ContinuousBatchingEngine(pipes[1], slots=2)
    assert single.mesh is None and not single.overlap_decode
    with pytest.raises(ValueError, match='mesh-sharded engine'):
        single.elastic_resize(n_devices=1)
    sharded = ContinuousBatchingEngine(pipes[1], slots=5,
                                       mesh=serving_mesh(2, device='cpu'))
    assert sharded.slots == 6                     # rounded to the mesh
    with pytest.raises(ValueError, match='n_devices or an explicit'):
        sharded.elastic_resize()
    with pytest.raises(ValueError, match='slots_per_device'):
        ContinuousBatchingEngine(pipes[1], mesh=cpu, slots_per_device=0)
    # two logical shards share one parameter replica
    assert len({id(sh.pipe) for sh in sharded._shards}) == 1
