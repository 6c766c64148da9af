"""The port's observability (``repro_torch.obs``) and the engine features it
reads (``replay``'s clock, ``tick_s_estimate``, shedding, decode overlap,
``summary``, the slot-sizing helpers) against the reference.

The exporters are copies: the same events give byte-equal files.  The
engines run the same request sequence on a logical clock from the same
weights (``bridge.load_jax_params``): their event streams (name, category,
ids and args; the wall timestamps of the step, tick and warmup spans
and the occupancy counter left out) and their Prometheus expositions (the wall-clock ``warmup`` and
``first_tick`` lines left out) agree, floats within 1e-12 relative (the
photonic accountant is a copy computed in the same order; the latencies
are logical).  Shedding gives the same ``shed_by_reason``.  Decode overlap
on the CPU runs the decode in order, so its images equal those with
overlap off exactly."""
import json
import math
import time

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.diffusion.pipeline import DiffusionPipeline as JPipe
from repro.models import unet as ju
from repro.serving import AdmissionQueue as JQueue
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import GenerationRequest as JReq
from repro.serving import batcher as jbatcher
from repro_torch import obs as tobs
from repro_torch.bridge import load_jax_params
from repro_torch.diffusion.pipeline import DiffusionPipeline as TPipe
from repro_torch.models import unet as tu
from repro_torch.serving import AdmissionQueue as TQueue
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import GenerationRequest as TReq
from repro_torch.serving import ServingMetrics
from repro_torch.serving import batcher as tbatcher

JCFG = ju.UNetConfig('tiny-obs', img_size=16, in_ch=3, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                     n_heads=4, timesteps=16)
TCFG = tu.UNetConfig(**vars(JCFG))
FLOAT_RTOL = 1e-12
IMAGE_ATOL = 1e-3         # w8a8: one int8 rounding at a tie, as elsewhere
# events the engine stamps with the tracer's wall clock
WALL_EVENTS = ('step', 'tick', 'warmup', 'occupancy')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jpipe():
    return JPipe.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope='module')
def tpipe(jpipe):
    pipe = TPipe.init(0, TCFG, device='cpu')
    load_jax_params(pipe.unet, jax.tree_util.tree_map(np.asarray,
                                                      jpipe.unet_params))
    return pipe


def _strict(text):
    def boom(tok):
        raise AssertionError(f'non-strict JSON token {tok!r}')
    return json.loads(text, parse_constant=boom)


# ---------------------------------------------------------------------------
# the copied modules
# ---------------------------------------------------------------------------

def _record(mod):
    """The same explicit-timestamp events through one package's tracer."""
    tr = mod.Tracer()
    tr.instant('submit', cat='queue', ts=0.0, rid=0, steps=4,
               precision='w8a8', trace_id='req-0')
    tr.instant('shed', cat='queue', ts=0.25, rid=3, reason='queue_full')
    tr.complete('step', 0.5, 0.75, cat='tick', tick=0, precision='fp32',
                refresh=True, guided=False, slots=2, energy_j=1.5e-3)
    tr.complete('request', 0.0, 1.0, cat='request', rid=0, slot=2,
                device=1, psnr=float('nan'), energy_j=float('inf'))
    tr.counter('occupancy', cat='engine', ts=1.0, tick=0, active=2,
               queued=1)
    tr.instant('decode_done', cat='decode', ts=1.0, rid=0, slot=2,
               overlapped=True)
    return tr


@pytest.mark.parametrize('fmt', ['chrome', 'jsonl'])
def test_exporters_write_the_reference_bytes(tmp_path, fmt):
    paths = []
    for name, mod in (('jax', jobs), ('torch', tobs)):
        path = tmp_path / f'{name}.{fmt}'
        writer = mod.write_chrome_trace if fmt == 'chrome' \
            else mod.write_jsonl
        writer(_record(mod), str(path))
        paths.append(path)
    got, want = paths[1].read_bytes(), paths[0].read_bytes()
    assert got == want and len(got) > 0
    if fmt == 'jsonl':
        back = tobs.read_jsonl(str(paths[1]))
        assert [e['name'] for e in back] == [e.name for e in
                                             _record(tobs).events]
        assert back[3]['args']['psnr'] is None
    else:
        _strict(got.decode())


def test_obs_exports_the_reference_names():
    assert tobs.__all__ == jobs.__all__
    assert tobs.CATEGORIES == jobs.CATEGORIES
    assert tobs.NAMESPACE == jobs.NAMESPACE
    assert tobs.NULL_TRACER.enabled is False and tobs.Tracer().enabled
    assert tobs.sanitize({'a': [float('nan')]}) == {'a': [None]}


def test_snapshot_reporter_interval_matches_reference():
    """Both reporters on one fake clock: the same lines at the same
    polls (the first arms, then one every interval)."""
    out = {}
    for name, mod in (('jax', jobs), ('torch', tobs)):
        clock = iter([0.0, 0.5, 1.0, 1.2, 2.5, 2.6])
        lines = []
        rep = mod.SnapshotReporter(interval_s=1.0, emit=lines.append,
                                   clock=lambda: next(clock))
        m = ServingMetrics()
        for _ in range(6):
            rep.maybe_report(metrics=m, active_slots=1, queued=2)
        out[name] = (lines, rep.reports)
    assert out['torch'] == out['jax'] and out['torch'][1] == 2


# ---------------------------------------------------------------------------
# load model
# ---------------------------------------------------------------------------

GRID = [(rate, step_s, steps) for rate in (0.0, 0.5, 4.0, 17.0)
        for step_s in (0.0, 0.012, 0.121) for steps in (0, 4, 10, 50)]


@pytest.mark.parametrize('rate,step_s,steps', GRID)
def test_load_model_matches_reference(rate, step_s, steps):
    for slots in (1, 3, 4):
        assert tbatcher.overload_factor(rate, step_s, steps, slots) == \
            jbatcher.overload_factor(rate, step_s, steps, slots)
    assert tbatcher.offered_load(rate, step_s, steps) == \
        jbatcher.offered_load(rate, step_s, steps)
    for util, max_slots, shards in ((0.8, 64, 1), (0.5, 8, 2), (0.9, 3, 4)):
        assert tbatcher.choose_slots(rate, step_s, steps, util, max_slots,
                                     shards) == \
            jbatcher.choose_slots(rate, step_s, steps, util, max_slots,
                                  shards)


def test_per_precision_load_and_slot_alignment_match_reference():
    rate = {'fp32': 1.0, 'w8a8': 4.0, 'w8a8+noise': 0.0}
    step_s = {'fp32': 0.116, 'w8a8': 0.121, 'w8a8+noise': 0.742}
    for fn in ('offered_load', 'choose_slots'):
        assert getattr(tbatcher, fn)(rate, step_s, 10) == \
            getattr(jbatcher, fn)(rate, step_s, 10)
    for slots in range(1, 9):
        for shards in range(1, 5):
            assert tbatcher.align_slots(slots, shards) == \
                jbatcher.align_slots(slots, shards)
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            tbatcher.align_slots(*bad)
    with pytest.raises(ValueError):
        tbatcher.overload_factor(1.0, 0.1, 10, slots=0)


# ---------------------------------------------------------------------------
# one logical-clock run through both engines
# ---------------------------------------------------------------------------

# tick -> requests submitted before it: a w8a8 request beside fp32 ones,
# an early exit, a burst past the queue bound (shed as queue_full) and a
# request whose deadline passes while it waits (shed as expired)
SEQ = {0: [dict(request_id=0, seed=10, steps=2),
           dict(request_id=1, seed=11, steps=3, precision='w8a8'),
           dict(request_id=2, seed=12, steps=5, exit_tol=10.0),
           dict(request_id=3, seed=13, steps=2)],
       1: [dict(request_id=4, seed=14, steps=2, slo_ms=500.0)]}


def _run(engine, make_req):
    results, now = [], 0.0
    for k in range(100):
        for r in SEQ.get(k, ()):
            engine.submit(make_req(**r), now=now)
        results.extend(engine.tick(now=now))
        now += 1.0
        if not engine.busy and k >= max(SEQ):
            return {r.request_id: r for r in results}
    raise AssertionError('engine did not drain')


@pytest.fixture(scope='module')
def both_runs(jpipe, tpipe):
    """Both engines after serving ``SEQ`` traced, with decode overlap, on
    2 slots and a queue bounded at 3; memoised."""
    out = {}
    for name, engine, queue, tracer, req in (
            ('jax', JEngine, JQueue, jobs.Tracer, JReq),
            ('torch', TEngine, TQueue, tobs.Tracer, TReq)):
        tr = tracer()
        eng = engine(jpipe if name == 'jax' else tpipe, slots=2,
                     quality_probe=0, overlap_decode=True, tracer=tr,
                     queue=queue(max_depth=3))
        eng.warmup(precisions=('fp32', 'w8a8'))
        out[name] = eng, tr, _run(eng, req)
    return out


def _plain(v):
    if isinstance(v, float) and math.isfinite(v):
        return pytest.approx(v, rel=FLOAT_RTOL)
    return v


def _stream(tracer):
    """Each event's dict without its wall timestamps."""
    rows = []
    for e in tracer.events:
        d = e.to_dict()
        if e.name in WALL_EVENTS:
            d.pop('ts'), d.pop('dur', None)
            d['args'] = {k: v for k, v in d.get('args', {}).items()
                         if k != 'seconds'}
        rows.append(d)
    return rows


def test_engine_event_stream_matches_reference(both_runs):
    _, jtr, jres = both_runs['jax']
    _, ttr, tres = both_runs['torch']
    want, got = _stream(jtr), _stream(ttr)
    assert [(e['name'], e['cat']) for e in got] == \
        [(e['name'], e['cat']) for e in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g, w)
        for k in w:
            if k == 'args':
                assert g[k].keys() == w[k].keys(), (g, w)
                for a in w[k]:
                    assert g[k][a] == _plain(w[k][a]), (a, g, w)
            else:
                assert g[k] == _plain(w[k]), (k, g, w)
    names = {e['name'] for e in want}
    assert {'submit', 'shed', 'slot_assign', 'early_exit', 'decode_dispatch',
            'decode_done', 'complete', 'request', 'step', 'tick',
            'warmup', 'occupancy'} <= names
    assert sorted(tres) == sorted(jres) == [0, 1, 2]
    for rid, w in jres.items():
        np.testing.assert_allclose(tres[rid].image, np.asarray(w.image),
                                   atol=IMAGE_ATOL)


def _prom_lines(metrics, mod):
    out = []
    for line in mod.render_exposition(metrics).splitlines():
        if 'warmup' in line or 'first_tick' in line:
            continue
        if line.startswith('#'):
            out.append(line)
        else:
            name, value = line.rsplit(' ', 1)
            out.append((name, _plain(float(value))))
    return out


def test_exposition_matches_reference(both_runs):
    jeng, _, _ = both_runs['jax']
    teng, _, _ = both_runs['torch']
    got = _prom_lines(teng.metrics, tobs)
    assert got == _prom_lines(jeng.metrics, jobs)
    assert ('repro_serving_overlapped_decodes_total', 2) in got
    assert ('repro_serving_shed_total{reason="queue_full"}', 1) in got
    assert ('repro_serving_shed_total{reason="expired"}', 1) in got


def test_summary_matches_reference(both_runs):
    js = both_runs['jax'][0].metrics.summary()
    ts = both_runs['torch'][0].metrics.summary()
    assert list(ts) == list(js)
    for k in js:
        if k not in ('warmup_s', 'first_tick_s'):
            assert ts[k] == _plain(js[k]), k
    assert ts['overlapped_decodes'] == 2.0 and ts['devices'] == 1.0
    assert ts['shed_queue_full'] == ts['shed_expired'] == 1.0


# ---------------------------------------------------------------------------
# shedding, as the reference's overload tests run it, on both engines
# ---------------------------------------------------------------------------

def _burst(req, eng):
    for i in range(6):
        eng.submit(req(request_id=i, seed=100 + i, steps=2), now=0.0)
    return eng.run_until_idle(now=0.0, tick_dt=0.01)


def _expiry(req, eng, slo_ms=1.0, now=1.0):
    assert eng.submit(req(request_id=0, seed=100, steps=3), now=0.0)
    assert eng.submit(req(request_id=1, seed=101, steps=3, slo_ms=slo_ms),
                      now=0.0)
    return eng.run_until_idle(now=now, tick_dt=0.01)


SHED_CASES = {
    # case: (slots, queue kwargs, pinned tick_s_estimate)
    'burst_queue_full': (2, dict(max_depth=3), None),
    'expired_deadline_aware': (1, dict(shed_policy='deadline-aware'), None),
    'expired_reject_newest': (1, {}, None),
    'will_miss_slo': (1, dict(shed_policy='deadline-aware'), 10.0),
    'fits_without_estimate': (1, dict(shed_policy='deadline-aware'), None),
}


@pytest.mark.parametrize('case', sorted(SHED_CASES))
def test_shedding_matches_reference(jpipe, tpipe, case):
    slots, qkw, tick_s = SHED_CASES[case]
    out = {}
    for name, engine, queue, req in (('jax', JEngine, JQueue, JReq),
                                     ('torch', TEngine, TQueue, TReq)):
        eng = engine(jpipe if name == 'jax' else tpipe, slots=slots,
                     quality_probe=0, queue=queue(**qkw))
        assert eng.tick_s_estimate is None
        eng.tick_s_estimate = tick_s
        if case == 'burst_queue_full':
            res = _burst(req, eng)
        elif case in ('will_miss_slo', 'fits_without_estimate'):
            # 5 s of slack at admission; 3 steps at 10 s a tick cannot fit
            res = _expiry(req, eng, slo_ms=5000.0, now=0.0)
        else:
            res = _expiry(req, eng)
        out[name] = (sorted(r.request_id for r in res),
                     dict(eng.metrics.shed_by_reason),
                     eng.metrics.summary()['deadline_sheds'])
    assert out['torch'] == out['jax']
    want = {'burst_queue_full': {'queue_full': 3},
            'fits_without_estimate': {}}.get(case, {'expired': 1})
    assert out['torch'][1] == want


# ---------------------------------------------------------------------------
# the port's engine alone
# ---------------------------------------------------------------------------

def _serve_two(tpipe, overlap):
    eng = TEngine(tpipe, slots=2, quality_probe=0, overlap_decode=overlap)
    eng.submit(TReq(0, seed=1, steps=2), now=0.0)
    eng.submit(TReq(1, seed=2, steps=3), now=0.0)
    surfaced = []
    for k in range(10):
        surfaced.append([r.request_id for r in eng.tick(now=float(k))])
        if not eng.busy:
            break
    return eng, surfaced


def test_decode_overlap_surfaces_results_one_tick_later(tpipe):
    eng_off, off = _serve_two(tpipe, False)
    eng_on, on = _serve_two(tpipe, True)
    assert not eng_off._sides and not eng_on._sides          # the CPU
    assert off == [[], [0], [1]]
    assert on == [[], [], [0], [1]]
    assert eng_on.metrics.overlapped_decodes == 1   # the last one: idle
    assert eng_off.metrics.overlapped_decodes == 0
    assert eng_on.metrics.ticks == eng_off.metrics.ticks == 3


def test_decode_overlap_keeps_images_and_latencies(tpipe):
    res = {}
    for overlap in (False, True):
        eng = TEngine(tpipe, slots=2, quality_probe=0,
                      overlap_decode=overlap)
        for i, steps in enumerate((2, 3, 2)):
            eng.submit(TReq(i, seed=20 + i, steps=steps), now=0.0)
        res[overlap] = {r.request_id: r for r in
                        eng.run_until_idle(now=0.0, tick_dt=1.0)}
    for rid, r in res[False].items():
        np.testing.assert_array_equal(res[True][rid].image, r.image)
        # the logical clock stamps the drain's tick, overlapped or not
        assert res[True][rid].finish_time == r.finish_time


def test_warmup_and_measure_leave_clock_trace_and_metrics(tpipe):
    tr = tobs.Tracer()
    eng = TEngine(tpipe, slots=2, quality_probe=0, tracer=tr,
                  overlap_decode=True)
    metrics, queue = eng.metrics, eng.queue
    eng.warmup()
    assert [e.name for e in tr.events] == ['warmup']
    t = eng.measure_tick_s(steps=2)
    assert t > 0.0 and eng.tick_s_estimate == t
    assert eng.metrics is metrics and eng.queue is queue
    assert eng.tracer is tr and len(tr) == 1
    assert eng._wall_t0 == 0.0 and metrics.ticks == 0
    assert metrics.submitted == metrics.completed == 0
    assert metrics.warmup_s > 0 and not eng.busy


def test_replay_runs_on_the_serving_clock(tpipe):
    """Every time ``replay`` records is on the clock it starts: arrivals,
    trace timestamps and the results' timing fields, which the request
    spans repeat."""
    tr = tobs.Tracer()
    eng = TEngine(tpipe, slots=2, quality_probe=0, tracer=tr)
    reqs = [TReq(i, seed=i, steps=2, arrival_time=a)
            for i, a in enumerate((0.0, 0.0, 0.05))]
    t0 = time.perf_counter()
    results = eng.replay(reqs)
    wall = time.perf_counter() - t0
    assert sorted(r.request_id for r in results) == [0, 1, 2]
    assert eng._wall_t0 >= t0
    for r in results:
        assert reqs[r.request_id].arrival_time <= r.submit_time
        assert r.submit_time <= r.start_time <= r.finish_time <= wall
    spans = {s.rid: s for s in tr.spans('request')}
    for r in results:
        assert spans[r.request_id].ts == r.submit_time
        assert spans[r.request_id].dur == pytest.approx(r.latency_s,
                                                        abs=1e-12)
    assert all(0.0 <= e.ts <= wall for e in tr.events)


def test_untraced_engine_builds_no_events(tpipe):
    eng = TEngine(tpipe, slots=2, quality_probe=0)
    assert eng.tracer is tobs.NULL_TRACER
    eng.submit(TReq(0, seed=0, steps=2), now=0.0)
    eng.run_until_idle(now=0.0)
    assert len(tobs.NULL_TRACER) == 0
