"""The port's ``serve --diffusion`` against the reference's: the same
Poisson arrivals, then ``serve_diffusion`` of both packages on the
reference CLI's toy UNet at 16 px, the port's pipeline carrying the
reference's weights (``bridge.load_jax_params``); and the port's CLI on
the CPU, flag by flag.

Under a Poisson trace the wall clock decides which requests share a
tick, but fp32 and w8a8 images do not depend on that (the UNet and the
per-row activation scales treat slot rows independently), so they are
held there: images per request id within ``IMAGE_ATOL`` (w8a8: one int8
rounding at a tie, worth one LSB, as in the engine parity tests),
energies to 1e-12 relative.  DeepCache's phase follows admission and a
noisy request's keys follow the tick index, so the cached, early-exit
and noisy cases replay with every arrival at t=0 (an infinite rate),
which fixes the schedule; their tallies are then exact."""
import json

import jax
import numpy as np
import pytest
import torch

import repro.serving
from repro.diffusion.pipeline import DiffusionPipeline as JPipe
from repro.launch import serve as jserve
from repro.models import unet as ju
from repro_torch.bridge import load_jax_params
from repro_torch.launch import serve as tserve
from repro_torch.obs import read_jsonl

IMAGE_ATOL = 1e-3
ENERGY_RTOL = 1e-12
IMG, SLOTS = 16, 2


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


@pytest.fixture(scope='module')
def tpipe():
    """The port's toy pipeline with the weights the reference CLI draws
    (``DiffusionPipeline.init(PRNGKey(0), cfg)`` on its own config)."""
    pipe = tserve._diffusion_pipe('toy', IMG, 'cpu')
    jcfg = ju.UNetConfig(**vars(pipe.unet_cfg))
    jpipe = JPipe.init(jax.random.PRNGKey(0), jcfg)
    load_jax_params(pipe.unet, jax.tree_util.tree_map(np.asarray,
                                                      jpipe.unet_params))
    return pipe


@pytest.mark.parametrize('n,rate,seed,slo_ms,precision', [
    (6, 8.0, 0, None, 'fp32'), (16, 4.0, 0, 250.0, 'w8a8'),
    (5, 0.7, 3, None, 'w8a8+noise'), (4, float('inf'), 1, None, 'fp32')])
def test_poisson_trace_matches_reference(n, rate, seed, slo_ms, precision):
    got = tserve.poisson_trace(n, rate, 4, seed, slo_ms=slo_ms,
                               precision=precision)
    want = jserve.poisson_trace(n, rate, 4, seed, slo_ms=slo_ms,
                                precision=precision)
    fields = ('request_id', 'seed', 'steps', 'arrival_time', 'slo_ms',
              'precision')
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]
    if rate == float('inf'):
        assert all(r.arrival_time == 0.0 for r in got)


def _reference_serve(monkeypatch, **kw):
    """The reference's ``serve_diffusion`` and the engine it built."""
    engines = []

    class Recorded(repro.serving.ContinuousBatchingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)
    monkeypatch.setattr(repro.serving, 'ContinuousBatchingEngine', Recorded)
    results = jserve.serve_diffusion(IMG, n_requests=4, slots=SLOTS, **kw)
    return {r.request_id: r for r in results}, engines[0]


CASES = {
    # case: serve_diffusion keywords
    'poisson_fp32': dict(steps=3, rate_hz=8.0, precision='fp32'),
    'poisson_w8a8': dict(steps=3, rate_hz=8.0, precision='w8a8'),
    'at_once_cached_early_exit': dict(steps=6, rate_hz=float('inf'),
                                      precision='fp32', cache_interval=3,
                                      exit_tol=10.0),
    'at_once_noisy': dict(steps=3, rate_hz=float('inf'),
                          precision='w8a8+noise'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_serve_diffusion_matches_reference(tpipe, monkeypatch, case):
    kw = dict(CASES[case], quality_probe=0)
    want, jeng = _reference_serve(monkeypatch, **kw)
    results, summary = tserve.serve_diffusion(
        IMG, n_requests=4, slots=SLOTS, pipe=tpipe, **kw)
    got = {r.request_id: r for r in results}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid, w in want.items():
        g = got[rid]
        assert (g.precision, g.steps_executed, g.full_evals, g.cached_evals,
                g.early_exit) == (w.precision, w.steps_executed,
                                  w.full_evals, w.cached_evals,
                                  w.early_exit), rid
        assert g.energy_j == pytest.approx(w.energy_j, rel=ENERGY_RTOL)
        np.testing.assert_allclose(g.image, np.asarray(w.image),
                                   atol=IMAGE_ATOL, err_msg=str(rid))
    js = jeng.metrics.summary()
    assert set(summary) - {'makespan_s'} == set(js)
    assert summary['completed'] == js['completed'] == 4.0
    assert summary['total_energy_mj'] == pytest.approx(
        js['total_energy_mj'], rel=ENERGY_RTOL)
    if case.startswith('at_once'):
        for k in ('early_exits', 'steps_saved', 'cache_hit_rate'):
            assert summary[k] == js[k], k
    if case == 'at_once_cached_early_exit':
        assert summary['early_exits'] == 4.0
        assert summary['cache_hit_rate'] > 0


def _main(capsys, *flags):
    tserve.main(['--diffusion', '--device', 'cpu', '--requests', '6',
                 '--rate', '8', '--slots', '3', '--steps', '4', '--img',
                 str(IMG), *flags])
    return capsys.readouterr().out


def test_cli_prints_the_reference_report(capsys):
    out = _main(capsys)
    lines = out.splitlines()
    assert any(line.startswith('[serve] 6 done in') and 'req/s' in line
               and 'p99=' in line for line in lines)
    assert any(line.startswith('[energy]') and 'GPU digital baseline' in line
               for line in lines)
    assert any(line.startswith('[frontier] fp32:') for line in lines)
    assert '[sched]' not in out and '[overload]' not in out
    assert 'psnr=' not in out


def test_cli_w8a8_adds_the_quality_columns(capsys):
    out = _main(capsys, '--precision', 'w8a8')
    line = next(x for x in out.splitlines() if x.startswith('[frontier]'))
    assert line.startswith('[frontier] w8a8:') and 'psnr=' in line \
        and '6 probed' in line
    assert 'simulated DiffLight' in out


def test_cli_scheduler_adds_the_sched_line(capsys):
    out = _main(capsys, '--cache-interval', '3', '--exit-tol', '0.01')
    assert any(line.startswith('[sched] cache_hit_rate=')
               for line in out.splitlines())
    assert 'cache_interval=3, exit_tol=0.01 patience=2' in out


def test_cli_overload_survives(capsys):
    out = _main(capsys, '--overload', '5')
    lines = out.splitlines()
    cap = next(x for x in lines if x.startswith('[overload] measured'))
    assert '= 5.0x, queue_depth=6' in cap
    line = next(x for x in lines if x.startswith('[overload] survived:'))
    shed = int(line.split(' shed ')[1].split('/')[0])
    done = int(next(x for x in lines if x.startswith('[serve]')
                    and ' done in ' in x).split()[1])
    assert done + shed == 6
    peak = line.split('queue peaked at ')[1].split(',')[0]
    assert int(peak.split('/')[0]) <= int(peak.split('/')[1]) == 6


def test_cli_writes_trace_log_and_exposition(capsys, tmp_path):
    paths = {k: str(tmp_path / f'serve.{k}') for k in ('json', 'jsonl',
                                                         'prom')}
    out = _main(capsys, '--overlap-decode', 'on', '--trace', paths['json'],
                '--log-json', paths['jsonl'], '--prom', paths['prom'],
                '--report-every', '0.01')
    assert '[obs] trace reconciled: 6 request spans == 6 completed' in out
    assert '[obs] completed=' in out        # the snapshot reporter
    with open(paths['json']) as f:
        doc = json.loads(f.read(), parse_constant=lambda tok: 1 / 0)
    names = {r['name'] for r in doc['traceEvents']}
    assert {'request', 'step', 'tick', 'decode_done', 'thread_name'} <= names
    events = read_jsonl(paths['jsonl'])
    assert sum(e['name'] == 'request' for e in events) == 6
    assert any(e['name'] == 'decode_done' and e['args']['overlapped']
               for e in events)
    with open(paths['prom']) as f:
        prom = f.read()
    assert '# TYPE repro_serving_completed_total counter' in prom
    assert 'repro_serving_completed_total 6\n' in prom
    assert 'repro_serving_latency_seconds{quantile="0.99"}' in prom


@pytest.fixture(scope='module')
def reference_cli_report():
    """The reference CLI's function on the trace the mesh flag cases
    replay (6 requests at 8 req/s, 4 steps, fp32), unsharded: its mesh
    needs XLA's forced device count, which this process cannot set."""
    engines = []

    class Recorded(repro.serving.ContinuousBatchingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)
    with pytest.MonkeyPatch.context() as mp, \
            jax.threefry_partitionable(True):
        mp.setattr(repro.serving, 'ContinuousBatchingEngine', Recorded)
        results = jserve.serve_diffusion(IMG, 4, 6, 8.0, 3,
                                         precision='fp32', quality_probe=0)
    return ({r.request_id: r for r in results},
            engines[0].metrics.summary())


# case: the mesh flags, and the [mesh] / [elastic] lines they print
MESH_CASES = {
    'devices': (['--devices', '2', '--slots-per-device', '1'],
                ['[mesh] slot axis sharded over 2 devices (cpu, cpu): 2 '
                 'slots (1/device), overlap_decode=True']),
    'shrink': (['--devices', '4', '--resize-to', '2', '--resize-after', '2'],
               ['[mesh] slot axis sharded over 4 devices',
                '[elastic] 2 done -> resizing 4 -> 2 devices mid-replay',
                '[elastic] rebuilt: 2 slots on 2 devices, ']),
    'grow': (['--devices', '1', '--slots-per-device', '1', '--resize-to',
              '3', '--resize-after', '1'],
             ['[mesh] slot axis sharded over 1 devices (cpu): 1 slots',
              '[elastic] 1 done -> resizing 1 -> 3 devices mid-replay',
              '[elastic] rebuilt: 3 slots on 3 devices, ']),
    'rounded_overlap_off': (['--devices', '2', '--overlap-decode', 'off'],
                            ['[mesh] slot axis sharded over 2 devices (cpu, '
                             'cpu): 4 slots (2/device), '
                             'overlap_decode=False']),
}


@pytest.mark.parametrize('case', sorted(MESH_CASES))
def test_cli_serves_the_mesh_flags(tpipe, reference_cli_report, capsys,
                                   monkeypatch, case):
    """The mesh flags on ``--device cpu`` (logical CPU shards, the port's
    CLI serving the reference's weights): every request completes with
    the image the reference CLI's function gives it, nothing is shed,
    and the ``[mesh]`` and ``[elastic]`` lines report the layout, the
    mid-replay resize and the straggler check."""
    flags, lines = MESH_CASES[case]
    monkeypatch.setattr(tserve, '_diffusion_pipe', lambda *a: tpipe)
    runs = []
    serve = tserve.serve_diffusion

    def recorded(*a, **k):
        runs.append(serve(*a, **k))
        return runs[-1]
    monkeypatch.setattr(tserve, 'serve_diffusion', recorded)
    out = _main(capsys, *flags)
    want, js = reference_cli_report
    results, summary = runs[0]
    got = {r.request_id: r for r in results}
    assert sorted(got) == sorted(want) == list(range(6))
    assert summary['completed'] == js['completed'] == 6.0
    assert summary['shed'] == js['shed'] == 0.0
    for rid, w in want.items():
        np.testing.assert_allclose(got[rid].image, np.asarray(w.image),
                                   atol=IMAGE_ATOL, err_msg=str(rid))
    for line in lines + ['[mesh] stragglers: none detected',
                         '[serve] 6 done in']:
        assert line in out, (line, out)
    assert ('[elastic]' in out) == ('--resize-to' in flags)
    assert summary['devices'] == float(flags[flags.index('--resize-to') + 1]
                                       if '--resize-to' in flags
                                       else flags[1])


def test_resize_needs_a_mesh(tpipe):
    with pytest.raises(ValueError, match='resize_to resizes a mesh'):
        tserve.serve_diffusion(IMG, 2, 2, 8.0, 2, resize_to=1, pipe=tpipe)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('checks the refusal where there is no GPU')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tserve.main(['--diffusion', '--requests', '1'])


def test_sd_model_refuses_another_image_size():
    with pytest.raises(ValueError, match='512-px'):
        tserve._diffusion_pipe('sd-v1.4', 16, 'cpu')
