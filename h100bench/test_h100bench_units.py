"""CPU tests of the benchmark's arithmetic: the traffic generator, the
metrics' reductions, the roofline and operation counts, and the import
rules of the harness and its reference."""
from __future__ import annotations

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import common, traffic
from harness.trace import _name_gaps, _union
from roofline import peaks, work

HERE = Path(__file__).resolve().parent


# --- traffic ---------------------------------------------------------------

POISSON = {'arrivals': 'poisson', 'rate': 2.0}
CLOSED = {'arrivals': 'closed'}
BATCHES = {'batch': 3, 'prompt_lengths': [4, 8, 16, 8]}


def _first(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize('seed', [0, 7, 2 ** 31 + 12345])
def test_traffic_is_deterministic_per_seed(seed):
    assert _first(traffic.image_requests(CLOSED, seed, 30), 20) == \
        _first(traffic.image_requests(CLOSED, seed, 30), 20)
    assert list(traffic.image_requests(POISSON, seed, 30)) == \
        list(traffic.image_requests(POISSON, seed, 30))
    for b in range(5):
        assert torch.equal(traffic.prompts(BATCHES, seed, b, 50),
                           traffic.prompts(BATCHES, seed, b, 50))
    a, b = (traffic.train_batch({'rows': 2, 'seq_len': 9}, seed, 3, 40)
            for _ in range(2))
    assert torch.equal(a['tokens'], b['tokens'])
    assert torch.equal(a['tokens'][:, 1:], a['labels'][:, :-1])


def test_seeds_change_contents_not_amounts():
    d0, d1 = (traffic.poisson_dues(POISSON, 30) for _ in range(2))
    g0 = np.diff(d0, prepend=0.0)
    assert len(d0) == 60 and np.array_equal(d0, d1)
    assert np.isclose(np.mean(g0), 1 / POISSON['rate'], rtol=0.01)
    assert d0[-1] < 30 and np.all(g0 > 0)
    r0, r1 = (list(traffic.image_requests(POISSON, s, 30)) for s in (1, 2))
    assert [r['due'] for r in r0] == [r['due'] for r in r1]
    assert [r['seed'] for r in r0] != [r['seed'] for r in r1]
    s0 = [r['seed'] for r in _first(traffic.image_requests(CLOSED, 1, 30), 8)]
    s1 = [r['seed'] for r in _first(traffic.image_requests(CLOSED, 2, 30), 8)]
    assert s0 != s1
    for b in range(4):
        p0, p1 = (traffic.prompts(BATCHES, s, b, 50) for s in (1, 2))
        assert p0.shape == p1.shape == (3, BATCHES['prompt_lengths'][b])
        assert not torch.equal(p0, p1)


@pytest.mark.parametrize('seed', [0, 7, 2 ** 31 + 12345])
def test_precision_map_is_drawn_per_request_from_the_seed(seed):
    from harness import precision
    mix = {'precision': {'w8a8+noise': 1, 'fp32': 1, 'w8a8': 2}}
    drawn = [traffic.precision(mix, seed, i) for i in range(400)]
    assert drawn == [traffic.precision(mix, seed, i) for i in range(400)]
    assert drawn != [traffic.precision(mix, seed + 1, i) for i in range(400)]
    assert drawn.count('w8a8') == pytest.approx(200, abs=40)
    assert drawn.count('fp32') == pytest.approx(100, abs=35)
    assert traffic.precisions(mix) == ['fp32', 'w8a8', 'w8a8+noise']
    one = {'precision': 'w8a8+noise'}
    assert traffic.precisions(one) == ['w8a8+noise']
    assert {traffic.precision(one, seed, i) for i in range(5)} == \
        {'w8a8+noise'}
    assert [precision.of(n).int8_gemm for n in traffic.precisions(mix)] == \
        [False, True, False]
    with pytest.raises(ValueError):
        precision.of('int4')


# --- the metrics' arithmetic ----------------------------------------------

def test_fractional_image_credit():
    credit = common.driver('sd_engine').image_credit
    # a window of 10 ticks, 4-step requests admitted at ticks 0, 4, 8, 12:
    # two whole, one with 2 of 4 steps inside, one after the window
    assert credit([0, 4, 8, 12], 4, 10) == pytest.approx(2.5)
    assert credit([], 4, 10) == 0.0
    assert credit([9], 50, 10) == pytest.approx(1 / 50)


def test_training_rate_over_whole_steps():
    rate = common.driver('lm_train').train_rate
    # 3 steps of 2 x 4096 tokens from t = 10 s to t = 16 s
    assert rate(3, 2 * 4096, 10.0, 16.0) == pytest.approx(4096.0)


def test_p90_counts_misses():
    lat = [1.0] * 8 + [2.0, math.inf]
    assert common.nearest_rank(lat, 0.9) == 2.0
    assert common.nearest_rank(lat + [math.inf], 0.9) == math.inf
    assert common.nearest_rank(list(range(1, 101)), 0.9) == 90
    assert common.nearest_rank([3.0, 1.0, 2.0], 0.5) == 2.0


def test_union_idle_counts_overlap_once():
    ops = [('a', 10, 30), ('b', 20, 40), ('c', 50, 60), ('d', 55, 58)]
    busy, gaps = _union(ops, 0, 100)
    assert busy == 40                          # 10-40 and 50-60
    assert gaps == [(0, 10), (40, 50), (60, 100)]
    host = [(0, 100, 'engine.tick', True), (35, 45, 'aten::item', False),
            (60, 100, 'aten::add_', False)]
    named = _name_gaps(gaps, host)
    assert named == pytest.approx({'engine.tick/-': 10e-9,
                                   'engine.tick/aten::item': 10e-9,
                                   'engine.tick/aten::add_': 40e-9})


def test_shares_read_nothing_without_work_or_time():
    from roofline.shares import mfu, roofline

    class Slice:
        window_s = 2.0

        @staticmethod
        def kernel_s(*names):
            return 0.5 if 'k' in names else 0.0

    w = work.Work()
    w.kernel('fam', 0.0, 3.35e12 * 0.25, 'fp32')      # 0.25 s of bytes
    w.product('int8', 1979e12 * 0.5)                  # 0.5 s at the peak
    layers = common.Layers(Slice, w, {})
    assert roofline(layers, 'fam', 'k') == pytest.approx(50.0)
    assert roofline(layers, 'fam', 'other') is None
    assert roofline(layers, 'none', 'k') is None
    assert mfu(layers) == pytest.approx(25.0)
    assert mfu(common.Layers(Slice, work.Work(), {})) is None


# --- roofline and operation counts ----------------------------------------

def test_least_time_is_the_larger_bound():
    assert peaks.least_s(1979e12, 0, 'int8') == pytest.approx(1.0)
    assert peaks.least_s(0, 3.35e12, 'int8') == pytest.approx(1.0)
    assert peaks.least_s(495e12 / 3, 1.0, 'fp32') == pytest.approx(1.0)


def test_w8a8_work_by_hand():
    w = work.Work()
    w.w8a8(128, 64, 32)
    ops = 2 * 128 * 64 * 32
    nbytes = 128 * 64 + 64 * 32 + 4 * 128 + 4 * 32 + 4 * 128 * 32
    assert w.least['w8a8'] == pytest.approx(max(ops / 1979e12,
                                                nbytes / 3.35e12))
    assert w.model_ops == {'int8': ops}


TINY_UNET = dict(img_size=16, in_ch=4, base_ch=8, ch_mults=[1, 2],
                 n_res_blocks=1, attn_resolutions=[8], n_heads=2,
                 context_dim=6, timesteps=10, groups=4)


def test_unet_counts_by_hand():
    B, T = 2, 5
    w = work.sd_unet_eval(TINY_UNET, B, T, quant=True)
    # ResBlocks: down 1 + 1, mid 2, up 2 + 2: two GroupNorms each, + gn_out
    assert w.calls['gn_swish'] == 2 * 8 + 1
    # attention at 8 px: down level 1 (1 block), mid, up level 1 (2
    # blocks): 4 blocks, 8 projections each with the context
    assert w.calls['w8a8'] == 4 * 8
    u = work.sd_unet_eval(TINY_UNET, B, 0, quant=True)
    assert u.calls['w8a8'] == 4 * 4
    # conv_in's products alone, by hand: 2 B H W Cout Cin 9
    conv_in = 2 * B * 16 * 16 * 8 * 4 * 9
    assert w.model_ops['fp32'] > conv_in
    # a skip pass: level 0 only, no attention there, no W8A8
    s = work.sd_unet_eval(TINY_UNET, B, T, quant=True, full=False)
    assert s.calls['w8a8'] == 0
    assert s.calls['gn_swish'] == 2 * (1 + 2) + 1
    assert s.model_ops['fp32'] < w.model_ops['fp32']


TINY_LM = dict(num_hidden_layers=2, hidden_size=8, num_attention_heads=2,
               num_key_value_heads=1, intermediate_size=16, vocab_size=11,
               kv_repeat=2)


def test_lm_counts_by_hand():
    B, S = 3, 4
    w = work.lm_prefill(TINY_LM, B, S, quant=True)
    # per layer wq, wo, gate, up, down on W8A8; one flash call
    assert w.calls['w8a8'] == 2 * 5 and w.calls['flash'] == 2
    int8 = 2 * (2 * B * S * 8 * 8 * 2 + 3 * 2 * B * S * 8 * 16)
    assert w.model_ops['int8'] == int8
    flash = 4 * B * 2 * 4 * (S * (S + 1) / 2)
    kv = 2 * (2 * B * S * 8 * 4)                       # wk, wv
    head = 2 * B * 8 * 11
    assert w.model_ops['fp32'] == pytest.approx(2 * (flash + kv) + head)
    d = work.lm_decode(TINY_LM, B, 6, quant=True)
    assert d.calls['flash'] == 0
    assert d.model_ops['fp32'] == pytest.approx(
        2 * (4 * B * 2 * 4 * 7 + 2 * B * 8 * 4 * 2) + head)


def test_train_step_counts_model_work_only():
    """Forward and backward, three forwards' products: the forward that
    remat runs again is left out."""
    B, S = 2, 5
    t = work.lm_train_step(TINY_LM, B, S)
    layers = 2 * (2 * B * S * (8 * 8 * 2 + 8 * 4 * 2 + 3 * 8 * 16)
                  + 4 * B * 2 * 4 * S * (S + 1) / 2)
    head = 2 * B * S * 8 * 11
    assert t.model_ops['fp32'] == pytest.approx(3 * (layers + head))
    assert not t.calls


# --- import rules ----------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.', 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.', 1)[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob('*.py'))
    assert files
    for f in files:
        bad = set(_imports(f)) & {'jax', 'jaxlib', 'flax', 'repro'}
        assert not bad, f'{f} imports {bad}'


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / 'reference').rglob('*.py')):
        assert 'repro_torch' not in set(_imports(f)), f


def test_forbidden_names_are_compared_whole():
    import sys
    assert common.FORBIDDEN == ('jax', 'jaxlib', 'flax', 'repro')
    tops = {m.split('.', 1)[0] for m in sys.modules}
    assert set(common.forbidden_loaded()) == tops & set(common.FORBIDDEN)
