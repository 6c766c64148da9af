"""The dry run's port (``repro_torch.launch.dryrun``, ``roofline``,
``hillclimb``) against the parts of the reference that run under the
installed JAX: its ``input_specs`` stand-ins and specs (the compile
that follows them does not run here), ``parse_collectives`` on the HLO
text of ``tests/test_system.py::test_collective_parser``, and the
roofline report's arithmetic.  The traces run on fake process groups in
this process (``dryrun.fake_mesh``), which the module's fixture tears
down; one test takes a real single-rank gloo group to see it refused.

Tolerances: none.  Per-device bytes are shape arithmetic on both sides,
FLOPs are ``torch.utils.flop_counter``'s formulas on the same shapes,
and the probe's linear extrapolation is exact in integers held as
floats well below 2**53."""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

# the reference's dry-run modules set XLA_FLAGS (512 host devices) when
# imported; this process's JAX keeps the flags it had
_FLAGS = os.environ.get('XLA_FLAGS')
import repro.launch.dryrun as JDR  # noqa: E402
import repro.launch.hillclimb as JHC  # noqa: E402
import repro.launch.roofline as JRF  # noqa: E402

if _FLAGS is None:
    os.environ.pop('XLA_FLAGS', None)
else:
    os.environ['XLA_FLAGS'] = _FLAGS

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import diffusion as JDIFF  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import diffusion as TDIFF  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import fused_gn_swish as GN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import w8a8_matmul as MM  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.launch import roofline as RF  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_adamw  # noqa: E402

PRODUCTION = [((16, 16), ('data', 'model')),
              ((2, 16, 16), ('pod', 'data', 'model'))]
ARCHS = sorted(jreg.ARCHS)


class _RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


@pytest.fixture(scope='module', autouse=True)
def _no_group_left():
    yield
    DR.release_mesh()


def _ref_bytes(args, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(args)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for i, d in enumerate(leaf.shape):
            ax = spec[i] if i < len(spec) else None
            axes = ax if isinstance(ax, tuple) else (ax,)
            n *= d // math.prod(mesh.shape[a] for a in axes if a is not None)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _port_bytes(cfg, shape, desc, **kw) -> int:
    _, args, specs, _ = DR.input_specs(cfg, shape, desc, **kw)
    return DR.argument_bytes(args, specs, desc)


@pytest.mark.parametrize('mesh', range(len(PRODUCTION)),
                         ids=['16x16', '2x16x16'])
@pytest.mark.parametrize('arch', ARCHS)
def test_argument_bytes_match_reference(arch, mesh):
    """Every live cell at full width: the port's per-device argument
    bytes equal the reference's stand-ins under its specs."""
    shape, axes = PRODUCTION[mesh]
    ref, desc = _RefMesh(shape, axes), SH.MeshDesc(shape, axes)
    for cell in JDR.cells_for(arch):
        _, args, specs, _ = JDR.input_specs(jreg.get(arch), JSHAPES[cell],
                                            ref)
        want = _ref_bytes(args, specs, ref)
        got = _port_bytes(treg.get(arch), TB.SHAPES[cell], desc)
        assert got == want, (arch, cell, got, want)


@pytest.mark.parametrize('kw', [{'serve_quant': True},
                                {'mla_cache_seq': True},
                                {'serve_params_bf16': False}],
                         ids=['w8a8', 'mla-seq', 'fp32'])
def test_argument_bytes_match_reference_serving_options(kw):
    arch = 'deepseek-v2-lite-16b'
    for shape, axes in PRODUCTION:
        ref, desc = _RefMesh(shape, axes), SH.MeshDesc(shape, axes)
        for cell in ('prefill_32k', 'decode_32k'):
            _, args, specs, _ = JDR.input_specs(jreg.get(arch),
                                                JSHAPES[cell], ref, **kw)
            assert _port_bytes(treg.get(arch), TB.SHAPES[cell], desc,
                               **kw) == _ref_bytes(args, specs, ref)


def test_collective_counter_matches_reference_parser():
    """The three collectives of the reference's parser test, issued on a
    fake 16-rank mesh: the same bytes, counts and weighted total."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol
    hlo = '''
      %ag = bf16[16,128]{1,0} all-gather(bf16[1,128]{1,0} %p), replica_groups={}
      %ar.1 = f32[64]{0} all-reduce(f32[64]{0} %x), to_apply=%add
      %tup = (f32[8]{0}, f32[8]{0}) all-to-all(f32[8]{0} %a, f32[8]{0} %b)
    '''
    want = JDR.parse_collectives(hlo)
    mesh = DR.fake_mesh((16,), ('model',))
    with FakeTensorMode():
        p = torch.empty((1, 128), dtype=torch.bfloat16)
        x = torch.empty(64)
        a = torch.empty(16)
        with DR.count_ops() as counter:
            funcol.all_gather_single(p, 0, (mesh, 0))
            funcol.all_reduce(x, 'sum', (mesh, 0))
            funcol.all_to_all_single(a, None, None, (mesh, 0))
    got = DR.parse_collectives(counter.collectives)
    for key in ('bytes_per_kind', 'count_per_kind', 'weighted_bytes'):
        assert got[key] == want[key], key
    # 16 ranks span two hosts of 8 cards: all three go over the network
    assert got['weighted_bytes_host'] == 0.0
    assert DR.collective_seconds(got['weighted_bytes'], 0.0) == \
        got['weighted_bytes'] / DR.NET_BW


def test_collectives_within_a_host_are_priced_at_nvlink():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol
    mesh = DR.fake_mesh((2, 8), ('data', 'model'))
    with FakeTensorMode():
        x = torch.empty(64)
        with DR.count_ops() as counter:
            funcol.all_reduce(x, 'sum', (mesh, 1))    # ranks 0..7
            funcol.all_reduce(x, 'sum', (mesh, 0))    # ranks 0, 8
    got = DR.parse_collectives(counter.collectives)
    assert got['weighted_bytes'] == 2 * 2 * 256
    assert got['weighted_bytes_host'] == 2 * 256
    assert DR.collective_seconds(got['weighted_bytes'],
                                 got['weighted_bytes_host']) == \
        512 / DR.NVLINK_BW + 512 / DR.NET_BW


def test_hardware_constants_are_the_h100s():
    assert (DR.PEAK_FLOPS_BF16, DR.HBM_BW, DR.NVLINK_BW, DR.NET_BW,
            DR.HBM_BYTES) == (989e12, 3.35e12, 450e9, 50e9, 80e9)


def _small(monkeypatch, seq=64, batch=8):
    for name in ('train_4k', 'prefill_32k', 'decode_32k'):
        monkeypatch.setitem(TB.SHAPES, name, dataclasses.replace(
            TB.SHAPES[name], seq_len=seq, global_batch=batch))


def _check_record(r, probe=True):
    assert r['memory']['peak_bytes_per_device'] > 0
    assert r['memory']['argument_bytes'] > 0
    assert r['cost']['flops_per_device'] > 0
    assert r['cost']['bytes_accessed_per_device'] > 0
    assert r['roofline']['dominant'] in ('compute_s', 'memory_s',
                                         'collective_s')
    rf = r['roofline']
    assert rf[rf['dominant']] == max(rf['compute_s'], rf['memory_s'],
                                     rf['collective_s'])
    # the eager trace runs every layer: the probe's extrapolation of the
    # depth-U and depth-2U counts equals the full-depth count
    c = r['cost']
    assert ('probe_raw' in c) == probe
    assert not probe or c['probe_raw']['extrapolated'] == [
        c['flops_per_device'], c['bytes_accessed_per_device'],
        c['collective_bytes_per_device'],
        c['collective_bytes_host_per_device']]


def test_run_cell_small_scale(monkeypatch, tmp_path):
    """The reference test's scenario: the smoke InternLM2, train_4k cut
    to 64 x 8, a (2, 2, 2) mesh; and its assertions."""
    _small(monkeypatch)
    mesh = DR.fake_mesh((2, 2, 2), ('pod', 'data', 'model'))
    r = DR.run_cell('internlm2-1.8b', 'train_4k', multi_pod=True, mesh=mesh,
                    cfg=treg.smoke_config('internlm2-1.8b'),
                    out_dir=str(tmp_path))
    _check_record(r)
    assert r['cost']['steps_full'] == 2
    assert r['devices'] == 8 and r['mesh'] == {'pod': 2, 'data': 2,
                                               'model': 2}
    coll = r['collectives_scanned_body']
    assert coll['count_per_kind']['all-gather'] > 0
    assert coll['count_per_kind']['reduce-scatter'] > 0
    assert r['cost']['collective_bytes_per_device'] == coll['weighted_bytes']
    _, args, specs, _ = DR.input_specs(
        treg.smoke_config('internlm2-1.8b'), TB.SHAPES['train_4k'],
        SH.MeshDesc((2, 2, 2), ('pod', 'data', 'model')))
    assert r['memory']['argument_bytes'] == DR.argument_bytes(args, specs,
                                                              mesh)
    assert (tmp_path / 'internlm2-1.8b__train_4k__multipod.json').exists()


@pytest.mark.parametrize('cell', ['prefill_32k', 'decode_32k'])
@pytest.mark.parametrize('arch', ['internlm2-1.8b', 'granite-moe-1b-a400m'])
def test_run_cell_small_scale_serving(monkeypatch, arch, cell):
    """A prefill and a decode cell of a dense and an MoE family on the
    (2, 2, 2) mesh, their caches laid out by ``cache_pspecs``."""
    _small(monkeypatch)
    mesh = DR.fake_mesh((2, 2, 2), ('pod', 'data', 'model'))
    cfg = treg.smoke_config(arch)
    probe = cell == 'decode_32k'
    r = DR.run_cell(arch, cell, multi_pod=True, mesh=mesh, cfg=cfg,
                    with_probe=probe)
    _check_record(r, probe)
    _, args, specs, _ = DR.input_specs(cfg, TB.SHAPES[cell], mesh)
    assert r['memory']['argument_bytes'] == DR.argument_bytes(args, specs,
                                                              mesh)


def test_flops_count_local_ops_equal_the_real_step():
    """On a (1, 1) mesh every local op is the global one: the trace's
    FLOPs equal ``FlopCounterMode`` over one real CPU step (float32)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = treg.smoke_config('internlm2-1.8b')
    shape = TB.ShapeConfig('t', 64, 4, 'train')
    mesh = DR.fake_mesh((1, 1), ('data', 'model'))
    tr = DR.trace_cell(cfg, shape, mesh, dtype=torch.float32)
    model = ST.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')
    params = list(ST.train_params(model).values())
    step = ST.build_train_step(cfg, AdamWConfig(), dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64),
                                              dtype=np.int32))
             for k in ('tokens', 'labels')}
    with FlopCounterMode(display=False) as fc:
        step(model, init_adamw(params), batch)
    assert tr['flops'] == fc.get_total_flops() > 0
    # the arguments: the parameters, two float32 moments, AdamW's step
    # and the int32 tokens and labels
    n = sum(p.numel() for p in params)
    assert tr['argument_bytes'] == 3 * 4 * n + 4 + 2 * 4 * 64 * 4
    assert tr['peak_bytes_per_device'] > tr['argument_bytes']


def test_fake_mesh_refuses_a_real_process_group():
    import torch.distributed as dist
    DR.release_mesh()
    dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match='process of its own'):
            DR.run_cell('internlm2-1.8b', 'train_4k', multi_pod=False)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('arch', ARCHS)
def test_roofline_params_match_reference(arch):
    total = RF.count_params(arch)
    assert total == JRF.count_params(arch)
    assert RF.active_params(arch, total) == JRF.active_params(arch, total)
    for cell in JDR.cells_for(arch):
        assert RF.model_flops(arch, cell, total) == \
            JRF.model_flops(arch, cell, total)


def test_roofline_report_matches_reference(tmp_path):
    """The same records through both reports: the same table, but for
    the memory note (80 GB of HBM against the v5e's 16 GiB)."""
    import json
    rows = [('internlm2-1.8b', 'train_4k', 6.1e12, 90e9),
            ('internlm2-1.8b', 'decode_32k', 4.9e9, 4.4e9),
            ('granite-moe-1b-a400m', 'prefill_32k', 2.5e12, 20e9)]
    for arch, cell, flops, peak in rows:
        rec = {'arch': arch, 'shape': cell, 'devices': 256,
               'memory': {'peak_bytes_per_device': peak},
               'cost': {'flops_per_device': flops},
               'roofline': {'compute_s': flops / DR.PEAK_FLOPS_BF16,
                            'memory_s': 0.5, 'collective_s': 0.25,
                            'dominant': 'memory_s'}}
        with open(tmp_path / f'{arch}__{cell}__singlepod.json', 'w') as f:
            json.dump(rec, f)
    got = RF.report(str(tmp_path)).splitlines()
    want = JRF.report(str(tmp_path)).splitlines()
    assert len(got) == len(want) == 2 + len(rows)
    strip = lambda line: line.rsplit('|', 2)[0]
    assert [strip(x) for x in got] == [strip(x) for x in want]
    note = lambda lines: [x.rsplit('|', 2)[1].strip() for x in lines[2:]]
    # rows sorted: granite prefill, internlm2 decode, internlm2 train
    assert note(got) == ['', '', 'OVER 80 GB H100']
    assert note(want) == ['OVER 16GiB v5e budget', '',
                          'OVER 16GiB v5e budget']


def test_hillclimb_variants_match_reference():
    def plain(v):
        name, arch, shape, mods, kw = v
        kw = {k: (dataclasses.asdict(x) if dataclasses.is_dataclass(x)
                  else x) for k, x in kw.items()}
        return name, arch, shape, mods, kw
    assert [plain(v) for v in HC.VARIANTS] == [plain(v)
                                               for v in JHC.VARIANTS]
    assert HC.OUT.endswith(os.path.join('results', 'perf_torch'))


def test_paper_is_reduction_matches_reference():
    assert TDIFF.PAPER_IS_REDUCTION == JDIFF.PAPER_IS_REDUCTION


@pytest.mark.parametrize('device', ['fake-cuda', 'meta'])
def test_kernels_refuse_tensors_without_memory(monkeypatch, device):
    """A fake tensor on CUDA (or a meta tensor) raises, naming the op,
    and never reaches a kernel's ``ctypes`` launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_launch(*a, **k):
        raise AssertionError('a kernel was launched')

    for mod, name in ((FA, 'flash_attention_bshd_kernel'),
                      (FA, 'flash_attention_kernel'),
                      (MM, 'w8a8_matmul_kernel'),
                      (GN, 'fused_gn_swish_kernel')):
        monkeypatch.setattr(mod, name, no_launch)
    if device == 'meta':
        mk = lambda *s: torch.empty(s, device='meta')
        ctx = torch.no_grad()
    else:
        mode = FakeTensorMode()
        mk = lambda *s: torch.empty(s, device='cuda')
        ctx = mode
    with ctx:
        x, w = mk(4, 64), mk(64, 32)
        q, k = mk(1, 8, 2, 16), mk(1, 8, 2, 16)
        img, g = mk(1, 4, 4, 32), mk(32)
        for op, call in (
                ('w8a8_matmul', lambda: ops.w8a8_matmul(x, w)),
                ('fused_gn_swish', lambda: ops.fused_gn_swish(img, g, g)),
                ('flash_attention', lambda: ops.flash_attention(q, k, k)),
                ('flash_attention', lambda: ops.flash_attention_bshd(
                    q, k, k))):
            with pytest.raises(ValueError, match=op):
                call()
