"""The port's sharding rules against the reference's, in one process, on
stand-in meshes: the reference's rules read only ``mesh.shape`` (a dict)
and ``mesh.axis_names``, the port's a ``MeshDesc``, so both are asked
for ``(2, 4)``, ``(4, 2)``, ``(16, 16)`` and ``(2, 16, 16)`` without
any device.  Also ``placements`` (tuple axes), ``shard_hint`` on plain
tensors, the training meshes' helpers, and ``compression.py`` against
``repro.distributed.compression``.

Tolerances: none.  Specs are compared for equality (the reference's
spec of a unit's leaf with its leading scan ``None`` dropped), and the
int8 compression bit for bit: ``torch.round`` and ``jnp.round`` both
round half to even, and the scale is one float32 division."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed import compression as JC
from repro.distributed import sharding as JSH
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.distributed import compression as TC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as TM
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT

MESHES = [((2, 4), ('data', 'model')), ((4, 2), ('data', 'model')),
          ((16, 16), ('data', 'model')), ((2, 16, 16), ('pod', 'data',
                                                         'model'))]
MESH_IDS = ['2x4', '4x2', '16x16', '2x16x16']
DECODERS = ('internlm2-1.8b', 'granite-moe-1b-a400m', 'deepseek-v2-lite-16b',
            'mamba2-2.7b', 'jamba-1.5-large-398b', 'qwen2-vl-7b',
            'starcoder2-7b', 'mistral-large-123b', 'yi-34b')


class _RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _meshes(i):
    shape, axes = MESHES[i]
    return _RefMesh(shape, axes), SH.MeshDesc(shape, axes)


def _cfgs(arch, preset):
    if preset == 'full':
        return jreg.get(arch), treg.get(arch)
    return jreg.smoke_config(arch), treg.smoke_config(arch)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, preset):
    jcfg, _ = _cfgs(arch, preset)
    return jax.eval_shape(lambda: JS.init_params(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _port_model(arch, preset):
    return TT.LM(_cfgs(arch, preset)[1], 'meta')


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {JSH._path_str(p): tuple(s) for p, s in leaves}


def _unstack(path, spec, stacked=('blocks',)):
    """The reference's spec of a leaf as the port's: a unit's leaf loses
    its leading scan axis, which is never sharded."""
    if path.split('/')[0] in stacked:
        assert spec[0] is None, (path, spec)
        return spec[1:]
    return spec


@pytest.mark.parametrize('tp', [True, False], ids=['tp', 'ep_only'])
@pytest.mark.parametrize('mesh', range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize('arch,preset', [(a, 'smoke') for a in DECODERS]
                         + [('internlm2-1.8b', 'full')])
def test_param_pspecs_match_reference(arch, preset, mesh, tp):
    ref_mesh, desc = _meshes(mesh)
    want = {p: _unstack(p, s) for p, s in _flat_ref(JSH.param_pspecs(
        _ref_params(arch, preset), ref_mesh, model_axis_tp=tp)).items()}
    got = SH.param_pspecs(_port_model(arch, preset), desc, model_axis_tp=tp)
    assert list(got) == list(TS.train_params(_port_model(arch, preset)))
    assert {SH.param_path(n): s for n, s in got.items()} == want


def test_param_pspecs_full_internlm2_examples(capsys):
    """The issue's worked examples on the production (2, 16, 16) mesh,
    and the dropped axes printed under ``verbose``."""
    got = SH.param_pspecs(_port_model('internlm2-1.8b', 'full'),
                          SH.MeshDesc((2, 16, 16), ('pod', 'data', 'model')),
                          verbose=True)
    assert got['embed.table'] == ('model', 'data')
    assert got['blocks.0.sub0.attn.wq.w'] == ('data', 'model')
    assert got['blocks.23.sub0.mlp.down.w'] == ('model', 'data')
    assert got['final_norm.scale'] == (None,)
    SH.param_pspecs(_port_model('internlm2-1.8b', 'smoke'),
                    SH.MeshDesc((4, 3), ('data', 'model')), verbose=True)
    out = capsys.readouterr().out
    assert "[sharding] dropped axis 'model' on embed/table (dim 211)" in out


@pytest.mark.parametrize('mesh', range(len(MESHES)), ids=MESH_IDS)
def test_dp_spec_and_batch_pspecs_match_reference(mesh):
    ref_mesh, desc = _meshes(mesh)
    for batch in (1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 64, 512):
        assert SH.dp_spec(desc, batch) == JSH.dp_spec(ref_mesh, batch), batch
        for ndim in (2, 3):
            assert SH.batch_pspecs(desc, batch, ndim) == \
                tuple(JSH.batch_pspecs(ref_mesh, batch, ndim)), batch


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, preset, batch):
    jcfg, _ = _cfgs(arch, preset)
    return jax.eval_shape(lambda: JT.init_lm_cache(jcfg, batch, 64))


@pytest.mark.parametrize('mla_seq', [False, True], ids=['', 'mla_seq'])
@pytest.mark.parametrize('batch', [4, 1])
@pytest.mark.parametrize('mesh', range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize('arch,preset', [
    ('internlm2-1.8b', 'smoke'), ('internlm2-1.8b', 'full'),
    ('deepseek-v2-lite-16b', 'smoke'), ('mamba2-2.7b', 'smoke'),
    ('jamba-1.5-large-398b', 'smoke')],
    ids=['gqa', 'gqa-full', 'mla', 'mamba', 'hybrid'])
def test_cache_pspecs_match_reference(arch, preset, mesh, batch, mla_seq):
    """GQA, MLA and Mamba caches (and the hybrid's mix), batch 4 (sharded
    over the data-parallel axes) and batch 1 (the sequence over 'data'
    instead); the full InternLM2's 8 KV heads over a 'model' of 16
    shard the sequence."""
    ref_mesh, desc = _meshes(mesh)
    want = JSH.cache_pspecs(_ref_cache(arch, preset, batch), ref_mesh,
                            batch, mla_cache_seq=mla_seq)
    want = _flat_ref(want)
    cache = TT.init_lm_cache(_cfgs(arch, preset)[1], batch, 64,
                             device='meta')
    got = SH.cache_pspecs(cache, desc, batch, mla_cache_seq=mla_seq)
    assert len(got) == TT.n_scan_steps(_cfgs(arch, preset)[1])
    for unit in got:
        flat = {f'{s}/{k}': v for s, d in unit.items() for k, v in d.items()}
        assert flat == {p: s[1:] for p, s in want.items()}


def test_resolve_hint_follows_dp_spec_and_drops_what_does_not_divide():
    desc = SH.MeshDesc((2, 2, 4), ('pod', 'data', 'model'))
    assert SH.resolve_hint((8, 16, 12), ('dp', None, 'model'), desc) == \
        (('pod', 'data'), None, 'model')
    assert SH.resolve_hint((2, 16, 6), ('dp', None, 'model'), desc) == \
        ('data', None, None)
    assert SH.resolve_hint((3, 16, 8, 2), ('dp', 'absent'), desc) == \
        (None, None, None, None)


def test_shard_hint_is_the_identity_on_plain_tensors():
    x = torch.randn(4, 8, 16)
    assert SH.shard_hint(x, 'dp', None, 'model') is x
    assert SH.replicate(x) is x
    assert SH.split_dim(x, -1, (2, 8)).shape == (4, 8, 2, 8)
    assert SH.current_mesh() is None
    with SH.use_mesh('stand-in'):
        assert SH.current_mesh() == 'stand-in'
        assert SH.shard_hint(x, 'dp') is x
    assert SH.current_mesh() is None


def test_placements_for_tuple_axes():
    from torch.distributed.tensor import Replicate, Shard
    desc = SH.MeshDesc((2, 2, 4), ('pod', 'data', 'model'))
    assert SH.placements(desc, (('pod', 'data'), None, 'model')) == \
        [Shard(0), Shard(0), Shard(2)]
    assert SH.placements(desc, ('data', 'model')) == \
        [Replicate(), Shard(0), Shard(1)]
    assert SH.placements(desc, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match='not in the mesh order'):
        SH.placements(desc, (('data', 'pod'),))
    with pytest.raises(ValueError, match='shards two dims'):
        SH.placements(desc, ('data', 'data'))


@pytest.mark.parametrize('mesh', range(len(MESHES)), ids=MESH_IDS)
def test_mesh_helpers_match_reference(mesh):
    from repro.launch import mesh as JMESH
    ref_mesh, desc = _meshes(mesh)
    assert TM.dp_axes(desc) == JMESH.dp_axes(ref_mesh)
    assert TM.mesh_dp_size(desc) == JMESH.mesh_dp_size(ref_mesh)
    assert TM.mesh_model_size(desc) == JMESH.mesh_model_size(ref_mesh)


def test_make_mesh_names_the_ranks_it_needs(monkeypatch):
    monkeypatch.setenv('WORLD_SIZE', '1')
    with pytest.raises(ValueError, match='--nproc-per-node 256'):
        TM.make_production_mesh(device='cpu')
    with pytest.raises(ValueError, match='--nproc-per-node 512'):
        TM.make_production_mesh(multi_pod=True, device='cpu')
    with pytest.raises(ValueError, match='--nproc-per-node 8'):
        TM.make_mesh((2, 4), ('data', 'model'), 'cpu')


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {'a': rng.normal(size=(64,)).astype(np.float32),
            'b': [rng.normal(size=(3, 5)).astype(np.float32) * 1e-3,
                  np.zeros((4,), np.float32)],
            'c': np.asarray([0.5, -0.5, 1.5, -2.5, 127.0], np.float32)}


def _to_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_t(tree):
    return TC._map(torch.from_numpy, tree)


def _eq(got, want):
    flat_g = jax.tree_util.tree_leaves(TC._map(lambda t: t.numpy(), got))
    flat_w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                              want))
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_compression_matches_reference_bit_for_bit():
    g = _grads()
    cj, ct = JC.compress(_to_j(g)), TC.compress(_to_t(g))
    _eq(ct.q, cj.q)
    _eq(ct.scale, cj.scale)
    _eq(TC.decompress(ct), JC.decompress(cj))
    res_j, res_t = JC.init_residual(_to_j(g)), TC.init_residual(_to_t(g))
    _eq(res_t, res_j)
    for step in range(3):
        g = _grads(step + 1)
        cj, res_j = JC.compress_with_feedback(_to_j(g), res_j)
        ct, res_t = TC.compress_with_feedback(_to_t(g), res_t)
        _eq(ct.q, cj.q)
        _eq(ct.scale, cj.scale)
        _eq(res_t, res_j)


def test_compression_error_feedback_converges():
    """``tests/test_core.py::test_compression_error_feedback_converges``
    on the port."""
    rng = np.random.default_rng(1)
    g = {'a': torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
    res = TC.init_residual(g)
    acc_true = torch.zeros(64)
    acc_rec = torch.zeros(64)
    for _ in range(50):
        c, res = TC.compress_with_feedback(g, res)
        acc_rec = acc_rec + TC.decompress(c)['a']
        acc_true = acc_true + g['a']
    rel = float(torch.linalg.norm(acc_rec - acc_true) /
                torch.linalg.norm(acc_true))
    assert rel < 0.01, rel
