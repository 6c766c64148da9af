"""The sharded trainer on the CPU: ``gloo`` ranks started by
``torch.multiprocessing`` (spawn), a ``DeviceMesh`` named as the
reference's, parameters and AdamW moments as DTensors laid out by
``sharding.param_pspecs``.  It mirrors the reference's
``test_end_to_end_sharded_training_8dev`` and
``test_checkpoint_restart_and_elastic_reshard_8dev``, which fail on the
reference side under the installed jax, so the sharded runs are held to
the port's single-device ``Trainer`` and, on ``(2, 2)``, to a loop of the
reference's jitted train step.

Each mesh size runs once, in a module-scoped fixture (8, 4 and 1 ranks),
and the cases read its results.  The smoke InternLM2 trains with a
vocabulary of 212 (the smoke 211 padded), so the embedding table's
vocabulary dim divides 'model' and shards over it.

Tolerances: losses and grad norms 1e-5 relative (float32 sums in
another order: the sharded matmuls reduce over shards; measured up to
2.9e-7 over 15 steps, 1.8e-7 against the reference's loop, 1.2e-7 for
the families' step); the restored parameters bit for bit (a checkpoint
holds full arrays, and placing them is a copy); the embedding gradient
1e-5 of its largest element (measured 5.0e-7).
"""
import dataclasses
import math
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import TokenPipelineConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import Trainer, mesh_axes
from repro_torch.optim.adamw import AdamWConfig

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
VOCAB = 212
STEPS = 15
CKPT_AT = 8             # the periodic checkpoint the elastic runs restore
BATCH, SEQ = 8, 16
SPAWN_TIMEOUT = 600     # only a hung rank reaches it
# every decoder-only family of the registry (the encoder-decoder's loss
# reads frames, which the trainer's loop does not feed)
FAMILIES = ('internlm2-1.8b', 'granite-moe-1b-a400m', 'deepseek-v2-lite-16b',
            'mamba2-2.7b', 'jamba-1.5-large-398b', 'qwen2-vl-7b',
            'starcoder2-7b')
# the smoke InternLM2 under remat 'full' (torch.utils.checkpoint over
# DTensor parameters); the smoke configs keep remat 'none'
REMAT = 'internlm2-1.8b+remat'


def _cfg(arch='internlm2-1.8b'):
    if arch == REMAT:
        return _cfg().scaled(remat='full')
    return dataclasses.replace(treg.smoke_config(arch), vocab=VOCAB)


def _opt(steps=STEPS):
    return AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=steps)


def _data(cfg):
    return TokenPipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                               global_batch=BATCH)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, out, args):
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    torch.set_num_threads(1)
    import logging      # DTensor's advice on flattening 2-D reductions
    logging.getLogger('torch.distributed.tensor').setLevel(logging.ERROR)
    import datetime
    dist.init_process_group('gloo', rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out, f'{rank}.pt'))
    except BaseException:
        with open(os.path.join(out, f'{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def spawn(fn, world, *args):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; the list of
    their results.  A rank that fails ends them all and raises its
    traceback, so a failure never hangs the others."""
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory() as out:
        port = _free_port()
        procs = [ctx.Process(target=_entry,
                             args=(fn, r, world, port, out, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + SPAWN_TIMEOUT
        try:
            while any(p.exitcode is None for p in procs):
                bad = [p for p in procs if p.exitcode not in (None, 0)]
                if bad or time.time() > deadline:
                    errs = [open(os.path.join(out, n)).read()
                            for n in sorted(os.listdir(out))
                            if n.endswith('.err')]
                    raise RuntimeError(
                        f'ranks failed or timed out: '
                        f'{[p.exitcode for p in procs]}\n' +
                        '\n'.join(errs[:1]))
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out, f'{r}.pt'), weights_only=False)
                for r in range(world)]


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def _full_params(tr, keep=True):
    """Every parameter gathered whole (a collective: every rank calls
    it); None where ``keep`` is false."""
    full = {n: (p.full_tensor() if SH.is_dtensor(p) else p).detach().clone()
            for n, p in ST.train_params(tr.params).items()}
    return full if keep else None


def _layout(tr, rank):
    """Each parameter's placements and whether it is a DTensor whose
    local shard is on this rank's device."""
    return {n: (SH.is_dtensor(p), tuple(repr(x) for x in p.placements)
                if SH.is_dtensor(p) else None,
                SH.is_dtensor(p) and p.to_local().device == tr.device)
            for n, p in ST.train_params(tr.params).items()}


def _train_8(rank, world, ckpt, resumed):
    """(2, 4): 15 steps with a checkpoint after step 8; then (4, 2)
    restored from that checkpoint and run to the end."""
    cfg = _cfg()
    mesh = make_mesh((2, 4), ('data', 'model'), 'cpu')
    tr = Trainer(cfg, _opt(), ckpt_dir=ckpt, device='cpu', mesh=mesh)
    out = {'init': _full_params(tr, rank == 0),
           'layout': _layout(tr, rank)}
    out['losses'] = tr.run(_data(cfg), STEPS, ckpt_every=CKPT_AT - 1,
                           log_every=100)
    if rank == 0:
        os.makedirs(resumed)
        import shutil
        shutil.copytree(os.path.join(ckpt, f'step_{CKPT_AT:08d}'),
                        os.path.join(resumed, f'step_{CKPT_AT:08d}'))
    dist.barrier()
    mesh2 = make_mesh((4, 2), ('data', 'model'), 'cpu')
    tr2 = Trainer(cfg, _opt(), ckpt_dir=resumed, device='cpu', mesh=mesh2)
    tr2.maybe_restore()
    out['restored'] = _full_params(tr2, rank == 0)
    out['restored_at'] = tr2.start_step
    out['resumed'] = tr2.run(_data(cfg), STEPS, log_every=100)
    return out


def _train_4(rank, world, ref_params):
    """(2, 2) and (2, 1, 2): a few steps each; the embedding table's
    gradient; one step of every smoke family; the reference's initial
    parameters trained on (2, 2)."""
    out = {}
    cfg = _cfg()
    for shape in ((2, 2), (2, 1, 2)):
        mesh = make_mesh(shape, mesh_axes(shape), 'cpu')
        tr = Trainer(cfg, _opt(4), device='cpu', mesh=mesh)
        out[shape] = tr.run(_data(cfg), 4, log_every=100)
    mesh = make_mesh((2, 2), ('data', 'model'), 'cpu')
    tr = Trainer(cfg, _opt(4), device='cpu', mesh=mesh)
    table = tr.params.embed.table
    out['table_placements'] = tuple(repr(x) for x in table.placements)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.pipeline import token_batch
    batch = ST.shard_batch(token_batch(_data(cfg), 0), mesh)
    with implicit_replication():
        loss = ST.train_loss(tr.params, cfg, batch, torch.float32)
        (g,) = torch.autograd.grad(loss, [table])
    out['table_grad_placements'] = tuple(repr(x) for x in g.placements)
    out['table_grad'] = g.full_tensor()
    fam = {}
    for arch in FAMILIES + (REMAT,):
        c = _cfg(arch)
        tr = Trainer(c, _opt(1), device='cpu', mesh=mesh)
        step = ST.build_train_step(c, _opt(1), dtype=torch.float32, mesh=mesh)
        _, _, m = step(tr.params, tr.opt, token_batch(_data(c), 0))
        fam[arch] = (float(m['loss']), float(m['grad_norm']))
    out['families'] = fam
    from repro_torch import bridge
    tr = Trainer(_ref_cfg(), _opt(4), device='cpu')
    bridge.load_jax_lm_params(tr.params, ref_params)
    trm = Trainer(_ref_cfg(), _opt(4), device='cpu', mesh=mesh)
    with torch.no_grad():
        for p, q in zip(ST.train_params(trm.params).values(),
                        ST.train_params(tr.params).values()):
            p.copy_(SH.distribute(q.detach(), mesh, p.placements))
    out['ref_run'] = trm.run(_data(_ref_cfg()), 4, log_every=100)
    return out


def _train_1(rank, world, ckpt):
    """(1, 1): restored from the (2, 4) checkpoint and run to the end."""
    cfg = _cfg()
    mesh = make_mesh((1, 1), ('data', 'model'), 'cpu')
    tr = Trainer(cfg, _opt(), ckpt_dir=ckpt, device='cpu', mesh=mesh)
    tr.maybe_restore()
    return {'restored': _full_params(tr), 'restored_at': tr.start_step,
            'resumed': tr.run(_data(cfg), STEPS, log_every=100)}


def _ref_cfg():
    return treg.smoke_config('internlm2-1.8b')


# ---------------------------------------------------------------------------
# fixtures: each mesh size runs once
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def single():
    """The single-device ``Trainer``: initial parameters, 15 losses."""
    cfg = _cfg()
    tr = Trainer(cfg, _opt(), device='cpu')
    init = _full_params(tr)
    return {'init': init, 'losses': tr.run(_data(cfg), STEPS,
                                           log_every=100)}


@pytest.fixture(scope='module')
def workdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


@pytest.fixture(scope='module')
def run8(workdir):
    ckpt = os.path.join(workdir, 'ckpt24')
    res = spawn(_train_8, 8, ckpt, os.path.join(workdir, 'resume42'))
    return res, ckpt


@pytest.fixture(scope='module')
def run1(run8, workdir):
    src = os.path.join(run8[1], f'step_{CKPT_AT:08d}')
    dst = os.path.join(workdir, 'resume11')
    import shutil
    shutil.copytree(src, os.path.join(dst, f'step_{CKPT_AT:08d}'))
    return spawn(_train_1, 1, dst)[0]


@pytest.fixture(scope='module')
def reference_run():
    """The reference's initial smoke InternLM2 and a loop of its jitted
    train step over its ``token_batch`` (4 steps)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.data import pipeline as JD
    from repro.launch import steps as JS
    from repro.optim import adamw as JA
    jcfg = jreg.smoke_config('internlm2-1.8b')
    jp = JS.init_params(jax.random.PRNGKey(0), jcfg)
    oc = JA.AdamWConfig(**dataclasses.asdict(_opt(4)))
    dcfg = JD.TokenPipelineConfig(vocab=jcfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH)
    step = jax.jit(JS.build_train_step(jcfg, oc, dtype=jnp.float32))
    p, opt, losses = jp, JA.init_adamw(jp), []
    for s in range(4):
        p, opt, m = step(p, opt, JD.token_batch(dcfg, s))
        losses.append(float(m['loss']))
    return jax.tree_util.tree_map(np.asarray, jp), losses


@pytest.fixture(scope='module')
def run4(reference_run):
    return spawn(_train_4, 4, reference_run[0])


def _close(got, want, rtol=LOSS_RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def test_loss_falls_and_parameters_stay_sharded_on_2x4(run8):
    """The reference's 8-device test: on (2, 4) the loss falls over 15
    steps, every parameter is a DTensor on every rank with its local
    shard on the rank's device, and some shard over both axes."""
    res, _ = run8
    losses = res[0]['losses']
    assert len(losses) == STEPS and losses[-1] < losses[0] - 0.5
    for r in res:
        assert all(is_dt and local_ok
                   for is_dt, _, local_ok in r['layout'].values())
    both = [n for n, (_, pl, _) in res[0]['layout'].items()
            if all(x.startswith('Shard') for x in pl)]
    assert 'embed.table' in both and 'blocks.0.sub0.attn.wq.w' in both


def test_initial_parameters_equal_the_single_device_ones(run8, single):
    for n, w in single['init'].items():
        assert torch.equal(run8[0][0]['init'][n], w), n


@pytest.mark.parametrize('mesh', ['2,4', '4,2', '2,2', '2,1,2'])
def test_losses_equal_the_single_device_trainer(mesh, run8, run4, single):
    """The sharded ``Trainer`` computes what the single-device one does
    (4,2: the steps after the elastic restore)."""
    want = single['losses']
    if mesh == '2,4':
        got, ref = run8[0][0]['losses'], want
    elif mesh == '4,2':
        got, ref = run8[0][0]['resumed'], want[CKPT_AT:]
    else:
        shape = tuple(int(x) for x in mesh.split(','))
        got = run4[0][shape]
        tr = Trainer(_cfg(), _opt(4), device='cpu')
        ref = tr.run(_data(_cfg()), 4, log_every=100)
    assert len(got) == len(ref)
    _close(got, ref)


@pytest.mark.parametrize('target', ['4,2', '1,1'])
def test_checkpoint_from_2x4_restores_bit_for_bit(target, run8, run1):
    """Saved on (2, 4) after step 8, restored onto (4, 2) and (1, 1):
    the parameters equal the saved arrays bit for bit, and the resumed
    losses equal the uninterrupted run's."""
    res, ckpt = run8
    got = res[0] if target == '4,2' else run1
    assert got['restored_at'] == CKPT_AT
    with np.load(os.path.join(ckpt, f'step_{CKPT_AT:08d}',
                              'arrays.npz')) as data:
        import json
        with open(os.path.join(ckpt, f'step_{CKPT_AT:08d}',
                               'meta.json')) as f:
            meta = json.load(f)
        assert meta['mesh'] == {'shape': [2, 4], 'axes': ['data', 'model']}
        saved = {n[len('params.'):]: data[f'a{i}']
                 for i, n in enumerate(meta['names'])
                 if n.startswith('params.')}
    assert saved.keys() == got['restored'].keys()
    for n, w in saved.items():
        assert np.array_equal(got['restored'][n].numpy(), w), n
    _close(got['resumed'], res[0]['losses'][CKPT_AT:])


def test_embedding_gradient_under_the_vocabulary_sharded_table(run4):
    """The table lies on ('model', 'data'): its vocabulary over 'model'.
    The lookup gathers it whole; its gradient comes back to the table's
    placements and equals the single-device one."""
    assert run4[0]['table_placements'] == ('Shard(dim=1)', 'Shard(dim=0)')
    cfg = _cfg()
    tr = Trainer(cfg, _opt(4), device='cpu')
    from repro_torch.data.pipeline import token_batch
    params = ST.train_params(tr.params)
    loss = ST.train_loss(tr.params, cfg, token_batch(_data(cfg), 0),
                         torch.float32)
    (want,) = torch.autograd.grad(loss, [params['embed.table']])
    got = run4[0]['table_grad']
    scale = want.abs().max().item()
    assert scale > 0 and (got - want).abs().max().item() <= GRAD_RTOL * scale


@pytest.mark.parametrize('arch', FAMILIES + (REMAT,))
def test_one_step_of_every_family_on_2x2(arch, run4):
    cfg = _cfg(arch)
    tr = Trainer(cfg, _opt(1), device='cpu')
    from repro_torch.data.pipeline import token_batch
    _, _, m = tr.step_fn(tr.params, tr.opt, token_batch(_data(cfg), 0))
    want = (float(m['loss']), float(m['grad_norm']))
    _close(run4[0]['families'][arch], want)


def test_reference_initial_params_on_2x2_match_the_reference_loop(
        run4, reference_run):
    """The reference's initial parameters, trained on (2, 2), against a
    loop of the reference's jitted train step on one device."""
    _close(run4[0]['ref_run'], reference_run[1])


def test_every_rank_reports_the_same_losses(run8, run4):
    for r in run8[0][1:]:
        assert r['losses'] == run8[0][0]['losses']
    for r in run4[1:]:
        assert r['families'] == run4[0]['families']
