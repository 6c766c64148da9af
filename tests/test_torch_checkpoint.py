"""The port's checkpointing, fault tolerance, data pipeline and trainer
CLI, on the CPU: the reference's tests of ``CheckpointManager``,
``StepMonitor``, ``PreemptionHandler``, the elastic plans and
``token_batch`` (``tests/test_distributed.py``), ported; the manager's
names, dtypes and async error; a resumed ``Trainer`` equal to an
uninterrupted one, from its final and from a periodic checkpoint, and
after a preemption; ``main()`` run twice on one checkpoint directory;
the refused ``--mesh-shape``.

Imports neither ``jax`` nor the JAX package.  A resumed run repeats the
same float32 operations on the same values as the uninterrupted one, so
losses and parameters are held equal, bit for bit."""
import json
import os

import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import (TokenPipelineConfig, token_batch,
                                       token_stream)
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StepMonitor,
                                                     elastic_plan,
                                                     elastic_serving_plan)
from repro_torch.launch import train as TR
from repro_torch.launch.steps import make_batch_struct
from repro_torch.optim.adamw import AdamWConfig, AdamWState

ARCH = 'internlm2-1.8b'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def test_checkpoint_atomicity_and_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {'w': torch.arange(6.0).reshape(2, 3),
            's': torch.tensor(7, dtype=torch.int32)}
    for step in (1, 2, 3):
        m.save(step, tree, blocking=True)
    assert m.latest_step() == 3
    # keep=2 -> step 1 collected
    assert not os.path.exists(str(tmp_path / 'step_00000001'))
    restored = m.restore(3, tree)
    assert torch.equal(restored['w'], tree['w'])
    assert restored['s'].dtype == torch.int32 and restored['s'].item() == 7
    # an uncommitted directory (a write cut off before its rename) is
    # ignored
    os.makedirs(str(tmp_path / 'step_00000099'))
    os.makedirs(str(tmp_path / 'step_00000100.tmp'))
    assert m.latest_step() == 3
    assert m.restore_latest(tree)[0] == 3


def test_checkpoint_async(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = {'w': torch.ones((128, 128))}
    m.save(5, tree, blocking=False)
    tree['w'].add_(1.0)       # the snapshot was taken at the call
    m.wait()
    assert m.latest_step() == 5
    assert torch.equal(m.restore(5, tree)['w'], torch.ones((128, 128)))


def test_checkpoint_async_error_is_raised_at_wait(tmp_path):
    m = CheckpointManager(str(tmp_path))
    blocker = tmp_path / 'step_00000007.tmp'
    blocker.write_text('a file where the writer wants a directory')
    m.save(7, {'w': torch.zeros(3)}, blocking=False)
    with pytest.raises(RuntimeError, match='async checkpoint write'):
        m.wait()
    m.wait()                  # the error is raised once
    assert m.latest_step() is None


def test_checkpoint_names_dtypes_and_order(tmp_path):
    """Leaves in insertion order, named by key path; bfloat16 through its
    bits; a NamedTuple by field names; a tree with other names refused."""
    m = CheckpointManager(str(tmp_path))
    g = torch.Generator().manual_seed(0)
    tree = {'params': {'b': torch.randn(3, generator=g),
                       'a': torch.randn(2, 2, generator=g)},
            'opt': AdamWState(torch.tensor(4, dtype=torch.int32),
                              [torch.randn(3, generator=g).bfloat16()],
                              [torch.rand(3, generator=g).bfloat16()])}
    m.save(4, tree)
    with open(tmp_path / 'step_00000004' / 'meta.json') as f:
        meta = json.load(f)
    assert meta['names'] == ['params.b', 'params.a', 'opt.step', 'opt.m.0',
                             'opt.v.0']
    assert meta['dtypes'] == ['float32', 'float32', 'int32', 'bfloat16',
                              'bfloat16']
    back = m.restore(4, tree)
    assert isinstance(back['opt'], AdamWState)
    pairs = [(back['params'][k], tree['params'][k]) for k in 'ab'] + \
        list(zip([back['opt'].step] + back['opt'].m + back['opt'].v,
                 [tree['opt'].step] + tree['opt'].m + tree['opt'].v))
    for got, want in pairs:
        assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match='other tensors'):
        m.restore(4, {'params': {'a': tree['params']['a'],
                                 'b': tree['params']['b']},
                      'opt': tree['opt']})


# ---------------------------------------------------------------------------
# fault tolerance logic
# ---------------------------------------------------------------------------

def test_straggler_detection():
    mon = StepMonitor(n_hosts=4, window=16, threshold=1.5, min_samples=4)
    for _ in range(8):
        for h in range(4):
            mon.record(h, 1.0 if h != 2 else 2.5)
    rep = mon.check()
    assert rep is not None and rep.slow_hosts == [2]
    assert 're-mesh' in rep.recommendation


def test_straggler_no_false_positive():
    mon = StepMonitor(n_hosts=4, min_samples=4)
    for _ in range(8):
        for h in range(4):
            mon.record(h, 1.0 + 0.01 * h)
    assert mon.check() is None


def test_elastic_plan():
    shape, axes = elastic_plan(64)           # 512 chips
    assert shape == (2, 16, 16) and axes == ('pod', 'data', 'model')
    shape, axes = elastic_plan(62)           # lost 2 hosts -> 496 chips
    assert shape == (31, 16)                 # sheds a pod, keeps TP
    with pytest.raises(ValueError):
        elastic_plan(1, model_parallel=16)


def test_elastic_serving_plan():
    assert elastic_serving_plan(6, 2) == ((6,), ('data',), 12)
    with pytest.raises(ValueError):
        elastic_serving_plan(0)
    with pytest.raises(ValueError):
        elastic_serving_plan(2, 0)


def test_preemption_flag():
    h = PreemptionHandler(install=False)
    assert not h.preempted
    h._handler(15, None)
    assert h.preempted


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_pipeline_deterministic_and_sharded():
    cfg = TokenPipelineConfig(vocab=128, seq_len=16, global_batch=8)
    a = token_batch(cfg, step=3)
    b = token_batch(cfg, step=3)
    assert torch.equal(a['tokens'], b['tokens'])
    assert torch.equal(a['tokens'][:, 1:], a['labels'][:, :-1])
    c = token_batch(cfg, step=4)
    assert not torch.equal(a['tokens'], c['tokens'])
    # host shards partition the batch deterministically
    s0 = token_batch(cfg, 3, shard=(0, 2))
    s1 = token_batch(cfg, 3, shard=(1, 2))
    assert s0['tokens'].shape == (4, 16)
    assert not torch.equal(s0['tokens'], s1['tokens'])
    with pytest.raises(ValueError):
        token_batch(cfg, 3, shard=(0, 3))
    stream = token_stream(cfg, start_step=3)
    assert torch.equal(next(stream)['tokens'], a['tokens'])
    assert torch.equal(next(stream)['tokens'], c['tokens'])


def test_make_batch_struct():
    shape = SHAPES['train_4k']
    b = make_batch_struct(smoke_config(ARCH), shape)
    assert set(b) == {'tokens', 'labels'}
    assert b['tokens'].device.type == 'meta'
    assert tuple(b['labels'].shape) == (256, 4096)
    assert b['labels'].dtype == torch.int32
    e = make_batch_struct(smoke_config('whisper-base'), shape)
    assert tuple(e['frames'].shape) == (256, 4096, 64)
    assert e['frames'].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

DATA = TokenPipelineConfig(vocab=smoke_config(ARCH).vocab, seq_len=16,
                           global_batch=4)
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)


def _trainer(ckpt=None):
    return TR.Trainer(smoke_config(ARCH), OPT, ckpt_dir=ckpt, device='cpu')


def _state(tr):
    return ([p.detach().clone() for p in tr.params.parameters()],
            [m.clone() for m in tr.opt.m + tr.opt.v], tr.opt.step.item())


def _assert_same_state(a, b):
    assert a[2] == b[2]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


@pytest.fixture(scope='module')
def uninterrupted():
    """Losses and final state of 6 steps in one run."""
    tr = _trainer()
    losses = tr.run(DATA, 6, log_every=100)
    return losses, _state(tr)


def test_resume_from_final_checkpoint_equals_uninterrupted(tmp_path,
                                                           uninterrupted):
    first = _trainer(str(tmp_path))
    losses = first.run(DATA, 3)
    assert first.ckpt.latest_step() == 3
    second = _trainer(str(tmp_path))
    second.maybe_restore()
    assert second.start_step == 3
    losses += second.run(DATA, 6)
    assert losses == uninterrupted[0]
    _assert_same_state(_state(second), uninterrupted[1])


def test_resume_from_periodic_checkpoint_equals_uninterrupted(
        tmp_path, uninterrupted):
    """A periodic checkpoint is saved under the steps it has completed:
    after step index 2 (``ckpt_every=2``), as step 3, which a restored
    run takes next."""
    first = _trainer(str(tmp_path))
    first.run(DATA, 4, ckpt_every=2)
    os.rename(tmp_path / 'step_00000004', tmp_path / 'discarded')
    second = _trainer(str(tmp_path))
    second.maybe_restore()
    assert second.start_step == 3 and second.opt.step.item() == 3
    losses = second.run(DATA, 6)
    assert losses == uninterrupted[0][3:]
    _assert_same_state(_state(second), uninterrupted[1])


def test_preemption_saves_and_stops(tmp_path, uninterrupted, capsys):
    tr = _trainer(str(tmp_path))
    tr.preempt.preempted = True
    losses = tr.run(DATA, 6)
    assert len(losses) == 1 and tr.ckpt.latest_step() == 1
    assert 'preemption' in capsys.readouterr().out
    second = _trainer(str(tmp_path))
    second.maybe_restore()
    assert second.start_step == 1
    assert losses + second.run(DATA, 6) == uninterrupted[0]


def test_main_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ['--arch', ARCH, '--preset', 'smoke', '--batch', '2', '--seq',
            '8', '--device', 'cpu', '--ckpt', str(tmp_path)]
    TR.main(args + ['--steps', '3'])
    out = capsys.readouterr().out
    assert '[train] step=0 loss=' in out and '[train] done. loss' in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    TR.main(args + ['--steps', '5'])
    out = capsys.readouterr().out
    assert '[train] resumed from step 3' in out
    assert '[train] step=0' not in out and '[train] done. loss' in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 5
    TR.main(args + ['--steps', '5'])
    assert 'nothing to run: resumed at step 5' in capsys.readouterr().out


@pytest.mark.parametrize('shape', ['2,1', '1,1,1', '4'])
def test_main_refuses_a_mesh(shape, capsys):
    with pytest.raises(SystemExit) as e:
        TR.main(['--arch', ARCH, '--device', 'cpu', '--mesh-shape', shape])
    assert e.value.code == 2
    assert 'ROADMAP Queue 1 item 6b' in capsys.readouterr().err


def test_trainer_asks_for_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TR.Trainer(smoke_config(ARCH), OPT)
