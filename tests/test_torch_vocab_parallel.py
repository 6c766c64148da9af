"""The training loss on a ``DeviceMesh`` (``layers.token_xent`` through
``sharding.vocab_xent``), and the two repairs of a rank that holds one
row of the batch.

Gloo ranks started by ``torch.multiprocessing`` on the CPU take the same
numpy logits and labels, the logits laid out at ('data', None, 'model')
(``transformer._readout``'s layout), the labels at their rows.  Their
loss and the logits' gradient are held against the single-device
``token_xent`` and the reference's ``lm_loss`` on the same logits.  The
labels sit at every shard edge of a vocabulary split 2 and 4 ways, some
are -1, and the last 3 of the 24 columns are padding (``real_vocab``).
On a (1, 1) mesh no dim splits the vocabulary and the loss and its
gradient equal the single device's bit for bit.

Tolerance: 1e-6 of the loss and 1e-6 of the gradient's largest element:
each shard sums its own ``exp(x - max)`` and the all-reduce adds the
shards' sums in another order, in float32 (measured below 2e-7).

The dry-run traces (fake tensors on a fake process group, at smoke
width) check what no rank may hold: a row over the whole vocabulary, or
rotary tables over the global batch; and they trace the two one-row
cases that failed before: Whisper's loss backward at one row a rank, and
a batch of one row on a 'data' axis of one rank.
"""
import dataclasses
import os
import socket
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

B, S, V, REAL = 4, 5, 24, 21
RTOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((B, S, V))).astype(np.float32)
    labels = rng.integers(0, REAL, (B, S)).astype(np.int32)
    labels[0] = [0, 5, 6, 11, 12]            # shard edges at 2 and 4 ways
    labels[1, :3] = [17, 18, REAL - 1]
    labels[1, 3] = labels[2, 0] = -1
    return logits, labels


def _port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank(rank, world, port, shape, out):
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port))
    dist.init_process_group('gloo', rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.distributed import sharding as SH
        from repro_torch.models import layers as L
        mesh = init_device_mesh('cpu', shape,
                                mesh_dim_names=('data', 'model'))
        logits, labels = _inputs()
        lg = SH.distribute(torch.from_numpy(logits), mesh,
                           ('data', None, 'model')).requires_grad_()
        lab = SH.distribute(torch.from_numpy(labels), mesh,
                            SH.batch_pspecs(mesh, B, 2))
        with implicit_replication():
            loss = L.token_xent(lg, lab, REAL)
            (g,) = torch.autograd.grad(loss, [lg])
        res = {'loss': loss.full_tensor().detach(), 'grad': g.full_tensor(),
               'local': tuple(g.to_local().shape)}
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _on_mesh(tmp_path, shape):
    out = str(tmp_path / 'xent.pt')
    world = shape[0] * shape[1]
    mp.spawn(_rank, args=(world, _port(), shape, out), nprocs=world)
    return torch.load(out)


def _single():
    from repro_torch.models import layers as L
    logits, labels = _inputs()
    lg = torch.from_numpy(logits).requires_grad_()
    loss = L.token_xent(lg, torch.from_numpy(labels), REAL)
    (g,) = torch.autograd.grad(loss, [lg])
    return loss.detach(), g


def _reference(monkeypatch):
    """The reference's ``lm_loss`` and its gradient by the logits, its
    ``lm_apply`` handing it the logits."""
    import jax
    import jax.numpy as jnp

    import repro.models.transformer as RT
    logits, labels = _inputs()
    cfg = types.SimpleNamespace(vocab=V)

    def f(lg):
        monkeypatch.setattr(RT, 'lm_apply', lambda *a, **k: lg)
        return RT.lm_loss(None, cfg, None, jnp.asarray(labels),
                          real_vocab=REAL)

    loss, g = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(loss), np.asarray(g)


def _close(got, want):
    scale = float(np.abs(np.asarray(want)).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize('shape', [(2, 2), (1, 4), (4, 1)],
                         ids=['2x2', '1x4', '4x1'])
def test_sharded_loss_and_gradient_equal_one_device_and_reference(
        tmp_path, monkeypatch, shape):
    got = _on_mesh(tmp_path, shape)
    loss, g = _single()
    ref_loss, ref_g = _reference(monkeypatch)
    _close(got['loss'], loss)
    _close(got['grad'], g)
    _close(got['loss'], ref_loss)
    _close(got['grad'], ref_g)
    # each rank's gradient covers its own rows and vocabulary columns
    assert got['local'] == (B // shape[0], S, V // shape[1])
    # the padded columns get no gradient
    assert float(got['grad'][..., REAL:].abs().max()) == 0.0


def test_loss_on_a_one_rank_mesh_equals_one_device_bit_for_bit(tmp_path):
    got = _on_mesh(tmp_path, (1, 1))
    loss, g = _single()
    assert torch.equal(got['loss'], loss)
    assert torch.equal(got['grad'], g)


def test_single_device_loss_matches_reference(monkeypatch):
    loss, g = _single()
    ref_loss, ref_g = _reference(monkeypatch)
    _close(loss, ref_loss)
    _close(g, ref_g)


# ---------------------------------------------------------------------------
# dry-run traces on a fake mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def fake():
    from repro_torch.launch import dryrun as DR
    yield DR
    DR.release_mesh()


def _trace(DR, arch, mesh_shape, batch, seq, kind='train', **replace):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import smoke_config
    cfg = dataclasses.replace(smoke_config(arch), **replace)
    mesh = DR.fake_mesh(mesh_shape, ('data', 'model'))
    return DR.trace_cell(cfg, ShapeConfig('t', seq, batch, kind), mesh,
                         record=True)


def test_train_trace_holds_no_row_over_the_vocabulary(fake):
    """The smoke InternLM2 at a vocabulary of 256 on a (4, 4) mesh: no
    storage of the step, forward or backward, spans the vocabulary, and
    the rotary tables hold one row whatever the batch."""
    tr = _trace(fake, 'internlm2-1.8b', (4, 4), 16, 32, vocab=256)
    made = tr['storages_made']
    assert not [m for m in made if m[1] and m[1][-1] == 256]
    # the loss's local logits: 4 rows, 64 of the 256 columns
    assert any(m[1] == (4, 32, 64) and m[2] == 'float32' for m in made)
    tables = [m for m in made if m[0] in ('cos.default', 'sin.default')
              and len(m[1]) == 3]                  # (rows, S, hd / 2)
    assert tables and all(m[1][0] == 1 for m in tables)


@pytest.mark.parametrize('mesh_shape,batch', [((16, 16), 16), ((4, 4), 4)],
                         ids=['16x16', '4x4'])
def test_whisper_loss_backward_at_one_row_a_rank(fake, mesh_shape, batch):
    """Whisper's training step with one row on each 'data' rank: its
    backward asked a fake tensor for its value (``_local_scalar_dense``)
    where the residual stream landed with its rows on 'model'."""
    tr = _trace(fake, 'whisper-base', mesh_shape, batch, 64)
    assert tr['peak_bytes_per_device'] > tr['argument_bytes'] > 0


@pytest.mark.parametrize('arch,kind', [
    ('internlm2-1.8b', 'train'), ('internlm2-1.8b', 'prefill'),
    ('whisper-base', 'train')])
def test_a_batch_of_one_on_a_data_axis_of_one_rank(fake, arch, kind):
    """A batch of one row on a (1, 4) mesh: DTensor refused to flatten
    the row's dim, split over the 'data' axis of one rank, before the
    attention's and the MLP's products."""
    tr = _trace(fake, arch, (1, 4), 1, 32, kind)
    assert tr['peak_bytes_per_device'] > tr['argument_bytes'] > 0
