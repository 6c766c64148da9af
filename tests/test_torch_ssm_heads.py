"""The SSD scan on a ``DeviceMesh`` whose 'model' axis divides the heads
(``ssm._scan_on_heads``): each rank scans its own heads with the groups
they read, as the reference lays ``A_log``, ``D``, ``dt_bias`` and the
state over 'model'.

Gloo ranks started by ``torch.multiprocessing`` on the CPU run one
training loss and its gradient of a smoke config, its parameters laid
out by the reference's rules, against the same model on one device:
Mamba2 (one group), the hybrid Jamba (two groups, so each rank of a
'model' axis of 2 reads its own group) and a Mamba2 of 24 heads in 6
groups on a 'model' axis of 4, where a rank's 6 heads straddle two
groups and read one group row per head.  Each rank records the heads
its scans held.  A fake-mesh dry-run trace of the smoke Mamba2 on
(4, 4) records the same.

Tolerance: 1e-5 relative on the loss and each gradient (its largest
element): the sharded products sum over shards in another order,
float32 (measured below 3e-7).
"""
import dataclasses
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

RTOL = 1e-5
BATCH, SEQ = 4, 32          # two chunks of the smoke configs' 16


def _cfg(name):
    from repro_torch.configs.registry import smoke_config
    if name == 'mamba2-straddle':
        cfg = smoke_config('mamba2-2.7b')
        return dataclasses.replace(cfg, d_model=96, ssm=dataclasses.replace(
            cfg.ssm, n_groups=6))
    return smoke_config(name)


def _port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ),
                                             dtype=np.int32))
            for k in ('tokens', 'labels')}


def _scans():
    """Record the heads of every scan and recurrence call."""
    from repro_torch.models import ssm as SSM
    seen = []
    orig = SSM._ssd_chunked

    def rec(x, *a, **k):
        seen.append(x.shape[2])
        return orig(x, *a, **k)
    SSM._ssd_chunked = rec
    return seen


def _rank(rank, world, port, name, shape, out):
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port))
    dist.init_process_group('gloo', rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.launch import dryrun as DR
        from repro_torch.launch import steps as ST
        from repro_torch.launch.train import _distribute_params
        cfg = _cfg(name)
        mesh = init_device_mesh('cpu', shape,
                                mesh_dim_names=('data', 'model'))
        model = ST.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')
        _distribute_params(model, mesh, DR.model_specs(model, mesh))
        params = ST.train_params(model)
        seen = _scans()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            batch = ST.shard_batch(_batch(cfg), mesh)
            loss = ST.train_loss(model, cfg, batch, torch.float32)
            grads = torch.autograd.grad(loss, list(params.values()))
        res = {'loss': loss.full_tensor().detach(), 'heads': seen,
               'grads': {n: g.full_tensor() for n, g in
                         zip(params, grads)}}
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _single(name):
    from repro_torch.launch import steps as ST
    cfg = _cfg(name)
    model = ST.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')
    params = ST.train_params(model)
    loss = ST.train_loss(model, cfg, _batch(cfg), torch.float32)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), cfg


@pytest.mark.parametrize('name,shape', [
    ('mamba2-2.7b', (2, 2)), ('mamba2-2.7b', (1, 4)),
    ('jamba-1.5-large-398b', (2, 2)), ('mamba2-straddle', (1, 4))],
    ids=['mamba2-2x2', 'mamba2-1x4', 'jamba-2x2', 'straddle-1x4'])
def test_loss_and_gradients_on_each_ranks_heads(tmp_path, name, shape):
    out = str(tmp_path / 'ssd.pt')
    world = shape[0] * shape[1]
    mp.spawn(_rank, args=(world, _port(), name, shape, out), nprocs=world)
    got = torch.load(out)
    loss, grads, cfg = _single(name)
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim
    assert got['heads'] and set(got['heads']) == {H // shape[1]}
    assert abs(float(got['loss']) - float(loss)) <= RTOL * abs(float(loss))
    assert got['grads'].keys() == grads.keys()
    for n, g in grads.items():
        scale = float(g.abs().max())
        err = float((got['grads'][n] - g).abs().max())
        assert err <= RTOL * max(scale, 1e-12), (n, err, scale)


def test_fake_mesh_trace_scans_heads_over_model():
    """The smoke Mamba2's training step on a fake (4, 4) mesh: every scan
    holds 16 / 4 heads of its rank's 4 rows, and no float32 storage of
    the step holds all 16 heads."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import ssm as SSM
    seen = []
    orig = SSM._ssd_chunked

    def rec(x, *a, **k):
        seen.append(tuple(x.shape))
        return orig(x, *a, **k)
    SSM._ssd_chunked = rec
    try:
        mesh = DR.fake_mesh((4, 4), ('data', 'model'))
        tr = DR.trace_cell(_cfg('mamba2-2.7b'), ShapeConfig('t', 32, 16,
                                                             'train'),
                           mesh, record=True)
    finally:
        SSM._ssd_chunked = orig
        DR.release_mesh()
    assert seen and all(s[0] == 4 and s[2] == 4 for s in seen)
    # x (B, S, H, P) and the state (B, H, P, N) at all 16 heads, float32
    whole = [m for m in tr['storages_made'] if m[2] == 'float32'
             and m[1] in ((4, 32, 16, 8), (4, 16, 8, 16))]
    assert not whole, whole[:4]
    assert any(m[1] == (4, 32, 4, 8) for m in tr['storages_made'])
