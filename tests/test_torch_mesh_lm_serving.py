"""The LM serving steps on a ``DeviceMesh`` (the path the dry run traces)
against the same model on one device: four gloo ranks started by
``torch.multiprocessing`` on the CPU, a smoke config with its
parameters laid out by the reference's rules (``dryrun.model_specs``)
and its cache by ``cache_pspecs``; a prefill, then decode steps on the
single-device run's greedy tokens.  For InternLM2 the meshes cover the
KV cache's layouts: heads over 'model' with the batch over 'data' (2,
2); the sequence over 'model' when the KV heads do not divide it (1,
4); the sequence over 'data' when the batch of 1 does not (2, 2), which
decodes through ``attention.seq_parallel_core``.  DeepSeek-V2-Lite's
absorbed MLA runs per rank (``on_shards``); Mamba2's and the smoke
Jamba's (two groups) SSD scan and recurrence run on each rank's own
heads (``ssm._scan_on_heads``), the state's heads on 'model'.

Tolerance: 1e-5 absolute on logits and cache rows of order 1: the
sharded products sum over shards in another order (float32, measured
<= 4e-7)."""
import os
import socket

import pytest
import torch
import torch.multiprocessing as mp

PROMPT, NEW, TOL = 13, 3, 1e-5


def _port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _place(tree, specs, mesh):
    from repro_torch.distributed import sharding as SH
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, s, mesh) for v, s in zip(tree, specs)]
    return SH.distribute(tree, mesh, specs)


def _rank(rank, world, port, arch, shape, batch, out):
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port))
    dist.init_process_group('gloo', rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.configs.registry import smoke_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch import dryrun as DR
        from repro_torch.launch import steps as ST
        from repro_torch.launch.train import _distribute_params
        from repro_torch.models import transformer as T
        cfg = smoke_config(arch)
        mesh = init_device_mesh('cpu', shape,
                                mesh_dim_names=('data', 'model'))
        model = ST.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')
        ref = ST.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')
        _distribute_params(model, mesh, DR.model_specs(model, mesh))
        tokens = torch.randint(0, cfg.vocab, (batch, PROMPT),
                               generator=torch.Generator().manual_seed(1),
                               dtype=torch.int32)
        new = lambda: ST.init_serve_state(cfg, batch, PROMPT + NEW,
                                          cache_dtype=torch.float32)
        specs = SH.cache_pspecs(new(), mesh, batch)
        cache = _place(new(), specs, mesh)['cache']
        rcache = new()['cache']
        on = lambda t: SH.distribute(t, mesh, SH.batch_pspecs(mesh, batch, 2))
        errs = []
        with torch.no_grad(), SH.use_mesh(mesh), implicit_replication():
            lg, cache = T.lm_prefill(model, cfg, on(tokens), cache,
                                     dtype=torch.float32)
            rlg, rcache = T.lm_prefill(ref, cfg, tokens, rcache,
                                       dtype=torch.float32)
            errs.append((lg.full_tensor() - rlg).abs().max().item())
            for i in range(NEW):
                nxt = rlg.argmax(-1).to(torch.int32)
                lg, cache = T.lm_decode(model, cfg, on(nxt), cache,
                                        PROMPT + i, dtype=torch.float32)
                rlg, rcache = T.lm_decode(ref, cfg, nxt, rcache, PROMPT + i,
                                          dtype=torch.float32)
                errs.append((lg.full_tensor() - rlg).abs().max().item())
            for c, rc in zip(cache, rcache):
                for k, t in c['sub0'].items():
                    errs.append((t.full_tensor() - rc['sub0'][k]).abs()
                                .max().item())
        if rank == 0:
            torch.save({'errs': errs, 'spec': specs['cache'][0]['sub0'],
                        'layers': len(cache)}, out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('arch,shape,batch,spec', [
    ('internlm2-1.8b', (2, 2), 4, {'k': ('data', None, 'model', None)}),
    ('internlm2-1.8b', (1, 4), 4, {'k': ('data', 'model', None, None)}),
    ('internlm2-1.8b', (2, 2), 1, {'k': (None, 'data', 'model', None)}),
    ('deepseek-v2-lite-16b', (2, 2), 4, {'c_kv': ('data', None, None)}),
    ('mamba2-2.7b', (2, 2), 4, {'state': ('data', 'model', None, None)}),
    ('jamba-1.5-large-398b', (2, 2), 4,
     {'state': ('data', 'model', None, None)})],
    ids=['heads-on-model', 'rows-on-model', 'rows-on-data', 'mla', 'ssm',
         'ssm-groups'])
def test_sharded_prefill_and_decode_match_one_device(tmp_path, arch, shape,
                                                     batch, spec):
    out = str(tmp_path / 'errs.pt')
    mp.spawn(_rank, args=(4, _port(), arch, shape, batch, out), nprocs=4)
    got = torch.load(out)
    for k, v in spec.items():
        assert got['spec'][k] == v
    assert len(got['errs']) == 1 + NEW + len(got['spec']) * got['layers']
    assert max(got['errs']) <= TOL, got['errs']
