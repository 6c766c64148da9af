"""Training loop, port of ``repro/launch/train.py``: the train step,
checkpoint/restart, preemption handling and straggler monitoring, on one
device or sharded over a ``DeviceMesh``.

    python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --preset smoke --steps 20 --batch 8 --seq 64 --ckpt /tmp/ckpt \\
        [--device cpu]

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch internlm2-1.8b --preset smoke \\
        --mesh-shape 2,2 [--device cpu] [--backend gloo]

It runs on the GPU unless ``--device cpu`` is given, and raises when the
GPU it is asked for is missing.  ``--mesh-shape`` names the mesh, its
axes the reference's (``('data', 'model')`` for up to two dims,
``('pod', 'data', 'model')`` for three), one rank per mesh entry under
``torchrun``; a shape whose size is not the world size exits 2, naming
the ``--nproc-per-node`` it needs.  ``--backend`` defaults to ``nccl``
on the GPU and ``gloo`` on the CPU; NCCL refuses two ranks on one card,
so ranks that share a card need ``--backend gloo``, and the CLI says so
rather than switching.  Outside ``torchrun`` only the default ``1,1``
runs, on one device with plain tensors.

With a mesh the ``Trainer`` holds the parameters and AdamW moments as
DTensors laid out by ``sharding.param_pspecs`` (the reference's FSDP x
tensor layout), computes what the single-device ``Trainer`` computes
up to float reduction order, and prints on rank 0 only.  Every rank
draws the global batch ``token_batch(data_cfg, step)`` and keeps its
rows, so the data do not depend on the mesh (the reference's
``token_batch(shard=)`` seeds each shard on its own and would).  A
checkpoint holds full arrays and restores onto any mesh (elastic
resharding).  As in the reference, the loop feeds only ``token_batch``,
so the encoder-decoder, whose loss reads ``frames``, does not train here
(its train step does, given frames).

A checkpoint is saved under the number of steps it has completed, so a
restored run starts at the first step it has not taken.  (The
reference saves its periodic and preemption checkpoints under the index
of the step just taken, one short, and a run restored from one takes
that step again: ROADMAP Queue 3.)
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get, smoke_config
from repro_torch.data.pipeline import TokenPipelineConfig, token_batch
from repro_torch.diffusion.pipeline import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StepMonitor)
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import launch_hint, make_mesh, world_size
from repro_torch.optim.adamw import AdamWConfig, AdamWState, init_adamw


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the current card on a CUDA mesh."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _distribute_params(model: torch.nn.Module, mesh, specs) -> None:
    """Replace each float parameter of ``model`` by a DTensor on ``mesh``
    laid out by ``specs[name]`` (every rank holds the same full value;
    each keeps its own chunk)."""
    for mname, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            name = f'{mname}.{pname}' if mname else pname
            if p is None or name not in specs:
                continue
            mod._parameters[pname] = torch.nn.Parameter(
                SH.distribute(p.detach(), mesh, specs[name]),
                requires_grad=p.requires_grad)


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 ckpt_dir: Optional[str] = None, real_vocab=None,
                 dtype: torch.dtype = torch.float32, keep: int = 3,
                 device='cuda', mesh=None):
        self.cfg, self.opt_cfg, self.mesh = cfg, opt_cfg, mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh_device(mesh))
        self.rank = dist.get_rank() if mesh is not None else 0
        self.ckpt = CheckpointManager(ckpt_dir, keep) if ckpt_dir else None
        self.monitor = StepMonitor(
            n_hosts=1 if mesh is None else dist.get_world_size())
        self.preempt = PreemptionHandler(install=False)
        self.real_vocab = real_vocab
        self.params = ST.init_params(
            torch.Generator(device=self.device).manual_seed(0), cfg,
            self.device)
        if mesh is not None:
            _distribute_params(self.params, mesh,
                              SH.param_pspecs(self.params, mesh))
        self.opt = init_adamw(list(ST.train_params(self.params).values()))
        self.step_fn = ST.build_train_step(cfg, opt_cfg, real_vocab,
                                           dtype=dtype, mesh=mesh)
        self.start_step = 0

    def log(self, msg: str) -> None:
        """Print on rank 0 only."""
        if self.rank == 0:
            print(msg, flush=True)

    def _tree(self) -> Dict[str, object]:
        """Parameters and optimizer state by name, the checkpoint's tree."""
        names = list(ST.train_params(self.params))
        return {'params': ST.train_params(self.params),
                'opt': {'step': self.opt.step,
                        'm': dict(zip(names, self.opt.m)),
                        'v': dict(zip(names, self.opt.v))}}

    def maybe_restore(self):
        """Resume from the latest committed checkpoint (params +
        optimizer), resharded onto the *current* mesh (elastic
        restart)."""
        if self.ckpt is None:
            return
        step = self.ckpt.latest_step()
        if step is None:
            return
        restored = self.ckpt.restore(step, self._tree())
        with torch.no_grad():
            for p, saved in zip(ST.train_params(self.params).values(),
                                restored['params'].values()):
                p.copy_(saved)
        opt = restored['opt']
        self.opt = AdamWState(opt['step'], list(opt['m'].values()),
                              list(opt['v'].values()))
        self.start_step = step
        self.log(f'[train] resumed from step {step}')

    def save(self, step: int, blocking: bool = False):
        if self.ckpt is not None:
            self.ckpt.save(step, self._tree(), blocking=blocking,
                           extra_meta={'arch': self.cfg.name})

    def run(self, data_cfg: TokenPipelineConfig, steps: int,
            ckpt_every: int = 50, log_every: int = 10) -> List[float]:
        losses = []
        host = self.rank
        for step in range(self.start_step, steps):
            t0 = time.time()
            batch = token_batch(data_cfg, step, device=self.device)
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
            loss = float(metrics['loss'])
            losses.append(loss)
            self.monitor.record(host, time.time() - t0)
            if step % log_every == 0:
                self.log(f'[train] step={step} loss={loss:.4f} '
                         f'gnorm={float(metrics["grad_norm"]):.3f} '
                         f'dt={time.time()-t0:.2f}s')
            if self.ckpt and step and step % ckpt_every == 0:
                self.save(step + 1)
            if self.preempt.preempted:
                self.log('[train] preemption: sync checkpoint + exit')
                self.save(step + 1, blocking=True)
                return losses
            rep = self.monitor.check()
            if rep is not None:
                self.log(f'[train] straggler: {rep.recommendation}')
        if self.ckpt:
            self.save(steps, blocking=True)
        return losses


def mesh_axes(shape) -> tuple:
    """The reference's axes for a ``--mesh-shape``."""
    return (('data', 'model')[:len(shape)] if len(shape) <= 2
            else ('pod', 'data', 'model'))


def _local_device(device: str) -> torch.device:
    """This rank's device under ``torchrun``: card ``LOCAL_RANK`` modulo
    the cards there are (ranks share cards when they outnumber them)."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        return dev
    local = int(os.environ.get('LOCAL_RANK', '0'))
    dev = torch.device('cuda', local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', required=True)
    ap.add_argument('--preset', default='smoke', choices=['smoke', 'full'])
    ap.add_argument('--steps', type=int, default=50)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=64)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--ckpt', default=None)
    ap.add_argument('--mesh-shape', default='1,1',
                    help="e.g. 2,2 (data, model) or 2,1,2 (pod, data, "
                         "model): one rank per entry under torchrun")
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (plain PyTorch)")
    ap.add_argument('--backend', default=None, choices=['nccl', 'gloo'],
                    help='nccl on cuda, gloo on cpu by default')
    args = ap.parse_args(argv)
    try:
        shape = tuple(int(x) for x in args.mesh_shape.split(','))
    except ValueError:
        ap.error(f'--mesh-shape {args.mesh_shape}: not integers')
    if not 1 <= len(shape) <= 3 or min(shape) < 1:
        ap.error(f'--mesh-shape {args.mesh_shape}: one to three positive '
                 f'sizes')
    n, world = math.prod(shape), world_size()
    launched = 'WORLD_SIZE' in os.environ         # under torchrun
    if n != world or (not launched and shape != (1, 1)):
        ap.error(f'--mesh-shape {args.mesh_shape} needs {n} rank(s), one '
                 f'per device, under torchrun, and this run has {world}'
                 f'{"" if launched else " outside it"}: '
                 f'--nproc-per-node {n} ({launch_hint(n)})')
    cfg = smoke_config(args.arch) if args.preset == 'smoke' \
        else get(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    mesh = None
    if launched:
        device = _local_device(args.device)
        backend = args.backend or ('nccl' if device.type == 'cuda'
                                   else 'gloo')
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
        if backend == 'nccl' and device.type == 'cuda' and \
                local_world > torch.cuda.device_count():
            ap.error(f'{local_world} ranks share {torch.cuda.device_count()}'
                     f' card(s), and NCCL refuses two ranks on one card '
                     f'("Duplicate GPU detected"): pass --backend gloo')
        if backend == 'nccl' and device.type != 'cuda':
            ap.error('--backend nccl needs --device cuda')
        dist.init_process_group(backend)
        mesh = make_mesh(shape, mesh_axes(shape), device.type)
    try:
        tr = Trainer(cfg, opt_cfg, ckpt_dir=args.ckpt, device=args.device,
                     mesh=mesh)
        tr.maybe_restore()
        data_cfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                       global_batch=args.batch)
        losses = tr.run(data_cfg, args.steps)
        if losses:
            tr.log(f'[train] done. loss {losses[0]:.3f} -> '
                   f'{losses[-1]:.3f}')
        else:
            tr.log(f'[train] done. nothing to run: resumed at step '
                   f'{tr.start_step} of {args.steps}')
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
