"""Training loop, port of ``repro/launch/train.py``: the train step,
checkpoint/restart, preemption handling and straggler monitoring on one
device.

    python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --preset smoke --steps 20 --batch 8 --seq 64 --ckpt /tmp/ckpt \\
        [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises when the
GPU it is asked for is missing.  The reference places the parameters and
the optimizer state on a mesh; the port's ``Trainer`` takes a device in
its place, and ``--mesh-shape`` other than ``1,1`` is refused (sharding
is ROADMAP Queue 1 item 6b).  As in the reference, the loop feeds only
``token_batch``, so the encoder-decoder, whose loss reads ``frames``,
does not train here (its train step does, given frames).

A checkpoint is saved under the number of steps it has completed, so a
restored run starts at the first step it has not taken.  (The
reference saves its periodic and preemption checkpoints under the index
of the step just taken, one short, and a run restored from one takes
that step again: ROADMAP Queue 3.)
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get, smoke_config
from repro_torch.data.pipeline import TokenPipelineConfig, token_batch
from repro_torch.diffusion.pipeline import resolve_device
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StepMonitor)
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import AdamWConfig, AdamWState, init_adamw

MESH_REFUSED = ('sharding the parameters and optimizer state over a mesh '
                'is ROADMAP Queue 1 item 6b; the port trains on one device')


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 ckpt_dir: Optional[str] = None, real_vocab=None,
                 dtype: torch.dtype = torch.float32, keep: int = 3,
                 device='cuda'):
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep) if ckpt_dir else None
        self.monitor = StepMonitor(n_hosts=1)
        self.preempt = PreemptionHandler(install=False)
        self.real_vocab = real_vocab
        self.params = ST.init_params(
            torch.Generator(device=self.device).manual_seed(0), cfg,
            self.device)
        self.opt = init_adamw(list(ST.train_params(self.params).values()))
        self.step_fn = ST.build_train_step(cfg, opt_cfg, real_vocab,
                                           dtype=dtype)
        self.start_step = 0

    def _tree(self) -> Dict[str, object]:
        """Parameters and optimizer state by name, the checkpoint's tree."""
        names = list(ST.train_params(self.params))
        return {'params': ST.train_params(self.params),
                'opt': {'step': self.opt.step,
                        'm': dict(zip(names, self.opt.m)),
                        'v': dict(zip(names, self.opt.v))}}

    def maybe_restore(self):
        """Resume from the latest committed checkpoint (params +
        optimizer)."""
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
        print(f'[train] resumed from step {step}')

    def save(self, step: int, blocking: bool = False):
        if self.ckpt is not None:
            self.ckpt.save(step, self._tree(), blocking=blocking,
                           extra_meta={'arch': self.cfg.name})

    def run(self, data_cfg: TokenPipelineConfig, steps: int,
            ckpt_every: int = 50, log_every: int = 10) -> List[float]:
        losses = []
        host = 0
        for step in range(self.start_step, steps):
            t0 = time.time()
            batch = token_batch(data_cfg, step, device=self.device)
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
            loss = float(metrics['loss'])
            losses.append(loss)
            self.monitor.record(host, time.time() - t0)
            if step % log_every == 0:
                print(f'[train] step={step} loss={loss:.4f} '
                      f'gnorm={float(metrics["grad_norm"]):.3f} '
                      f'dt={time.time()-t0:.2f}s', flush=True)
            if self.ckpt and step and step % ckpt_every == 0:
                self.save(step + 1)
            if self.preempt.preempted:
                print('[train] preemption: sync checkpoint + exit')
                self.save(step + 1, blocking=True)
                return losses
            rep = self.monitor.check()
            if rep is not None:
                print(f'[train] straggler: {rep.recommendation}')
        if self.ckpt:
            self.save(steps, blocking=True)
        return losses


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
                    help=f'only 1,1: {MESH_REFUSED}')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (plain PyTorch)")
    args = ap.parse_args(argv)
    if args.mesh_shape.replace(' ', '') != '1,1':
        ap.error(f'--mesh-shape {args.mesh_shape} is refused: '
                 f'{MESH_REFUSED}')
    cfg = smoke_config(args.arch) if args.preset == 'smoke' \
        else get(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    tr = Trainer(cfg, opt_cfg, ckpt_dir=args.ckpt, device=args.device)
    tr.maybe_restore()
    data_cfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.batch)
    losses = tr.run(data_cfg, args.steps)
    if losses:
        print(f'[train] done. loss {losses[0]:.3f} -> {losses[-1]:.3f}')
    else:
        print(f'[train] done. nothing to run: resumed at step '
              f'{tr.start_step} of {args.steps}')


if __name__ == '__main__':
    main()
