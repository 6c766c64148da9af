"""Plain reference of the training cells: the LM's causal cross-entropy
(the mean over every labelled token), its gradient by autograd with
each layer recomputed in the backward pass, and AdamW as the
configuration states it:

    g' = g * min(1, clip / ||g||)         (||g|| over every leaf together)
    m = b1 m + (1 - b1) g',  v = b2 v + (1 - b2) g'^2
    delta = (m / (1 - b1^k)) / (sqrt(v / (1 - b2^k)) + eps) + wd * p
    p = p - lr(k) * delta

at step k = 1, 2, ..., with ``lr(k)`` a linear warmup over
``warmup_steps`` then a cosine decay to ``min_lr_frac`` at
``total_steps``.  Rows go through one at a time, their gradients summed.
The model is the family's plain ``forward(num, p, c, tokens, remat=True)``
(``reference/lm.py``'s for the dense LM).  Imports torch only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .numerics import Numerics


def lr_at(cfg: dict, k: int) -> float:
    warm = min(k / max(cfg['warmup_steps'], 1), 1.0)
    t = min(max((k - cfg['warmup_steps'])
                / max(cfg['total_steps'] - cfg['warmup_steps'], 1), 0.0), 1.0)
    cos = cfg['min_lr_frac'] + (1 - cfg['min_lr_frac']) * 0.5 * \
        (1 + math.cos(math.pi * t))
    return cfg['lr'] * warm * cos


def loss_and_grads(num: Numerics, forward, p: Dict[str, torch.Tensor],
                   c: dict, tokens: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[float, List[torch.Tensor]]:
    names = list(p)
    leaves = [p[n] for n in names]
    total = labels.numel()
    loss, grads = 0.0, None
    for r in range(tokens.shape[0]):
        logits = forward(num, p, c, tokens[r:r + 1].long(), remat=True)[0]
        nll = F.cross_entropy(logits, labels[r].long(), reduction='sum') / total
        g = torch.autograd.grad(nll, leaves)
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        loss += float(nll.detach())
        del logits, nll, g
    return loss, grads


@torch.no_grad()
def adamw(cfg: dict, p: Dict[str, torch.Tensor], grads, m, v, k: int):
    """One step, in place on ``p``, ``m`` and ``v`` (lists in ``p``'s
    order); returns the gradients as the update takes them (clipped)."""
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    factor = min(cfg['grad_clip'] / max(norm, 1e-12), 1.0) \
        if cfg['grad_clip'] > 0 else 1.0
    lr = lr_at(cfg, k)
    b1c, b2c = 1 - cfg['b1'] ** k, 1 - cfg['b2'] ** k
    taken = []
    for w, g, mi, vi in zip(p.values(), grads, m, v):
        g = g * factor
        mi.mul_(cfg['b1']).add_((1 - cfg['b1']) * g)
        vi.mul_(cfg['b2']).add_((1 - cfg['b2']) * g * g)
        delta = (mi / b1c) / (torch.sqrt(vi / b2c) + cfg['eps']) + \
            cfg['weight_decay'] * w
        w.sub_(lr * delta)
        taken.append(g)
    return taken


def train(num: Numerics, forward, p0: Dict[str, torch.Tensor], c: dict,
          opt: dict, batches) -> dict:
    """``len(batches)`` steps from the weights ``p0`` (left as they are):
    each step's loss, each leaf's norm of the first step's clipped
    gradient, and each leaf's norm of the change over all the steps."""
    p = {n: w.detach().clone().requires_grad_(True) for n, w in p0.items()}
    m = [torch.zeros_like(w) for w in p.values()]
    v = [torch.zeros_like(w) for w in p.values()]
    losses, first = [], None
    for k, b in enumerate(batches, start=1):
        loss, grads = loss_and_grads(num, forward, p, c, b['tokens'],
                                     b['labels'])
        taken = adamw(opt, p, grads, m, v, k)
        if first is None:
            first = {n: float(g.norm()) for n, g in zip(p, taken)}
        losses.append(loss)
        del grads, taken
    change = {n: float((p[n].detach() - p0[n]).norm()) for n in p}
    return {'loss': losses, 'grad': first, 'change': change}


def gaps(prog: dict, ref: dict, floor: float = 1e-3) -> Dict[str, float]:
    """The three numbers the training cells compare: the largest relative
    gap of a step's loss; over the leaves, the largest gap between the
    program's and the reference's norm of the first gradient, and of the
    change, each against the larger of the reference leaf's norm and the
    median leaf's.  A leaf whose reference gradient is under ``floor``
    times the median leaf's is nought to rounding: Adam moves it by
    round-off alone, so its change is left out."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog['loss'], ref['loss']))

    def worst(key, names):
        med = sorted(ref[key][n] for n in names)[len(names) // 2]
        return max(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med)
                   for n in names)

    names = list(ref['grad'])
    gmed = sorted(ref['grad'].values())[len(names) // 2]
    moved = [n for n in names if ref['grad'][n] >= floor * gmed]
    return {'loss_gap': loss, 'grad_gap': worst('grad', names),
            'update_gap': worst('change', moved)}
