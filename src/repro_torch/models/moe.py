"""Mixture-of-Experts FFN, port of ``repro/models/moe.py``: a top-k
router, capacity-based dispatch into per-expert buffers, the experts'
products, and the weighted combine.

Tokens go through ``G`` independent dispatch groups, as in the reference
(whose groups shard over the data axis and whose dispatch runs under
``vmap``); the port runs the groups batched.  The dispatch is exact
integer bookkeeping, step for step the reference's: top-k with the lower
expert index first on ties, a token's rank within its expert from a
stable sort, per-group capacity ``C``, and tokens past ``C`` dropped.
FLOPs are honest: ``E*C*d*ff`` with ``E*C ~= T*k*cf``, no dense
all-experts fallback.

The router and the experts stay float under ``quant``, as in the
reference; only the shared experts' MLP runs on the W8A8 kernel.
``router_aux_loss`` is the reference's Switch-style load-balancing loss,
for training; no loss of either package calls it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.quantization import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L


def _wt(w, dtype: torch.dtype) -> torch.Tensor:
    """Expert weight -> compute dtype, dequantizing a QTensor (or a
    ``QWeight``, as ``quantize_params`` leaves it).  In the weight's own
    dtype this is the weight itself, not a copy."""
    if isinstance(w, L.QWeight):
        w = QTensor(w.q, w.scale)
    if isinstance(w, QTensor):
        return (w.q.float() * w.scale).to(dtype)
    return w.to(dtype)


class MoE(nn.Module):
    """The reference's ``init_moe`` params: ``router`` (normal, stddev
    0.02), ``w_gate`` / ``w_up`` ``(E, d, ff)`` and ``w_down`` ``(E, ff,
    d)`` (normal, stddev 0.02), and ``shared``, a gated MLP of width
    ``n_shared * ff``, when the config has shared experts."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        m = cfg.moe
        d, ff, E = cfg.d_model, m.d_ff_expert, m.n_experts
        self.router = L.Linear(d, E, bias=False, device=device, stddev=0.02)
        self.w_gate = L.empty_param((E, d, ff), device)
        self.w_up = L.empty_param((E, d, ff), device)
        self.w_down = L.empty_param((E, ff, d), device)
        self.shared = (L.MLP(d, m.n_shared * ff, gated=True, bias=False,
                             device=device) if m.n_shared else None)

    def init_own_(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            w.normal_(0.0, 0.02, generator=generator)


def _dispatch_indices(expert_ids: torch.Tensor, E: int,
                      C: int) -> torch.Tensor:
    """expert_ids (..., T, k) -> flat slot index (..., T, k) into an
    ``(E*C,)`` buffer per leading index; a token past its expert's
    capacity gets slot ``E*C`` (dropped).

    A token's rank within its expert: sort the flattened assignments by
    expert id, stably; the rank is the sorted position minus the first
    position of that expert."""
    *lead, T, k = expert_ids.shape
    flat = expert_ids.reshape(*lead, T * k)
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side='left')
    rank_sorted = torch.arange(T * k, device=flat.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    slot = torch.where(rank < C, flat * C + rank, E * C)
    return slot.reshape(*lead, T, k)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, p: MoE) -> torch.Tensor:
    """Router probabilities (G, T, E) of the groups x (G, T, d)."""
    return torch.softmax(p.router(x.float()), dim=-1)


def _dispatch(x: torch.Tensor, p: MoE, m: MoEConfig, C: int):
    """Dispatch groups x (G, T, d) -> (buf (G, E, C, d), slot (G, T, k),
    top_p (G, T, k)); the scatter stays within each group."""
    return _dispatch_routed(x, _route(x, p), m, C)


def _dispatch_routed(x: torch.Tensor, probs: torch.Tensor, m: MoEConfig,
                     C: int):
    """``_dispatch`` given the router probabilities (G, T, E)."""
    G, T, d = x.shape
    E, k = m.n_experts, m.top_k
    top_p, top_e = _top_k(probs, k)
    if m.router_normalize:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    slot = _dispatch_indices(top_e, E, C)
    # one buffer of E*C + 1 rows per group; the last row takes the dropped
    # tokens (the reference's out-of-range ``mode='drop'``) and is cut off
    rows = E * C + 1
    idx = slot + rows * torch.arange(G, device=x.device)[:, None, None]
    buf = x.new_zeros((G * rows, d))
    buf.index_add_(0, idx.reshape(-1),
                   x.repeat_interleave(k, dim=1).reshape(-1, d))
    return buf.reshape(G, rows, d)[:, :E * C].reshape(G, E, C, d), slot, \
        top_p


def _combine(y_buf: torch.Tensor, slot: torch.Tensor, top_p: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """y_buf (G, E, C, d) -> (G, T, d): each token's expert outputs,
    weighted by its top-k probabilities; a dropped slot contributes 0."""
    G, E, C, d = y_buf.shape
    T, k = slot.shape[1:]
    flat = slot.reshape(G, T * k)
    rows = torch.arange(G, device=slot.device)[:, None]
    y_tok = y_buf.reshape(G, E * C, d)[rows, flat.clamp(0, E * C - 1)]
    y_tok = torch.where((flat < E * C)[..., None], y_tok, 0.0)
    return torch.einsum('gtkd,gtk->gtd', y_tok.reshape(G, T, k, d),
                        top_p.to(dtype))


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, act) -> torch.Tensor:
    """buf (G, E, C, d) through each expert's gated MLP -> (G, E, C, d)."""
    h = act(torch.einsum('gecd,edf->gecf', buf, w_gate)) \
        * torch.einsum('gecd,edf->gecf', buf, w_up)
    return torch.einsum('gecf,efd->gecd', h, w_down)


def moe_ffn(p: MoE, cfg: ArchConfig, x: torch.Tensor,
            quant: bool = False) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  On a mesh the groups shard over the
    data-parallel axes and the experts over 'model' (the reference's
    constraints).  The dispatch (sort, ``searchsorted``, ``index_add_``),
    the combine (a gather) and the reshapes into and out of groups have
    no DTensor rule, so they run on each rank's own groups
    (``sharding.on_shards``); the batch is replicated first when its
    sharding and the groups' differ, so those reshapes stay local."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    G = min(cfg.moe_groups, T)
    while T % G:
        G -= 1
    Tg = T // G
    C = max(1, int(Tg * m.top_k * m.capacity_factor / m.n_experts))
    C = -(-C // 8) * 8          # the reference's lane-friendly multiple
    act = L.ACTIVATIONS[cfg.act]
    lay = 'dp'                  # the batch's layout around the groups
    if SH.is_dtensor(x):
        mesh = x.device_mesh
        if SH.dp_spec(mesh, B) != SH.dp_spec(mesh, G):
            lay = None
        x = SH.shard_hint(x, lay, None, None)
    xg = SH.shard_hint(SH.on_shards(lambda a: a.reshape(-1, Tg, d), 1, x),
                       'dp', None, None)
    probs = SH.shard_hint(_route(xg, p), 'dp', None, None)
    buf, slot, top_p = SH.on_shards(
        lambda a, b: _dispatch_routed(a, b, m, C), 3, xg, probs)
    buf = SH.shard_hint(buf, 'dp', 'model', None, None)      # (G, E, C, d)
    # each rank's groups through its experts (``on_shards``), every
    # expert's weights gathered whole: DTensor's einsum fails on some
    # capacities (a decode step's C = 8 over 'model')
    ws = [SH.shard_hint(_wt(w, x.dtype), 'model', None, None)
          for w in (p.w_gate, p.w_up, p.w_down)]
    y_buf = SH.on_shards(lambda b, g, u, dn: _experts(b, g, u, dn, act), 1,
                         buf, *ws)
    y_buf = SH.shard_hint(y_buf, 'dp', 'model', None, None)
    # the combine reads every expert's rows: 'model' gathered first
    y_buf = SH.shard_hint(y_buf, 'dp', None, None, None)
    y = SH.on_shards(lambda a, b, c: _combine(a, b, c, x.dtype), 1,
                   y_buf, slot, top_p)
    y = SH.shard_hint(y, lay, None, None)
    y = SH.shard_hint(SH.on_shards(lambda a: a.reshape(-1, S, d), 1, y),
                      'dp', None, None)
    if p.shared is not None:
        y = y + L.mlp(p.shared, x, act=cfg.act, quant=quant,
                      tp_axis='model' if cfg.model_axis_tp else None)
    return y


def router_aux_loss(p: MoE, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss over x (B, S, d):
    ``n_experts`` times the sum over experts of the share of tokens whose
    top expert it is and its mean router probability."""
    E = cfg.moe.n_experts
    probs = torch.softmax(p.router(x.float()), dim=-1)      # (B, S, E)
    top_e = probs.argmax(dim=-1)
    frac_tokens = torch.nn.functional.one_hot(top_e, E).float().mean((0, 1))
    frac_probs = probs.mean((0, 1))
    return E * (frac_tokens * frac_probs).sum()
