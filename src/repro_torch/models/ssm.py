"""Mamba2 (SSD, state-space duality) mixer, port of
``repro/models/ssm.py``.

Chunked SSD: within a chunk the recurrence is a masked, decay-weighted
attention-like quadratic form; across chunks a small float32 state
``(B, H, P, N)`` is carried (the reference's ``lax.scan`` over chunks
is a Python loop here).  Decode is the pure recurrence ``state' = state *
exp(dt*A) + dt * (B outer x)``.  Every three-operand contraction of the
reference is written as two pairwise ones, so no ``(B, Q, Q, H, P)``
intermediate is formed whatever ``torch.einsum`` would choose.

The paper's attention techniques (C2/C3) do not apply to this
attention-free mixer; ``quant`` (C1) runs its four projections on the
W8A8 kernel, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.headdim


def ssm_constants(n_heads: int) -> Dict[str, np.ndarray]:
    """The reference's deterministic ``A_log = log(linspace(1, 16, H))``,
    ``D = 1`` and ``dt_bias = log(expm1(linspace(1e-3, 1e-1, H)))``,
    computed in float64 and rounded once to float32, so every device gets
    the same bits.  (XLA's CPU code for the float32 linspace, log and
    expm1 is not correctly rounded: its values differ from these by at
    most 4.8e-7.)"""
    return {
        'A_log': np.log(np.linspace(1.0, 16.0, n_heads)).astype(np.float32),
        'D': np.ones((n_heads,), np.float32),
        'dt_bias': np.log(np.expm1(np.linspace(1e-3, 1e-1, n_heads))
                          ).astype(np.float32),
    }


class Mamba(nn.Module):
    """The reference's ``init_mamba`` params: the input projections
    ``in_z`` / ``in_xbc`` / ``in_dt`` (kept apart as in the reference),
    the depthwise causal convolution ``conv_w`` ``(d_conv, conv_dim)``
    (normal, stddev 0.02) and ``conv_b`` (zero), the SSM constants
    ``A_log``, ``D``, ``dt_bias``, the gated ``norm`` and ``out_proj``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        s, d_inner, H = _dims(cfg)
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        d = cfg.d_model
        self.in_z = L.Linear(d, d_inner, bias=False, device=device)
        self.in_xbc = L.Linear(d, conv_dim, bias=False, device=device)
        self.in_dt = L.Linear(d, H, bias=False, device=device)
        self.conv_w = L.empty_param((s.d_conv, conv_dim), device)
        self.conv_b = L.empty_param((conv_dim,), device)
        self.A_log = L.empty_param((H,), device)
        self.D = L.empty_param((H,), device)
        self.dt_bias = L.empty_param((H,), device)
        self.norm = L.RMSNorm(d_inner, device)
        self.out_proj = L.Linear(d_inner, d, bias=False, device=device)

    def init_own_(self, generator: torch.Generator) -> None:
        self.conv_w.normal_(0.0, 0.02, generator=generator)
        self.conv_b.zero_()
        for name, value in ssm_constants(self.A_log.numel()).items():
            getattr(self, name).copy_(torch.from_numpy(value))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d then swish.  xBC (B, S, C), w (K, C);
    ``state`` (B, K-1, C) holds the last K-1 inputs (decode).  Returns the
    output and the new state."""
    K = w.shape[0]
    B, S, C = xBC.shape
    pad = (xBC.new_zeros((B, K - 1, C)) if state is None
           else state.to(xBC.dtype))
    xp = torch.cat([pad, xBC], dim=1)                     # (B, S+K-1, C)
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return L.swish(out + b), new_state


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over chunks.  x (B, S, H, P), dt (B, S, H), A (H,) negative,
    Bm / Cm (B, S, G, N) with H = G * rep.  S pads to a multiple of the
    chunk.  Returns (y (B, S, H, P), final state (B, H, P, N) float32)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nC = x.shape[1] // Q
    xc = x.reshape(B, nC, Q, H, P)
    dtc = dt.reshape(B, nC, Q, H)
    Bc = Bm.reshape(B, nC, Q, G, N)
    Cc = Cm.reshape(B, nC, Q, G, N)
    cum = torch.cumsum(dtc * A, dim=2)                    # within a chunk
    state = (x.new_zeros((B, H, P, N), dtype=torch.float32)
             if init_state is None else init_state.float())
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nC):
        xq, dtq, cumq = xc[:, c], dtc[:, c], cum[:, c]
        bqh = Bc[:, c].repeat_interleave(rep, dim=2)      # (B, Q, H, N)
        cqh = Cc[:, c].repeat_interleave(rep, dim=2)
        # intra-chunk: L[i, j] = exp(cum_i - cum_j) for j <= i
        Lm = torch.where(mask[None, :, :, None], torch.exp(torch.clamp(
            cumq[:, :, None, :] - cumq[:, None, :, :], -60.0, 0.0)), 0.0)
        s = torch.einsum('bign,bjgn->bijg', Cc[:, c], Bc[:, c])
        s = s.repeat_interleave(rep, dim=-1) * Lm         # (B, Q, Q, H)
        y = torch.einsum('bijh,bjhp->bihp', s * dtq[:, None], xq)
        # inter-chunk: C_i . state, decayed from the chunk's start
        decay_i = torch.exp(torch.clamp(cumq, -60.0, 0.0))   # (B, Q, H)
        y = y + torch.einsum('bihn,bhpn->bihp', cqh, state) \
            * decay_i[..., None]
        ys.append(y)
        # state' = state exp(cum_end) + sum_j exp(cum_end - cum_j) dt_j B_j x_j
        cum_end = cumq[:, -1]                             # (B, H)
        w_j = dtq * torch.exp(torch.clamp(cum_end[:, None] - cumq, -60.0,
                                          0.0))
        state = state * torch.exp(torch.clamp(cum_end, -60.0, 0.0)
                                  )[:, :, None, None] \
            + torch.einsum('bjhn,bjhp->bhpn', bqh * w_j[..., None], xq)
    y = torch.stack(ys, dim=1).reshape(B, nC * Q, H, P)[:, :S]
    return y, state


def _recurrence(xh, dt, A, Bm, Cm, state):
    """One decode step of the SSM: xh (B, 1, H, P), dt (B, 1, H), A (H,),
    Bm / Cm (B, 1, G, N), the cached state (B, H, P, N) -> y (B, 1, H, P)
    and the new float32 state."""
    rep = xh.shape[2] // Bm.shape[2]
    bqh = Bm[:, 0].repeat_interleave(rep, dim=1)          # (B, H, N)
    cqh = Cm[:, 0].repeat_interleave(rep, dim=1)
    dA = torch.exp(dt[:, 0] * A)                          # (B, H)
    state = state.float() * dA[:, :, None, None] \
        + (dt[:, 0, :, None] * xh[:, 0])[..., None] * bqh[:, :, None, :]
    return torch.einsum('bhn,bhpn->bhp', cqh, state)[:, None], state


def _scan_on_heads(xh, dt, A, Bm, Cm, chunk: int, cache, S: int):
    """The SSD scan (or, for a one-token step on a cache, the recurrence)
    on a mesh whose 'model' axis divides the heads: each rank runs it on
    its batch rows and its own heads, with the groups those heads read
    (head h reads group ``h // (H // G)``), the reference's layout.
    ``xh`` and ``dt`` hold their heads on 'model', ``A`` its heads, the
    state (B, H, P, N) its heads on 'model' (dim 1, as ``cache_pspecs``
    lays the cache); ``Bm`` and ``Cm`` (B, S, G, N) are replicated over
    'model'.  Returns y (B, S, H, P), laid out as ``xh``, and the state."""
    from torch.distributed.tensor import Shard
    H, G = xh.shape[2], Bm.shape[2]
    rep = H // G
    xh = SH.shard_hint(xh, 'dp', None, 'model', None)
    dt = SH.shard_hint(dt, 'dp', None, 'model')
    A = SH.shard_hint(A, 'model')
    Bm, Cm = SH.shard_hint(Bm, 'dp'), SH.shard_hint(Cm, 'dp')
    h0, hl = SH.row_shard(xh, 2)
    if hl % rep == 0 or rep % hl == 0:     # the rank's heads fill groups
        groups = slice(h0 // rep, (h0 + hl - 1) // rep + 1)
    else:                                  # one group row per head
        groups = torch.arange(h0, h0 + hl, device=Bm.device) // rep
    y_pl = list(xh.placements)
    st_pl = [Shard(1) if pl.is_shard(2) else pl for pl in y_pl]
    outs = (y_pl, st_pl)
    if cache is None:
        return SH.on_shards(
            lambda x, d, a, b, c: _ssd_chunked(x, d, a, b[:, :, groups],
                                               c[:, :, groups], chunk),
            2, xh, dt, A, Bm, Cm, out_placements=outs)
    st = cache['state']
    st = st.redistribute(st.device_mesh, st_pl) if SH.is_dtensor(st) \
        else SH.distribute(st, xh.device_mesh, st_pl)
    if S == 1:
        fn = lambda x, d, a, b, c, s: _recurrence(       # noqa: E731
            x, d, a, b[:, :, groups], c[:, :, groups], s)
    else:
        fn = lambda x, d, a, b, c, s: _ssd_chunked(      # noqa: E731
            x, d, a, b[:, :, groups], c[:, :, groups], chunk, s)
    return SH.on_shards(fn, 2, xh, dt, A, Bm, Cm, st, out_placements=outs)


def mamba(p: Mamba, cfg: ArchConfig, x: torch.Tensor, *,
          cache: Optional[Dict[str, torch.Tensor]] = None,
          quant: bool = False
          ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, S, d) -> (out, cache).  ``cache`` = {'conv': (B, K-1,
    conv_dim), 'state': (B, H, P, N)}: a decode step (S == 1) runs the
    recurrence, a longer input the chunked SSD from the cached state.  The
    cache is updated in place and comes back as the new cache."""
    s, d_inner, H = _dims(cfg)
    B, S, _ = x.shape
    G, N, P = s.n_groups, s.d_state, s.headdim
    pol = 'w8a8' if quant else None
    tp = 'model' if cfg.model_axis_tp else None
    x = SH.shard_hint(x, 'dp', None, None)
    z = SH.shard_hint(p.in_z(x, pol), 'dp', None, tp)
    xBC = SH.shard_hint(p.in_xbc(x, pol), 'dp', None, tp)
    dt = p.in_dt(x, pol)
    xBC, new_conv = _causal_conv(xBC, p.conv_w.to(xBC.dtype),
                                 p.conv_b.to(xBC.dtype),
                                 None if cache is None else cache['conv'])
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xh = SH.split_dim(xs, -1, (H, P))
    # on a mesh whose 'model' axis divides the heads, each rank scans its
    # own heads
    on_heads = SH.is_dtensor(xh) and tp == 'model' and \
        H % SH.axis_sizes(xh.device_mesh).get('model', 1) == 0
    if on_heads:
        xh = SH.shard_hint(xh, 'dp', None, 'model', None)
    xh = xh.float()
    Bm = SH.split_dim(Bm, -1, (G, N)).float()
    Cm = SH.split_dim(Cm, -1, (G, N)).float()
    dt = F.softplus(dt.float() + p.dt_bias)               # (B, S, H)
    A = -torch.exp(p.A_log)

    if on_heads:
        y, state = _scan_on_heads(xh, dt, A, Bm, Cm, s.chunk, cache, S)
    elif cache is not None and S == 1:                    # the recurrence
        # on a mesh per rank on its batch rows, the heads whole
        # (``on_shards``), as the chunked scan below: DTensor's einsum
        # fails on the heads split out of the sharded channels
        xh, dt, Bm, Cm, st = (SH.shard_hint(t, 'dp') for t in
                              (xh, dt, Bm, Cm, cache['state']))
        y, state = SH.on_shards(_recurrence, 2, xh, dt, SH.replicate(A),
                                Bm, Cm, st)
    elif SH.is_dtensor(xh):               # a mesh: no cache (training)
        # the chunked scan per rank on its batch rows (``on_shards``):
        # DTensor's einsum rules cannot follow its reshapes; the heads are
        # whole on every rank, the constants gathered
        xh, dt, Bm, Cm = (SH.shard_hint(t, 'dp') for t in (xh, dt, Bm, Cm))
        y, state = SH.on_shards(
            lambda a, b, c, d, e: _ssd_chunked(a, b, c, d, e, s.chunk), 2,
            xh, dt, SH.replicate(A), Bm, Cm)
    else:
        y, state = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk,
                                None if cache is None else cache['state'])
    y = (y + xh * p.D[:, None]).reshape(B, S, d_inner).to(x.dtype)
    out = p.out_proj(L.rmsnorm(p.norm, y * L.swish(z)), pol)
    if cache is not None:
        if new_conv is not None:
            cache['conv'].copy_(new_conv)
        cache['state'].copy_(state)
    return out, cache


def init_mamba_cache(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    s, d_inner, H = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {'conv': torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device),
            'state': torch.zeros((batch, H, s.headdim, s.d_state),
                                 dtype=dtype, device=device)}
