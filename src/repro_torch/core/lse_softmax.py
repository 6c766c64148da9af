"""Log-sum-exp softmax decomposition (paper Eq. 4) and its streaming form,
port of ``repro/core/lse_softmax.py``.

The streaming form keeps (m, l, acc) = (running max, running sum of
exp, unnormalised value accumulator) over blocks of scores: the
online-softmax recurrence of flash attention, and the paper's
comparator + LUT pipeline.  ``streaming_attention_ref`` is the plain
version the flash kernel is held against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def lse_softmax(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax via the paper's four-op decomposition: running max,
    log of the shifted exp-sum, subtract, exponentiate."""
    gamma_max = scores.amax(dim=dim, keepdim=True)                  # op 1
    shifted = scores - gamma_max
    ln_sum = torch.log(torch.exp(shifted).sum(dim=dim, keepdim=True))  # op 2
    return torch.exp(shifted - ln_sum)                               # ops 3+4


class StreamState(NamedTuple):
    """Running (gamma_max, sum-of-exp, unnormalised accumulator)."""
    m: torch.Tensor    # (..., 1) running max
    l: torch.Tensor    # (..., 1) running sum of exp(score - m)
    acc: torch.Tensor  # (..., d_v) running weighted-value accumulator


def stream_init(batch_shape: Tuple[int, ...], d_v: int,
                dtype: torch.dtype = torch.float32,
                device=None) -> StreamState:
    shape = tuple(batch_shape)
    return StreamState(
        m=torch.full(shape + (1,), NEG_INF, dtype=dtype, device=device),
        l=torch.zeros(shape + (1,), dtype=dtype, device=device),
        acc=torch.zeros(shape + (d_v,), dtype=dtype, device=device))


def stream_update(state: StreamState, scores_blk: torch.Tensor,
                  values_blk: torch.Tensor) -> StreamState:
    """Fold in a block of scores (..., B) and the matching value rows
    (..., B, d_v); value rows broadcast over any extra leading query dims
    of the scores."""
    m_blk = scores_blk.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(state.m, m_blk)                            # op 1
    correction = torch.exp(state.m - m_new)
    p = torch.exp(scores_blk - m_new)                                # op 4
    l_new = state.l * correction + p.sum(dim=-1, keepdim=True)
    v = values_blk.to(p.dtype)
    if p.ndim == v.ndim:        # p (..., S, B) x v (..., B, d)
        pv = p @ v
    else:                       # p (..., B)    x v (..., B, d)
        pv = torch.einsum('...b,...bd->...d', p, v)
    return StreamState(m_new, l_new, state.acc * correction + pv)


def stream_finalize(state: StreamState) -> torch.Tensor:
    """ops 2+3: divide by exp(ln_sum) = l."""
    return state.acc / torch.clamp_min(state.l, 1e-30)


def streaming_attention_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, block: int = 128,
                            causal: bool = False,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Streaming attention over K/V blocks of ``block`` rows, float32
    arithmetic, output in q's type.  q (..., S, d), k/v (..., T, d); the
    causal mask is ``k_pos <= q_pos`` with both counted from 0, and
    padded key rows score ``NEG_INF``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    S, T = q.shape[-2], k.shape[-2]
    pad = (-T) % block
    kp = F.pad(k, (0, 0, 0, pad)) if pad else k
    vp = F.pad(v, (0, 0, 0, pad)) if pad else v
    q32 = q.float() * scale
    state = stream_init(q.shape[:-1], v.shape[-1], device=q.device)
    kv_pos = torch.arange(block, device=q.device)
    q_pos = torch.arange(S, device=q.device)
    for i in range(kp.shape[-2] // block):
        kb = kp[..., i * block:(i + 1) * block, :].float()
        vb = vp[..., i * block:(i + 1) * block, :]
        s = q32 @ kb.transpose(-1, -2)
        col = i * block + kv_pos
        mask = col[None, :] < T
        if causal:
            mask = mask & (col[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, NEG_INF)
        state = stream_update(state, s, vb)
    return stream_finalize(state).to(q.dtype)
