"""Attention MatMul decomposition (paper Eq. 6) and scale folding, port of
``repro/core/attention_decomp.py``.

DiffLight computes  Q.K^T = Q.(X.W_K)^T = (Q.W_K^T).X^T  so the photonic
banks never materialise K, and folds the 1/sqrt(d_k) scaling into the
weight matrix so no separate scaling pass is needed.  On a GPU the same
rewrite is a choice of order:

  standard:   K = X W_K        (T x d x d_k MACs), then Q K^T (S x T x d_k)
  reordered:  Q' = Q W_K^T     (S x d_k x d MACs), then Q' X^T (S x T x d)

The reordering wins when S*d_k*d + S*T*d < T*d*d_k + S*T*d_k, roughly
when S << T and d_k < d (cross-attention, decode with short queries).
Both paths and a chooser by operation count are here.  No model of
either package calls them; the paper's Eq. 6 is reproduced for its own
sake.
"""
from __future__ import annotations

from typing import Tuple

import torch


def fold_scale_into_wq(w_q: torch.Tensor, d_k: int) -> torch.Tensor:
    """Fold 1/sqrt(d_k) into the query projection (always free)."""
    return w_q * (d_k ** -0.5)


def scores_standard(q: torch.Tensor, x_kv: torch.Tensor,
                    w_k: torch.Tensor) -> torch.Tensor:
    """q (..., S, d_k) already projected and scaled; x_kv (..., T, d);
    w_k (d, d_k) -> scores (..., S, T)."""
    k = torch.einsum('...td,dk->...tk', x_kv, w_k)
    return torch.einsum('...sk,...tk->...st', q, k)


def scores_reordered(q: torch.Tensor, x_kv: torch.Tensor,
                     w_k: torch.Tensor) -> torch.Tensor:
    """Eq. 6: (Q W_K^T) X^T; K is never materialised."""
    q_prime = torch.einsum('...sk,dk->...sd', q, w_k)
    return torch.einsum('...sd,...td->...st', q_prime, x_kv)


def decomp_flops(S: int, T: int, d: int, d_k: int) -> Tuple[int, int]:
    """MACs of (standard, reordered)."""
    standard = T * d * d_k + S * T * d_k
    reordered = S * d_k * d + S * T * d
    return standard, reordered


def scores_auto(q: torch.Tensor, x_kv: torch.Tensor,
                w_k: torch.Tensor) -> torch.Tensor:
    """The cheaper path by operation count, chosen from the shapes."""
    S, d_k = q.shape[-2], q.shape[-1]
    T, d = x_kv.shape[-2], x_kv.shape[-1]
    std, reo = decomp_flops(S, T, d, d_k)
    return scores_reordered(q, x_kv, w_k) if reo < std else \
        scores_standard(q, x_kv, w_k)
