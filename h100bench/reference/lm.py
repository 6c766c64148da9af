"""Plain reference of the language-model cells: a dense decoder-only LM
as InternLM2 describes it (arXiv:2403.17297), over a dict of weights
laid out as the benchmark's weight file (``param_spec``).

Per layer: RMSNorm (eps as the configuration states), grouped-query
attention (``wq``/``wo`` on the W8A8 rule when quantized, ``wk``/``wv``
float32, rotary embedding in the half-split convention at
``rope_theta``, query head j reading KV head j // (H / G), causal
softmax in float32), a residual add; RMSNorm, the gated MLP
``down(swish(gate(x)) * up(x))`` (all three on the W8A8 rule when
quantized), a residual add.  Then RMSNorm and the float32 LM head.
No cache: every position is computed from the whole prefix.

Imports torch only: no kernel, cache or step of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .numerics import Numerics

P = Dict[str, torch.Tensor]
SMALL = 0.1
EMBED_BOUND = 0.02 * math.sqrt(3.0)     # uniform with stddev 0.02


def param_spec(c: dict) -> list:
    d, H, G = c['hidden_size'], c['num_attention_heads'], \
        c['num_key_value_heads']
    hd, ff, V = d // H, c['intermediate_size'], c['vocab_size']
    spec = [('embed.table', (V, d), EMBED_BOUND, 0.0)]
    for i in range(c['num_hidden_layers']):
        b = f'blocks.{i}.sub0'
        spec += [(f'{b}.mix_norm.scale', (d,), SMALL, 1.0),
                 (f'{b}.attn.wq.w', (d, H * hd), d ** -0.5, 0.0),
                 (f'{b}.attn.wk.w', (d, G * hd), d ** -0.5, 0.0),
                 (f'{b}.attn.wv.w', (d, G * hd), d ** -0.5, 0.0),
                 (f'{b}.attn.wo.w', (H * hd, d), (H * hd) ** -0.5, 0.0),
                 (f'{b}.ffn_norm.scale', (d,), SMALL, 1.0),
                 (f'{b}.mlp.up.w', (d, ff), d ** -0.5, 0.0),
                 (f'{b}.mlp.down.w', (ff, d), ff ** -0.5, 0.0),
                 (f'{b}.mlp.gate.w', (d, ff), d ** -0.5, 0.0)]
    spec += [('final_norm.scale', (d,), SMALL, 1.0),
             ('lm_head.w', (d, V), EMBED_BOUND, 0.0)]
    return spec


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (B, S, H, hd) at positions 0 .. S-1."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(num: Numerics, q, k, v):
    """Causal attention, q (B, S, H, hd), k/v (B, S, H, hd), float32."""
    B, S, H, hd = q.shape
    s = num.einsum('bshd,bthd->bhst', q * hd ** -0.5, k)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    a = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return num.einsum('bhst,bthd->bshd', a, v)


def _layer(num: Numerics, p: P, c: dict, i: int, x, quant: bool,
           kv: Optional[list] = None):
    d, H, G = c['hidden_size'], c['num_attention_heads'], \
        c['num_key_value_heads']
    hd, eps = d // H, c['rms_norm_eps']
    B, S, _ = x.shape
    b = f'blocks.{i}.sub0'
    h = rmsnorm(x, p[f'{b}.mix_norm.scale'], eps)
    q = num.linear(h, p[f'{b}.attn.wq.w'], quant=quant).reshape(B, S, H, hd)
    k = num.linear(h, p[f'{b}.attn.wk.w']).reshape(B, S, G, hd)
    v = num.linear(h, p[f'{b}.attn.wv.w']).reshape(B, S, G, hd)
    q, k = rope(q, c['rope_theta']), rope(k, c['rope_theta'])
    if kv is not None:
        kv.append((k, v))
    k = k.repeat_interleave(H // G, dim=2)
    v = v.repeat_interleave(H // G, dim=2)
    o = attention(num, q, k, v).reshape(B, S, H * hd)
    x = x + num.linear(o, p[f'{b}.attn.wo.w'], quant=quant)
    h = rmsnorm(x, p[f'{b}.ffn_norm.scale'], eps)
    gate = num.linear(h, p[f'{b}.mlp.gate.w'], quant=quant)
    up = num.linear(h, p[f'{b}.mlp.up.w'], quant=quant)
    return x + num.linear(gate * torch.sigmoid(gate) * up,
                          p[f'{b}.mlp.down.w'], quant=quant)


def forward(num: Numerics, p: P, c: dict, tokens: torch.Tensor,
            quant: bool = False, last: Optional[int] = None,
            remat: bool = False, kv: Optional[list] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab), float32; with ``last``, of
    the last ``last`` positions only.  ``remat``: each layer's
    activations are recomputed in the backward pass (plain
    ``torch.utils.checkpoint``), so a gradient at long sequences fits.
    ``kv``: a list that receives each layer's keys (rotated) and values,
    (B, S, kv heads, hd) each, as a cache holds them."""
    S = tokens.shape[1]
    x = p['embed.table'][tokens]
    for i in range(c['num_hidden_layers']):
        if remat:
            x = checkpoint(_layer, num, p, c, i, x, quant,
                           use_reentrant=False)
        else:
            x = _layer(num, p, c, i, x, quant, kv)
    if last is not None:
        x = x[:, S - last:]
    x = rmsnorm(x, p['final_norm.scale'], c['rms_norm_eps'])
    return num.mm(x, p['lm_head.w'])


@torch.no_grad()
def logits(num: Numerics, p: P, c: dict, tokens: torch.Tensor,
           quant: bool, last: Optional[int] = None,
           kv: Optional[list] = None) -> torch.Tensor:
    return forward(num, p, c, tokens, quant, last, kv=kv)

