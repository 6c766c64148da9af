"""Operations and bytes of the work a window ran, counted from shapes.

``Work`` sums, per kernel family, the least time the card needs for each
call (``peaks.least_s``: operations over the peak of their precision or
bytes over the memory rate, the larger, each input byte read once and
each output byte written once), and per precision the operations of the
model's products (``model_ops``), which an ``mfu`` metric sets against
the window's wall.  The counters below walk a configuration's shapes:

* ``sd_unet_eval``: one UNet evaluation of B rows (a full pass, or a
  DeepCache skip pass): the GroupNorm+swish kernel's calls (the ResBlocks'
  and the output's; the attention blocks' GroupNorm is plain), the W8A8
  products of a quantized evaluation (the attention projections), and the
  model's products: convolutions (a stride-2 4x4 transposed conv counts
  the 4 taps each output pixel takes from real input), attention scores
  and mixes, and the projections and time-embedding linears;
* ``lm_prefill`` and ``lm_decode``: a dense LM's prefill of B prompts of
  S tokens (flash over the causal prefix, the head on the last row) and
  one decode step at cache length ``pos + 1``;
* ``lm_train_step``: a dense LM's training step: the forward and the
  backward (twice the forward's products); remat's second forward is
  left out, so the share is of model work, not of the products run.
"""
from __future__ import annotations

import collections
from typing import Dict

from .peaks import least_s


class Work:
    def __init__(self):
        self.least: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)
        self.model_ops: Dict[str, float] = collections.defaultdict(float)

    def kernel(self, family: str, ops: float, nbytes: float,
               precision: str) -> None:
        self.least[family] += least_s(ops, nbytes, precision)
        self.calls[family] += 1

    def product(self, precision: str, ops: float) -> None:
        self.model_ops[precision] += ops

    def w8a8(self, M: int, K: int, N: int) -> None:
        """An int8 product with its scales, float32 out."""
        self.kernel('w8a8', 2.0 * M * K * N,
                    M * K + K * N + 4 * M + 4 * N + 4 * M * N, 'int8')
        self.product('int8', 2.0 * M * K * N)

    def linear(self, M: int, K: int, N: int, quant: bool) -> None:
        if quant:
            self.w8a8(M, K, N)
        else:
            self.product('fp32', 2.0 * M * K * N)

    def add(self, other: 'Work', times: int = 1) -> None:
        for k, v in other.least.items():
            self.least[k] += v * times
        for k, v in other.calls.items():
            self.calls[k] += v * times
        for k, v in other.model_ops.items():
            self.model_ops[k] += v * times


# ---------------------------------------------------------------------------
# the diffusion UNet
# ---------------------------------------------------------------------------

def _attn_at(c: dict, lvl: int) -> bool:
    return (c['img_size'] >> lvl) in c['attn_resolutions']


def sd_unet_eval(c: dict, B: int, context_tokens: int, quant: bool,
                 full: bool = True) -> Work:
    """One evaluation of B rows; ``context_tokens`` 0 for the
    unconditional branch (no cross-attention)."""
    w = Work()
    base, mults, nres = c['base_ch'], c['ch_mults'], c['n_res_blocks']
    t_dim, ctx_dim = 4 * base, c.get('context_dim')
    L = len(mults)

    def gn(r, ch):
        n = B * r * r * ch
        w.kernel('gn_swish', 10.0 * n, 8.0 * n + 8.0 * ch, 'fp32')

    def conv(r_out, cin, cout, taps):
        w.product('fp32', 2.0 * B * r_out * r_out * cout * cin * taps)

    def res(r, cin, cout):
        gn(r, cin)
        conv(r, cin, cout, 9)
        w.linear(B, t_dim, cout, False)
        gn(r, cout)
        conv(r, cout, cout, 9)
        if cin != cout:
            conv(r, cin, cout, 1)

    def attn(r, ch):
        S = r * r
        for _ in range(4):                       # wq, wk, wv, wo
            w.linear(B * S, ch, ch, quant)
        w.product('fp32', 4.0 * B * S * S * ch)  # scores and mix
        if ctx_dim is not None and context_tokens:
            T = context_tokens
            w.linear(B * S, ch, ch, quant)       # xq
            w.linear(B * T, ctx_dim, ch, quant)  # xk
            w.linear(B * T, ctx_dim, ch, quant)  # xv
            w.linear(B * S, ch, ch, quant)       # xo
            w.product('fp32', 4.0 * B * S * T * ch)

    w.linear(B, base, t_dim, False)
    w.linear(B, t_dim, t_dim, False)
    img = c['img_size']
    conv(img, c['in_ch'], base, 9)
    chs, ch = [base], base
    for lvl, m in enumerate(mults):
        r = img >> lvl
        for _ in range(nres):
            if lvl == 0 or full:
                res(r, ch, base * m)
                if _attn_at(c, lvl):
                    attn(r, base * m)
            ch = base * m
            chs.append(ch)
        if lvl < L - 1:
            if full:
                conv(r // 2, ch, ch, 9)
            chs.append(ch)
    r = img >> (L - 1)
    if full:
        res(r, ch, ch)
        attn(r, ch)
        res(r, ch, ch)
    for lvl in reversed(range(L)):
        r = img >> lvl
        for _ in range(nres + 1):
            cin = ch + chs.pop()
            if lvl == 0 or full:
                res(r, cin, base * mults[lvl])
                if _attn_at(c, lvl):
                    attn(r, base * mults[lvl])
            ch = base * mults[lvl]
        if lvl > 0 and full:
            conv(2 * r, ch, ch, 4)
    gn(img, ch)
    conv(img, ch, c['in_ch'], 9)
    return w


# ---------------------------------------------------------------------------
# the dense LM
# ---------------------------------------------------------------------------

def _lm_dims(c: dict):
    d, H = c['hidden_size'], c['num_attention_heads']
    G = c['num_key_value_heads']
    return d, H, G, d // H, c['intermediate_size'], c['vocab_size']


def _lm_layers(w: Work, c: dict, M: int, quant: bool) -> None:
    d, H, G, hd, ff, _ = _lm_dims(c)
    for _ in range(c['num_hidden_layers']):
        w.linear(M, d, H * hd, quant)            # wq
        w.linear(M, d, G * hd, False)            # wk
        w.linear(M, d, G * hd, False)            # wv
        w.linear(M, H * hd, d, quant)            # wo
        w.linear(M, d, ff, quant)                # gate
        w.linear(M, d, ff, quant)                # up
        w.linear(M, ff, d, quant)                # down


def lm_prefill(c: dict, B: int, S: int, quant: bool) -> Work:
    w = Work()
    d, H, G, hd, _, V = _lm_dims(c)
    _lm_layers(w, c, B * S, quant)
    kv_heads = G * c.get('kv_repeat', 1)         # heads as the cache holds them
    pairs = S * (S + 1) / 2                      # causal (query, key) pairs
    for _ in range(c['num_hidden_layers']):
        ops = 4.0 * B * H * hd * pairs
        nbytes = 4.0 * B * S * hd * (2 * H + 2 * kv_heads)
        w.kernel('flash', ops, nbytes, 'fp32')
        w.product('fp32', ops)
    w.linear(B, d, V, False)                     # the head, last row only
    return w


def lm_decode(c: dict, B: int, pos: int, quant: bool) -> Work:
    """One decode step writing cache row ``pos``."""
    w = Work()
    d, H, G, hd, _, V = _lm_dims(c)
    _lm_layers(w, c, B, quant)
    for _ in range(c['num_hidden_layers']):
        w.product('fp32', 4.0 * B * H * hd * (pos + 1))
    w.linear(B, d, V, False)
    return w


def lm_train_step(c: dict, B: int, S: int) -> Work:
    """The model's products of one step: the forward and the backward
    (twice the forward's), all float32.  The forward that remat runs
    again is the step's choice, not the model's work, and is left out:
    a step that recomputes less reads no lower."""
    fwd = Work()
    d, H, G, hd, _, V = _lm_dims(c)
    _lm_layers(fwd, c, B * S, False)
    for _ in range(c['num_hidden_layers']):
        fwd.product('fp32', 4.0 * B * H * hd * S * (S + 1) / 2)
    fwd.linear(B * S, d, V, False)
    w = Work()
    w.add(fwd, 3)
    return w
