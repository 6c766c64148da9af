"""The dense decoder-only LM family (InternLM2: grouped-query attention,
rotary embedding, RMSNorm, the gated MLP): what the LM drivers take from
a family.

* ``arch_config(c)``: the port's ``ArchConfig`` from a configuration;
* ``param_spec(c)``: the weight file's layout (``harness/weights``);
* ``logits(num, p, c, tokens, quant, last, kv)``: the plain reference's
  logits (``reference/lm.py``), with ``kv`` a list that receives each
  layer's cache as ``{name: (B, S, ...)}``;
* ``forward``: the reference's forward for training (``reference/train``);
* ``cache_rows(cache, arch, j, T, layers)``: the port's cache of row
  ``j`` at positions ``0 .. T-1`` in ``layers``, as ``{layer: {name:
  tensor}}`` on the host, with the names and layout of the reference's;
* ``prefill_work``, ``decode_work``, ``train_work``: the operations and
  bytes of a prefill, a decode step and a train step (``roofline/work``).
"""
from __future__ import annotations

from reference import lm as ref
from roofline import work as W

param_spec = ref.param_spec
forward = ref.forward
prefill_work = W.lm_prefill
decode_work = W.lm_decode
train_work = W.lm_train_step


def arch_config(c: dict):
    from repro_torch.configs.base import ArchConfig
    if c.get('rms_norm_eps') != 1e-6:
        raise ValueError('the port\'s RMSNorm takes eps 1e-6')
    return ArchConfig(
        name=c['name'], family='dense', n_layers=c['num_hidden_layers'],
        d_model=c['hidden_size'], n_heads=c['num_attention_heads'],
        n_kv_heads=c['num_key_value_heads'], d_ff=c['intermediate_size'],
        vocab=c['vocab_size'], act='swish', norm='rmsnorm', rope='rope',
        rope_theta=c['rope_theta'], kv_repeat=c['kv_repeat'],
        remat=c.get('remat', 'full'))


def logits(num, p, c: dict, tokens, quant: bool, last=None, kv=None):
    pairs = [] if kv is not None else None
    out = ref.logits(num, p, c, tokens, quant, last=last, kv=pairs)
    if kv is not None:
        kv.extend({'k': k, 'v': v} for k, v in pairs)
    return out


def cache_rows(cache, arch, j: int, T: int, layers) -> dict:
    """Keys and values, one copy of each KV head (the port replicates
    each ``kv_repeat`` times)."""
    rep = arch.kv_repeat
    return {i: {n: cache[i]['sub0'][n][j, :T, ::rep].cpu() for n in 'kv'}
            for i in layers}
