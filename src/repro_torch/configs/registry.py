"""Architecture registry: ``--arch <id>`` resolution + smoke-scale
reduction for CPU tests.  Copy of ``repro/configs/registry.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs import (deepseek_v2_lite_16b,
                                 granite_moe_1b_a400m, internlm2_1_8b,
                                 jamba_1_5_large_398b, mamba2_2_7b,
                                 mistral_large_123b, qwen2_vl_7b,
                                 starcoder2_7b, whisper_base, yi_34b)
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      SSMConfig)

_MODULES = {
    'granite-moe-1b-a400m': granite_moe_1b_a400m,
    'deepseek-v2-lite-16b': deepseek_v2_lite_16b,
    'starcoder2-7b': starcoder2_7b,
    'internlm2-1.8b': internlm2_1_8b,
    'mistral-large-123b': mistral_large_123b,
    'yi-34b': yi_34b,
    'mamba2-2.7b': mamba2_2_7b,
    'whisper-base': whisper_base,
    'jamba-1.5-large-398b': jamba_1_5_large_398b,
    'qwen2-vl-7b': qwen2_vl_7b,
}

ARCHS: Dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
REAL_VOCABS: Dict[str, int] = {k: m.REAL_VOCAB for k, m in _MODULES.items()}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f'unknown arch {name!r}; known: {sorted(ARCHS)}')
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: small widths, few layers/experts, tiny
    vocab — runs a forward/train step on CPU in seconds."""
    cfg = get(name)
    kw = dict(
        name=cfg.name + '-smoke',
        n_layers=max(2, len(cfg.hybrid_block) or 2),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=211,
        kv_repeat=1,
        moe_groups=2,
        remat='none',
        max_seq_len=256,
    )
    if cfg.moe is not None:
        kw['moe'] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=32, n_shared=cfg.moe.n_shared)
    if cfg.mla is not None:
        kw['mla'] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm is not None:
        kw['ssm'] = SSMConfig(d_state=16, headdim=8, expand=2,
                              n_groups=1 if cfg.ssm.n_groups == 1 else 2,
                              d_conv=4, chunk=16)
    if cfg.family == 'encdec':
        kw['n_enc_layers'] = 2
    if cfg.family == 'hybrid':
        kw['n_layers'] = len(cfg.hybrid_block)   # one super-block
    if cfg.rope == 'mrope':
        kw['mrope_sections'] = (2, 3, 3)
    return dataclasses.replace(cfg, **kw)
