"""deepseek-v2-lite-16b [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora=512 (qk nope 128 / rope 64 / v 128),
MoE 64 routed experts top-6 + 2 shared, d_ff=1408 per expert,
vocab=102400.  (The assignment brief lists both "64e" and "160 routed";
DeepSeek-V2-**Lite** has 64 routed experts — we follow the primary spec.
The real model's first dense layer is folded into the uniform MoE stack for
scan-ability; noted in DESIGN.md.)
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name='deepseek-v2-lite-16b',
    family='moe',
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    act='swish',
    norm='rmsnorm',
    rope='rope',
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
)
REAL_VOCAB = 102400
