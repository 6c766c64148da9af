"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155 (padded to 49408 for 16-way TP),
MoE 32 experts top-8, d_ff=512 per expert.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import pad_vocab

CONFIG = ArchConfig(
    name='granite-moe-1b-a400m',
    family='moe',
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=pad_vocab(49155, 256),      # 49155 -> 49408
    act='swish',
    norm='rmsnorm',
    rope='rope',
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    kv_repeat=2,                       # kv 8 -> 16 for even 16-way TP
    tie_embeddings=True,
)
REAL_VOCAB = 49155
