"""starcoder2-7b [arXiv:2402.19173].  32L d_model=4608 36H (GQA kv=4)
d_ff=18432 vocab=49152, GQA + RoPE, gelu, layernorm, biases."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='starcoder2-7b',
    family='dense',
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    act='gelu',
    norm='layernorm',
    rope='rope',
    rope_theta=1e5,
    attn_bias=True,
    mlp_bias=True,
    kv_repeat=1,     # 36 q-heads: no even kv replication; cache heads
                     # shard 4-way (DESIGN.md §4)
)
REAL_VOCAB = 49152
