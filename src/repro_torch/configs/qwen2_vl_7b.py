"""qwen2-vl-7b [arXiv:2409.12191].  28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064, M-RoPE (sections 16/24/24); vision frontend is a
STUB (input_specs provides patch embeddings)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='qwen2-vl-7b',
    family='vlm',
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    act='swish',
    norm='rmsnorm',
    rope='mrope',
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    attn_bias=True,
    frontend='vision_stub',
    kv_repeat=1,     # 28 q-heads: kv shards 4-way
)
REAL_VOCAB = 152064
