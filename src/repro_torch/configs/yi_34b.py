"""yi-34b [arXiv:2403.04652].  60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000, llama-arch."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='yi-34b',
    family='dense',
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    act='swish',
    norm='rmsnorm',
    rope='rope',
    kv_repeat=1,     # 56 q-heads not divisible by 16 kv_eff; kv shards 8-way
)
REAL_VOCAB = 64000
