"""internlm2-1.8b [arXiv:2403.17297].  24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92544."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='internlm2-1.8b',
    family='dense',
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    act='swish',
    norm='rmsnorm',
    rope='rope',
    kv_repeat=2,
)
REAL_VOCAB = 92544
