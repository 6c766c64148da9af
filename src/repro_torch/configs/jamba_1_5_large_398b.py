"""jamba-1.5-large-398b [arXiv:2403.19887].  72L d_model=8192 64H (GQA kv=8)
d_ff=24576, Mamba+attention 1:7 interleave (attention at position 4 of each
8-layer super-block), MoE 16 experts top-2 on every other FFN."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name='jamba-1.5-large-398b',
    family='hybrid',
    n_layers=72,                # 9 scanned super-blocks of 8
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    act='swish',
    norm='rmsnorm',
    rope='rope',
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=8,
                  d_conv=4, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    hybrid_block=('M', 'M', 'M', 'A', 'M', 'M', 'M', 'M'),
    hybrid_ffn=('D', 'E', 'D', 'E', 'D', 'E', 'D', 'E'),
    kv_repeat=2,
    # >100B deployment defaults (EXPERIMENTS.md §Perf iterations 3/fixes):
    # dots-remat cuts the collective+memory terms ~3.6x vs full remat
    remat='dots',
)
REAL_VOCAB = 65536
