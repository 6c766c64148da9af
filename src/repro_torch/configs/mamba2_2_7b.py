"""mamba2-2.7b [arXiv:2405.21060; unverified].  64L d_model=2560,
attention-free SSD, d_state=128, headdim=64 (-> 80 heads), expand=2,
n_groups=1 (HF state-spaces/mamba2-2.7b), vocab=50280 (padded 50432)."""
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models.layers import pad_vocab

CONFIG = ArchConfig(
    name='mamba2-2.7b',
    family='ssm',
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=pad_vocab(50280, 256),       # 50280 -> 50432
    norm='rmsnorm',
    rope='none',
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1,
                  d_conv=4, chunk=256),
    tie_embeddings=True,
)
REAL_VOCAB = 50280
