"""whisper-base [arXiv:2212.04356; unverified].  6L enc + 6L dec,
d_model=512 8H d_ff=2048 vocab=51865 (padded 51968); conv/audio frontend is
a STUB per the assignment (input_specs provides frame embeddings)."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import pad_vocab

CONFIG = ArchConfig(
    name='whisper-base',
    family='encdec',
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=pad_vocab(51865, 256),       # 51865 -> 51968
    act='gelu',
    norm='layernorm',
    rope='none',
    attn_bias=True,
    mlp_bias=True,
    frontend='audio_stub',
    kv_repeat=1,
)
REAL_VOCAB = 51865
