"""Architecture / run configuration schema.

One ``ArchConfig`` describes a full model; ``ShapeConfig`` describes one
assigned input-shape cell.  Configs are plain frozen dataclasses so they hash
(static args under jit) and serialize.  Copy of ``repro/configs/base.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25
    router_normalize: bool = True   # renormalize top-k probs
    every: int = 1              # MoE FFN every `every` layers (else dense)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 8
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    act: str = 'swish'
    norm: str = 'rmsnorm'                   # rmsnorm | layernorm
    rope: str = 'rope'                      # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    tie_embeddings: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): layer kinds within one scanned super-block.
    # 'A' = attention, 'M' = mamba; ffn kinds: 'D' dense, 'E' moe.
    hybrid_block: Tuple[str, ...] = ()
    hybrid_ffn: Tuple[str, ...] = ()
    n_enc_layers: int = 0                   # encdec only
    frontend: str = 'none'                  # none | audio_stub | vision_stub
    max_seq_len: int = 1 << 20
    # distribution hints
    # model_axis_tp=False: keep the 'model' mesh axis for EXPERT parallelism
    # only — attention / dense-MLP weights shard over 'data' (FSDP) and
    # activations are never tensor-parallel.  Wins for small-d_model MoE
    # archs where TP all-reduces dwarf the tiny per-shard matmuls (§Perf).
    model_axis_tp: bool = True
    kv_repeat: int = 1                      # replicate KV heads for even TP
    moe_groups: int = 32                    # dispatch groups (>= data shards)
    remat: str = 'full'                     # full | dots | none
    # unrolled layer loop (no lax.scan while-loop): used by the dry-run cost
    # probes because XLA cost analysis counts a while body once, ignoring
    # trip count; production path keeps scan for O(1) HLO size.
    unroll_layers: bool = False
    # quantization (paper C1): serve path W8A8
    w8a8_serve: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def full_attention(self) -> bool:
        """True if *all* sequence mixing is quadratic attention (these archs
        skip the long_500k cell)."""
        return self.family in ('dense', 'moe', 'encdec', 'vlm') and \
            self.ssm is None

    def scaled(self, **kw) -> 'ArchConfig':
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == 'decode'


SHAPES = {
    'train_4k': ShapeConfig('train_4k', 4096, 256, 'train'),
    'prefill_32k': ShapeConfig('prefill_32k', 32768, 32, 'prefill'),
    'decode_32k': ShapeConfig('decode_32k', 32768, 128, 'decode'),
    'long_500k': ShapeConfig('long_500k', 524288, 1, 'decode'),
}


def shape_cells(arch: ArchConfig):
    """The live (shape) cells for an arch (full-attention archs skip
    long_500k — see DESIGN.md §4)."""
    names = ['train_4k', 'prefill_32k', 'decode_32k']
    if not arch.full_attention:
        names.append('long_500k')
    return [SHAPES[n] for n in names]
