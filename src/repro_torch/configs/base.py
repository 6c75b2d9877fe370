"""Architecture + shape configuration schema (a copy of
``repro.configs.base``: the same fields and defaults)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    router: str = "topk"        # topk | sinkhorn | pushrelabel
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    attn_period: int = 0        # hybrid: 1 attention layer per this many
    # --- encoder-decoder ---
    encoder_layers: int = 0
    # --- modality frontend (stub: precomputed embeddings) ---
    input_mode: str = "tokens"  # tokens | frames | tokens+patches
    num_patch_tokens: int = 0
    # --- numerics / memory ---
    param_dtype: str = "float32"
    optimizer: str = "adamw"    # adamw | adafactor
    remat: bool = True
    # dry-run only: unroll the layer scan so XLA cost analysis counts every
    # layer (a scanned body is costed once); execution configs keep scan.
    scan_unroll: bool = False
    # hillclimb: shard the residual stream's sequence dim over 'tp' between
    # layers (Megatron-style sequence parallelism)
    seq_shard: bool = False
    # hillclimb: decode attention reads the KV cache in bf16 with fp32
    # accumulation (preferred_element_type) instead of materializing fp32
    # copies of the full cache each step
    fast_decode_math: bool = False
    # hillclimb: PaLM-style parallel attention+FFN residual block - the two
    # per-layer tensor-parallel all-reduces merge into one (halves TP
    # collective payload; an architecture variant, off by default)
    parallel_block: bool = False
    # sub-quadratic decode possible (SSM/hybrid) -> long_500k runnable
    subquadratic: bool = False

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 256) * 256

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Per the assignment: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention architecture"
    return True, ""
