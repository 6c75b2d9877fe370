"""Architecture registry: --arch <id> resolves here (``get_arch``).

``ARCHS`` is the JAX package's registry, name for name. ``PORT_ARCHS``
holds the architectures only the port runs (their configs subclass
``ArchConfig`` with fields the JAX package does not have); no name is in
both."""
from . import (
    qwen3_4b, codeqwen1_5_7b, llama3_2_3b, command_r_plus_104b,
    kimi_k2_1t_a32b, deepseek_moe_16b, seamless_m4t_medium,
    mamba2_2_7b, jamba_1_5_large_398b, llava_next_mistral_7b,
    deepseek_v2_lite,
)
from .base import (  # noqa: F401  (re-exported registry surface)
    ArchConfig, ShapeConfig, SHAPES, SMOKE_SHAPES, shape_applicable,
)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    qwen3_4b, codeqwen1_5_7b, llama3_2_3b, command_r_plus_104b,
    kimi_k2_1t_a32b, deepseek_moe_16b, seamless_m4t_medium,
    mamba2_2_7b, jamba_1_5_large_398b, llava_next_mistral_7b,
)}

PORT_ARCHS = {m.CONFIG.name: m.CONFIG for m in (deepseek_v2_lite,)}


def get_arch(name: str) -> ArchConfig:
    """The config named ``name``, from ``ARCHS`` or ``PORT_ARCHS``."""
    if name in ARCHS:
        return ARCHS[name]
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    raise KeyError(f"unknown architecture {name!r}; known: "
                   f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32 if cfg.head_dim else 0,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        param_dtype="float32",
        optimizer="adamw",
    )
    if cfg.family == "hybrid":
        kw["num_layers"] = cfg.attn_period  # one full period
    if cfg.num_experts:
        kw.update(num_experts=8, top_k=min(cfg.top_k, 2), d_ff_expert=64,
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.num_patch_tokens:
        kw["num_patch_tokens"] = 8
    if getattr(cfg, "kv_lora_rank", 0):
        # latent attention: every MLA width shrunk with the model's
        kw.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16, head_dim=16, num_kv_heads=4)
    return cfg.with_(**kw)
