"""DeepSeek-V2-Lite [moe] - latent attention (MLA), 2 shared + 64 routed
experts, top-6, one leading dense layer. Port-only: the JAX package has
no latent attention, so the config is an ``MLAConfig`` and lives in
``registry.PORT_ARCHS``, not in ``ARCHS``.
[arXiv:2405.04434;
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json]
"""
from dataclasses import dataclass

from .base import ArchConfig


@dataclass(frozen=True)
class MLAConfig(ArchConfig):
    """``ArchConfig`` with multi-head latent attention, YaRN RoPE and the
    MoE gate's normalisation switch (DeepSeek-V2's ``config.json`` names
    in the comments). ``ArchConfig``'s own fields keep their meaning;
    ``head_dim`` is the value width."""
    kv_lora_rank: int = 0          # kv_lora_rank: width of the KV latent c
    qk_nope_head_dim: int = 0      # qk_nope_head_dim
    qk_rope_head_dim: int = 0      # qk_rope_head_dim: the shared rope key
    v_head_dim: int = 0            # v_head_dim
    # rope_scaling (type "yarn")
    rope_factor: float = 1.0       # factor
    rope_orig_len: int = 0         # original_max_position_embeddings
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    # the routed gates are the softmax probabilities at the chosen
    # experts, renormalised over the k only when True
    norm_topk_prob: bool = True

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


CONFIG = MLAConfig(
    name="deepseek-v2-lite", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, head_dim=128,
    rope_theta=1e4, norm_eps=1e-6,
    num_experts=64, top_k=6, num_shared_experts=2, d_ff_expert=1408,
    first_dense_layers=1, router="pushrelabel",
    param_dtype="float32", optimizer="adamw",
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    rope_factor=40.0, rope_orig_len=4096, beta_fast=32.0, beta_slow=1.0,
    mscale=0.707, mscale_all_dim=0.707,
    norm_topk_prob=False,
)
