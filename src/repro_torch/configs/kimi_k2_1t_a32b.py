"""kimi-k2-1t-a32b [moe] - trillion-param MoE, 384 experts top-8.
[arXiv:2501.kimi2; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=18432, vocab_size=163840, head_dim=128,
    num_experts=384, top_k=8, num_shared_experts=1, d_ff_expert=2048,
    first_dense_layers=1, rope_theta=5e4,
    param_dtype="bfloat16", optimizer="adafactor",
)
