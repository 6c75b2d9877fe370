"""jamba-1.5-large-398b [hybrid] - Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    num_experts=16, top_k=2, d_ff_expert=24576,
    ssm_state=128, ssm_headdim=128, attn_period=8, subquadratic=True,
    param_dtype="bfloat16", optimizer="adafactor",
)
