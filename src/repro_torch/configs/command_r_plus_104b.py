"""command-r-plus-104b [dense] - GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128, rope_theta=75e4,
    param_dtype="bfloat16", optimizer="adafactor",
)
