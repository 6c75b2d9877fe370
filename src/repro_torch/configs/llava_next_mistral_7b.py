"""llava-next-mistral-7b [vlm] - anyres tiling; patch frontend is a stub
(input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128, rope_theta=1e6,
    input_mode="tokens+patches", num_patch_tokens=576,
)
