"""seamless-m4t-medium [audio] - enc-dec; modality frontend is a stub
(input_specs provides precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    encoder_layers=12, input_mode="frames",
)
