"""Hand-written CUDA kernels (``csrc/*.cu``), their plain PyTorch versions,
and the wrappers that choose between them by the tensors' device."""
