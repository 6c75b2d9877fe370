"""PyTorch + CUDA port of the push-relabel additive-approximation OT solver.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``)
and keeps its names. Every entry point runs on the CUDA device unless the
caller passes ``device="cpu"``; on the card the hot steps launch the
hand-written kernels in ``csrc/``, on the CPU the same wrappers run their
plain PyTorch versions.
"""
