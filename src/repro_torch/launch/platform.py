"""Backend selection. Port of ``repro.launch.platform``.

``set_platform`` pins what ``core.device.resolve_device(None)`` returns,
so every entry point called without ``device=`` (and
``launch.mesh.make_batch_mesh``) runs there. "gpu" is the default and
raises without CUDA; "cpu" runs the kernels' plain versions; "tpu" is
not a backend of the port.

The reference's ``gpu_flags()`` is XLA's flag string; torch has no such
flags, so it has no counterpart here and none is invented.
"""
from __future__ import annotations

from ..core import device as _device

_PLATFORMS = ("cpu", "gpu")


def set_platform(platform: str = "gpu") -> None:
    """Pin the default device: ``"gpu"`` (CUDA, raising without it) or
    ``"cpu"``."""
    if platform not in _PLATFORMS:
        raise ValueError(
            f"unknown platform {platform!r}; the port runs on one of "
            f"{_PLATFORMS} (it has no TPU backend)")
    if platform == "gpu":
        _device.resolve_device("cuda")
    _device.pin_default_device("cpu" if platform == "cpu" else "cuda")
