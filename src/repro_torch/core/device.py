"""Device resolution, input placement and host-sync accounting shared by
the whole port.

Every entry point takes ``device=None``, which means the CUDA device.
There is no silent fallback: asking for CUDA on a machine without it
raises, and only an explicit ``device="cpu"`` runs on the CPU.

``launch.platform.set_platform("cpu")`` pins ``None`` to the CPU instead.

Each device->host read that steers a Python loop goes through
:func:`host_flags` / :func:`host_numpy`, which count it under a kind
("round", "chunk", "sinkhorn", and "debug" for the sanitizer's checks of
``analysis/checked.py``) in ``sync_counts`` so a run can report how often
it waited on the device. The counts are updated under a lock: the
shards of a mesh dispatch run from worker threads of one process.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

sync_counts = {"round": 0, "chunk": 0, "sinkhorn": 0, "debug": 0}
_sync_lock = threading.Lock()
# what device=None means; set_platform("cpu") pins it to "cpu"
_default = "cuda"


def pin_default_device(kind: str) -> None:
    """Make ``resolve_device(None)`` return ``kind`` ("cuda" or "cpu")."""
    global _default
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"default device must be cuda or cpu, got {kind!r}")
    _default = kind


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA (or the CPU once ``set_platform("cpu")`` pinned
    it). Raises when CUDA is asked for but missing."""
    dev = torch.device(_default if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device unless device='cpu' is "
            "passed, and torch.cuda.is_available() is False here")
    return dev


def as_f32(x, device) -> torch.Tensor:
    """Contiguous float32 tensor on ``device`` from a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def reset_sync_counts() -> None:
    with _sync_lock:
        for k in sync_counts:
            sync_counts[k] = 0


def count_sync(kind: str) -> None:
    """Count one device->host read under ``kind``."""
    with _sync_lock:
        sync_counts[kind] = sync_counts.get(kind, 0) + 1


def host_flags(kind: str, *flags: torch.Tensor) -> tuple:
    """One blocking device->host read of one or more () bool tensors,
    counted once; returns them as Python bools."""
    count_sync(kind)
    if len(flags) == 1:
        return (bool(flags[0].item()),)
    return tuple(bool(v) for v in torch.stack(flags).tolist())


def host_numpy(kind: str, t: torch.Tensor) -> np.ndarray:
    """One blocking device->host copy of ``t``, counted."""
    count_sync(kind)
    return t.cpu().numpy()
