"""Device resolution, input placement and host-sync accounting shared by
the whole port.

Every entry point takes ``device=None``, which means the CUDA device.
There is no silent fallback: asking for CUDA on a machine without it
raises, and only an explicit ``device="cpu"`` runs on the CPU.

``launch.platform.set_platform("cpu")`` pins ``None`` to the CPU instead.

Every device->host read of the solve path goes through
:func:`host_flags` / :func:`host_numpy`, which count it under a kind
named for its layer in ``sync_counts`` and add the seconds the host was
blocked in it to ``sync_wait_s`` (two clock reads a read), so a run can
report how often and how long it waited on the device: "round" (a
round's stop flag), "chunk" (the driver's converged mask), "sinkhorn",
"debug" (the sanitizer's checks of ``analysis/checked.py``), "prepare"
(OT's masses for the host thresholds, the admission codes), "epilogue"
(the matrix placement's phase counts) and "fetch" (artifacts and
certificates, ``core/solution.py``). The counts are updated under a
lock: the shards of a mesh dispatch run from worker threads of one
process. While the solve path records spans (``obs.tracing``), each
read is also counted on the root span open on its thread.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..obs import tracing as _tracing
from ..obs.metrics import now as _now

# the loop kinds are always present; the others appear at their first read
_LOOP_KINDS = ("round", "chunk", "sinkhorn", "debug")
sync_counts = dict.fromkeys(_LOOP_KINDS, 0)
# host seconds blocked in the reads of each kind
sync_wait_s: dict = {}
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
    """Zero the loop kinds' counts, drop the other kinds (they appear
    again at their next read) and every wait."""
    with _sync_lock:
        sync_counts.clear()
        sync_counts.update(dict.fromkeys(_LOOP_KINDS, 0))
        sync_wait_s.clear()


def count_sync(kind: str, wait_s: float = 0.0) -> None:
    """Count one device->host read under ``kind`` that blocked the host
    ``wait_s`` seconds."""
    with _sync_lock:
        sync_counts[kind] = sync_counts.get(kind, 0) + 1
        sync_wait_s[kind] = sync_wait_s.get(kind, 0.0) + wait_s
    if _tracing.recording():
        _tracing.add("syncs." + kind)
        _tracing.add("sync_wait_s." + kind, wait_s)


def host_flags(kind: str, *flags: torch.Tensor) -> tuple:
    """One blocking device->host read of one or more () bool tensors,
    counted once; returns them as Python bools."""
    t0 = _now()
    if len(flags) == 1:
        out = (bool(flags[0].item()),)
    else:
        out = tuple(bool(v) for v in torch.stack(flags).tolist())
    count_sync(kind, _now() - t0)
    return out


def host_numpy(kind: str, t: torch.Tensor) -> np.ndarray:
    """One blocking device->host copy of ``t``, counted."""
    t0 = _now()
    out = t.cpu().numpy()
    count_sync(kind, _now() - t0)
    return out
