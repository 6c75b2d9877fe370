"""Atomic, CRC-verified checkpoints with async write and retention.

Port of ``repro.checkpoint.checkpointing``, with its layout and
guarantees: ``<dir>/step_<n:010d>/arrays.npz`` plus ``manifest.json``
(shapes, dtypes and a CRC32 over the leaves), written in a ``.tmp_``
directory and renamed into place, so a crash mid-write never leaves a
half checkpoint; ``latest_step`` skips a checkpoint whose CRC fails;
``retain`` keeps the newest N; ``async_=True`` writes on a thread.

The tree is the port's: dicts, lists, tuples and NamedTuples (an
``OptState``) of tensors, ``None`` leaves skipped. The manifest records
each leaf by its path (``"opt/m/embed"``) where the reference records
JAX's treedef string, and ``restore`` refuses a checkpoint whose paths
differ from the tree it restores into. bf16 leaves are stored as their
int16 view (npz has no bf16) and viewed back on restore.

``save`` copies every leaf to the host before it returns, as the
reference's ``jax.device_get`` does: the optimizer updates the tensors
in place, so a writer thread that read them later would save a later
step. Restore makes new tensors on the devices of ``like``'s leaves, or,
given ``shardings`` (a tree of ``models.sharding.NamedSharding`` and
None leaves), places each leaf by its sharding (``sharding.device_put``):
the elastic path, any mesh whose block counts divide the shapes."""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix="") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf, in order; None is skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items for kv in _flatten(v, f"{prefix}/{k}"
                                                    if prefix else str(k))]


def _unflatten(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that nothing else shares, complete when this
    returns."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype_name == "bfloat16":
        return t.view(torch.bfloat16)
    if _dtype_name(t) != dtype_name:
        raise IOError(f"leaf stored as {arr.dtype}, manifest says "
                      f"{dtype_name}")
    return t


def save(directory: str, step: int, tree: Any, *, async_: bool = False,
         retain: int = 3):
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    names = [_dtype_name(t) for _, t in flat]
    host_leaves = [_host(t) for _, t in flat]

    def write():
        os.makedirs(directory, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_")
        try:
            arrays = {f"a{i}": a for i, a in enumerate(host_leaves)}
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            crc = 0
            for a in host_leaves:
                crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
            manifest = {
                "step": step,
                "paths": paths,
                "num_leaves": len(host_leaves),
                "shapes": [list(a.shape) for a in host_leaves],
                "dtypes": names,
                "crc32": crc,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(directory, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        _gc(directory, retain)

    if async_:
        t = threading.Thread(target=write, daemon=False)
        t.start()
        return t
    write()
    return None


def _gc(directory: str, retain: int):
    steps = sorted(
        d for d in os.listdir(directory) if d.startswith("step_")
    )
    for d in steps[:-retain]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in sorted(os.listdir(directory), reverse=True):
        if not d.startswith("step_"):
            continue
        path = os.path.join(directory, d)
        if _verify(path):
            best = int(d.split("_")[1])
            break
    return best


def _verify(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            crc = 0
            for i in range(manifest["num_leaves"]):
                crc = zlib.crc32(
                    np.ascontiguousarray(z[f"a{i}"]).tobytes(), crc
                )
        return crc == manifest["crc32"]
    except Exception:
        # any unreadable file (truncated zip, bad JSON, missing member)
        # is a checkpoint to skip, as in the reference
        return False


def _shardings_up_to(like, shardings) -> list:
    """``shardings`` read along ``like``'s structure: one entry (a
    sharding or None) per tensor leaf of ``like``, in ``_flatten``'s
    order; a None subtree gives None to every leaf under it."""
    if like is None:
        return []
    if isinstance(like, dict):
        items = [(v, None if shardings is None else shardings[k])
                 for k, v in like.items()]
    elif isinstance(like, (list, tuple)):
        items = [(v, None if shardings is None else shardings[i])
                 for i, v in enumerate(like)]
    else:
        return [shardings]
    return [s for v, sh in items for s in _shardings_up_to(v, sh)]


def restore(directory: str, step: int, like: Any, *, shardings: Any = None):
    """Restore into the structure of ``like``: each leaf a new tensor on
    the device of ``like``'s leaf at the same path. With ``shardings`` (a
    matching tree of ``NamedSharding``), a leaf whose sharding is not
    None comes back as a ``ShardedTensor`` of the full logical tensor's
    values: this is the elastic-rescale path."""
    from ..models.sharding import device_put

    path = os.path.join(directory, f"step_{step:010d}")
    if not _verify(path):
        raise IOError(f"checkpoint {path} fails CRC verification")
    flat = _flatten(like)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["paths"] != [p for p, _ in flat]:
        raise ValueError(f"checkpoint {path} holds another tree")
    shs = (_shardings_up_to(like, shardings) if shardings is not None
           else [None] * len(flat))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        out = []
        for i, ((_, t), sh) in enumerate(zip(flat, shs)):
            host = _decode(z[f"a{i}"], manifest["dtypes"][i])
            if sh is None:
                out.append(host.to(t.device))
            else:
                # one copy onto the mesh's first device; its blocks there
                # are views of it
                first = sh.device_at(sh.positions()[0])
                out.append(device_put(host.to(first), sh))
    return _unflatten(like, iter(out))
