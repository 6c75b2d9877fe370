"""Solver state across the two packages, as numpy.

The solver has no weights: what crosses between the JAX reference and
the port is the integer solver state. ``state_to_numpy`` gives a dict of
numpy arrays keyed by field name; ``state_from_numpy`` builds the port's
``PushRelabelState`` (keys of the assignment state) or ``OTState`` (keys of
the OT state) on a device. Arrays carry the leading batch axis; a dict of
one unbatched instance (scalar ``phases``) gets a batch axis of 1.

Both also take the per-instance states of a matrix-placement solve (a
list of states or of dicts, one instance each, as ``matrix_stack``
stacks them): the instances are stacked along the batch axis, each
zero-padded to the largest instance's shape as ``matrix_stack`` pads.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .pushrelabel import PushRelabelState
from .transport import OTState

State = Union[PushRelabelState, OTState]


def _is_state(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _stack(dicts: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """One batched dict from per-instance dicts (batched or not), each
    field zero-padded to the largest shape."""
    out = {}
    for k in dicts[0]:
        parts = []
        for d in dicts:
            a = np.asarray(d[k])
            lead = np.ndim(d["phases"]) == 0
            parts.append(a[None] if lead else a)
        shape = np.max([p.shape[1:] for p in parts], axis=0) \
            if parts[0].ndim > 1 else ()
        padded = []
        for p in parts:
            pad = [(0, 0)] + [(0, int(s) - w)
                              for s, w in zip(shape, p.shape[1:])]
            padded.append(np.pad(p, pad))
        out[k] = np.concatenate(padded)
    return out


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A state (or a list of per-instance states) as a dict of numpy
    arrays with the batch axis in front."""
    if _is_state(state):
        return {k: v.cpu().numpy() for k, v in state._asdict().items()}
    return _stack([state_to_numpy(s) for s in state])


def state_from_numpy(d, device=None) -> State:
    """The port's state on ``device`` from a dict of arrays (or a list of
    per-instance dicts)."""
    dev = resolve_device(device)
    if not isinstance(d, dict):
        d = _stack(list(d))
    cls = PushRelabelState if "match_ba" in d else OTState
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__} needs {sorted(missing)}")
    lead = () if np.ndim(d["phases"]) == 1 else (1,)
    # torch.tensor copies: the state never shares the caller's arrays
    return cls(**{
        k: torch.tensor(
            np.asarray(d[k], np.int32).reshape(lead + np.shape(d[k])),
            device=dev)
        for k in cls._fields})
