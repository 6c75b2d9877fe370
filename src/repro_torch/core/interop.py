"""Solver state across the two packages, as numpy.

The solver has no weights: what crosses between the JAX reference and
the port is the integer solver state. ``state_to_numpy`` gives a dict of
numpy arrays keyed by field name; ``state_from_numpy`` builds the port's
``PushRelabelState`` (keys of the assignment state) or ``OTState`` (keys of
the OT state) on a device. Arrays carry the leading batch axis; a dict of
one unbatched instance (scalar ``phases``) gets a batch axis of 1.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from .device import resolve_device
from .pushrelabel import PushRelabelState
from .transport import OTState

State = Union[PushRelabelState, OTState]


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(d: Dict[str, np.ndarray], device=None) -> State:
    dev = resolve_device(device)
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
