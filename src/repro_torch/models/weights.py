"""Model parameters across the two packages, as numpy.

``params_from_reference`` takes the JAX reference's parameter pytree
(nested dicts and lists of arrays; any array ``np.asarray`` accepts)
and builds the port's parameters on a device: the same keys, except that
each stage's arrays, stacked along a leading period axis in the
reference, become a list of per-period dicts (``{"l0": ..., "l1": ...}``
each). ``params_to_reference`` is the inverse, giving numpy arrays (a
bf16 tensor comes back as float32, which holds it exactly).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.device import resolve_device
from .model import leaves, map_params


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 in numpy
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)   # a copy, never shared


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _unstack(stage: Dict[str, Any], device) -> List[Dict[str, Any]]:
    n = np.shape(leaves(stage)[0])[0]
    return [map_params(lambda a, i=i: _tensor(np.asarray(a)[i], device),
                       stage) for i in range(n)]


def _stack(periods: List[Dict[str, Any]]) -> Dict[str, Any]:
    def rec(items):
        if isinstance(items[0], dict):
            return {k: rec([it[k] for it in items]) for k in items[0]}
        return np.stack([_numpy(t) for t in items])
    return rec(periods)


def params_from_reference(tree, device=None) -> Dict[str, Any]:
    """The port's parameters on ``device`` from the reference's tree."""
    dev = resolve_device(device)
    out = {k: _tensor(tree[k], dev) for k in ("embed", "final_norm",
                                             "lm_head")}
    out["stages"] = [_unstack(s, dev) for s in tree["stages"]]
    if "encoder" in tree:
        out["encoder"] = {
            "stages": [_unstack(s, dev) for s in tree["encoder"]["stages"]],
            "final_norm": _tensor(tree["encoder"]["final_norm"], dev),
        }
    return out


def params_to_reference(params) -> Dict[str, Any]:
    """The reference's tree, as numpy arrays, from the port's
    parameters."""
    out = {k: _numpy(params[k]) for k in ("embed", "final_norm", "lm_head")}
    out["stages"] = [_stack(s) for s in params["stages"]]
    if "encoder" in params:
        out["encoder"] = {
            "stages": [_stack(s) for s in params["encoder"]["stages"]],
            "final_norm": _numpy(params["encoder"]["final_norm"]),
        }
    return out

