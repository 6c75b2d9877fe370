"""Cost matrices of the paper's experiments: Euclidean distance between
2-D points in the unit square (Fig. 1) and L1 distance between normalized
images (Fig. 2).

``build_cost_matrix`` runs on the CUDA device unless ``device="cpu"`` is
passed: on the card it launches the ``cost_matrix`` kernel, on the CPU it
runs the kernel's plain version.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.cost_matrix import COSTS, euclidean, l1, sqeuclidean
from ..obs import tracing as _tracing
from .device import as_f32, resolve_device

__all__ = ["COSTS", "sqeuclidean", "euclidean", "l1", "build_cost_matrix"]


def build_cost_matrix(x, y, metric: str = "euclidean", *,
                      device=None) -> torch.Tensor:
    """(m, d), (n, d) -> (m, n) float32, or (B, m, d), (B, n, d) ->
    (B, m, n) in one launch, under a ``costs.build`` span."""
    with _tracing.root("costs.build") as sp:
        if sp is not None:
            sp.attrs["metric"] = metric
        dev = resolve_device(device)
        x, y = as_f32(x, dev), as_f32(y, dev)
        if x.ndim == 3:
            return ops.cost_matrix_batched(x, y, metric)
        return ops.cost_matrix(x, y, metric)
