"""One shape bucket's collate, shared by ``OTService.run_batch`` and the
scheduler's collate worker: pad the bucket, build its costs in one
``cost_matrix`` launch, pad the masses, run the admission check, and
drop the rejected lanes. Each service keeps only its own way of
reporting a rejection (a result-list slot or a failed Future).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import batched as B
from ..core.device import as_f32
from ..kernels import ops

__all__ = ["collate_bucket", "keep_lanes"]


def collate_bucket(xs: Sequence[np.ndarray], ys: Sequence[np.ndarray],
                   nus: Optional[Sequence[np.ndarray]],
                   mus: Optional[Sequence[np.ndarray]], key: Tuple[int, int],
                   sizes: np.ndarray, *, device: torch.device, metric: str,
                   validate: bool, tol: float, tracer, trace_id: str,
                   parent: Optional[int], **span_attrs: Any):
    """Pad one bucket to ``key = (mb, nb)`` and build its (B, mb, nb)
    costs in one ``cost_matrix`` launch on ``device`` (the plain version
    on the CPU). ``nus``/``mus`` are None for assignment buckets. With
    ``validate`` the admission check runs under an ``"admission"`` span
    (``span_attrs`` added to it) parented under ``parent``.

    Returns ``(c, nu, mu, codes)``; ``codes`` is the per-lane admission
    bitmask (all 0 without ``validate``)."""
    mb, nb = key
    d = xs[0].shape[1]
    c = ops.cost_matrix_batched(as_f32(B.pad_stack(xs, (mb, d)), device),
                                as_f32(B.pad_stack(ys, (nb, d)), device),
                                metric=metric)
    nu = mu = None
    if nus is not None:
        nu = as_f32(B.pad_stack(nus, (mb,)), device)
        mu = as_f32(B.pad_stack(mus, (nb,)), device)
    if not validate:
        return c, nu, mu, np.zeros(len(xs), np.int32)
    from ..core.validate import admission_codes

    ins = {"c": c} if nu is None else {"c": c, "nu": nu, "mu": mu}
    asp = tracer.start("admission", trace_id=trace_id, parent=parent,
                       **span_attrs)
    codes = admission_codes(ins, sizes=sizes, tol=tol)
    asp.end(rejected=int(np.count_nonzero(codes)))
    return c, nu, mu, codes


def keep_lanes(c, nu, mu, sizes: np.ndarray, keep: np.ndarray):
    """The admitted lanes ``keep`` of a collated bucket:
    ``(c, nu, mu, sizes)``, on the bucket's device."""
    c = B.take_lanes(c, keep)
    if nu is not None:
        nu, mu = B.take_lanes(nu, keep), B.take_lanes(mu, keep)
    return c, nu, mu, sizes[keep]
