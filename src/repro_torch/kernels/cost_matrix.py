"""``cost_matrix``: pairwise costs between point clouds.

Plain PyTorch versions of the metrics (``sqeuclidean``, ``euclidean``,
``l1``) and ``cost_matrix_ref``, the oracle of the CUDA kernel in
``csrc/cost_matrix.cu`` (launched by ``kernels/ops.py``). sqeuclidean and
euclidean use the Gram identity of ``repro/kernels/cost_matrix.py``'s
``_sqeuclid_tile``: ``max(|x|^2 + |y|^2 - 2 x.y^T, 0)`` and
``sqrt(d + 1e-30)``. Integer costs are floored from these floats, so the
arithmetic is kept as the reference writes it.

All functions take ``(..., m, d)`` and ``(..., n, d)`` and return
``(..., m, n)`` float32.
"""
from __future__ import annotations

import torch

METRICS = ("sqeuclidean", "euclidean", "l1")


def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y^T`` in full fp32: TF32 keeps ~3 digits and would move
    floor(c / eps). On CUDA, TF32 is switched off for this product only
    and the caller's setting is restored."""
    if not x.is_cuda:
        return x @ y.transpose(-1, -2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ y.transpose(-1, -2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True)
    d = x2 + y2.transpose(-1, -2) - 2.0 * _gram(x, y)
    return d.clamp_min(0.0)


def euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sqeuclidean(x, y) + 1e-30)


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row blocks bound the (..., rows, n, d) broadcast to 2**26 values."""
    m, n, d = x.shape[-2], y.shape[-2], x.shape[-1]
    lead = x[..., :1, :1].numel()
    rows = max(1, (1 << 26) // max(lead * n * d, 1))
    out = [(x[..., i:i + rows, None, :] - y[..., None, :, :]).abs().sum(-1)
           for i in range(0, m, rows)]
    return torch.cat(out, dim=-2) if out else x.new_zeros(
        x.shape[:-2] + (0, n))


COSTS = {"sqeuclidean": sqeuclidean, "euclidean": euclidean, "l1": l1}


def tolerance(metric: str, d: int) -> tuple:
    """``(rtol, atol)`` within which two fp32 evaluations of a metric
    (kernel and plain version, or two summation orders) agree for points
    in the unit cube [0, 1]^d. The Gram identity ``|x|^2 + |y|^2 - 2 x.y``
    is exact only to a few ulps of ``|x|^2 + |y|^2 <= 2d``: atol =
    4 * 2**-23 * 2d. sqrt maps an absolute error e near zero to sqrt(e),
    hence euclidean's atol. l1 sums d terms in another order: rtol 1e-5
    covers d ulps of the sum for d <= 784."""
    gram = 4 * 2.0 ** -23 * 2 * d
    return {"sqeuclidean": (1e-5, gram), "euclidean": (1e-5, gram ** 0.5),
            "l1": (1e-5, 1e-4)}[metric]


def cost_matrix_ref(x: torch.Tensor, y: torch.Tensor,
                    metric: str = "sqeuclidean") -> torch.Tensor:
    if metric not in COSTS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{METRICS}")
    return COSTS[metric](x, y)
