"""The least time a solve's work needs on one NVIDIA H100 SXM.

The peaks and the byte and operation counts are copies of
``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``FP32_FLOP_PER_S``,
``INT32_OP_PER_S``, ``cost_bound`` and ``propose_bound`` (there in
milliseconds, here in seconds), so the yardstick does not move when that
script changes.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
# int32 ALU instructions: the fp32 rate counts an FMA as 2 flops, so one
# instruction per lane per clock is half of it
INT32_OP_PER_S = FP32_FLOP_PER_S / 2


def cost_bound_s(metric: str, b: int, m: int, n: int, d: int) -> float:
    """One (B, m, n) cost build from (B, m, d) and (B, n, d) points: x and
    y read once and the costs written once, over the HBM rate; or the
    B m n d terms, an FFMA (2 flops) each for (sq)euclidean and two FP32
    instructions each for l1, whichever is longer."""
    t_bytes = 4 * b * (m * d + n * d + m * n) / HBM_BYTES_PER_S
    if metric == "l1":
        t_ops = 2 * b * m * n * d / (FP32_FLOP_PER_S / 2)
    else:
        t_ops = 2 * b * m * n * d / FP32_FLOP_PER_S
    return max(t_bytes, t_ops)


def propose_bound_s(b: int, m: int, n: int, n_active: int) -> float:
    """One propose step over ``n_active`` live rows: their integer costs
    (4 n bytes a row) and the vectors read once and 12 bytes a row
    written, over the HBM rate; or 3 int32 operations an element read,
    over the int32 rate, whichever is longer."""
    nbytes = (4 * n_active * n + 4 * b * m + 4 * b * n + b * n + b * m
              + 4 * b + 12 * b * m)
    return max(nbytes / HBM_BYTES_PER_S, 3 * n_active * n / INT32_OP_PER_S)


def solve_bound_s(metric: str, b: int, m: int, n: int, d: int) -> float:
    """The least time of one call of B instances: build the costs once
    and read every cost once, with every row live."""
    return cost_bound_s(metric, b, m, n, d) + propose_bound_s(b, m, n, b * m)
