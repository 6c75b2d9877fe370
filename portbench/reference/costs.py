"""Plain NumPy costs between point sets, in float64, a block of rows at a
time so that a 10 000 x 10 000 instance fits in a few tens of MB."""
from __future__ import annotations

import numpy as np

METRICS = ("euclidean", "sqeuclidean", "l1")


def row_blocks(m: int, n: int, budget: int = 1 << 22):
    """Slices of ``m`` rows, each of at most ``budget`` (row, column)
    pairs (at least one row)."""
    step = max(1, budget // max(n, 1))
    for lo in range(0, m, step):
        yield slice(lo, min(m, lo + step))


def cost_block(x: np.ndarray, y: np.ndarray, metric: str) -> np.ndarray:
    """(k, d) x (n, d) float64 points -> (k, n) float64 costs."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    out = np.zeros((x.shape[0], y.shape[0]))
    for j in range(x.shape[1]):
        diff = x[:, j, None] - y[None, :, j]
        out += np.abs(diff) if metric == "l1" else diff * diff
    return np.sqrt(out) if metric == "euclidean" else out


def pair_costs(x: np.ndarray, y: np.ndarray, metric: str) -> np.ndarray:
    """Costs of the pairs (x[k], y[k]), float64."""
    diff = x - y
    if metric == "l1":
        return np.abs(diff).sum(1)
    sq = (diff * diff).sum(1)
    return np.sqrt(sq) if metric == "euclidean" else sq


# float32's unit roundoff: the configurations state float32 costs and
# duals
F32_U = 2.0 ** -24
# candidate edges kept from one block of rows (the largest slacks)
_KEEP = 1 << 17


def cost_tolerance(metric: str, d: int) -> tuple:
    """``(rtol, atol)``: how far a float32 evaluation of a cost between
    points in the unit cube [0, 1]^d may lie from the exact one. A copy
    of the program's statement (``repro_torch/kernels/cost_matrix.py``,
    ``tolerance``): the Gram identity ``|x|^2 + |y|^2 - 2 x.y`` is exact
    only to a few ulps of ``|x|^2 + |y|^2 <= 2d``, and a square root maps
    an absolute error e near zero to sqrt(e)."""
    gram = 4 * 2.0 ** -23 * 2 * d
    return {"sqeuclidean": (1e-5, gram), "euclidean": (1e-5, gram ** 0.5),
            "l1": (1e-5, 1e-4)}[metric]


def scale_and_excess(x, y, metric, y_b, y_a, eps, live=None):
    """One pass over every cost: ``(max cost, how far the duals break
    eps-feasibility)``. An edge breaks it by ``y_b[i] + y_a[j] - c[i, j]
    - eps max(c)`` (float64, exact costs) over what float32 allows: the
    cost's evaluation error (``cost_tolerance``) and four roundings of
    the terms, ``u (|y_b[i]| + |y_a[j]| + c[i, j] + eps max(c))`` with
    u = 2^-24; the number is the largest such ratio over the live
    columns, 0 when no edge breaks it (a sound answer reads below 1). An edge can break it only if its
    slack ``y_b + y_a - c`` exceeds eps times the largest cost seen so
    far, so only those edges are kept from each block."""
    cols = np.arange(y.shape[0]) if live is None else np.flatnonzero(live)
    yc, yac = y[cols], y_a[cols]
    scale, keep = 0.0, []
    for rows in row_blocks(x.shape[0], y.shape[0]):
        c = cost_block(x[rows], y, metric)
        if c.size:
            scale = max(scale, float(c.max()))
        if live is not None:
            c = c[:, cols]
        slack = y_b[rows, None] + yac[None, :] - c
        i, j = np.nonzero(slack > eps * scale)
        if i.size > _KEEP:
            top = np.argpartition(slack[i, j], -_KEEP)[-_KEEP:]
            i, j = i[top], j[top]
        keep.append((i + rows.start, j, slack[i, j], c[i, j]))
    unit = eps * scale
    i, j, slack, c = (np.concatenate(a) for a in zip(*keep))
    over = slack - unit
    hit = over > 0
    if not hit.any():
        return scale, 0.0
    i, j, c, over = i[hit], j[hit], c[hit], over[hit]
    rtol, atol = cost_tolerance(metric, x.shape[1])
    room = (atol + rtol * c
            + 4 * F32_U * (np.abs(y_b[i]) + np.abs(yac[j]) + c + unit))
    return scale, float((over / room).max())
