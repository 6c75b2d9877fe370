"""The plain reference of an assignment configuration: what a returned
matching, its cost and its duals must satisfy, worked out in float64
from the points the benchmark made.

It takes nothing the program made but its answer: it rebuilds every
cost from the points, so a wrong cost kernel shows too.

Numbers (each the worst over the instances checked):

  perm_bad     rows whose column is out of range or shared with another
               row: a perfect matching has none
  cost_err     |reported cost - cost of the returned matching| over the
               latter
  dual_excess  how far the duals break eps-feasibility, y_b[i] + y_a[j]
               <= c[i, j] + eps max(c), as a multiple of what float32
               costs and duals allow (``costs.scale_and_excess``)
  gap_ratio    (cost of the matching - sum(y_b) - sum(y_a)) in units of
               eps * m * max(c)
"""
from __future__ import annotations

import numpy as np

from .costs import pair_costs, scale_and_excess

NUMBERS = ("perm_bad", "cost_err", "dual_excess", "gap_ratio")


def check(instance, answer: dict, config: dict) -> dict:
    """The numbers of one answer to ``instance`` (its points ``x``,
    ``y``) under the configuration's ``metric`` and ``eps``."""
    return certify(instance.x, instance.y, config["metric"], config["eps"],
                   answer)


def certify(x, y, metric: str, eps: float, out: dict) -> dict:
    """``out``: the program's answer for one instance, host arrays
    ``matching`` (m,), ``y_b`` (m,), ``y_a`` (n,) and the float ``cost``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m, n = x.shape[0], y.shape[0]
    match = np.asarray(out["matching"], np.int64).reshape(-1)
    y_b = np.asarray(out["y_b"], np.float64).reshape(-1)
    y_a = np.asarray(out["y_a"], np.float64).reshape(-1)
    if match.shape != (m,) or y_b.shape != (m,) or y_a.shape != (n,):
        return {k: np.inf for k in NUMBERS}
    ok = (match >= 0) & (match < n)
    perm_bad = m - np.unique(match[ok]).size
    scale, excess = scale_and_excess(x, y, metric, y_b, y_a, eps)
    bound = eps * m * scale
    cost = float(pair_costs(x[ok], y[match[ok]], metric).sum())
    dual = float(y_b.sum() + y_a.sum())
    return {
        "perm_bad": float(perm_bad),
        "cost_err": abs(float(out["cost"]) - cost) / max(abs(cost), 1e-300),
        "dual_excess": excess,
        "gap_ratio": (cost - dual) / bound,
    }
