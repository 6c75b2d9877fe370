"""The plain reference of an OT configuration: what a returned sparse
plan, its cost and its duals must satisfy, worked out in float64 from
the points and masses the benchmark made.

It takes nothing the program made but its answer: it rebuilds every
cost from the points, so a wrong cost kernel shows too.

Numbers (each the worst over the instances checked):

  marg_err     the plan's largest departure from a transport plan of
               (nu, mu): a row or column sum off its mass, or a negative
               entry (infinite for an entry outside the instance)
  cost_err     |reported cost - <plan, c>| over <plan, c>
  dual_excess  how far the duals break eps-feasibility, y_b[i] + y_a[j]
               <= c[i, j] + eps max(c), on the columns with demand, as a
               multiple of what float32 costs and duals allow
               (``costs.scale_and_excess``)
  gap_ratio    (<plan, c> - <nu, y_b> - <mu, y_a>) in units of
               eps * sum(nu) * max(c)
"""
from __future__ import annotations

import numpy as np

from .costs import pair_costs, scale_and_excess

NUMBERS = ("marg_err", "cost_err", "dual_excess", "gap_ratio")


def check(instance, answer: dict, config: dict) -> dict:
    """The numbers of one answer to ``instance`` (its points ``x``,
    ``y`` and masses ``nu``, ``mu``) under the configuration's ``metric``
    and ``eps``."""
    return certify(instance.x, instance.y, instance.nu, instance.mu,
                   config["metric"], config["eps"], answer)


def certify(x, y, nu, mu, metric: str, eps: float, out: dict) -> dict:
    """``out``: the program's answer for one instance, host arrays
    ``rows``, ``cols``, ``vals`` (the plan's triplets), ``y_b`` (m,),
    ``y_a`` (n,) and the float ``cost``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    nu = np.asarray(nu, np.float64)
    mu = np.asarray(mu, np.float64)
    m, n = x.shape[0], y.shape[0]
    rows = np.asarray(out["rows"], np.int64).reshape(-1)
    cols = np.asarray(out["cols"], np.int64).reshape(-1)
    vals = np.asarray(out["vals"], np.float64).reshape(-1)
    y_b = np.asarray(out["y_b"], np.float64).reshape(-1)
    y_a = np.asarray(out["y_a"], np.float64).reshape(-1)
    if y_b.shape != (m,) or y_a.shape != (n,) or not (
            rows.shape == cols.shape == vals.shape):
        return {k: np.inf for k in NUMBERS}
    inside = bool(((rows >= 0) & (rows < m) & (cols >= 0)
                   & (cols < n)).all())
    if inside:
        marg = max(
            float(np.abs(np.bincount(rows, vals, m) - nu).max()),
            float(np.abs(np.bincount(cols, vals, n) - mu).max()),
            float(max(0.0, -vals.min(initial=0.0))))
        cost = float((vals * pair_costs(x[rows], y[cols], metric)).sum())
    else:
        marg, cost = np.inf, np.inf
    scale, excess = scale_and_excess(x, y, metric, y_b, y_a, eps,
                                     live=mu > 0)
    bound = eps * float(nu.sum()) * scale
    dual = float(nu @ y_b + mu @ y_a)
    return {
        "marg_err": marg,
        "cost_err": abs(float(out["cost"]) - cost) / max(abs(cost), 1e-300),
        "dual_excess": excess,
        "gap_ratio": (cost - dual) / bound,
    }
