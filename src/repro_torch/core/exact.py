"""Exact oracles used only in tests and checks (never in the hot path).

- assignment: scipy's Jonker-Volgenant ``linear_sum_assignment``.
- optimal transport: scipy ``linprog`` (HiGHS) on the flow LP. The
  equality constraints are built sparse, so n = 512 needs megabytes, not
  the 2 GB of a dense constraint matrix.
"""
from __future__ import annotations

import numpy as np


def exact_assignment_cost(c) -> float:
    from scipy.optimize import linear_sum_assignment

    c = np.asarray(c)
    r, col = linear_sum_assignment(c)
    return float(c[r, col].sum())


def exact_ot_cost(c, mu, nu) -> float:
    """min <C, P> s.t. P 1 = mu, P^T 1 = nu, P >= 0 (balanced OT)."""
    from scipy.optimize import linprog
    from scipy.sparse import coo_matrix

    c = np.asarray(c, np.float64)
    mu = np.asarray(mu, np.float64)
    nu = np.asarray(nu, np.float64)
    m, n = c.shape
    var = np.arange(m * n)
    rows = np.concatenate([var // n, m + var % n])
    a_eq = coo_matrix((np.ones(2 * m * n), (rows, np.concatenate([var, var]))),
                      shape=(m + n, m * n)).tocsr()
    res = linprog(
        c.ravel(), A_eq=a_eq[:-1], b_eq=np.concatenate([mu, nu])[:-1],
        bounds=(0, None), method="highs",
    )
    if not res.success:
        raise RuntimeError(f"exact_ot_cost: linprog failed: {res.message}")
    return float(res.fun)
