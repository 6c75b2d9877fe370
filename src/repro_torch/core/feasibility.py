"""Machine-checkable certificates for the paper's invariants (all integer).

A numpy copy of ``repro.core.feasibility``: it checks ONE instance's
integer state (index a batched state per lane first).

These run on the *int* state (units of eps) so every check is exact:
  (I1)  y_b >= 0, y_a <= 0, free rows-of-A... in our orientation: free demand
        columns have y_a == 0; y_b >= 0 elementwise; y_a <= 0 elementwise.
  (I2)  eps-feasibility: non-matching y_b[i] + y_a[j] <= c[i,j] + 1 for all
        (i, j); matching edges y_b[i] + y_a[j] == c[i,j].
  Lemma 3.2: |y| <= 1/eps + 2 units (i.e. 1 + 2*eps).
"""
from __future__ import annotations

import numpy as np


def check_invariants(c_int, y_b, y_a, match_ba, eps: float) -> dict:
    c_int = np.asarray(c_int)
    y_b = np.asarray(y_b)
    y_a = np.asarray(y_a)
    match_ba = np.asarray(match_ba)
    m, n = c_int.shape
    out = {}
    out["I1_yb_nonneg"] = bool((y_b >= 0).all())
    out["I1_ya_nonpos"] = bool((y_a <= 0).all())
    matched_cols = match_ba[match_ba >= 0]
    free_col_mask = np.ones(n, bool)
    free_col_mask[matched_cols] = False
    out["I1_free_a_zero"] = bool((y_a[free_col_mask] == 0).all())
    s = y_b[:, None] + y_a[None, :]
    feas = s <= c_int + 1
    rows = np.arange(m)[match_ba >= 0]
    cols = match_ba[match_ba >= 0]
    tight = s[rows, cols] == c_int[rows, cols]
    out["I2_matching_tight"] = bool(tight.all())
    nonmatch = feas.copy()
    out["I2_feasible"] = bool(nonmatch.all())
    bound = int(np.ceil(1.0 / eps)) + 2
    out["L32_dual_bound"] = bool(
        (np.abs(y_b) <= bound).all() and (np.abs(y_a) <= bound).all()
    )
    out["valid_matching"] = len(cols) == len(np.unique(cols))
    return out


def check_ot_invariants(c_int, state, s_int, d_int, eps: float) -> dict:
    """Integer certificates for the clustered OT solver (transport.py).

    Expands the 2-cluster representation back to per-copy duals and checks
    the paper's invariants + Lemma 4.1 on the *final* state.
    """
    c = np.asarray(c_int)
    y_b = np.asarray(state.y_b)
    ya_hi = np.asarray(state.ya_hi)
    free_b = np.asarray(state.free_b)
    free_a = np.asarray(state.free_a)
    f_hi = np.asarray(state.f_hi)
    f_lo = np.asarray(state.f_lo)
    s_int = np.asarray(s_int)
    d_int = np.asarray(d_int)
    live = d_int > 0  # columns with no demand have no copies -> no constraints
    out = {}
    out["conserve_supply"] = bool(
        ((f_hi + f_lo).sum(1) + free_b == s_int).all()
    )
    out["conserve_demand"] = bool(
        ((f_hi + f_lo).sum(0) + free_a == d_int).all()
    )
    out["I1_ya_nonpos"] = bool((ya_hi[live] <= 0).all())
    out["I1_free_a_at_zero"] = bool((ya_hi[live & (free_a > 0)] == 0).all())
    out["I1_yb_positive"] = bool((y_b >= 1).all())  # init eps, only rises
    # Feasibility (2) for the max-dual copies (free b at y_b, a at ya_hi).
    s = y_b[:, None] + ya_hi[None, :]
    out["I2_feasible"] = bool((s[:, live] <= c[:, live] + 1).all())
    # Lemma 4.1: matched b-copy duals (tightness-derived) live in
    # {y_b, y_b - 1}; raises keep free copies at the max.
    bh = c - ya_hi[None, :]          # b-copy dual where flow sits at hi
    bl = c - ya_hi[None, :] + 1      # ... at lo
    okh = (f_hi == 0) | ((bh <= y_b[:, None]) & (bh >= y_b[:, None] - 1))
    okl = (f_lo == 0) | ((bl <= y_b[:, None]) & (bl >= y_b[:, None] - 1))
    out["L41_two_clusters_hi"] = bool(okh.all())
    out["L41_two_clusters_lo"] = bool(okl.all())
    bound = int(np.ceil(1.0 / eps)) + 2
    out["L32_dual_bound"] = bool(
        (np.abs(y_b) <= bound).all() and (np.abs(ya_hi[live]) <= bound).all()
    )
    return out


def is_maximal(adm: np.ndarray, mprime_b: np.ndarray, active_rows: np.ndarray) -> bool:
    """No admissible edge joins an unmatched active row to an unmatched col."""
    adm = np.asarray(adm)
    n = adm.shape[1]
    col_used = np.zeros(n, bool)
    used = mprime_b[mprime_b >= 0]
    col_used[used] = False if used.size == 0 else True
    row_free = active_rows & (np.asarray(mprime_b) < 0)
    sub = adm[row_free][:, ~col_used]
    return not bool(sub.any())
