"""Literal Section-4 reduction: materialize unit copies and run the
unbalanced assignment solver. Exponentially sized in 1/eps - used ONLY as a
test oracle (small theta) for the clustered production solver in transport.py.

Port of ``repro.core.copies``. The copies' costs are built in numpy as
the reference builds them; the solve runs on ``device`` (the card by
default, the CPU when ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .pushrelabel import (PushRelabelState, complete_matching, round_costs,
                          solve_assignment_int)


def solve_ot_via_copies(c, nu, mu, eps: float, theta: float, device=None):
    """Returns (plan, cost, int-state, rows, cols) by expanding each node
    into copies; the state without the lane axis, as the reference's."""
    dev = resolve_device(device)
    c = np.asarray(c, np.float32)
    nu = np.asarray(nu, np.float64)
    mu = np.asarray(mu, np.float64)
    scale = max(float(c.max()), 1e-30)
    s_int = np.floor(nu * theta).astype(np.int64)
    d_int = np.ceil(mu * theta).astype(np.int64)
    rows = np.repeat(np.arange(c.shape[0]), s_int)
    cols = np.repeat(np.arange(c.shape[1]), d_int)
    big_c = c[np.ix_(rows, cols)] / scale
    c_int = round_costs(torch.as_tensor(big_c, device=dev), eps).contiguous()
    state = solve_assignment_int(c_int, eps)
    matching = complete_matching(state.match_ba, state.match_ab)[0]
    matching = matching.cpu().numpy()
    plan = np.zeros(c.shape, np.float64)
    valid = matching >= 0
    np.add.at(plan, (rows[valid], cols[matching[valid]]), 1.0 / theta)
    cost = float((plan * c).sum())
    return plan, cost, PushRelabelState(*(t[0] for t in state)), rows, cols
