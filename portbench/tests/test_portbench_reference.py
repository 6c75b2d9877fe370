"""The plain reference accepts the port's answers (on the CPU, at a small
size) and rejects an answer with a corrupted matching, a shifted dual,
moved mass or a wrong cost."""
from pathlib import Path
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import gen  # noqa: E402
from portbench.reference import assignment, costs, transport  # noqa: E402
from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve  # noqa: E402
from repro_torch.core.costs import build_cost_matrix  # noqa: E402

EPS = 0.05
# the readings on the CPU are ~1e-7 and 0; DUAL_EXCESS is a share of
# what float32 costs and duals allow, the configurations' guarantee
COST_ERR, DUAL_EXCESS = 1e-5, 1.0
_points = gen.law("points", "uniform_unit_square").draw
_masses = gen.law("masses", "dirichlet1").draw


def _assignment(n=64, seed=3):
    rng = gen.rng_for(seed, "test")
    x, y = _points(rng, n), _points(rng, n)
    c = build_cost_matrix(x, y, "euclidean", device="cpu")
    s = solve(ASSIGNMENT, {"c": c[None]}, EPS, DispatchPolicy(),
              want=("cost", "duals", "matching"), device="cpu")[0]
    y_b, y_a = s.duals()
    return x, y, {"cost": s.cost, "matching": s.matching().copy(),
                  "y_b": y_b.copy(), "y_a": y_a.copy()}


def _ot(n=48, seed=4):
    rng = gen.rng_for(seed, "test")
    x, y = _points(rng, n), _points(rng, n)
    nu, mu = _masses(rng, n), _masses(rng, n)
    c = build_cost_matrix(x, y, "euclidean", device="cpu")
    s = solve(OT, [(c, nu, mu)], EPS, DispatchPolicy(),
              want=("cost", "duals", "plan_sparse"), device="cpu")[0]
    y_b, y_a = s.duals()
    p = s.plan_sparse()
    return x, y, nu, mu, {"cost": s.cost, "y_b": y_b.copy(),
                          "y_a": y_a.copy(), "rows": p.rows.copy(),
                          "cols": p.cols.copy(), "vals": p.vals.copy()}


def _ok_assignment(r):
    return (r["perm_bad"] == 0 and r["cost_err"] <= COST_ERR
            and r["dual_excess"] <= DUAL_EXCESS and r["gap_ratio"] <= 2)


def _ok_ot(r):
    return (r["marg_err"] <= 1e-5 and r["cost_err"] <= COST_ERR
            and r["dual_excess"] <= DUAL_EXCESS and r["gap_ratio"] <= 2)


def test_the_reference_accepts_the_ports_assignment():
    x, y, out = _assignment()
    r = assignment.certify(x, y, "euclidean", EPS, out)
    assert _ok_assignment(r), r


def test_the_reference_accepts_the_ports_transport_plan():
    x, y, nu, mu, out = _ot()
    r = transport.certify(x, y, nu, mu, "euclidean", EPS, out)
    assert _ok_ot(r), r


@pytest.mark.parametrize("fault", ["duplicate", "swap", "dual", "cost"])
def test_the_reference_rejects_a_corrupted_assignment(fault):
    x, y, out = _assignment()
    if fault == "duplicate":
        out["matching"][1] = out["matching"][0]
    elif fault == "swap":
        out["matching"][[0, 1]] = out["matching"][[1, 0]]
    elif fault == "dual":
        # the shift of one dual by one rounding unit eps * max(c)
        unit = EPS * costs.cost_block(x.astype(float), y.astype(float),
                                      "euclidean").max()
        out["y_b"][5] += np.float32(unit)
    else:
        out["cost"] *= 1.001
    assert not _ok_assignment(
        assignment.certify(x, y, "euclidean", EPS, out))


@pytest.mark.parametrize("fault", ["moved", "outside", "dual", "cost"])
def test_the_reference_rejects_a_corrupted_plan(fault):
    x, y, nu, mu, out = _ot()
    if fault == "moved":
        out["rows"] = out["rows"].copy()
        out["rows"][0] = (out["rows"][0] + 1) % len(nu)
    elif fault == "outside":
        out["cols"] = out["cols"].copy()
        out["cols"][0] = len(mu)
    elif fault == "dual":
        unit = EPS * costs.cost_block(x.astype(float), y.astype(float),
                                      "euclidean").max()
        out["y_a"][3] += np.float32(unit)
    else:
        out["cost"] *= 1.001
    assert not _ok_ot(transport.certify(x, y, nu, mu, "euclidean", EPS, out))


def test_a_lower_precision_cost_build_fails_the_check():
    """The control at a test's size: the port solving bf16-rounded costs
    gives a cost that the float64 costs do not bear out."""
    rng = gen.rng_for(11, "test")
    n = 64
    x, y = _points(rng, n), _points(rng, n)
    c = build_cost_matrix(x, y, "euclidean", device="cpu")
    c = c.to(torch.bfloat16).to(torch.float32)
    s = solve(ASSIGNMENT, {"c": c[None]}, 0.01, DispatchPolicy(),
              want=("cost", "duals", "matching"), device="cpu")[0]
    y_b, y_a = s.duals()
    r = assignment.certify(x, y, "euclidean", 0.01,
                           {"cost": s.cost, "matching": s.matching(),
                            "y_b": y_b, "y_a": y_a})
    assert r["cost_err"] > 10 * COST_ERR and not _ok_assignment(r), r


def test_costs_match_a_direct_computation():
    rng = np.random.default_rng(0)
    x, y = rng.uniform(size=(7, 3)), rng.uniform(size=(5, 3))
    direct = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(costs.cost_block(x, y, "euclidean"), direct)
    np.testing.assert_allclose(costs.cost_block(x, y, "sqeuclidean"),
                               direct ** 2)
    np.testing.assert_allclose(costs.cost_block(x, y, "l1"),
                               np.abs(x[:, None] - y[None]).sum(-1))
    assert [s.stop for s in costs.row_blocks(10, 4, budget=12)] == \
        [3, 6, 9, 10]
