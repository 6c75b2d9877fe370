"""``repro_torch.core.copies.solve_ot_via_copies`` (the literal Section-4
reduction, a test oracle of the clustered OT solver) against the
reference's, on the CPU: the inputs of
``tests/test_transport.py::test_matches_explicit_copies_reduction`` and
two more. Integer state, copies and plan equal; cost within 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.copies import solve_ot_via_copies as ref_copies
from repro.core.costs import build_cost_matrix
from repro_torch.core.copies import solve_ot_via_copies


def _instance(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    y = rng.uniform(size=(n, 2))
    c = np.asarray(build_cost_matrix(x, y, "euclidean"))
    return c, rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n))


@pytest.mark.parametrize("n,seed,eps,theta", [(12, 5, 0.1, 160.0),
                                              (8, 1, 0.2, 64.0),
                                              (10, 3, 0.05, 100.0)])
def test_copies_reduction_equals_reference(n, seed, eps, theta):
    c, nu, mu = _instance(n, seed)
    plan_r, cost_r, state_r, rows_r, cols_r = ref_copies(c, nu, mu, eps,
                                                         theta)
    plan, cost, state, rows, cols = solve_ot_via_copies(c, nu, mu, eps,
                                                        theta, device="cpu")
    np.testing.assert_array_equal(rows, rows_r)
    np.testing.assert_array_equal(cols, cols_r)
    for f in state_r._fields:
        got = getattr(state, f).numpy()
        want = np.asarray(getattr(state_r, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(plan, plan_r)
    assert cost == pytest.approx(cost_r, rel=0, abs=1e-6)


def test_copies_default_device_is_the_card():
    """``device=None`` is CUDA: without it, the oracle raises rather than
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    c, nu, mu = _instance(4, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_ot_via_copies(c, nu, mu, 0.2, 32.0)
