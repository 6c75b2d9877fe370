"""repro_torch assignment core held against the JAX reference: integer
state equal at every chunk boundary, and the one-instance solve."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from _torch_parity import batch, cases, chunk_parity
from repro.core import batched as jbatched
from repro.core import feasibility as jfeas
from repro.core import pushrelabel as jpr
from repro_torch.core import feasibility as tfeas
from repro_torch.core import pushrelabel as tpr


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_assignment_state_equal_at_every_chunk(case, k):
    _, sizes, eps, guaranteed = case
    chunks = chunk_parity("assignment", batch("assignment", 7, sizes), eps,
                          sizes, guaranteed, k)
    assert chunks >= 1


@pytest.mark.parametrize("n,eps", [(16, 0.2), (48, 0.05)])
def test_solve_assignment_equals_reference(n, eps):
    rng = np.random.default_rng(n)
    c = rng.uniform(size=(n, n)).astype(np.float32)
    # the reference's batched program is the one whose prologue the port
    # follows (see repro_torch.core.pushrelabel.assignment_prologue)
    ref = jbatched.solve_assignment_batched(jnp.asarray(c[None]), eps,
                                            guaranteed=True)
    got = tpr.solve_assignment(c, eps, guaranteed=True, device="cpu")
    for f in ("matching", "phases", "rounds",
              "matched_before_completion"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    # f32 sums in another order: a few ulps of the total
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-5)
    np.testing.assert_allclose(got.y_b.numpy(), np.asarray(ref.y_b),
                               rtol=1e-6)


def test_complete_matching_equals_reference():
    rng = np.random.default_rng(3)
    m, n = 12, 16
    match_ba = np.full((2, m), -1, np.int32)
    match_ab = np.full((2, n), -1, np.int32)
    for b in range(2):
        rows = rng.choice(m, 5, replace=False)
        cols = rng.choice(n, 5, replace=False)
        match_ba[b, rows], match_ab[b, cols] = cols, rows
    valid_b = np.arange(m)[None] < np.array([[12], [9]])
    valid_a = np.arange(n)[None] < np.array([[16], [11]])
    got = tpr.complete_matching(*(torch.as_tensor(a) for a in
                                  (match_ba, match_ab, valid_b, valid_a)))
    for b in range(2):
        ref = jpr.complete_matching(
            jnp.asarray(match_ba[b]), jnp.asarray(match_ab[b]),
            jnp.asarray(valid_b[b]), jnp.asarray(valid_a[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_invariants_hold_on_port_state():
    rng = np.random.default_rng(9)
    c = rng.uniform(size=(1, 32, 32)).astype(np.float32)
    eps = 0.05
    eps_t = torch.tensor([eps])
    _, c_int, _, _, _ = tpr.assignment_prologue(torch.as_tensor(c), eps_t)
    state = tpr.run_assignment_phases(
        c_int, tpr.init_assignment_state(1, 32, 32),
        torch.tensor([int(eps * 32)], dtype=torch.int32),
        torch.tensor([tpr._max_phases(eps, 32)], dtype=torch.int32), 10_000)
    args = (c_int[0].numpy(), state.y_b[0].numpy(), state.y_a[0].numpy(),
            state.match_ba[0].numpy(), eps)
    got = tfeas.check_invariants(*args)
    assert got == jfeas.check_invariants(*args)
    assert all(got.values()), got
