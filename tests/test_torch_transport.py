"""repro_torch OT core held against the JAX reference: integer state equal
at every chunk boundary, the one-instance solve, and the host threshold."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from _torch_parity import batch, cases, chunk_parity
from repro.core import batched as jbatched
from repro.core import feasibility as jfeas
from repro.core import transport as jtr
from repro_torch.core import feasibility as tfeas
from repro_torch.core import transport as ttr


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", cases(), ids=lambda c: c[0])
def test_ot_state_equal_at_every_chunk(case, k):
    _, sizes, eps, guaranteed = case
    chunks = chunk_parity("ot", batch("ot", 5, sizes), eps, sizes,
                          guaranteed, k)
    assert chunks >= 1


@pytest.mark.parametrize("n,eps", [(12, 0.2), (40, 0.1)])
def test_solve_ot_equals_reference(n, eps):
    rng = np.random.default_rng(n)
    c = rng.uniform(size=(n, n)).astype(np.float32)
    nu = rng.dirichlet(np.ones(n)).astype(np.float32)
    mu = rng.dirichlet(np.ones(n)).astype(np.float32)
    # the reference's batched program is the one whose prologue the port
    # follows (see repro_torch.core.pushrelabel.assignment_prologue)
    ref = jbatched.solve_ot_batched(jnp.asarray(c[None]),
                                    jnp.asarray(nu[None]),
                                    jnp.asarray(mu[None]), eps,
                                    guaranteed=True)
    got = ttr.solve_ot(c, nu, mu, eps, guaranteed=True, device="cpu")
    for f in ref.state._fields:
        np.testing.assert_array_equal(getattr(got.state, f).numpy(),
                                      np.asarray(getattr(ref.state, f)), f)
    for f in ("s_int", "d_int", "theta"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    # float epilogue: f32 cumsums and sums in another order; the plan's
    # entries are multiples of 1/theta plus NW repairs of size ~1/theta
    np.testing.assert_allclose(got.plan.numpy(), np.asarray(ref.plan),
                               atol=1e-6)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-5)
    np.testing.assert_allclose(got.plan.sum(2).numpy()[0], nu, atol=1e-6)

    st = {f: getattr(got.state, f)[0].numpy() for f in got.state._fields}
    c_int = (np.floor(c / (c.max() * np.float32(eps / 3)))).astype(np.int32)
    args = (c_int, ttr.OTState(**st), got.s_int[0].numpy(),
            got.d_int[0].numpy(), eps / 3)
    inv = tfeas.check_ot_invariants(*args)
    assert inv == jfeas.check_ot_invariants(*args)
    assert all(inv.values()), inv


@pytest.mark.parametrize("eps,total", [(0.1, 10), (0.3 / 3, 10),
                                       (0.05, 333)])
def test_termination_threshold_host_float64(eps, total):
    nu = np.full((total,), 1.0, np.float32)
    assert (ttr.ot_termination_threshold(nu, 1.0, eps)
            == jtr.ot_termination_threshold(nu, 1.0, eps))


def test_northwest_corner_equals_reference():
    rng = np.random.default_rng(2)
    r = rng.dirichlet(np.ones(7), size=3).astype(np.float32)
    c = rng.dirichlet(np.ones(5), size=3).astype(np.float32)
    got = ttr.northwest_corner(torch.as_tensor(r), torch.as_tensor(c))
    for b in range(3):
        ref = jtr.northwest_corner(jnp.asarray(r[b]), jnp.asarray(c[b]))
        # f32 running sums (<= 1) may round apart by an ulp of 1 each
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref),
                                   atol=2 * 2.0**-23)
