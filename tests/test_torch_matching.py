"""repro_torch matching primitives held against the JAX reference.

The same numpy inputs feed ``repro.core.matching`` and
``repro_torch.core.matching``; integer outputs must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import matching as jm
from repro_torch.core import matching as tm


@pytest.mark.parametrize("m,n", [(1, 1), (7, 9), (33, 64)])
@pytest.mark.parametrize("salt", [0, 1, 12345, 2**31 - 2, 2**31 - 1, -5])
def test_proposal_keys_equal_reference(m, n, salt):
    ref = np.asarray(jm.proposal_keys(m, n, jnp.int32(salt)))
    got = tm.proposal_keys(m, n, torch.tensor(salt, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_proposal_keys_per_lane_salts():
    salts = np.array([0, 7919, 2**31 - 1, 123456789], np.int32)
    got = tm.proposal_keys(5, 6, torch.as_tensor(salts)).numpy()
    for b, s in enumerate(salts):
        ref = np.asarray(jm.proposal_keys(5, 6, jnp.int32(s)))
        np.testing.assert_array_equal(got[b], ref.astype(np.int64))


def _random_instance(rng, b, m, n):
    c = rng.integers(0, 5, size=(b, m, n)).astype(np.int32)
    y_b = rng.integers(0, 4, size=(b, m)).astype(np.int32)
    y_a = -rng.integers(0, 3, size=(b, n)).astype(np.int32)
    active = rng.uniform(size=(b, m)) < 0.7
    avail = rng.uniform(size=(b, n)) < 0.8
    salt = rng.integers(0, 2**31 - 1, size=b).astype(np.int32)
    return c, y_b, y_a, active, avail, salt


@pytest.mark.parametrize("seed,m,n", [(0, 8, 8), (1, 24, 40), (2, 64, 64)])
def test_propose_dense_equals_reference(seed, m, n):
    rng = np.random.default_rng(seed)
    c, y_b, y_a, active, avail, salt = _random_instance(rng, 3, m, n)
    got = tm._propose_dense(*(torch.as_tensor(a) for a in
                              (c, y_b, y_a, active, avail, salt)))
    for b in range(3):
        ref = jm._propose_dense(jnp.asarray(c[b]), jnp.asarray(y_b[b]),
                                jnp.asarray(y_a[b]), jnp.asarray(active[b]),
                                jnp.asarray(avail[b]), jnp.int32(salt[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed,m,n", [(3, 8, 8), (4, 24, 40), (5, 64, 48)])
def test_maximal_matching_equals_reference(seed, m, n):
    """M' (both sides), leftover availability/activity, rounds and the
    done flag equal the reference lane by lane, with per-lane salts; a
    lane outside ``lanes`` takes no round."""
    rng = np.random.default_rng(seed)
    # dense admissibility: y_b + y_a == c + 1 on ~1/3 of the edges
    b = 4
    c = rng.integers(0, 3, size=(b, m, n)).astype(np.int32)
    y_b = np.ones((b, m), np.int32) * 2
    y_a = -rng.integers(0, 2, size=(b, n)).astype(np.int32)
    in_bprime = rng.uniform(size=(b, m)) < 0.8
    salt = rng.integers(0, 10_000, size=b).astype(np.int32)
    lanes = np.array([True, True, False, True])
    got = tm.greedy_maximal_matching(
        *(torch.as_tensor(a) for a in (c, y_b, y_a, in_bprime, salt)),
        lanes=torch.as_tensor(lanes), propose_fn=tm._propose_dense)
    for i in range(b):
        if not lanes[i]:
            assert int(got.rounds[i]) == 0
            assert (got.mprime_b[i] == -1).all()
            continue
        ref = jm.greedy_maximal_matching(
            jnp.asarray(c[i]), jnp.asarray(y_b[i]), jnp.asarray(y_a[i]),
            jnp.asarray(in_bprime[i]), jnp.int32(salt[i]))
        for f in ref._fields:
            np.testing.assert_array_equal(
                getattr(got, f)[i].numpy(), np.asarray(getattr(ref, f)),
                err_msg=f)
