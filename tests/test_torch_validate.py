"""repro_torch's admission check, deadline cut, ragged wrappers and public
core surface, held against the JAX reference on the CPU.

Inputs are made by numpy from a seed; the admission cases keep every
imbalanced lane far from the ``tol * scale`` edge, where fp32 sums taken
in another order could classify a lane differently (see the docstring of
``repro_torch.core.validate``)."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore
from repro.core import api as japi
from repro.core import batched as jbatched
from repro.core import validate as jV
import repro_torch.core as tcore
from repro_torch.core import api as tapi
from repro_torch.core import batched as tbatched
from repro_torch.core import validate as tV

from _torch_parity import assert_states_equal


# --------------------------------------------------------------------------
# admission codes
# --------------------------------------------------------------------------

def _admission_batch(kind: str, seed: int):
    """(inputs, sizes) of one batch: ``padded`` (poison only in padding),
    ``nan`` (NaN / inf costs), ``negative`` (negative and NaN masses),
    ``imbalanced`` (scaled marginals), ``mixed`` (all reasons at once)."""
    rng = np.random.default_rng(seed)
    b, m, n = 6, 8, 7
    c = np.abs(rng.standard_normal((b, m, n))).astype(np.float32)
    nu = rng.dirichlet(np.ones(m), size=b).astype(np.float32)
    mu = rng.dirichlet(np.ones(n), size=b).astype(np.float32)
    sizes = np.array([[8, 7], [5, 4], [8, 3], [2, 7], [6, 6], [8, 7]],
                     np.int32)
    for i, (mi, ni) in enumerate(sizes):
        # marginals normalized over each lane's valid block
        nu[i, mi:] = 0.0
        mu[i, ni:] = 0.0
        nu[i] /= nu[i].sum()
        mu[i] /= mu[i].sum()
    if kind in ("padded", "mixed"):
        c[1, 6, 1] = np.nan          # row 6 >= m_valid 5: padding
        c[2, 0, 5] = np.inf          # col 5 >= n_valid 3: padding
        nu[3, 4] = -1.0              # row 4 >= m_valid 2: padding
        mu[1, 6] = np.nan            # col 6 >= n_valid 4: padding
    if kind in ("nan", "mixed"):
        c[0, 3, 2] = np.nan
        c[4, 5, 5] = -np.inf
    if kind in ("negative", "mixed"):
        nu[2, 1] = -0.25
        mu[5, 0] = np.nan
    if kind in ("imbalanced", "mixed"):
        nu[3] *= 1.5                 # |1.5 - 1| >> tol * 1.5
        mu[4] *= 0.5
    return {"c": c, "nu": nu, "mu": mu}, sizes


KINDS = ["padded", "nan", "negative", "imbalanced", "mixed"]


@pytest.mark.parametrize("with_sizes", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_admission_codes_equal_reference(kind, with_sizes):
    inputs, sizes = _admission_batch(kind, 3)
    sz = sizes if with_sizes else None
    for ins in (inputs, {"c": inputs["c"]}):
        ref = jV.admission_codes(ins, sizes=sz)
        got = tV.admission_codes(ins, sizes=sz)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    # and from tensors (the serving layers hand over device tensors)
    got_t = tV.admission_codes(
        {k: torch.as_tensor(v) for k, v in inputs.items()}, sizes=sz)
    np.testing.assert_array_equal(got_t, jV.admission_codes(inputs,
                                                            sizes=sz))


def test_admission_mixed_codes_are_the_expected_bits():
    inputs, sizes = _admission_batch("mixed", 3)
    codes = tV.admission_codes(inputs, sizes=sizes)
    # lane 2's negative weight also moves its total mass by > 0.25; lane
    # 5's NaN weight makes its sum NaN, which compares as balanced
    assert list(codes) == [tV.NONFINITE_COST, tV.OK,
                           tV.NEGATIVE_MASS | tV.MASS_IMBALANCE,
                           tV.MASS_IMBALANCE,
                           tV.NONFINITE_COST | tV.MASS_IMBALANCE,
                           tV.NEGATIVE_MASS]
    assert tV.describe(int(codes[4])) == jV.describe(int(codes[4]))
    assert tV.describe(0) == "ok"


@pytest.mark.parametrize("tol", [1e-3, 0.6])
def test_admission_tolerance_is_data(tol):
    """A loose tolerance admits the 1.5x lane; codes equal the reference's
    at both."""
    inputs, sizes = _admission_batch("imbalanced", 4)
    ref = jV.admission_codes(inputs, sizes=sizes, tol=tol)
    got = tV.admission_codes(inputs, sizes=sizes, tol=tol)
    np.testing.assert_array_equal(got, ref)
    assert bool(got[3]) == (tol < 0.5)


def test_check_admission_raises_like_reference():
    inputs, sizes = _admission_batch("mixed", 5)
    with pytest.raises(jV.RequestRejected) as je:
        jV.check_admission(inputs, sizes=sizes, who="lane")
    with pytest.raises(tV.RequestRejected) as te:
        tV.check_admission(inputs, sizes=sizes, who="lane")
    assert (te.value.who, te.value.code, te.value.reason) == (
        je.value.who, je.value.code, je.value.reason)
    assert str(te.value) == str(je.value)
    clean, csizes = _admission_batch("padded", 5)
    np.testing.assert_array_equal(
        tV.check_admission(clean, sizes=csizes), np.zeros(6, np.int32))


def test_validate_policy_gate_through_solve():
    """DispatchPolicy(validate=True) is all-or-nothing at the direct API,
    in both packages."""
    c = np.abs(np.random.default_rng(1).standard_normal((2, 5, 5)))
    c = c.astype(np.float32)
    bad = c.copy()
    bad[1, 0, 0] = np.inf
    tpol = tapi.DispatchPolicy(mode="compact", validate=True)
    sol = tapi.solve(tapi.ASSIGNMENT, {"c": c}, 0.1, tpol, want=("cost",),
                     device="cpu")
    ref = japi.solve(japi.ASSIGNMENT, {"c": c}, 0.1,
                     japi.DispatchPolicy(mode="compact", validate=True),
                     want=("cost",))
    # the f32 sums of the epilogue run in another order
    np.testing.assert_allclose(sol.cost(), np.asarray(ref.cost()),
                               rtol=1e-6)
    with pytest.raises(tV.RequestRejected) as e:
        tapi.solve(tapi.ASSIGNMENT, {"c": bad}, 0.1, tpol, want=("cost",),
                   device="cpu")
    assert e.value.code == tV.NONFINITE_COST
    with pytest.raises(tV.RequestRejected):
        tapi.solve(tapi.ASSIGNMENT, [bad[0], bad[1]], 0.1, tpol,
                   device="cpu")


# --------------------------------------------------------------------------
# the deadline cut
# --------------------------------------------------------------------------

def _deadline_batch(name: str, seed: int):
    rng = np.random.default_rng(seed)
    b, m = 3, 48
    c = np.abs(rng.standard_normal((b, m, m))).astype(np.float32)
    if name == "assignment":
        return {"c": c}
    return {"c": c,
            "nu": rng.dirichlet(np.ones(m), size=b).astype(np.float32),
            "mu": rng.dirichlet(np.ones(m), size=b).astype(np.float32)}


def _specs(name):
    return getattr(japi, name.upper()), getattr(tapi, name.upper())


def _want(name):
    """Certificates, the state, and what ``legacy_dict`` reads."""
    return ("cost", "duals", "state",
            "matching" if name == "assignment" else "plan")


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_past_deadline_cuts_after_one_chunk_like_reference(name):
    inputs = _deadline_batch(name, 13)
    jspec, tspec = _specs(name)
    want = _want(name)
    ref = japi.solve(jspec, inputs, 0.02,
                     japi.DispatchPolicy(mode="compact", chunk=1),
                     want=want, deadline=time.monotonic())
    got = tapi.solve(tspec, inputs, 0.02,
                     tapi.DispatchPolicy(mode="compact", chunk=1),
                     want=want, deadline=time.monotonic(), device="cpu")
    assert ref.stats.dispatches == got.stats.dispatches == 1
    assert ref.stats.deadline_hit and got.stats.deadline_hit
    np.testing.assert_array_equal(got.degraded(), np.asarray(ref.degraded()))
    assert got.degraded().all()
    assert_states_equal(ref.state(), got.state(), f"{name} cut")
    assert got.driver_stats.as_dict()["deadline_hit"] is True
    for i in range(len(got)):
        assert got[i].degraded and got[i].dual_feasible()
        assert got[i].legacy_dict()["degraded"] is True
        assert got[i].stats.as_dict()["deadline_hit"] is True


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_far_deadline_equals_no_deadline(name):
    inputs = _deadline_batch(name, 14)
    _, tspec = _specs(name)
    pol = tapi.DispatchPolicy(mode="compact", chunk=2)
    want = _want(name)
    far = tapi.solve(tspec, inputs, 0.05, pol, want=want,
                     deadline=time.monotonic() + 3600.0, device="cpu")
    none = tapi.solve(tspec, inputs, 0.05, pol, want=want, device="cpu")
    assert not far.degraded().any() and not far.stats.deadline_hit
    assert far.stats.dispatches == none.stats.dispatches
    np.testing.assert_array_equal(far.cost(), none.cost())
    for f in far.state()._fields:
        assert torch.equal(getattr(far.state(), f),
                           getattr(none.state(), f)), f
    assert "degraded" not in far[0].legacy_dict()


def test_deadline_cut_gap_dominates_converged_gap():
    inputs = _deadline_batch("ot", 15)
    pol = tapi.DispatchPolicy(mode="compact", chunk=1)
    want = ("cost", "duals", "plan")
    cut = tapi.solve(tapi.OT, inputs, 0.02, pol, want=want,
                     deadline=time.monotonic(), device="cpu")
    full = tapi.solve(tapi.OT, inputs, 0.02, pol, want=want, device="cpu")
    assert cut.stats.dispatches < full.stats.dispatches
    for i in range(len(cut)):
        assert cut[i].additive_gap() >= full[i].additive_gap()
        assert np.isfinite(cut[i].additive_gap())


def test_deadline_requires_chunked_driver():
    c = np.abs(np.random.default_rng(2).standard_normal((2, 6, 6)))
    with pytest.raises(ValueError, match="deadline"):
        tapi.dispatch(tapi.ASSIGNMENT, {"c": np.float32(c)}, 0.1,
                      policy=tapi.DispatchPolicy(mode="lockstep"),
                      deadline=time.monotonic() + 9.0, device="cpu")


def test_hybrid_deadline_bounds_both_stages():
    """A past deadline cuts the warm Sinkhorn stage and the push-relabel
    finish after one chunk each; the finish's certificate still holds."""
    inputs = _deadline_batch("ot", 16)
    pol = tapi.DispatchPolicy(mode="compact", chunk=1, solver="hybrid")
    sol = tapi.solve(tapi.OT, inputs, 0.02, pol, want=("cost", "duals"),
                     deadline=time.monotonic(), device="cpu")
    assert sol.stats.deadline_hit and sol.degraded().all()
    assert sol.stats.dispatches == 2        # one chunk of each stage
    assert sol.dual_feasible().all()


# --------------------------------------------------------------------------
# ragged wrappers, from_legacy, the public surface
# --------------------------------------------------------------------------

def _ragged(name, seed):
    rng = np.random.default_rng(seed)
    out = []
    for m, n in [(10, 12), (20, 20), (16, 30), (7, 7)]:
        x, y = rng.uniform(size=(m, 2)), rng.uniform(size=(n, 2))
        c = np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
        if name == "assignment":
            out.append(c)
        else:
            out.append((c, rng.dirichlet(np.ones(m)).astype(np.float32),
                        rng.dirichlet(np.ones(n)).astype(np.float32)))
    return out


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_ragged_wrappers_equal_reference(name, compact):
    insts = _ragged(name, 21)
    eps = [0.1, 0.2, 0.1, 0.3] if compact else 0.15
    kw = dict(compact=compact, chunk=3, guaranteed=True,
              buckets=(16, 32))
    ref = getattr(jbatched, f"solve_{name}_ragged")(insts, eps, **kw)
    got = getattr(tbatched, f"solve_{name}_ragged")(insts, eps, **kw,
                                                     device="cpu")
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key, rv in r.items():
            if key in ("cost", "plan", "y_b", "y_a"):
                np.testing.assert_allclose(np.asarray(g[key]),
                                           np.asarray(rv), rtol=1e-5,
                                           atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(np.asarray(g[key]),
                                              np.asarray(rv), err_msg=key)


@pytest.mark.parametrize("compact", [True, False])
def test_from_legacy_equals_reference(compact):
    kw = dict(chunk=4, buckets=[16, 64], guaranteed=True,
              want=["cost"], solver="sinkhorn")
    ref = japi.DispatchPolicy.from_legacy(compact, **kw)
    got = tapi.DispatchPolicy.from_legacy(compact, **kw)
    for f in ("mode", "chunk", "buckets", "guaranteed", "want", "solver",
              "placement", "validate"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.resolved_mode() == ref.resolved_mode()
    # fused: None, resolved per bucket; on the CPU it is the reference's
    assert got.fused is None
    assert got.fused_for(tapi.ASSIGNMENT, "cpu") == ref.fused


def test_from_legacy_mesh_rules():
    from repro_torch.launch.mesh import make_small_mesh

    mesh = make_small_mesh((2,), ("data",), devices="cpu")
    with pytest.raises(ValueError, match="compact=True"):
        tapi.DispatchPolicy.from_legacy(False, mesh=object())
    pol = tapi.DispatchPolicy.from_legacy(True, mesh=mesh)
    assert (pol.mode, pol.mesh, pol.resolved_mode()) == ("mesh", mesh,
                                                          "mesh")
    ref = japi.DispatchPolicy.from_legacy(True, mesh=object())
    assert (ref.mode, ref.resolved_mode()) == ("mesh", "mesh")
    assert tbatched.solve_ot_ragged([], 0.1, mesh=mesh, device="cpu") == []


# the names of multi-device dispatch (ROADMAP.md Queue 1
# item 11): core/distributed.py and the integer-input solvers
ITEM_11 = {"DistributedStats", "choose_placement",
           "solve_assignment_distributed", "solve_ot_distributed",
           "solve_assignment_int", "solve_ot_int"}


def test_core_all_is_reference_less_item_11():
    # item 11 is ported: the surface is now the reference's whole
    assert ITEM_11 <= set(tcore.__all__)
    assert set(tcore.__all__) == set(jcore.__all__)
    assert len(tcore.__all__) == len(set(tcore.__all__))
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name


def test_solve_stats_fields_are_reference_less_item_11():
    import dataclasses

    ref = {f.name for f in dataclasses.fields(jcore.SolveStats)}
    got = {f.name for f in dataclasses.fields(tcore.SolveStats)}
    # devices / placement / collapsed_at (mesh dispatch, item 11) ported
    assert {"devices", "placement", "collapsed_at"} <= got
    assert got == ref
