"""The port's sanitizer (``repro_torch.analysis.checked``), the
counterpart of ``tests/test_checkify.py``: poisoned inputs and corrupted
solver states raise a useful :class:`DebugCheckError` under
``set_debug_checks(True)``, and on clean inputs the checked route is a
pure no-op on results.

The reference's own checkify route is broken (``checkified.py`` fails
inside ``jax.vmap``), so it is no oracle: debug results are held against
the port's plain solves bit for bit and against the reference's PLAIN
solves (integer fields equal, floats within the parity tolerance of
``tests/test_torch_api.py``)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import set_debug_checks as jset_debug_checks
from repro.core import compaction as jc
from repro_torch.analysis import debug_checks_enabled, set_debug_checks
from repro_torch.analysis.checked import DebugCheckError, checked_spec_fns
from repro_torch.core import compaction as tc
from repro_torch.core import device as tdevice
from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve
from repro_torch.core.problem import FUSED_ASSIGNMENT, FUSED_OT
from repro_torch.kernels import ops
from repro_torch.portfolio.sinkhorn_spec import (
    SINKHORN,
    SINKHORN_KERNEL,
    _tiny_sinkhorn_batch,
)

COST = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def debug_checks():
    set_debug_checks(True)
    yield
    set_debug_checks(None)


@pytest.fixture
def plain_reference():
    """The reference's plain route, whatever REPRO_DEBUG_CHECKS says."""
    jset_debug_checks(False)
    yield
    jset_debug_checks(None)


def _rand(b=4, mn=8, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.random((b, mn, mn)).astype(np.float32)
    nu = np.full((b, mn), 1.0 / mn, np.float32)
    mu = np.full((b, mn), 1.0 / mn, np.float32)
    return c, nu, mu


def _inputs(name, seed=0):
    c, nu, mu = _rand(seed=seed)
    return {"c": c} if name == "assignment" else {"c": c, "nu": nu,
                                                  "mu": mu}


def _solve(spec, inputs, eps, debug: bool, **policy):
    """A compacting solve through the front door, one phase a chunk (so
    the checks run between many chunks), with the final integer state
    kept; debug checks pinned on or off around it."""
    set_debug_checks(debug)
    try:
        sols = solve(spec, inputs, eps, DispatchPolicy(chunk=1, **policy),
                     want=("cost", "duals", "state"), device="cpu")
    finally:
        set_debug_checks(None)
    return sols


def _assert_same(a, b):
    """Two SolutionBatches equal bit for bit: integer state, cost, duals."""
    np.testing.assert_array_equal(a.cost(), b.cost())
    for x, y in zip(a.duals(), b.duals()):
        np.testing.assert_array_equal(x, y)
    sa, sb = a.state(), b.state()
    for f in sa._fields:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f


# --------------------------------------------------------------------------
# Clean inputs: debug mode is a pure no-op on results
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_debug_mode_bit_identical(name, fused):
    spec = ASSIGNMENT if name == "assignment" else OT
    eps = 0.1 if name == "assignment" else 0.25
    inputs = _inputs(name)
    plain = _solve(spec, inputs, eps, False, fused=fused)
    dbg = _solve(spec, inputs, eps, True, fused=fused)
    _assert_same(plain, dbg)
    assert dbg.stats.dispatches == plain.stats.dispatches > 1


@pytest.mark.parametrize("fused", [False, True])
def test_debug_mode_sinkhorn_equals_stepped(fused):
    """Sinkhorn under the checks runs the stepped spec (the row kernel's
    spec routes to it): bit-identical to the plain stepped solve."""
    inputs = _inputs("ot", seed=1)
    plain = _solve(OT, inputs, 0.25, False, solver="sinkhorn")
    dbg = _solve(OT, inputs, 0.25, True, solver="sinkhorn", fused=fused)
    _assert_same(plain, dbg)


def test_debug_mode_equals_reference_plain(plain_reference, debug_checks):
    c, nu, mu = _rand(seed=2)
    ja, _ = jc.solve_assignment_batched_compacting(c, 0.1, k=3)
    ta, _ = tc.solve_assignment_batched_compacting(c, 0.1, k=3,
                                                   device="cpu")
    jo, _ = jc.solve_ot_batched_compacting(c, nu, mu, 0.25, k=3)
    to, _ = tc.solve_ot_batched_compacting(c, nu, mu, 0.25, k=3,
                                           device="cpu")
    np.testing.assert_array_equal(ta.matching.numpy(),
                                  np.asarray(ja.matching))
    for ref, got in ((ja, ta), (jo, to)):
        for f in ("phases", "rounds"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                                   **COST)
    for f in jo.state._fields:
        np.testing.assert_array_equal(getattr(to.state, f).numpy(),
                                      np.asarray(getattr(jo.state, f)),
                                      err_msg=f)


def test_one_debug_read_per_chunk(debug_checks):
    """One counted "debug" read per chunk, plus one each for the
    prologue's and the epilogue's checks; the driver's own chunk reads
    are unchanged."""
    for spec, inputs, eps in ((ASSIGNMENT, _inputs("assignment"), 0.1),
                              (OT, _inputs("ot"), 0.25)):
        tdevice.reset_sync_counts()
        _, stats = tc.solve_compacting(spec, inputs, eps, k=1, device="cpu")
        assert stats.dispatches > 1
        assert tdevice.sync_counts["chunk"] == stats.dispatches
        assert tdevice.sync_counts["debug"] == stats.dispatches + 2


def test_fused_specs_route_through_stepped(monkeypatch):
    assert checked_spec_fns(FUSED_ASSIGNMENT, 3) is checked_spec_fns(
        ASSIGNMENT, 3)
    assert checked_spec_fns(FUSED_OT, 3) is checked_spec_fns(OT, 3)
    assert checked_spec_fns(SINKHORN_KERNEL, 3) is checked_spec_fns(
        SINKHORN, 3)

    def boom(*a, **kw):
        raise AssertionError("a fused kernel ran under the debug checks")

    monkeypatch.setattr(ops, "fused_run_assignment_phases", boom)
    monkeypatch.setattr(ops, "fused_run_ot_phases", boom)
    monkeypatch.setattr(ops, "sinkhorn_row_update", boom)
    _solve(ASSIGNMENT, _inputs("assignment"), 0.1, True, fused=True)
    _solve(OT, _inputs("ot"), 0.25, True, fused=True)
    _solve(OT, _inputs("ot"), 0.25, True, fused=True, solver="sinkhorn")


# --------------------------------------------------------------------------
# NaN-poisoned cost matrices
# --------------------------------------------------------------------------

def test_nan_cost_raises_assignment(debug_checks):
    c, _, _ = _rand()
    c[1, 2, 3] = np.nan
    with pytest.raises(DebugCheckError, match="nan") as e:
        tc.solve_assignment_batched_compacting(c, 0.1, k=3, device="cpu")
    assert (e.value.check, e.value.lane) == ("finite-cost", 1)


def test_nan_cost_raises_ot(debug_checks):
    c, nu, mu = _rand()
    c[0, 0, 0] = np.nan
    with pytest.raises(DebugCheckError, match="nan") as e:
        tc.solve_ot_batched_compacting(c, nu, mu, 0.25, k=3, device="cpu")
    assert e.value.lane == 0


def test_nan_mass_raises_ot(debug_checks):
    c, nu, mu = _rand()
    nu[2, 5] = np.nan
    with pytest.raises(DebugCheckError, match="nan") as e, \
            np.errstate(invalid="ignore"):
        tc.solve_ot_batched_compacting(c, nu, mu, 0.25, k=3, device="cpu")
    assert (e.value.check, e.value.lane) == ("finite-mass", 2)


def test_nan_outside_the_valid_block_is_not_flagged(debug_checks):
    """Padding is exempt: a NaN beyond an instance's size never reaches
    the solve."""
    c, _, _ = _rand()
    c[0, 7, 7] = np.nan
    sizes = np.array([[6, 6]] + [[8, 8]] * 3, np.int32)
    r, _ = tc.solve_assignment_batched_compacting(c, 0.1, sizes=sizes, k=3,
                                                  device="cpu")
    assert np.isfinite(r.cost.numpy()).all()


def test_nan_cost_silent_without_debug():
    """The plain path stays numerically silent: that asymmetry is the
    reason the sanitizer exists. The checks are pinned OFF (not the env
    default), so the test holds under REPRO_DEBUG_CHECKS=1 too."""
    c, _, _ = _rand()
    c[1, 2, 3] = np.nan
    set_debug_checks(False)
    try:
        r, _ = tc.solve_assignment_batched_compacting(c, 0.1, k=3,
                                                      device="cpu")
    finally:
        set_debug_checks(None)
    assert r.cost.shape == (4,)   # no exception


# --------------------------------------------------------------------------
# Corrupted solver state (the invariant checks)
# --------------------------------------------------------------------------

def test_out_of_range_matching_index_raises():
    _, _, data, state = tc._tiny_batch("assignment")
    bad = state._replace(match_ba=torch.full_like(state.match_ba, 99))
    _, _, chunk, _, _ = checked_spec_fns(ASSIGNMENT, 2)
    with pytest.raises(DebugCheckError, match="matching index out of range"):
        chunk(data, bad)


def test_negative_free_mass_raises():
    _, _, data, state = tc._tiny_batch("ot")
    bad = state._replace(free_b=torch.full_like(state.free_b, -5))
    _, _, chunk, _, _ = checked_spec_fns(OT, 2)
    with pytest.raises(DebugCheckError, match="negative free mass"):
        chunk(data, bad)


def test_negative_flow_names_its_lane():
    _, _, data, state = tc._tiny_batch("ot")
    f_lo = state.f_lo.clone()
    f_lo[1, 0, 2] = -1
    _, _, chunk, _, _ = checked_spec_fns(OT, 2)
    with pytest.raises(DebugCheckError, match="negative flow") as e:
        chunk(data, state._replace(f_lo=f_lo))
    assert (e.value.check, e.value.lane) == ("flow", 1)


def test_non_finite_sinkhorn_potentials_raise():
    _, _, data, state = _tiny_sinkhorn_batch()
    bad = state._replace(f=torch.full_like(state.f, float("nan")))
    _, _, chunk, _, _ = checked_spec_fns(SINKHORN, 2)
    with pytest.raises(DebugCheckError,
                       match="non-finite Sinkhorn potentials"):
        chunk(data, bad)
    data = {**data, "reg": -data["reg"]}
    with pytest.raises(DebugCheckError,
                       match="non-positive Sinkhorn regularization"):
        chunk(data, state)


def test_clean_state_passes_invariants():
    for name, spec in (("assignment", ASSIGNMENT), ("ot", OT)):
        _, _, data, state = tc._tiny_batch(name)
        _, _, chunk, _, _ = checked_spec_fns(spec, 2)
        out = chunk(data, state)      # must not raise
        assert out.phases.shape == state.phases.shape
    _, _, data, state = _tiny_sinkhorn_batch()
    out = checked_spec_fns(SINKHORN, 2)[2](data, state)
    assert out.phases.shape == state.phases.shape


# --------------------------------------------------------------------------
# The env-var switch
# --------------------------------------------------------------------------

def test_env_var_enables_debug(monkeypatch):
    set_debug_checks(None)
    monkeypatch.setenv("REPRO_DEBUG_CHECKS", "1")
    assert debug_checks_enabled()
    monkeypatch.setenv("REPRO_DEBUG_CHECKS", "0")
    assert not debug_checks_enabled()
    monkeypatch.setenv("REPRO_DEBUG_CHECKS", "off")
    assert not debug_checks_enabled()
    monkeypatch.setenv("REPRO_DEBUG_CHECKS", "1")
    set_debug_checks(False)           # the override wins over the env
    try:
        assert not debug_checks_enabled()
    finally:
        set_debug_checks(None)


def test_env_var_routes_the_driver(monkeypatch):
    monkeypatch.setenv("REPRO_DEBUG_CHECKS", "1")
    c, _, _ = _rand()
    c[3, 0, 0] = np.nan
    with pytest.raises(DebugCheckError, match="nan"):
        tc.solve_assignment_batched_compacting(c, 0.1, k=3, device="cpu")
