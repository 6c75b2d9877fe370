"""repro_torch's solver portfolio held against the reference on the CPU:
the Sinkhorn row update (plain version against the Pallas kernel in
interpret mode and against the reference's jnp update), the AWR schedule,
the Sinkhorn stepped core chunk by chunk, ``solve(..., solver="sinkhorn")``,
the hybrid's dual rounding and warm-started finish, the cost model behind
``solver="auto"``, and the ``core/sinkhorn`` baseline. The CUDA kernel
against the plain version: tests/test_torch_cuda.py.

Tolerances, with their reasons:

* ``ROW``: rtol = atol = 1e-5, the reference's own for its row kernel
  against its jnp update; both evaluate one logsumexp in another order.
* ``FLOAT``: rtol 1e-5, atol 1e-6 on potentials, costs and certificates
  of whole solves: the batched PyTorch reductions and XLA's sum in
  another order, and the Sinkhorn iteration contracts such differences
  instead of growing them.
* plan marginals: atol 2e-6, the reference's own (AWR rounding puts the
  plan on the transport polytope up to f32 sums).
* Integer state (``round_duals``, the warm push-relabel finish): exact.

Iteration counts: a lane stops at the first iteration where its f32 error
is <= tol. Two implementations whose sums run in another order may see
that crossing one iteration apart when the error lands within f32 noise
of tol; ``_assert_phases`` allows exactly that and nothing else.
"""
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import api as japi
from repro.core.compaction import spec_fns
from repro.core.sinkhorn import (
    reg_for_additive_eps as jreg_for_additive_eps,
    sinkhorn as jsinkhorn,
    sinkhorn_marginal_tolerance as jsinkhorn_marginal_tolerance,
)
from repro.kernels import ops as jops
from repro.portfolio import hybrid as jhybrid
from repro.portfolio import sinkhorn_spec as jspec
from repro_torch.core import api as tapi
from repro_torch.core import device as tdevice
# the module: repro_torch.core re-exports the function under its name,
# as repro.core does
tsink = importlib.import_module("repro_torch.core.sinkhorn")
from repro_torch.core.compaction import solve_compacting
from repro_torch.core.feasibility import check_ot_invariants
from repro_torch.core.problem import OT, fused_variant
from repro_torch.kernels import ops
from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref
from repro_torch.portfolio import costmodel as tcm
from repro_torch.portfolio import hybrid as thybrid
from repro_torch.portfolio import sinkhorn_spec as tspec
from repro_torch.portfolio import (
    SINKHORN,
    SINKHORN_KERNEL,
    WARM_OT,
    CostModel,
    fit,
    get_model,
    set_model,
)

from _torch_parity import B, SIZES, assert_states_equal, batch

ROW = dict(rtol=1e-5, atol=1e-5)
FLOAT = dict(rtol=1e-5, atol=1e-6)
MARGINAL = dict(atol=2e-6)


@pytest.fixture(autouse=True)
def _no_cost_model():
    """Every test starts without an installed model and leaves none."""
    set_model(None)
    yield
    set_model(None)


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _assert_phases(jph, tph, jerr, terr, tol, where=""):
    """Equal iteration counts, or one apart on a lane whose error at the
    earlier stop sat within f32 noise (1e-5 relative) of tol."""
    jph, tph = np.asarray(jph), np.asarray(tph)
    for i in np.flatnonzero(jph != tph):
        early = np.asarray(jerr if jph[i] < tph[i] else terr)[i]
        assert abs(int(jph[i]) - int(tph[i])) == 1, (where, i)
        assert abs(float(early) - float(np.asarray(tol)[i])) <= \
            1e-5 * float(np.asarray(tol)[i]), (where, i)


# --------------------------------------------------------------------------
# the row update
# --------------------------------------------------------------------------

def _row_inputs(seed, b, m, n, ragged):
    """Per-lane reg from eps in {0.3, 0.1, 0.05, 0.03}; ragged lanes hold
    cost 0 and zero mass outside their valid block, as the spec's prepare
    leaves them; the last lane has zero mass (log_nu at the floor)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (b, m, n)).astype(np.float32)
    nu = rng.dirichlet(np.ones(m), b).astype(np.float32)
    g = rng.normal(0.0, 0.2, (b, n)).astype(np.float32)
    if ragged:
        for i in range(b):
            mi, ni = m - 3 * i, n - 5 * i
            c[i, mi:, :] = 0.0
            c[i, :, ni:] = 0.0
            nu[i, mi:] = 0.0
    nu[-1] = 0.0
    nu_hat = nu / np.maximum(nu.sum(1, keepdims=True), 1e-30)
    log_nu = np.log(np.maximum(nu_hat, 1e-30)).astype(np.float32)
    eps = np.array([0.3, 0.1, 0.05, 0.03] * b)[:b]
    reg = (eps / (4 * np.log(max(m, n)))).astype(np.float32)
    return c, g, log_nu, reg


@pytest.mark.parametrize("b,m,n,ragged", [(3, 24, 40, False),
                                          (4, 33, 130, True)])
def test_row_update_plain_vs_reference(b, m, n, ragged):
    """The plain version (and the stepped spec's logsumexp update) against
    the reference's Pallas kernel in interpret mode and its jnp update,
    lane by lane."""
    c, g, log_nu, reg = _row_inputs(b * m + n, b, m, n, ragged)
    plain = sinkhorn_row_ref(*_t(c, g, log_nu, reg)).numpy()
    stepped = tspec._row_update_torch(*_t(c, g, log_nu, reg)).numpy()
    assert np.isfinite(plain).all()
    for i in range(b):
        args = (jnp.asarray(c[i]), jnp.asarray(g[i]),
                jnp.asarray(log_nu[i]), jnp.float32(reg[i]))
        pallas = np.asarray(jops.sinkhorn_row_update(*args))
        jnp_ref = np.asarray(jspec._row_update_jnp(*args))
        np.testing.assert_allclose(plain[i], pallas, **ROW)
        np.testing.assert_allclose(plain[i], jnp_ref, **ROW)
        np.testing.assert_allclose(stepped[i], jnp_ref, **ROW)


def test_row_update_wrapper_on_cpu_masks_lanes():
    """On CPU tensors the wrapper is the plain version; lanes that
    ``active_b`` marks off keep ``f``, and ``active_b`` without ``f`` is
    refused."""
    c, g, log_nu, reg = _t(*_row_inputs(5, 3, 16, 21, False))
    f_old = torch.full((3, 16), 7.0)
    active = torch.tensor([True, False, True])
    before = dict(ops.launches)
    out = ops.sinkhorn_row_update(c, g, log_nu, reg, active_b=active,
                                  f=f_old)
    assert ops.launches == before
    plain = sinkhorn_row_ref(c, g, log_nu, reg)
    assert torch.equal(out[0], plain[0]) and torch.equal(out[2], plain[2])
    assert torch.equal(out[1], f_old[1])
    assert torch.equal(ops.sinkhorn_row_update(c, g, log_nu, reg), plain)
    with pytest.raises(ValueError, match="needs f"):
        ops.sinkhorn_row_update(c, g, log_nu, reg, active_b=active)


def test_row_update_underflowing_row_stays_finite():
    """Every term of a row underflows exp in f32 (reg 1e-6 against costs
    up to 5); the online logsumexp keeps f finite and equal to the float64
    value to f32 precision."""
    rng = np.random.default_rng(3)
    c = rng.uniform(4.0, 5.0, (2, 3, 50)).astype(np.float32)
    g = np.zeros((2, 50), np.float32)
    log_nu = np.full((2, 3), np.log(np.float32(1e-30)), np.float32)
    reg = np.array([1e-6, 1e-3], np.float32)
    out = sinkhorn_row_ref(*_t(c, g, log_nu, reg)).numpy()
    c64, r64 = c.astype(np.float64), reg.astype(np.float64)[:, None, None]
    z = -c64 / r64
    zmax = z.max(axis=2, keepdims=True)
    lse = (zmax + np.log(np.exp(z - zmax).sum(axis=2, keepdims=True)))[..., 0]
    want = r64[:, :, 0] * (log_nu - lse)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=1e-5)


# --------------------------------------------------------------------------
# the schedule and the stepped core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("max_iters", [None, 50])
def test_sinkhorn_schedule_equals_reference(max_iters):
    eps = np.array([0.3, 0.1, 0.05, 0.01, 1e-6])
    m = np.array([16, 1, 300, 4096, 16])
    n = np.array([16, 2, 20, 4096, 16])
    got = tspec.sinkhorn_schedule(eps, m, n, max_iters)
    ref = jspec.sinkhorn_schedule(eps, m, n, max_iters)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(a, r)


def _prepared(inputs, eps, sizes):
    """The same prepared batch in both packages: (reference data, state,
    port data, state)."""
    jin = jspec.SINKHORN.canonicalize(inputs)
    p = jspec.SINKHORN.prepare(jin, eps, sizes=sizes)
    prologue, init, _, _, _ = spec_fns(jspec.SINKHORN, 1)
    jops_ = {kk: jnp.asarray(v) for kk, v in p.ops.items()}
    jdata, jctx = prologue(jops_)
    jstate = init(jdata, jctx)
    tin = SINKHORN.canonicalize(inputs, "cpu")
    tp = SINKHORN.prepare(tin, eps, sizes=sizes)
    np.testing.assert_array_equal(tp.phase_cap, p.phase_cap)
    tdata, tctx = SINKHORN.prologue(tp.ops)
    for kk in ("c_hat", "log_nu", "log_mu", "nu_hat", "reg", "tol"):
        np.testing.assert_allclose(tdata[kk].numpy(), np.asarray(jdata[kk]),
                                   **FLOAT, err_msg=kk)
    return jdata, jstate, tdata, SINKHORN.init_state(tdata, tctx)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_run_phases_chunks_match_reference(k):
    """The port's batched run_phases against the reference's vmapped chunk
    at every k-iteration boundary, to convergence: f, g and err within
    FLOAT, phases equal (or as ``_assert_phases`` allows)."""
    inputs = batch("ot", 11, SIZES)
    eps = np.array([0.3, 0.2, 0.25, 0.15])
    jdata, jstate, tdata, tstate = _prepared(inputs, eps, SIZES)
    _, _, chunk, conv, _ = spec_fns(jspec.SINKHORN, k)
    for i in range(10_000):
        _assert_phases(jstate.phases, tstate.phases.numpy(), jstate.err,
                       tstate.err.numpy(), jdata["tol"], f"chunk {i}")
        same = np.asarray(jstate.phases) == tstate.phases.numpy()
        for f in ("f", "g", "err"):
            np.testing.assert_allclose(
                getattr(tstate, f).numpy()[same],
                np.asarray(getattr(jstate, f))[same], **FLOAT,
                err_msg=f"chunk {i} field {f}")
        jconv, _ = conv(jdata, jstate)
        tconv = SINKHORN.converged(tdata, tstate).numpy()
        if bool(np.asarray(jconv).all()) and tconv.all():
            assert i > 0
            return
        jstate = chunk(jdata, jstate)
        tstate = SINKHORN.run_phases(tdata, tstate, k)
    raise AssertionError("no convergence")


def test_chunks_resumable_bit_identical():
    """k = 3 and k = 512 give the same result bit for bit: lanes that stop
    keep their state, whatever the chunking."""
    inputs = batch("ot", 7, SIZES)
    eps = np.array([0.3, 0.2, 0.25, 0.15])
    r3, _ = solve_compacting(SINKHORN, inputs, eps, sizes=SIZES, k=3,
                             device="cpu")
    r512, _ = solve_compacting(SINKHORN, inputs, eps, sizes=SIZES, k=512,
                               device="cpu")
    for f, a, b in zip(r3._fields, r3, r512):
        assert torch.equal(a, b), f


def test_run_phases_respects_k_and_cap():
    m = n = 8
    rng = np.random.default_rng(16)
    c_hat = torch.as_tensor(rng.uniform(0, 1, (1, m, n)), dtype=torch.float32)
    log_nu = torch.full((1, m), -float(np.log(m)))
    log_mu = torch.full((1, n), -float(np.log(n)))
    nu_hat = torch.full((1, m), 1.0 / m)
    st = tspec.SinkhornState(f=torch.zeros(1, m), g=torch.zeros(1, n),
                             err=torch.full((1,), float("inf")),
                             phases=torch.zeros(1, dtype=torch.int32))
    reg, tol = torch.tensor([0.05]), torch.tensor([1e-9])
    out = tspec.run_sinkhorn_phases(c_hat, log_nu, log_mu, nu_hat, reg, tol,
                                    torch.tensor([1000], dtype=torch.int32),
                                    st, 4)
    assert int(out.phases) == 4           # chunk budget
    out2 = tspec.run_sinkhorn_phases(c_hat, log_nu, log_mu, nu_hat, reg,
                                     tol,
                                     torch.tensor([6], dtype=torch.int32),
                                     out, 100)
    assert int(out2.phases) == 6          # AWR cap wins over k


def test_lockstep_stops_when_lanes_converge():
    """Lockstep passes k = cap + 1 (millions of iterations at small eps);
    the loop stops at its first check after the last lane converged, with
    one host read per ``_CHECK_EVERY`` iterations."""
    inputs = batch("ot", 5, None)
    tspec.reset_counts()
    tdevice.reset_sync_counts()
    r, _ = SINKHORN.solve_lockstep(inputs, 0.05, device="cpu")
    iters = int(r.phases.max())
    cap = SINKHORN._lockstep_k(np.full(B, 0.05), 32) - 1
    assert iters < cap // 100
    ran = tspec.counts["f_updates"]
    assert iters <= ran < iters + tsink._CHECK_EVERY
    assert tdevice.sync_counts["sinkhorn"] == ran // tsink._CHECK_EVERY


# --------------------------------------------------------------------------
# solve(..., solver="sinkhorn") against the reference
# --------------------------------------------------------------------------

def _instances(inputs, sizes):
    return [(inputs["c"][i, :mi, :ni], inputs["nu"][i, :mi],
             inputs["mu"][i, :ni]) for i, (mi, ni) in enumerate(sizes)]


def _arrays(sols):
    """Per-instance numbers of a SolutionBatch or of a list of Solution
    views (either package); ``err`` is read from the batched result, which
    the Solution surface does not expose."""
    if not isinstance(sols, list):
        sols = list(sols)
    out = {f: np.array([float(getattr(s, f)()) for s in sols])
           for f in ("dual_objective", "additive_gap", "additive_gap_bound")}
    out["dual_feasible"] = np.array([bool(s.dual_feasible()) for s in sols])
    out["cost"] = np.array([float(s.cost) for s in sols])
    out["phases"] = np.array([int(s.phases) for s in sols])
    out["err"] = np.array([float(np.asarray(s._b._r.err)[s._j])
                           for s in sols])
    out["duals"] = [s.duals() for s in sols]
    out["plan"] = [np.asarray(s.plan()) for s in sols]
    return out


@pytest.mark.parametrize("form", ["dict", "ragged"])
@pytest.mark.parametrize("mode", ["compact", "lockstep"])
def test_solve_sinkhorn_matches_reference(mode, form):
    """``solve(OT, ..., solver="sinkhorn")`` against the reference's:
    iteration counts, costs, duals and certificates within FLOAT, plan
    marginals within MARGINAL, on a ragged batch (per-instance eps where
    the mode takes it)."""
    inputs = batch("ot", 21, SIZES)
    eps = np.array([0.1, 0.2, 0.15, 0.1]) if mode == "compact" else 0.15
    want = ("cost", "duals", "plan", "stats")
    if form == "dict":
        src, kw = inputs, dict(sizes=SIZES)
    else:
        src, kw = _instances(inputs, SIZES), {}
    ref = japi.solve(japi.OT, src, eps, japi.DispatchPolicy(
        mode=mode, solver="sinkhorn"), want=want, **kw)
    got = tapi.solve(tapi.OT, src, eps, tapi.DispatchPolicy(
        mode=mode, solver="sinkhorn"), want=want, device="cpu", **kw)
    if form == "dict":
        assert got.stats.solver == ref.stats.solver == "sinkhorn"
    r, g = _arrays(ref), _arrays(got)
    tol = np.broadcast_to(np.asarray(eps, np.float64) / 8, (B,))
    _assert_phases(r["phases"], g["phases"], r["err"], g["err"], tol)
    same = r["phases"] == g["phases"]
    for f in ("cost", "err", "dual_objective", "additive_gap",
              "additive_gap_bound"):
        np.testing.assert_allclose(g[f][same], r[f][same], **FLOAT,
                                   err_msg=f)
    for j in np.flatnonzero(same):
        for a, b in zip(g["duals"][j], r["duals"][j]):
            np.testing.assert_allclose(a, np.asarray(b), **FLOAT)
    np.testing.assert_array_equal(g["dual_feasible"], r["dual_feasible"])
    assert g["dual_feasible"].all()
    assert (g["additive_gap"] <= g["additive_gap_bound"] + 1e-6).all()
    for j, (mi, ni) in enumerate(SIZES):
        plan = g["plan"][j].astype(np.float64)
        np.testing.assert_allclose(plan.sum(1)[:mi], inputs["nu"][j, :mi],
                                   **MARGINAL)
        np.testing.assert_allclose(plan.sum(0)[:ni], inputs["mu"][j, :ni],
                                   **MARGINAL)


def test_sinkhorn_padded_lane_regression():
    """Padded rows/cols of a ragged lane carry no plan mass and a finite
    cost (a subnormal log floor once made them -inf -> NaN); the port
    equals the reference there."""
    from repro.core.compaction import solve_compacting as jsolve_compacting

    b, mb, nb, m, n = 1, 16, 16, 10, 12
    rng = np.random.default_rng(2)
    c = np.zeros((b, mb, nb), np.float32)
    c[0, :m, :n] = rng.uniform(0.1, 1.0, (m, n))
    nu = np.zeros((b, mb), np.float32)
    nu[0, :m] = 1.0 / m
    mu = np.zeros((b, nb), np.float32)
    mu[0, :n] = 1.0 / n
    inputs = {"c": c, "nu": nu, "mu": mu}
    sizes = np.array([[m, n]], np.int32)
    r, _ = solve_compacting(SINKHORN, inputs, 0.3, sizes=sizes, device="cpu")
    jr, _ = jsolve_compacting(jspec.SINKHORN, inputs, 0.3, sizes=sizes)
    assert torch.isfinite(r.cost).all()
    plan = r.plan[0].double().numpy()
    assert plan[m:, :].sum() + plan[:, n:].sum() < 1e-6
    np.testing.assert_allclose(plan.sum(1)[:m], nu[0, :m], **MARGINAL)
    np.testing.assert_array_equal(r.phases.numpy(), np.asarray(jr.phases))
    np.testing.assert_allclose(r.cost.numpy(), np.asarray(jr.cost), **FLOAT)
    np.testing.assert_allclose(r.plan.numpy(), np.asarray(jr.plan),
                               **MARGINAL)


def test_kernel_spec_on_cpu_equals_stepped_spec():
    """SINKHORN_KERNEL runs the row kernel's plain version on the CPU; it
    evaluates the same logsumexp in another order, so the results agree
    within FLOAT and the iteration counts as ``_assert_phases`` allows."""
    assert fused_variant(SINKHORN) is SINKHORN_KERNEL
    assert SINKHORN_KERNEL.stepped is SINKHORN
    assert fused_variant(SINKHORN_KERNEL) is SINKHORN_KERNEL
    inputs = batch("ot", 9, SIZES)
    eps = np.array([0.3, 0.2, 0.25, 0.15])
    rs, _ = solve_compacting(SINKHORN, inputs, eps, sizes=SIZES,
                             device="cpu")
    rk, _ = solve_compacting(SINKHORN_KERNEL, inputs, eps, sizes=SIZES,
                             device="cpu")
    _assert_phases(rs.phases.numpy(), rk.phases.numpy(), rs.err.numpy(),
                   rk.err.numpy(), eps / 8)
    same = (rs.phases == rk.phases).numpy()
    for f in ("cost", "y_b", "y_a"):
        np.testing.assert_allclose(getattr(rk, f).numpy()[same],
                                   getattr(rs, f).numpy()[same], **FLOAT,
                                   err_msg=f)


def test_fused_sinkhorn_routes_every_f_update_through_the_wrapper(
        monkeypatch):
    calls = {"n": 0}
    real = ops.sinkhorn_row_update

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ops, "sinkhorn_row_update", counted)
    inputs = batch("ot", 4, SIZES)
    tspec.reset_counts()
    sol = tapi.solve(tapi.OT, inputs, 0.2, tapi.DispatchPolicy(
        solver="sinkhorn", fused=True), sizes=SIZES, want=("cost", "stats"),
        device="cpu")
    assert calls["n"] == tspec.counts["f_updates"] > 0
    assert calls["n"] >= int(sol.phases().max())
    # the stepped spec never calls the row kernel's wrapper
    n_fused = calls["n"]
    tspec.reset_counts()
    tapi.solve(tapi.OT, inputs, 0.2, tapi.DispatchPolicy(solver="sinkhorn"),
               sizes=SIZES, device="cpu")
    assert calls["n"] == n_fused and tspec.counts["f_updates"] > 0


# --------------------------------------------------------------------------
# hybrid
# --------------------------------------------------------------------------

def _boundary_case():
    """A lane whose row minimum sits where floor((c / scale) / eps) and
    floor(c / (scale * eps)) differ in f32 (the eager formula gives 13,
    the jitted program 14)."""
    s, eps, v = np.float32(0.7718125), np.float32(0.05), np.float32(0.5016781)
    c = np.full((1, 3, 4), v, np.float32)
    c[0, 0, 0] = s
    return (c, np.full((1, 4), 0.25, np.float32),
            np.full((1, 3), 5.0, np.float32), np.zeros((1, 4), np.float32),
            np.array([eps], np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_duals_equals_jitted_reference(seed):
    """Integer-exact against the reference's jitted round_duals on the
    same numpy (c, mu, f, g, eps), including a lane without live demand
    and columns without demand."""
    rng = np.random.default_rng(seed)
    b, m, n = 4, 24, 32
    c = rng.uniform(0.0, 1.0, (b, m, n)).astype(np.float32)
    mu = rng.dirichlet(np.ones(n), b).astype(np.float32)
    mu[:, -3:] = 0.0
    mu[1] = 0.0
    f = (rng.normal(0.0, 0.3, (b, m)) + seed).astype(np.float32)
    g = rng.normal(0.0, 0.3, (b, n)).astype(np.float32)
    eps = np.array([0.2 / 3, 0.1, 0.05, 0.1 / 3], np.float32)
    for args in ((c, mu, f, g, eps), _boundary_case()):
        ref = np.asarray(jhybrid.round_duals(*map(jnp.asarray, args)))
        got = thybrid.round_duals(*_t(*args))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_round_duals_boundary_follows_the_jitted_program():
    args = _boundary_case()
    with jax.disable_jit():
        eager = np.asarray(jhybrid._round_duals_one(
            *(jnp.asarray(a[0]) for a in args)))
    jitted = np.asarray(jhybrid.round_duals(*map(jnp.asarray, args)))[0]
    assert eager.tolist() == [13, 13, 13] and jitted.tolist() == [14, 14, 14]
    assert thybrid.round_duals(*_t(*args))[0].tolist() == jitted.tolist()


@pytest.mark.parametrize("k", [1, 4])
def test_warm_ot_matches_reference_state_at_every_chunk(k):
    """WARM_OT fed the reference's own y_b0 (its jitted stage 1 and
    rounding) reproduces the reference's integer state at every k-phase
    chunk boundary."""
    inputs = batch("ot", 13, SIZES)
    eps = np.array([0.1, 0.2, 0.15, 0.1])
    jin = jhybrid.WARM_OT.canonicalize(inputs)
    from repro.core.compaction import solve_compacting as jsc

    _, st1 = jsc(jspec.SINKHORN, jin, np.maximum(eps, jhybrid._COARSE_EPS),
                 sizes=SIZES, keep_state=True, max_iters=jhybrid._WARM_ITERS)
    y_b0 = np.asarray(jhybrid.round_duals(
        jin["c"], jin["mu"], st1.final_state.f, st1.final_state.g,
        jnp.asarray(eps, jnp.float32)))
    assert (y_b0 > 1).any()   # the warm start is not the cold one

    p = jhybrid.WARM_OT.prepare(jin, eps, sizes=SIZES, y_b0=y_b0)
    prologue, init, chunk, conv, _ = spec_fns(jhybrid.WARM_OT, k)
    jops_ = {kk: jnp.asarray(v) for kk, v in p.ops.items()}
    jdata, jctx = prologue(jops_)
    jctx = {**jctx, **{kk: jops_[kk] for kk in jhybrid.WARM_OT.ctx_ops}}
    jstate = init(jdata, jctx)

    tin = WARM_OT.canonicalize(inputs, "cpu")
    tp = WARM_OT.prepare(tin, eps, sizes=SIZES, y_b0=y_b0)
    np.testing.assert_array_equal(tp.threshold, p.threshold)
    tdata, tctx = WARM_OT.prologue(tp.ops)
    tctx = {**tctx, **{kk: tp.ops[kk] for kk in WARM_OT.ctx_ops}}
    tstate = WARM_OT.init_state(tdata, tctx)
    for i in range(10_000):
        assert_states_equal(jstate, tstate, f"chunk {i}")
        if bool(np.asarray(conv(jdata, jstate)[0]).all()):
            assert WARM_OT.converged(tdata, tstate).all()
            return
        jstate = chunk(jdata, jstate)
        tstate = WARM_OT.run_phases(tdata, tstate, k)
    raise AssertionError("no convergence")


def test_warm_state_passes_the_invariant_checks():
    inputs = batch("ot", 1, SIZES)
    eps = 0.1
    tin = WARM_OT.canonicalize(inputs, "cpu")
    y_b0, _ = thybrid.warm_duals(tin, eps, sizes=SIZES, device="cpu")
    assert (y_b0 > 1).any()
    tp = WARM_OT.prepare(tin, eps, sizes=SIZES, y_b0=y_b0)
    data, ctx = WARM_OT.prologue(tp.ops)
    ctx = {**ctx, **{kk: tp.ops[kk] for kk in WARM_OT.ctx_ops}}
    state = WARM_OT.init_state(data, ctx)
    assert state.y_b.data_ptr() != ctx["y_b0"].data_ptr()
    for i in range(B):
        one = type(state)(*(t[i].numpy() for t in state))
        rep = check_ot_invariants(data["c_int"][i].numpy(), one,
                                  ctx["s_int"][i].numpy(),
                                  ctx["d_int"][i].numpy(), eps)
        assert all(rep.values()), (i, rep)


def test_warm_ot_without_y_b0_equals_cold_ot():
    inputs = batch("ot", 6, SIZES)
    r_warm, _ = solve_compacting(WARM_OT, inputs, 0.2, sizes=SIZES,
                                 device="cpu")
    r_cold, _ = solve_compacting(OT, inputs, 0.2, sizes=SIZES, device="cpu")
    for f in ("cost", "y_b", "y_a", "plan", "phases", "rounds"):
        assert torch.equal(getattr(r_warm, f), getattr(r_cold, f)), f
    for f in r_cold.state._fields:
        assert torch.equal(getattr(r_warm.state, f),
                           getattr(r_cold.state, f)), f


@pytest.mark.parametrize("mode", ["compact", "lockstep"])
def test_hybrid_certificates_and_stats(mode):
    """Hybrid solves certify like push-relabel ones (guaranteed bound,
    feasible duals), and their stats fold the stage-1 dispatches in."""
    inputs = batch("ot", 3, SIZES)
    eps = 0.1
    pol = tapi.DispatchPolicy(mode=mode, solver="hybrid", guaranteed=True)
    sol = tapi.solve(tapi.OT, inputs, eps, pol, sizes=SIZES,
                     want=("cost", "duals", "state", "stats"), device="cpu")
    cold = tapi.solve(tapi.OT, inputs, eps, tapi.DispatchPolicy(
        mode=mode, guaranteed=True), sizes=SIZES, want=("cost", "duals"),
        device="cpu")
    assert sol.stats.solver == "hybrid"
    assert sol.dual_feasible().all() and cold.dual_feasible().all()
    assert (sol.additive_gap() <= sol.additive_gap_bound() + 1e-6).all()
    np.testing.assert_allclose(sol.additive_gap_bound(),
                               cold.additive_gap_bound(), **FLOAT)
    # the finish equals a WARM_OT solve from the same warm duals
    tin = WARM_OT.canonicalize(inputs, "cpu")
    y_b0, st1 = thybrid.warm_duals(tin, eps, sizes=SIZES, guaranteed=True,
                                   device="cpu")
    fin = tapi.solve(WARM_OT, tin, eps, tapi.DispatchPolicy(
        mode=mode, guaranteed=True), sizes=SIZES, want=("cost", "state"),
        device="cpu", y_b0=y_b0)
    for f in fin.state()._fields:
        assert torch.equal(getattr(sol.state(), f), getattr(fin.state(), f))
    _, stats = thybrid.dispatch_hybrid(inputs, eps, sizes=SIZES,
                                       policy=tapi.DispatchPolicy(mode=mode),
                                       keep_state=True, device="cpu")
    # at least one Sinkhorn chunk and one push-relabel chunk
    assert stats.dispatches >= st1.dispatches + 1 >= 2


# --------------------------------------------------------------------------
# the cost model and solver="auto"
# --------------------------------------------------------------------------

def _toy_model(cheap="sinkhorn"):
    rows = [{"solver": s, "n": 32, "eps": 0.1,
             "per_instance_s": 0.001 if s == cheap else 0.5}
            for s in ("pushrelabel", "sinkhorn", "hybrid")]
    return fit(rows, mode="cuda", backend="toy")


def test_costmodel_roundtrip_fit_and_choose(tmp_path):
    model = _toy_model()
    path = str(tmp_path / "cm.json")
    model.save(path)
    loaded = CostModel.load(path)
    assert loaded == model
    assert json.loads(open(path).read())["mode"] == "cuda"
    # the same schema as the reference's table
    from repro.portfolio.costmodel import CostModel as JCostModel

    assert JCostModel.from_dict(model.as_dict()).as_dict() == model.as_dict()
    # log-nearest snapping: n=40 -> bucket 32, eps=0.12 -> band 0.1
    assert loaded.predict("sinkhorn", 40, 0.12) == \
        loaded.predict("sinkhorn", 32, 0.1)
    assert loaded.choose(32, 0.1) == ("sinkhorn", 0.001)
    rows = [{"solver": "hybrid", "n": 30, "eps": 0.1, "per_instance_s": s}
            for s in (3.0, 1.0, 2.0)]
    fitted = fit(rows, mode="cuda", backend="toy")
    assert fitted.n_buckets == (32,) and fitted.entries == {
        ("hybrid", 32, 0.1): 2.0}
    # measured for hybrid only: push-relabel is the fall-back
    assert fitted.choose(32, 0.1, ("pushrelabel", "sinkhorn")) == \
        ("pushrelabel", None)


def test_default_table_is_the_ports_own():
    from pathlib import Path

    path = Path(tcm._DEFAULT_PATH)
    assert path.parent == Path(tspec.__file__).parent
    if path.exists():
        model = CostModel.load(str(path))
        assert model.mode == "cuda" and model.entries
        assert set(s for s, _, _ in model.entries) <= set(tcm.SOLVERS)


@pytest.mark.parametrize("cheap", ["sinkhorn", "hybrid"])
def test_auto_bit_identical_to_named_choice(cheap):
    inputs = batch("ot", 8, SIZES)
    set_model(_toy_model(cheap))
    sa = tapi.solve(tapi.OT, inputs, 0.1, tapi.DispatchPolicy(solver="auto"),
                    sizes=SIZES, want=("cost", "duals", "stats"),
                    device="cpu")
    sn = tapi.solve(tapi.OT, inputs, 0.1, tapi.DispatchPolicy(solver=cheap),
                    sizes=SIZES, want=("cost", "duals", "stats"),
                    device="cpu")
    assert sa.stats.solver == sn.stats.solver == cheap
    assert sa.stats.predicted_s == sn.stats.predicted_s == 0.001
    np.testing.assert_array_equal(sa.cost(), sn.cost())
    for a, b in zip(sa.duals(), sn.duals()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["empty", "none"])
def test_auto_without_model_falls_back_to_pushrelabel(monkeypatch, model):
    if model == "empty":
        set_model(CostModel(mode="cuda", backend="toy", entries={}))
    else:
        monkeypatch.setattr(tcm, "_DEFAULT_PATH", "/nonexistent/cm.json")
    inputs = batch("ot", 10, SIZES)
    s = tapi.solve(tapi.OT, inputs, 0.3, tapi.DispatchPolicy(solver="auto"),
                   sizes=SIZES, want=("cost", "stats"), device="cpu")
    p = tapi.solve(tapi.OT, inputs, 0.3, sizes=SIZES,
                   want=("cost", "stats"), device="cpu")
    assert s.stats.solver == "pushrelabel" and s.stats.predicted_s is None
    np.testing.assert_array_equal(s.cost(), p.cost())


def test_ragged_auto_routes_each_bucket():
    set_model(_toy_model("sinkhorn"))
    inputs = batch("ot", 12, SIZES)
    sols = tapi.solve(tapi.OT, _instances(inputs, SIZES), 0.1,
                      tapi.DispatchPolicy(solver="auto"),
                      want=("cost", "stats"), device="cpu")
    assert {s.stats.solver for s in sols} == {"sinkhorn"}
    assert all(s.stats.predicted_s == 0.001 for s in sols)


# --------------------------------------------------------------------------
# the front door
# --------------------------------------------------------------------------

def test_assignment_ignores_solver_knob():
    inputs = batch("assignment", 12, SIZES)
    for solver in ("sinkhorn", "hybrid", "auto"):
        s = tapi.solve(tapi.ASSIGNMENT, inputs, 0.3, tapi.DispatchPolicy(
            solver=solver), sizes=SIZES, want=("cost", "stats"),
            device="cpu")
        assert s.stats.solver == "pushrelabel"


def test_policy_rejects_unknown_solver():
    with pytest.raises(ValueError, match="unknown solver"):
        tapi.DispatchPolicy(solver="simplex")


class _Events:
    def __init__(self):
        self.kinds = []

    def event(self, kind, **attrs):
        self.kinds.append((kind, attrs))


def test_solver_choice_event_and_stats_surface():
    inputs = batch("ot", 13, SIZES)
    obs = _Events()
    _, stats = tapi.dispatch(tapi.OT, inputs, 0.3, sizes=SIZES,
                             policy=tapi.DispatchPolicy(solver="sinkhorn"),
                             obs=obs, device="cpu")
    ev = dict(obs.kinds)["solver-choice"]
    model = get_model()
    predicted = None if model is None else model.predict("sinkhorn", 32, 0.3)
    assert ev["solver"] == "sinkhorn" and ev["predicted_s"] == predicted
    assert stats.solver == "sinkhorn" and stats.predicted_s == predicted
    assert stats.solve_s > 0
    d = tapi.SolveStats.from_driver(stats, mode="compact", batch=B,
                                    solver="sinkhorn",
                                    predicted_s=0.5).as_dict()
    assert d["solver"] == "sinkhorn" and d["predicted_s"] == 0.5
    assert d["actual_s"] == stats.solve_s
    ref = japi.solve(japi.OT, inputs, 0.3, japi.DispatchPolicy(
        solver="sinkhorn"), sizes=SIZES, want=("stats",))
    got = tapi.solve(tapi.OT, inputs, 0.3, tapi.DispatchPolicy(
        solver="sinkhorn"), sizes=SIZES, want=("stats",), device="cpu")
    # predicted_s differs by design: the reference prices with its own
    # CPU table, the port with its card's (or none)
    rd, gd = ref.stats.as_dict(), got.stats.as_dict()
    assert set(gd) <= set(rd)
    for kk in ("solver", "mode", "batch", "bucket", "chunk"):
        assert gd[kk] == rd[kk], kk


# --------------------------------------------------------------------------
# the core/sinkhorn baseline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_log", [True, False])
def test_baseline_sinkhorn_matches_reference(use_log):
    rng = np.random.default_rng(4)
    m, n = 20, 27
    c = rng.uniform(0.0, 1.0, (m, n)).astype(np.float32)
    nu = rng.dirichlet(np.ones(m)).astype(np.float32)
    mu = rng.dirichlet(np.ones(n)).astype(np.float32)
    reg = tsink.reg_for_additive_eps(0.3, n)
    assert reg == jreg_for_additive_eps(0.3, n)
    tol = tsink.sinkhorn_marginal_tolerance(0.05)
    assert tol == jsinkhorn_marginal_tolerance(0.05)
    ref = jsinkhorn(c, nu, mu, reg=reg, max_iters=500, tol=tol,
                         use_log=use_log)
    got = tsink.sinkhorn(c, nu, mu, reg, 500, tol, use_log, device="cpu")
    assert 0 < int(got.iters) < 500
    _assert_phases(np.array([int(ref.iters)]), np.array([int(got.iters)]),
                   np.array([float(ref.marginal_err)]),
                   np.array([float(got.marginal_err)]), np.array([tol]))
    if int(got.iters) == int(ref.iters):
        for f in ("plan", "cost", "f", "g", "marginal_err"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-4, atol=1e-6, err_msg=f)
