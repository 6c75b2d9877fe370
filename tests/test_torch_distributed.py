"""repro_torch's batch placement (``core/distributed.py``) on logical CPU
meshes, held lane for lane against the reference's single-device
compacting solve.

The reference's own forced-8-device mesh path fails its ``shard_map``
varying-axes check (ROADMAP.md, reference caveats), so the oracle is its
``solve_compacting``: the reference promises that batch placement equals
it bit for bit. Shards run in worker threads of this process, each on a
repeated CPU device. The bucket descent (``devices_per_dispatch``,
``collapsed_at``) is checked against a model of the driver's rules
written out below, fed with the lanes' phase counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import problem as jproblem
from repro.core.compaction import solve_compacting as jsolve
from repro.obs import metrics as jmetrics
from repro_torch.core import device as tdevice
from repro_torch.core import problem as tproblem
from repro_torch.core.compaction import solve_compacting as tsolve
from repro_torch.core.distributed import (DistributedStats, solve_mesh,
                                          solve_assignment_distributed,
                                          solve_ot_distributed)
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.obs import metrics as tmetrics

from _torch_parity import B, assert_states_equal, batch, cases

CASES = {name: (sizes, eps, g) for name, sizes, eps, g in cases()}
_REF = {}


def _mesh(d):
    return make_small_mesh((d,), ("data",), devices="cpu")


def _reference(spec_name, case, k, seed=5):
    """The reference's compacting solve (memoized: one JAX run serves
    every D)."""
    key = (spec_name, case, k, seed)
    if key not in _REF:
        sizes, eps, g = CASES[case]
        inputs = batch(spec_name, seed, sizes)
        r, st = jsolve(getattr(jproblem, spec_name.upper()), inputs, eps,
                       sizes=sizes, k=k, guaranteed=g, keep_state=True)
        _REF[key] = (inputs, r, st)
    return _REF[key]


def _pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _descent(phases, b, d, k):
    """(devices_per_dispatch, collapsed_at) of the mesh driver, by its
    rules: bucket max(pow2(b), d) (pad lanes take no phase); a lane with
    p phases is live after chunk t iff ceil(p / k) > t; after each chunk
    stop when none is live, else re-bucket to pow2(live) once that is at
    most half the bucket, collapsing to one device below d. A batch
    below the mesh floor (pow2(b) < d) runs on one device throughout and
    reports its bucket as collapsed_at."""
    if _pow2(b) < d:
        return _descent(phases, b, 1, k)[0], _pow2(b)
    pow2 = _pow2
    done_at = [-(-int(p) // k) for p in phases]
    bb, sharded, collapsed, per = max(pow2(b), d), d > 1, None, []
    t = 0
    while True:
        t += 1
        per.append(d if sharded else 1)
        live = sum(c > t for c in done_at)
        if live == 0:
            return per, collapsed
        nb = pow2(live)
        if nb <= bb // 2:
            if sharded and nb < d:
                sharded, collapsed = False, nb
            bb = nb


def _check_lanes(spec_name, r, st, jr, jst, b):
    assert_states_equal(jst.final_state, st.final_state, "final state")
    if spec_name == "assignment":
        for f in ("matching", "phases", "rounds",
                  "matched_before_completion"):
            np.testing.assert_array_equal(getattr(r, f).numpy(),
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f)
        np.testing.assert_allclose(r.cost.numpy(), np.asarray(jr.cost),
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(r.plan.numpy(), np.asarray(jr.plan),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r.cost.numpy(), np.asarray(jr.cost),
                                   rtol=1e-6, atol=1e-7)
    assert r.phases.shape == (b,)


@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_batch_placement_equals_reference_compacting(spec_name, k):
    inputs, jr, jst = _reference(spec_name, "full", k)
    for d in (1, 2, 4, 8):
        tspec = getattr(tproblem, spec_name.upper())
        tdevice.reset_sync_counts()
        r, st = solve_mesh(tspec, inputs, 0.1, _mesh(d), k=k,
                           placement="batch", keep_state=True)
        assert isinstance(st, DistributedStats) and st.devices == d
        _check_lanes(spec_name, r, st, jr, jst, B)
        # one converged-mask read a chunk for the whole mesh
        assert tdevice.sync_counts["chunk"] == st.dispatches
        per, collapsed = _descent(np.asarray(jst.final_state.phases), B, d,
                                  k)
        assert st.devices_per_dispatch == per, d
        assert st.collapsed_at == collapsed, d
        first = max(B, d) if _pow2(B) >= d else _pow2(B)
        assert st.dispatched_batch == first
        assert st.phases_needed == jst.phases_needed
        assert st.occupancy[0][0] == first


@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
@pytest.mark.parametrize("case", ["ragged", "guaranteed"])
@pytest.mark.parametrize("fused", [False, True])
def test_batch_placement_ragged_eps_guaranteed_fused(spec_name, case,
                                                     fused):
    """Ragged sizes with per-instance eps, and the guaranteed bound, on
    the stepped and the fused specs (the fused specs' plain versions on
    the CPU; the reference promises fused == stepped)."""
    sizes, eps, g = CASES[case]
    inputs, jr, jst = _reference(spec_name, case, 3)
    name = ("FUSED_" if fused else "") + spec_name.upper()
    for d in (2, 8):
        r, st = solve_mesh(getattr(tproblem, name), inputs, eps, _mesh(d),
                           sizes=sizes, k=3, guaranteed=g,
                           placement="batch", keep_state=True)
        _check_lanes(spec_name, r, st, jr, jst, B)


def test_wrappers_and_slot_accounting():
    """The spec-binding wrappers; per-device slots are at most the
    single-device count and at least the phases needed."""
    inputs, jr, jst = _reference("ot", "full", 3)
    r, st = solve_ot_distributed(inputs["c"], inputs["nu"], inputs["mu"],
                                 0.1, _mesh(4), k=3, placement="batch")
    np.testing.assert_array_equal(r.phases.numpy(), np.asarray(jr.phases))
    assert st.phases_needed <= st.slot_phases <= jst.slot_phases
    a_in, ajr, _ = _reference("assignment", "full", 3)
    ra, sta = solve_assignment_distributed(a_in["c"], 0.1, _mesh(2), k=3,
                                           keep_state=True)
    np.testing.assert_array_equal(ra.matching.numpy(),
                                  np.asarray(ajr.matching))
    assert sta.placement == "batch"
    d = sta.as_dict()
    assert {"devices", "batch_axis", "placement", "collapsed_at",
            "devices_per_dispatch"} <= set(d)


@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
def test_below_the_floor_runs_single_device(spec_name):
    """B = 1 on a 4-device mesh: pow2(1) < 4, so the single-device
    driver runs from the start: one device a dispatch, collapsed at the
    dispatched batch of 1."""
    inputs, _, _ = _reference(spec_name, "full", 8)
    one = {kk: v[:1] for kk, v in inputs.items()}
    jr, jst = jsolve(getattr(jproblem, spec_name.upper()), one, 0.1, k=8,
                     keep_state=True)
    r, st = solve_mesh(getattr(tproblem, spec_name.upper()), one, 0.1,
                       _mesh(4), k=8, keep_state=True)
    assert_states_equal(jst.final_state, st.final_state, "B=1")
    assert st.devices == 4 and st.collapsed_at == 1
    assert st.devices_per_dispatch == [1] * st.dispatches
    assert st.dispatches == jst.dispatches


def test_empty_batch():
    r, st = solve_mesh(tproblem.OT, {"c": np.zeros((0, 4, 5), np.float32),
                                     "nu": np.zeros((0, 4), np.float32),
                                     "mu": np.zeros((0, 5), np.float32)},
                       0.1, _mesh(2))
    assert r.plan.shape == (0, 4, 5) and st.dispatches == 0


@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
def test_deadline_cut_equals_reference(spec_name):
    """A deadline already past: one chunk runs, then the cut; the
    best-so-far state and the unconverged lanes equal the reference's."""
    sizes, eps, g = CASES["ragged"]
    inputs = batch(spec_name, 9, sizes)
    jr, jst = jsolve(getattr(jproblem, spec_name.upper()), inputs, eps,
                     sizes=sizes, k=1, keep_state=True,
                     deadline=jmetrics.now() - 1.0)
    events = []

    class Obs:
        def event(self, name, **kw):
            events.append((name, kw))
    r, st = solve_mesh(getattr(tproblem, spec_name.upper()), inputs, eps,
                       _mesh(2), sizes=sizes, k=1, keep_state=True,
                       deadline=tmetrics.now() - 1.0, obs=Obs(),
                       placement="batch")
    assert st.deadline_hit and jst.deadline_hit and st.dispatches == 1
    assert_states_equal(jst.final_state, st.final_state, "cut")
    np.testing.assert_array_equal(st.unconverged, jst.unconverged)
    assert [n for n, _ in events] == ["chunk", "deadline-cut"]
    assert events[0][1]["devices"] == 2
    assert set(events[0][1]) == {"bucket", "live", "chunk_s", "phases",
                                 "devices"}


def test_device_must_agree_with_the_mesh():
    inputs, _, _ = _reference("assignment", "full", 8)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        solve_mesh(tproblem.ASSIGNMENT, inputs, 0.1, _mesh(2),
                   device="meta")
    with pytest.raises(ValueError, match="power of two"):
        solve_mesh(tproblem.ASSIGNMENT, inputs, 0.1, _mesh(3))
    with pytest.raises(ValueError, match="placement"):
        solve_mesh(tproblem.ASSIGNMENT, inputs, 0.1, _mesh(2),
                   placement="rows")


def test_compact_equals_mesh_on_the_port():
    """The port's own compact driver and its mesh driver agree (the
    reference-free form of the bit-identity, at D = 4 with k = 2)."""
    sizes, eps, _ = CASES["ragged"]
    inputs = batch("ot", 11, sizes)
    r0, s0 = tsolve(tproblem.OT, inputs, eps, sizes=sizes, k=2,
                    keep_state=True, device="cpu")
    r1, s1 = solve_mesh(tproblem.OT, inputs, eps, _mesh(4), sizes=sizes,
                        k=2, keep_state=True)
    for f in s0.final_state._fields:
        assert torch.equal(getattr(s0.final_state, f),
                           getattr(s1.final_state, f)), f
    assert torch.equal(r0.plan, r1.plan)


@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
def test_debug_checks_scope_under_a_mesh(spec_name):
    """The sanitizer keeps the reference's scope: a sharded mesh solve
    stays plain under the debug checks (no ``"debug"`` read, the plain
    state), while a mesh solve below its floor runs the checked
    functions (the prologue's read, one a chunk and the epilogue's)."""
    from repro_torch.analysis import set_debug_checks

    sizes, eps, _ = CASES["ragged"]
    spec = getattr(tproblem, spec_name.upper())
    inputs = batch(spec_name, 11, sizes)
    one = {kk: v[:1] for kk, v in inputs.items()}
    _, plain = solve_mesh(spec, inputs, eps, _mesh(2), sizes=sizes, k=2,
                          keep_state=True)
    set_debug_checks(True)
    try:
        tdevice.reset_sync_counts()
        _, sharded = solve_mesh(spec, inputs, eps, _mesh(2), sizes=sizes,
                                k=2, keep_state=True)
        sharded_reads = tdevice.sync_counts.get("debug", 0)
        tdevice.reset_sync_counts()
        _, below = solve_mesh(spec, one, 0.1, _mesh(4), k=2,
                              keep_state=True)
        below_reads = tdevice.sync_counts.get("debug", 0)
    finally:
        set_debug_checks(None)
    assert sharded.devices_per_dispatch[0] == 2 and sharded_reads == 0
    for f in plain.final_state._fields:
        assert torch.equal(getattr(plain.final_state, f),
                           getattr(sharded.final_state, f)), f
    assert below.collapsed_at == 1
    assert below_reads == below.dispatches + 2


@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
def test_batch_placement_eight_lanes_on_eight_shards(spec_name):
    """B = 8 (two seeds of the parity batch), so D = 8 shards one lane
    each and re-buckets below the floor: the survivors collapse onto the
    first device."""
    two = [batch(spec_name, s, None) for s in (5, 6)]
    inputs = {kk: np.concatenate([t[kk] for t in two]) for kk in two[0]}
    jr, jst = jsolve(getattr(jproblem, spec_name.upper()), inputs, 0.1,
                     k=3, keep_state=True)
    phases = np.asarray(jst.final_state.phases)
    for d in (4, 8):
        r, st = solve_mesh(getattr(tproblem, spec_name.upper()), inputs,
                           0.1, _mesh(d), k=3, placement="batch",
                           keep_state=True)
        _check_lanes(spec_name, r, st, jr, jst, 2 * B)
        per, collapsed = _descent(phases, 2 * B, d, 3)
        assert (st.devices_per_dispatch, st.collapsed_at) == (per,
                                                              collapsed)
        assert st.devices_per_dispatch[0] == d
    # with 8 lanes of which not all finish in the first chunk, the
    # 8-shard run must have collapsed before it ended
    if (-(-phases // 3) > 1).any():
        assert collapsed is not None and collapsed < 8


def test_portfolio_solvers_under_a_mesh():
    """The hybrid's warm-started finish keeps batch placement under a
    matrix-placement mesh policy (its warm duals are per lane) and equals
    the compact hybrid; Sinkhorn runs batch placement like any spec and
    refuses matrix placement, as the reference's does."""
    from repro_torch.core import api as tapi

    sizes, eps, _ = CASES["ragged"]
    inputs = batch("ot", 12, sizes)
    mesh = _mesh(4)
    ref, _ = tapi.solve(tapi.OT, inputs, eps,
                        tapi.DispatchPolicy(mode="compact",
                                            solver="hybrid"),
                        sizes=sizes, device="cpu")
    got, st = tapi.solve(tapi.OT, inputs, eps,
                         tapi.DispatchPolicy(mode="mesh", mesh=mesh,
                                             placement="matrix",
                                             solver="hybrid"),
                         sizes=sizes)
    assert st.placement == "batch" and st.devices == 4
    for f in ref.state._fields:
        assert torch.equal(getattr(got.state, f), getattr(ref.state, f)), f
    sref, _ = tapi.solve(tapi.OT, inputs, eps,
                         tapi.DispatchPolicy(mode="compact",
                                             solver="sinkhorn"),
                         sizes=sizes, device="cpu")
    sgot, _ = tapi.solve(tapi.OT, inputs, eps,
                         tapi.DispatchPolicy(mode="mesh", mesh=mesh,
                                             placement="batch",
                                             solver="sinkhorn"),
                         sizes=sizes)
    assert torch.equal(sgot.plan, sref.plan)
    with pytest.raises(NotImplementedError, match="batch placement"):
        tapi.solve(tapi.OT, inputs, eps,
                   tapi.DispatchPolicy(mode="mesh", mesh=mesh,
                                       placement="matrix",
                                       solver="sinkhorn"), sizes=sizes)


def test_a_failing_shard_fails_the_dispatch(monkeypatch):
    """An error in one shard's chunk reaches the caller after every shard
    joined; the worker threads are gone afterwards."""
    import threading

    inputs, _, _ = _reference("assignment", "full", 8)
    real = tproblem.ASSIGNMENT.run_phases
    calls = []

    def flaky(data, state, k):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise FloatingPointError("shard failed")
        return real(data, state, k)
    monkeypatch.setattr(tproblem.ASSIGNMENT, "run_phases", flaky)
    with pytest.raises(FloatingPointError, match="shard failed"):
        solve_mesh(tproblem.ASSIGNMENT, inputs, 0.1, _mesh(4), k=8,
                   placement="batch")
    assert len(calls) == 4
    assert all(n.startswith("mesh-shard") for n in calls)
    assert not any(t.name.startswith("mesh-shard")
                   for t in threading.enumerate())
