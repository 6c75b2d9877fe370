"""The compacting driver's choice of k (``core.compaction.chunk_for``) on
the CPU, where the fused specs run their eager twins: with the chunk
left unset and no deadline, a fused push-relabel bucket runs to
termination in one chunk and one read (a run-out chunk, counted as
``runouts`` on the ``solve`` span), with the same integer state as k = 8
and as the stepped route; a deadline, an explicit chunk, Sinkhorn, the
debug checks and mesh matrix placement keep their chunks."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import set_debug_checks  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import compaction as tc  # noqa: E402
from repro_torch.core import device as tdevice  # noqa: E402
from repro_torch.core import problem as tproblem  # noqa: E402
from repro_torch.core.distributed import solve_mesh  # noqa: E402
from repro_torch.launch.mesh import make_small_mesh  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.obs.metrics import now  # noqa: E402

# ragged sizes and per-instance eps in one (5, 20, 24) bucket
SIZES = np.array([[20, 24], [15, 22], [20, 20], [9, 13], [18, 24]],
                 np.int32)
EPS = np.array([0.05, 0.1, 0.08, 0.05, 0.12])


@pytest.fixture
def recorder():
    tracing.clear()
    tracing.record(True)
    yield tracing
    tracing.record(None)
    tracing.clear()


def _bucket(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, m, n = len(SIZES), 20, 24
    c = np.zeros((b, m, n), np.float32)
    nu = np.zeros((b, m), np.float32)
    mu = np.zeros((b, n), np.float32)
    for i, (mi, ni) in enumerate(SIZES):
        c[i, :mi, :ni] = rng.uniform(size=(mi, ni))
        nu[i, :mi] = rng.dirichlet(np.ones(mi))
        mu[i, :ni] = rng.dirichlet(np.ones(ni))
    return {"c": c} if name == "assignment" else {"c": c, "nu": nu,
                                                  "mu": mu}


def _solve(name: str, deadline=None, **policy):
    """The bucket through the front door's dict form, state kept."""
    return tapi.solve(getattr(tapi, name.upper()), _bucket(name), EPS,
                      tapi.DispatchPolicy(**policy), sizes=SIZES,
                      keep_state=True, deadline=deadline, device="cpu")


def _cap(name: str) -> int:
    """The largest phase cap of the bucket's lanes."""
    spec = getattr(tproblem, name.upper())
    p = spec.prepare(spec.canonicalize(_bucket(name), "cpu"), EPS,
                     sizes=SIZES)
    return int(p.phase_cap.max())


def _assert_states_equal(a, b, what):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_unset_chunk_runs_the_fused_bucket_out(name):
    """``fused=True``, no chunk, no deadline: one dispatch and one read,
    k above every cap, and the integer state and results of k = 8 on the
    same route and of the stepped route."""
    tdevice.reset_sync_counts()
    r, st = _solve(name, fused=True)
    assert st.dispatches == 1 and tdevice.sync_counts["chunk"] == 1
    assert st.chunk == _cap(name) + 1
    assert st.occupancy == [(st.dispatched_batch, 0)]
    r8, st8 = _solve(name, fused=True, chunk=8)
    assert st8.chunk == 8 and st8.dispatches > 1
    rs, sts = _solve(name)          # the CPU default: stepped, k = 8
    assert sts.chunk == 8
    for other, so, what in ((r8, st8, "k=8"), (rs, sts, "stepped")):
        _assert_states_equal(st.final_state, so.final_state, what)
        assert st.phases_needed == so.phases_needed
        for f in r._fields:
            a, b = getattr(r, f), getattr(other, f)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (what, f)


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_ragged_list_runs_each_bucket_out(recorder, name):
    """A ragged list over several shape buckets: each bucket one run-out
    chunk, so the ``solve`` span counts ``runouts == chunks``, each
    ``driver.chunk`` span carries its k; states equal the stepped
    route's."""
    rng = np.random.default_rng(1)
    insts = []
    for n in (12, 20, 40, 70):
        c = rng.uniform(size=(n, n)).astype(np.float32)
        insts.append(c if name == "assignment" else (
            c, rng.dirichlet(np.ones(n)).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32)))
    eps = [0.1, 0.2, 0.15, 0.25]
    spec = getattr(tapi, name.upper())
    got = tapi.solve(spec, insts, eps, tapi.DispatchPolicy(fused=True),
                     keep_state=True, device="cpu")
    spans = recorder.recorded()
    (root,) = [s for s in spans if s["name"] == "solve"]
    chunks = [s for s in spans if s["name"] == "driver.chunk"]
    assert root["runouts"] == root["chunks"] == len(chunks) > 1
    assert all(s["live"] == 0 and s["k"] > 8 for s in chunks)
    ref = tapi.solve(spec, insts, eps, tapi.DispatchPolicy(),
                     keep_state=True, device="cpu")
    for g, r in zip(got, ref):
        _assert_states_equal(g["state"], r["state"], "ragged")


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_deadline_keeps_k8_with_a_read_between_chunks(recorder, name):
    """With a deadline the fused route keeps k = 8 and reads between
    chunks (a far deadline cuts nothing), so no chunk runs out; the
    state equals the run-out's."""
    events = []

    class Obs:
        def event(self, kind, **kw):
            events.append(kind)

    tdevice.reset_sync_counts()
    r, st = tapi.solve(getattr(tapi, name.upper()), _bucket(name), EPS,
                       tapi.DispatchPolicy(fused=True), sizes=SIZES,
                       keep_state=True, deadline=now() + 3600.0, obs=Obs(),
                       device="cpu")
    assert st.chunk == 8 and st.dispatches > 1 and not st.deadline_hit
    assert tdevice.sync_counts["chunk"] == st.dispatches
    assert events.count("chunk") == st.dispatches
    (root,) = [s for s in recorder.recorded() if s["name"] == "solve"]
    assert root["chunks"] == st.dispatches and "runouts" not in root
    _, out = _solve(name, fused=True)
    _assert_states_equal(st.final_state, out.final_state, "deadline")


@pytest.mark.parametrize("above", [False, True],
                         ids=["chunk2", "above_every_cap"])
def test_explicit_chunk_is_honoured(recorder, above):
    """An explicit chunk is used as given. One above every cap runs the
    bucket out in one dispatch, but it is the caller's k and not the
    driver's run-out, so ``runouts`` is not counted."""
    k = _cap("assignment") + 5 if above else 2
    r, st = _solve("assignment", fused=True, chunk=k)
    assert st.chunk == k and (st.dispatches == 1) == above
    (root,) = [s for s in recorder.recorded() if s["name"] == "solve"]
    assert "runouts" not in root
    assert {s["k"] for s in recorder.recorded()
            if s["name"] == "driver.chunk"} == {k}


LOCKSTEP_CASES = {
    # (problem, policy fields, eps)
    "fused_assignment": ("assignment", {"fused": True}, 0.03),
    "fused_ot": ("ot", {"fused": True}, 0.03),
    "stepped_assignment": ("assignment", {"fused": False}, 0.03),
    "stepped_ot": ("ot", {"fused": False}, 0.03),
    "sinkhorn": ("ot", {"solver": "sinkhorn"}, 0.1),
}


@pytest.mark.parametrize("case", list(LOCKSTEP_CASES))
def test_fused_lockstep_is_the_drivers_run_out(recorder, case):
    """``mode="lockstep"`` is the compacting driver's own run-out on every
    route: one chunk and one read, counted as ``runouts``, with the state
    of the k = 8 chunk loop on the same route."""
    name, policy, eps = LOCKSTEP_CASES[case]
    spec = getattr(tapi, name.upper())
    tdevice.reset_sync_counts()
    r, st = tapi.solve(spec, _bucket(name), eps,
                       tapi.DispatchPolicy(mode="lockstep", **policy),
                       sizes=SIZES, keep_state=True, device="cpu")
    assert tdevice.sync_counts["chunk"] == 1
    assert (st.chunk, st.dispatches) == (0, 1)
    (root,) = [s for s in recorder.recorded() if s["name"] == "solve"]
    assert root["runouts"] == root["chunks"] == 1
    _, st8 = tapi.solve(spec, _bucket(name), eps,
                        tapi.DispatchPolicy(chunk=8, **policy),
                        sizes=SIZES, keep_state=True, device="cpu")
    assert st8.dispatches > 1
    _assert_states_equal(st.final_state, st8.final_state, "lockstep")


@pytest.mark.parametrize("fused", [False, True])
def test_sinkhorn_keeps_k8(fused):
    """Sinkhorn's specs, the row kernel's included, keep k = 8, and give
    the explicit k = 8 answer."""
    r, st = _solve("ot", solver="sinkhorn", fused=fused)
    r8, st8 = _solve("ot", solver="sinkhorn", fused=fused, chunk=8)
    assert st.chunk == 8 and st.dispatches == st8.dispatches > 1
    _assert_states_equal(st.final_state, st8.final_state, "sinkhorn")


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_debug_checks_keep_k8(name):
    """Under the debug checks the checked chunk runs stepped, so k stays
    8; the state equals the run-out's."""
    set_debug_checks(True)
    try:
        _, dbg = _solve(name, fused=True)
    finally:
        set_debug_checks(None)
    _, out = _solve(name, fused=True)
    assert dbg.chunk == 8 and dbg.dispatches > 1
    _assert_states_equal(dbg.final_state, out.final_state, "debug")


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_mesh_batch_placement_runs_out_and_matrix_keeps_k8(name):
    """``solve_mesh`` resolves an unset k as the single-device driver
    does: batch placement over two CPU shards runs a fused bucket out in
    one dispatch, with the state of k = 8; matrix placement (stepped)
    records k = 8."""
    mesh = make_small_mesh((2,), ("data",), devices="cpu")
    spec = getattr(tproblem, "FUSED_" + name.upper())
    inputs = _bucket(name)
    _, st = solve_mesh(spec, inputs, EPS, mesh, sizes=SIZES,
                       placement="batch", keep_state=True)
    _, st8 = solve_mesh(spec, inputs, EPS, mesh, sizes=SIZES, k=8,
                        placement="batch", keep_state=True)
    assert st.dispatches == 1 and st.chunk == _cap(name) + 1
    assert st.devices_per_dispatch == [2] and st8.dispatches > 1
    _assert_states_equal(st.final_state, st8.final_state, "mesh")
    one = {k: v[:1] for k, v in inputs.items()}
    _, sm = solve_mesh(spec, one, 0.2, mesh, placement="matrix")
    assert sm.placement == "matrix" and sm.chunk == 8


CHUNK_CASES = {
    # (spec, k, deadline, debug checks, the k chunk_for gives: None is
    # the caps' largest + 1)
    "fused_assignment": ("FUSED_ASSIGNMENT", None, None, False, None),
    "fused_ot": ("FUSED_OT", None, None, False, None),
    "stepped": ("ASSIGNMENT", None, None, False, 8),
    "deadline": ("FUSED_OT", None, 1.0, False, 8),
    "debug_checks": ("FUSED_ASSIGNMENT", None, None, True, 8),
    "explicit": ("FUSED_ASSIGNMENT", 3, None, False, 3),
    "explicit_with_deadline": ("OT", 5, 1.0, False, 5),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_for(monkeypatch, recorder, case):
    """The rule alone: ``(k, runout)``, with nothing counted. With no
    phase caps (an empty batch, matrix placement) it never runs out,
    and an explicit k above every cap is used as given, not as a
    run-out."""
    name, k, deadline, debug, want = CHUNK_CASES[case]
    monkeypatch.setattr(tc, "debug_checks_enabled", lambda: debug)
    cap = np.array([30, 57, 0], np.int32)
    spec = getattr(tproblem, name)
    with tracing.root("solve"):
        got = tc.chunk_for(spec, k, deadline, cap)
        bare = tc.chunk_for(spec, k, deadline)
        big = tc.chunk_for(tproblem.FUSED_OT, 100, None, cap)
    (root,) = recorder.recorded()
    assert got == ((58, True) if want is None else (want, False))
    assert bare == (tc.DEFAULT_CHUNK if k is None else k, False)
    assert big == (100, False)
    assert "runouts" not in root


def test_sinkhorn_kernel_spec_is_not_run_out():
    from repro_torch.portfolio.sinkhorn_spec import SINKHORN_KERNEL

    assert SINKHORN_KERNEL.fused
    assert tc.chunk_for(SINKHORN_KERNEL, None, None,
                        np.array([40], np.int32)) == (tc.DEFAULT_CHUNK,
                                                      False)


def test_serving_layers_leave_the_chunk_to_the_driver():
    """``OTService`` and ``AsyncOTScheduler`` pass an unset chunk through,
    so their buckets without a deadline run out on the card; an explicit
    one reaches the policy as given."""
    from repro_torch.serve.engine import OTService
    from repro_torch.serve.scheduler import AsyncOTScheduler

    assert OTService(device="cpu")._policy.chunk is None
    assert OTService(chunk=3, device="cpu")._policy.chunk == 3
    with AsyncOTScheduler(device="cpu", join_timeout_s=5) as sched:
        assert sched._policy.chunk is None


@pytest.mark.parametrize("fused,want", [(True, 100.0), (False, 0.0)])
def test_the_benchmark_reads_the_run_out_share(recorder, fused, want):
    """``driver.runout_share.solo`` / ``.batch`` over the recorded
    ``solve`` spans: 100 where every bucket ran out, 0 on the stepped
    route's k = 8 chunks, None with nothing recorded."""
    from portbench.lib.harness import load_file

    read = {n: load_file("metrics", n).read for n in (
        "driver.runout_share.solo", "driver.runout_share.batch")}
    assert {n: f(None) for n, f in read.items()} == dict.fromkeys(read)
    for name in ("assignment", "ot"):
        _solve(name, fused=fused)
    assert {n: f(None) for n, f in read.items()} == dict.fromkeys(read, want)
