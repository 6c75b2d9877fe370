"""repro_torch's ``solve`` front door held against ``repro.core.api.solve``:
lockstep and compact, dict and ragged-list forms, the legacy surfaces and
every ``want=`` artifact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi
from repro_torch.core import api as tapi

# float tolerances of the epilogue (f32 sums/cumsums in another order)
COST = dict(rtol=1e-5, atol=1e-6)
PLAN = dict(atol=1e-6)


def _ragged(spec_name, seed):
    rng = np.random.default_rng(seed)
    out = []
    for m, n in [(10, 12), (20, 20), (16, 30), (7, 7)]:
        x, y = rng.uniform(size=(m, 2)), rng.uniform(size=(n, 2))
        c = np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
        if spec_name == "assignment":
            out.append(c)
        else:
            out.append((c, rng.dirichlet(np.ones(m)).astype(np.float32),
                        rng.dirichlet(np.ones(n)).astype(np.float32)))
    return out


def _specs(name):
    return (getattr(japi, name.upper()), getattr(tapi, name.upper()))


@pytest.mark.parametrize("mode", ["lockstep", "compact"])
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_ragged_legacy_dicts_equal_reference(name, mode):
    jspec, tspec = _specs(name)
    insts = _ragged(name, 1)
    eps = [0.1, 0.2, 0.1, 0.3] if mode == "compact" else 0.15
    ref = japi.solve(jspec, insts, eps, japi.DispatchPolicy(mode=mode))
    got = tapi.solve(tspec, insts, eps, tapi.DispatchPolicy(mode=mode),
                     device="cpu")
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key, rv in r.items():
            if key in ("cost", "y_b", "y_a", "plan"):
                np.testing.assert_allclose(np.asarray(g[key]),
                                           np.asarray(rv), **COST, err_msg=key)
            else:
                np.testing.assert_array_equal(np.asarray(g[key]),
                                              np.asarray(rv), err_msg=key)


def _dict_batch(name, seed):
    rng = np.random.default_rng(seed)
    b, m, n = 3, 20, 24
    sizes = np.array([[20, 24], [15, 22], [20, 20]], np.int32)
    c = np.zeros((b, m, n), np.float32)
    nu = np.zeros((b, m), np.float32)
    mu = np.zeros((b, n), np.float32)
    for i, (mi, ni) in enumerate(sizes):
        c[i, :mi, :ni] = rng.uniform(size=(mi, ni))
        nu[i, :mi] = rng.dirichlet(np.ones(mi))
        mu[i, :ni] = rng.dirichlet(np.ones(ni))
    inputs = {"c": c} if name == "assignment" else {"c": c, "nu": nu,
                                                   "mu": mu}
    return inputs, sizes


@pytest.mark.parametrize("mode", ["lockstep", "compact"])
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_dict_form_artifacts_equal_reference(name, mode):
    jspec, tspec = _specs(name)
    inputs, sizes = _dict_batch(name, 4)
    want = tuple(a for a in jspec.artifacts if a != "stats")
    kw = dict(sizes=sizes, want=want)
    ref = japi.solve(jspec, inputs, 0.1, japi.DispatchPolicy(
        mode=mode, guaranteed=True, chunk=3), **kw)
    got = tapi.solve(tspec, inputs, 0.1, tapi.DispatchPolicy(
        mode=mode, guaranteed=True, chunk=3), device="cpu", **kw)
    assert got.batch == ref.batch and got.padded_shape == ref.padded_shape
    np.testing.assert_array_equal(got.phases(), ref.phases())
    np.testing.assert_array_equal(got.rounds(), ref.rounds())
    np.testing.assert_allclose(got.cost(), ref.cost(), **COST)
    for g, r in zip(got.duals(), ref.duals()):
        np.testing.assert_allclose(g, r, **COST)
    for f in ("scale", "mass", "dual_objective", "additive_gap",
              "additive_gap_bound"):
        np.testing.assert_allclose(getattr(got, f)(), getattr(ref, f)(),
                                   **COST, err_msg=f)
    np.testing.assert_array_equal(got.dual_feasible(), ref.dual_feasible())
    assert (got.additive_gap() <= got.additive_gap_bound()).all()
    assert got.dual_feasible().all()
    gs, rs = got.state(), ref.state()
    for f in rs._fields:
        np.testing.assert_array_equal(getattr(gs, f).numpy(),
                                      np.asarray(getattr(rs, f)), err_msg=f)
    np.testing.assert_allclose(got.plan(), ref.plan(), **PLAN)
    gsp, rsp = got.plan_sparse(), ref.plan_sparse()
    assert gsp.shape == rsp.shape
    for j in range(got.batch):
        np.testing.assert_allclose(gsp.instance(j).to_dense(),
                                   rsp.instance(j).to_dense(), **PLAN)
        np.testing.assert_allclose(got[j].plan_sparse().to_dense(),
                                   got[j].plan(), atol=0)
    if name == "assignment":
        np.testing.assert_array_equal(got.matching(), ref.matching())
        np.testing.assert_array_equal(gsp.idx, rsp.idx)
        np.testing.assert_array_equal(gsp.nnz, rsp.nnz)
    else:
        np.testing.assert_array_equal(got.theta(), ref.theta())


def test_legacy_dict_form_returns_result_and_stats():
    inputs, sizes = _dict_batch("ot", 6)
    ref, rstats = japi.solve(japi.OT, inputs, 0.2, sizes=sizes)
    got, gstats = tapi.solve(tapi.OT, inputs, 0.2, sizes=sizes,
                             device="cpu")
    for f in ref.state._fields:
        np.testing.assert_array_equal(getattr(got.state, f).numpy(),
                                      np.asarray(getattr(ref.state, f)))
    # every field, deadline_hit included (ported with the deadline cut)
    assert gstats.as_dict() == rstats.as_dict()
    assert gstats.solve_s > 0


def test_want_gating_and_validation():
    inputs, sizes = _dict_batch("assignment", 2)
    sol = tapi.solve(tapi.ASSIGNMENT, inputs, 0.2, sizes=sizes,
                     want=("cost",), device="cpu")
    assert sol.cost().shape == (3,)
    with pytest.raises(tapi.solution_mod.ArtifactNotRequested):
        sol.duals()
    assert sol.fetched_bytes == 3 * 4
    with pytest.raises(ValueError, match="unknown artifact"):
        tapi.solve(tapi.OT, [], 0.1, want=("matching",), device="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(mode="mesh"), "item 11"), (dict(mesh=object()), "item 11"),
    # validate=True (item 7) is ported: tests/test_torch_validate.py;
    # the row/col matrix placement of a mesh is still item 11
    (dict(mesh=object(), placement="matrix"), "item 11"),
])
def test_unported_policies_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tapi.DispatchPolicy(**kw)


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_fused_policy_routes_through_fused_spec(monkeypatch, name):
    """``DispatchPolicy(fused=True)`` runs every chunk through the fused
    spec's ``run_phases`` (FUSED_ASSIGNMENT / FUSED_OT), never through the
    stepped propose step."""
    from repro_torch.core import matching, problem

    fused = getattr(problem, f"FUSED_{name.upper()}")
    calls = {"fused": 0, "propose": 0}
    run = type(fused).run_phases

    def counted_run(self, data, state, k):
        calls["fused"] += self is fused
        return run(self, data, state, k)

    def no_propose(*a, **kw):
        calls["propose"] += 1
        raise AssertionError("the fused route proposed through the stepped "
                             "core")

    monkeypatch.setattr(type(fused), "run_phases", counted_run)
    monkeypatch.setattr(matching, "_propose_kernel", no_propose)
    inputs, sizes = _dict_batch(name, 5)
    spec = getattr(tapi, name.upper())
    _, stats = tapi.solve(spec, inputs, 0.05, tapi.DispatchPolicy(
        fused=True, chunk=2), sizes=sizes, device="cpu")
    assert calls == {"fused": stats.dispatches, "propose": 0}
    assert stats.dispatches > 1


def test_obs_events_and_sync_counts():
    from repro_torch.core import device

    class Rec:
        def __init__(self):
            self.events = []

        def event(self, name, **fields):
            self.events.append((name, fields))

    rec = Rec()
    device.reset_sync_counts()
    inputs, sizes = _dict_batch("assignment", 3)
    _, stats = tapi.solve(tapi.ASSIGNMENT, inputs, 0.1, sizes=sizes,
                          obs=rec, device="cpu")
    names = [n for n, _ in rec.events]
    # one event per chunk, then the dispatch's solver choice
    assert names == ["chunk"] * stats.dispatches + ["solver-choice"]
    assert rec.events[-1][1]["solver"] == "pushrelabel"
    # exactly one converged-mask read per chunk; the phase loop reads
    # nothing of its own (its stop flag comes with the first round's read)
    assert device.sync_counts["chunk"] == stats.dispatches
    assert set(device.sync_counts) == {"round", "chunk", "sinkhorn"}
    assert device.sync_counts["round"] > 0
    assert device.sync_counts["sinkhorn"] == 0


def test_batched_wrappers_equal_reference():
    """The per-problem lockstep and compacting entry points."""
    from repro.core import batched as jb, compaction as jc
    from repro_torch.core import batched as tb, compaction as tc

    inputs, sizes = _dict_batch("ot", 8)
    c, nu, mu = inputs["c"], inputs["nu"], inputs["mu"]
    ct = torch.as_tensor(c)
    pairs = [
        (jb.solve_assignment_batched(c, 0.1, sizes=sizes),
         tb.solve_assignment_batched(ct, 0.1, sizes=sizes, device="cpu")),
        (jb.solve_ot_batched(c, nu, mu, 0.1, sizes=sizes),
         tb.solve_ot_batched(ct, nu, mu, 0.1, sizes=sizes, device="cpu")),
        (jc.solve_assignment_batched_compacting(c, 0.1, sizes=sizes, k=2)[0],
         tc.solve_assignment_batched_compacting(ct, 0.1, sizes=sizes, k=2,
                                                device="cpu")[0]),
        (jc.solve_ot_batched_compacting(c, nu, mu, 0.1, sizes=sizes,
                                        k=2)[0],
         tc.solve_ot_batched_compacting(ct, nu, mu, 0.1, sizes=sizes, k=2,
                                        device="cpu")[0]),
    ]
    for ref, got in pairs:
        np.testing.assert_array_equal(got.phases.numpy(),
                                      np.asarray(ref.phases))
        np.testing.assert_array_equal(got.rounds.numpy(),
                                      np.asarray(ref.rounds))
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                                   **COST)
        if hasattr(ref, "matching"):
            np.testing.assert_array_equal(got.matching.numpy(),
                                          np.asarray(ref.matching))
