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


def _cpu_mesh(d):
    from repro_torch.launch.mesh import make_small_mesh

    return make_small_mesh((d,), ("data",), devices="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(mode="mesh"), "item 11"), (dict(mesh=2), "item 11"),
    (dict(mesh=4, placement="matrix"), "item 11"),
])
def test_unported_policies_name_their_roadmap_item(kw, item):
    """The mesh policies of ROADMAP.md Queue 1 item 11 are ported: each
    builds, resolves to mode "mesh" and solves like compact (batch
    placement bit for bit, matrix placement with the same integer
    state)."""
    kw = dict(kw)
    if "mesh" in kw:
        kw["mesh"] = _cpu_mesh(kw["mesh"])
    else:
        kw["mesh"] = _cpu_mesh(1)       # mesh=None would mean the cards
    pol = tapi.DispatchPolicy(**kw)
    assert pol.resolved_mode() == "mesh", item
    inputs, sizes = _dict_batch("assignment", 2)
    got, gst = tapi.solve(tapi.ASSIGNMENT, inputs, 0.2, pol, sizes=sizes)
    ref, _ = tapi.solve(tapi.ASSIGNMENT, inputs, 0.2,
                        tapi.DispatchPolicy(mode="compact"), sizes=sizes,
                        device="cpu")
    assert gst.placement == kw.get("placement", "batch")
    for f in ("matching", "phases", "rounds"):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=0)


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


FUSED_OPS = ("fused_run_assignment_phases", "fused_run_ot_phases",
             "sinkhorn_row_update")

# (policy fields, the problem, a faked CUDA device, the route it takes)
ROUTE_CASES = {
    "default_cpu_assignment": ({}, "assignment", False, "stepped"),
    "default_cpu_ot": ({}, "ot", False, "stepped"),
    "default_card_assignment": ({}, "assignment", True, "fused"),
    "default_card_ot": ({}, "ot", True, "fused"),
    "default_card_lockstep": ({"mode": "lockstep"}, "ot", True, "fused"),
    "explicit_true_cpu": ({"fused": True}, "assignment", False, "fused"),
    "explicit_false_card": ({"fused": False}, "ot", True, "stepped"),
    "sinkhorn_card": ({"solver": "sinkhorn"}, "ot", True, "stepped"),
    "matrix_card": ({"mode": "mesh", "placement": "matrix"}, "assignment",
                    True, "stepped"),
    "hybrid_finish_card": ({"solver": "hybrid"}, "ot", True, "stepped"),
    "sanitizer_card": ({}, "assignment", True, "stepped"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_default_route_resolution(monkeypatch, case):
    """``DispatchPolicy.fused_for`` per bucket: with ``fused=None`` the
    fused kernels run push-relabel chunks on a CUDA device (faked here:
    the CPU runs the kernels' eager twins) and the stepped cores run on
    the CPU, for Sinkhorn, under matrix placement and in the hybrid
    finish; an explicit ``fused`` wins. The root ``solve`` span's
    ``route`` follows what ran, also where the sanitizer swaps the
    stepped cores in."""
    from repro_torch.core import compaction
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.obs import tracing

    fields, name, card, route = ROUTE_CASES[case]
    if fields.get("mode") == "mesh":
        fields = dict(fields, mesh=make_small_mesh((2,), ("data",),
                                                   devices="cpu"))
    policy = tapi.DispatchPolicy(chunk=2, **fields)
    spec = getattr(tapi, name.upper())
    # the predicate itself, before the fake: a CUDA device, the CPU
    default = tapi.DispatchPolicy()
    assert default.fused_for(spec, torch.device("cuda", 0))
    assert not default.fused_for(spec, torch.device("cpu"))
    if card:
        monkeypatch.setattr(tapi, "_on_card", lambda device: True)
    if case.startswith("sanitizer"):
        monkeypatch.setattr(compaction, "debug_checks_enabled", lambda: True)
    ran = {op: 0 for op in FUSED_OPS}

    def counted(op):
        real = getattr(ops, op)

        def run(*a, **kw):
            ran[op] += 1
            return real(*a, **kw)
        return run

    for op in FUSED_OPS:
        monkeypatch.setattr(ops, op, counted(op))
    inputs, sizes = _dict_batch(name, 6)
    tracing.clear()
    tracing.record(True)
    try:
        tapi.solve(spec, inputs, 0.05, policy, sizes=sizes, device="cpu")
        (root,) = [s for s in tracing.recorded() if s["name"] == "solve"]
    finally:
        tracing.record(None)
        tracing.clear()
    assert (sum(ran.values()) > 0) == (route == "fused"), ran
    assert root["route"] == route


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
    assert set(device.sync_counts) == {"round", "chunk", "sinkhorn",
                                       "debug"}
    assert device.sync_counts["round"] > 0
    assert device.sync_counts["sinkhorn"] == 0
    # the plain route reads nothing for the sanitizer
    assert device.sync_counts["debug"] == 0


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
