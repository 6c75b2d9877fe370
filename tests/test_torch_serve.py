"""repro_torch's serving path on the CPU: ``OTService`` and
``AsyncOTScheduler`` held against the JAX reference's request for
request, the fault-tolerance behaviour of the reference's
``tests/test_faults.py``, and the shutdown semantics of its
``tests/test_scheduler_shutdown.py``.

Points lie on a dyadic grid (coordinates k/64), so the fp32 cost matrices
are exact in both packages and the integer state is equal bit for bit.
The float artifacts computed from it (OT costs and plans, euclidean
assignment costs) are f32 sums taken in another order and are held to
``F32``; assignment costs under ``sqeuclidean`` (multiples of 2**-12
summed below 2**12, exact in fp32 in any order) are bit-equal too.

Every threaded test passes ``join_timeout_s`` <= 5, flushes with a
timeout and reads each Future with one: no test waits without a bound.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.api import DispatchPolicy as JPolicy
from repro.obs import InMemorySink as JSink
from repro.serve.engine import OTService as JService
from repro.serve.faults import FaultInjector as JInjector
from repro.serve.faults import FaultPlan as JPlan
from repro.serve.scheduler import AsyncOTScheduler as JScheduler
from repro_torch.analysis import set_debug_checks
from repro_torch.analysis.checked import DebugCheckError
from repro_torch.core import validate as V
from repro_torch.core.api import (ASSIGNMENT, OT, DispatchPolicy, dispatch,
                                  solve)
from repro_torch.obs import InMemorySink
from repro_torch.serve import ft
from repro_torch.serve.engine import OTService
from repro_torch.serve.faults import (FaultInjector, FaultPlan,
                                      PoisonedDispatchError, WorkerDeath)
from repro_torch.serve.ft import (RequestRejected, TransientDispatchError,
                                  degradation_ladder, is_poison,
                                  is_transient, require_mass_pair,
                                  run_with_recovery)
from repro_torch.serve.scheduler import AsyncOTScheduler

# f32 tolerance of the float artifacts (see the module docstring)
F32 = dict(rtol=1e-6, atol=1e-7)
# bounded waits of the threaded tests
WAIT = 60
JOIN = 5


def _grid(rng, n, d=2):
    return (rng.integers(0, 65, size=(int(n), d)) / 64).astype(np.float32)


def _requests(seed, count=8, lo=8, hi=30):
    """Mixed assignment / OT requests ``(x, y, nu, mu)`` on the grid."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        m, n = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
        x, y = _grid(rng, m), _grid(rng, n)
        if i % 2:
            out.append((x, y, rng.dirichlet(np.ones(m)).astype(np.float32),
                        rng.dirichlet(np.ones(n)).astype(np.float32)))
        else:
            out.append((x, y, None, None))
    return out


def _pts(rng, m, d=2):
    return rng.standard_normal((int(m), d)).astype(np.float32)


def _cloud_batch(seed, n_req, m=10):
    rng = np.random.default_rng(seed)
    return [(_pts(rng, m), _pts(rng, m)) for _ in range(n_req)]


def _sched(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("join_timeout_s", JOIN)
    return AsyncOTScheduler(**kw)


def _assert_dicts_equal(got, ref, *, has_mass, exact_cost):
    assert set(got) == set(ref)
    for key, rv in ref.items():
        gv = got[key]
        if key in ("latency_s", "wait_s", "solve_s", "occupancy",
                   "batch_size"):
            continue    # timing, and the composition of the bucket
        if key == "plan" or (key == "cost" and not exact_cost):
            np.testing.assert_allclose(np.asarray(gv), np.asarray(rv),
                                       err_msg=key, **F32)
        else:
            np.testing.assert_array_equal(np.asarray(gv), np.asarray(rv),
                                          err_msg=key)


def _assert_sparse_equal(got, ref, *, has_mass):
    """Assignment plans (one unit per matched edge) are equal triplet for
    triplet. An OT plan's completion spreads float residuals: entries of
    ~1e-8 may be zero in one package and not in the other, so OT plans
    are compared dense, to ``F32``."""
    assert got.shape == ref.shape
    if has_mass:
        np.testing.assert_allclose(got.to_dense(), ref.to_dense(), **F32)
        return
    np.testing.assert_array_equal(got.rows, ref.rows)
    np.testing.assert_array_equal(got.cols, ref.cols)
    np.testing.assert_array_equal(got.vals, ref.vals)


# --------------------------------------------------------------------------
# OTService against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "l1"])
def test_service_cost_matrices_bit_equal_reference(metric):
    """The services' bucket collate (serve/collate.py) builds the same
    padded costs as the reference service's ``_batched_cost``."""
    from repro.core import batched as jB
    from repro_torch.obs import Tracer
    from repro_torch.serve.collate import collate_bucket

    rng = np.random.default_rng(1)
    xs = [_grid(rng, m) for m in (9, 14, 16)]
    ys = [_grid(rng, n) for n in (12, 16, 7)]
    jc = JService(eps=0.1, metric=metric)._batched_cost(
        jB.pad_stack(xs, (16, 2)), jB.pad_stack(ys, (16, 2)))
    sizes = np.array([[9, 12], [14, 16], [16, 7]])
    tc, nu, mu, codes = collate_bucket(
        xs, ys, None, None, (16, 16), sizes, device=torch.device("cpu"),
        metric=metric, validate=True, tol=V.DEFAULT_TOL, tracer=Tracer(),
        trace_id="t", parent=None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert nu is None and mu is None and not codes.any()


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_service_legacy_dicts_equal_reference(metric):
    reqs = _requests(2)
    js = JService(eps=0.1, metric=metric, compact=True)
    ts = OTService(eps=0.1, metric=metric, compact=True, device="cpu")
    for x, y, nu, mu in reqs:
        js.submit(x, y, nu, mu)
        ts.submit(x, y, nu, mu)
    ref, got = js.run_batch(), ts.run_batch()
    assert len(got) == len(ref)
    for (_, _, nu, _), g, r in zip(reqs, got, ref):
        has_mass = nu is not None
        _assert_dicts_equal(g, r, has_mass=has_mass,
                            exact_cost=metric == "sqeuclidean"
                            and not has_mass)
    assert ts.stats_dict().keys() == js.stats_dict().keys()
    for k in ("requests", "batches", "rejected", "dispatches"):
        assert ts.stats_dict()[k] == js.stats_dict()[k], k


def test_service_solutions_equal_reference():
    """``want=("cost", "plan_sparse")`` Solutions, plus the integer state
    (the ``state`` artifact) equal bit for bit."""
    reqs = _requests(3)
    want = ("cost", "plan_sparse", "state")
    js = JService(eps=0.1, compact=True, want=want)
    ts = OTService(eps=0.1, compact=True, want=want, device="cpu")
    for x, y, nu, mu in reqs:
        js.submit(x, y, nu, mu)
        ts.submit(x, y, nu, mu)
    for (_, _, nu, _), g, r in zip(reqs, ts.run_batch(), js.run_batch()):
        assert g.shape == r.shape and g.phases == r.phases
        np.testing.assert_allclose(g.cost, r.cost, **F32)
        _assert_sparse_equal(g.plan_sparse(), r.plan_sparse(),
                             has_mass=nu is not None)
        for f, rv in r.state()._asdict().items():
            np.testing.assert_array_equal(getattr(g.state(), f).numpy(),
                                          np.asarray(rv), err_msg=f)
        assert g.stats.mode == r.stats.mode == "compact"
        assert not g.degraded and not r.degraded


def test_service_quarantine_codes_equal_reference():
    reqs = _requests(4)
    poisoned = list(reqs)
    x, y, _, _ = poisoned[2]
    x = x.copy()
    x[0, 0] = np.nan
    poisoned[2] = (x, y, None, None)
    x, y, nu, mu = poisoned[3]
    poisoned[3] = (x, y, -nu, mu)                 # negative + imbalanced
    x, y, nu, mu = poisoned[5]
    poisoned[5] = (x, y, nu * 2.0, mu)            # imbalanced
    js, ts = JService(eps=0.1), OTService(eps=0.1, device="cpu")
    for x, y, nu, mu in poisoned:
        js.submit(x, y, nu, mu)
        ts.submit(x, y, nu, mu)
    ref, got = js.run_batch(), ts.run_batch()
    clean = OTService(eps=0.1, device="cpu")
    for x, y, nu, mu in reqs:
        clean.submit(x, y, nu, mu)
    clean_res = clean.run_batch()
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in (2, 3, 5):
            assert isinstance(g, RequestRejected), i
            assert (g.code, g.who) == (r.code, r.who)
            assert str(g) == str(r)
        else:
            _assert_dicts_equal(g, r, has_mass=reqs[i][2] is not None,
                                exact_cost=False)
            # survivors equal a clean run of their own package bit for bit
            assert g["cost"] == clean_res[i]["cost"]
    assert ts.stats_dict()["rejected"] == js.stats_dict()["rejected"] == 3


# chunk events of the reference carry ``compiled``, the jit-cache delta of
# the chunk program; the port compiles nothing per chunk (the kernels are
# built once, at first use), so the field has no meaning there
NO_TORCH_MEANING = {"chunk": {"compiled"}}


def _shapes(records):
    out = set()
    for ch, kind, payload, _ in records:
        if ch != "event":
            out.add((ch, kind, None))
            continue
        keys = set(payload) - NO_TORCH_MEANING.get(kind, set())
        name = payload.get("name") if kind == "span" else None
        out.add((kind, name, frozenset(keys)))
    return out


def test_service_events_equal_reference():
    reqs = _requests(5)
    x, y, _, _ = reqs[0]
    x = x.copy()
    x[1, 1] = np.inf
    reqs[0] = (x, y, None, None)
    jsink, tsink = JSink(), InMemorySink()
    js = JService(eps=0.1, sinks=(jsink,))
    ts = OTService(eps=0.1, sinks=(tsink,), device="cpu")
    for x, y, nu, mu in reqs:
        js.submit(x, y, nu, mu)
        ts.submit(x, y, nu, mu)
    js.run_batch()
    ts.run_batch()
    ref, got = _shapes(list(jsink.records)), _shapes(list(tsink.records))
    assert got == ref
    names = {n for k, n, _ in got if k == "span"}
    assert names == {"bucket", "admission", "solve", "artifact-fetch"}
    assert {k for k, _, _ in got} >= {"chunk", "rejected", "solver-choice"}
    assert tsink.count("chunk") == jsink.count("chunk")


def test_service_mesh_and_device_rules():
    from repro_torch.launch.mesh import make_small_mesh

    mesh = make_small_mesh((2,), ("data",), devices="cpu")
    svc = OTService(eps=0.1, mesh=mesh, device="cpu")
    assert svc.device == torch.device("cpu")
    assert svc._policy.resolved_mode() == "mesh"
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        OTService(eps=0.1, mesh=mesh, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OTService(eps=0.1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AsyncOTScheduler(eps=0.1)
    with AsyncOTScheduler(eps=0.1, mesh=mesh, device="cpu",
                          join_timeout_s=JOIN) as sched:
        assert sched.device == torch.device("cpu")
        assert sched._policy.mesh is mesh


# --------------------------------------------------------------------------
# AsyncOTScheduler against the reference
# --------------------------------------------------------------------------

def _run_both(reqs, *, policy_kw=None, jfaults=None, tfaults=None,
              submit_kw=None, **kw):
    """Submit ``reqs`` to a reference and a port scheduler under the same
    compact policy; returns (port Futures, reference Futures)."""
    policy_kw = policy_kw or {}
    submit_kw = submit_kw or [{} for _ in reqs]
    out = []
    for make, pol, faults in (
            (lambda **a: _sched(**a), DispatchPolicy(mode="compact",
                                                     **policy_kw), tfaults),
            (lambda **a: JScheduler(join_timeout_s=JOIN, **a),
             JPolicy(mode="compact", **policy_kw), jfaults)):
        with make(policy=pol, faults=faults, **kw) as s:
            futs = [s.submit(x, y, nu, mu, **skw)
                    for (x, y, nu, mu), skw in zip(reqs, submit_kw)]
            assert s.flush(timeout=WAIT)
            stats = s.stats_dict()
        out.append((futs, stats))
    return out


def test_scheduler_equals_reference_request_for_request():
    reqs = _requests(6, count=10)
    eps = [0.1, 0.2, 0.15, 0.1, 0.25, 0.1, 0.2, 0.1, 0.3, 0.1]
    skw = [{"eps": e} for e in eps]
    for i in (1, 4, 7):
        skw[i]["want"] = ("cost", "plan_sparse")
    (tf, tst), (jf, jst) = _run_both(reqs, submit_kw=skw, linger_ms=50,
                                     eps=0.1)
    for i, (g, r) in enumerate(zip(tf, jf)):
        g, r = g.result(timeout=WAIT), r.result(timeout=WAIT)
        if "want" in skw[i]:
            np.testing.assert_allclose(g.cost, r.cost, **F32)
            _assert_sparse_equal(g.plan_sparse(), r.plan_sparse(),
                                 has_mass=reqs[i][2] is not None)
            assert g.phases == r.phases and g.eps == r.eps
            assert (g.stats.ladder_level, g.stats.attempts) == (0, 1)
            continue
        _assert_dicts_equal(g, r, has_mass=reqs[i][2] is not None,
                            exact_cost=False)
    assert tst.keys() == jst.keys()
    for k in ("requests", "rejected", "quarantined", "retries",
              "degraded", "deadline_hits"):
        assert tst[k] == jst[k], k


def test_scheduler_rejections_equal_reference():
    """Admission-poisoned requests (a NaN point from the fault plan, a
    negative mass) fail with the reference's codes; the rest resolve to
    its results."""
    reqs = _requests(7, count=6)
    x, y, nu, mu = reqs[3]
    reqs[3] = (x, y, nu, -mu)
    (tf, tst), (jf, jst) = _run_both(
        reqs, linger_ms=50, eps=0.1,
        tfaults=FaultInjector(FaultPlan(poison_submits=(0,))),
        jfaults=JInjector(JPlan(poison_submits=(0,))))
    for i, (g, r) in enumerate(zip(tf, jf)):
        if i in (0, 3):
            ge, re_ = g.exception(timeout=WAIT), r.exception(timeout=WAIT)
            assert isinstance(ge, RequestRejected), i
            assert (ge.code, ge.who, str(ge)) == (re_.code, re_.who,
                                                  str(re_))
        else:
            _assert_dicts_equal(g.result(timeout=WAIT),
                                r.result(timeout=WAIT),
                                has_mass=reqs[i][2] is not None,
                                exact_cost=False)
    assert tst["rejected"] == jst["rejected"] == 2


def test_scheduler_past_deadline_cut_equals_reference():
    """An already-expired budget: both packages cut the bucket after one
    chunk, flag every lane degraded, and agree on the integer state."""
    rng = np.random.default_rng(8)
    reqs = [(_grid(rng, 30), _grid(rng, 30), None, None) for _ in range(2)]
    skw = [{"want": ("cost", "duals", "state"), "deadline": 0.0}] * 2
    (tf, tst), (jf, jst) = _run_both(
        reqs, policy_kw={"chunk": 1}, submit_kw=skw, linger_ms=50,
        eps=0.02)
    for g, r in zip(tf, jf):
        g, r = g.result(timeout=WAIT), r.result(timeout=WAIT)
        assert g.degraded and r.degraded
        assert g.stats.dispatches == r.stats.dispatches == 1
        assert g.stats.deadline_hit and r.stats.deadline_hit
        assert g.dual_feasible()
        for f, rv in r.state()._asdict().items():
            np.testing.assert_array_equal(getattr(g.state(), f).numpy(),
                                          np.asarray(rv), err_msg=f)
    assert tst["degraded"] == jst["degraded"] == 2
    assert tst["deadline_hits"] == jst["deadline_hits"]


# --------------------------------------------------------------------------
# failure classification and the ladder (reference test_faults.py)
# --------------------------------------------------------------------------

def test_mass_pair_rule_names_the_offender():
    with pytest.raises(ValueError, match="tenant 'acme'.*only nu"):
        with _sched(eps=0.2) as sched:
            sched.submit(np.ones((4, 2)), np.ones((4, 2)),
                         nu=np.ones(4), tenant="acme")
    svc = OTService(eps=0.2, device="cpu")
    with pytest.raises(ValueError, match="ticket #0.*only mu"):
        svc.submit(np.ones((4, 2)), np.ones((4, 2)), mu=np.ones(4))
    assert require_mass_pair(np.ones(3), np.ones(3)) is True
    assert require_mass_pair(None, None) is False


def test_failure_taxonomy():
    assert is_transient(TransientDispatchError("x"))
    assert is_transient(torch.cuda.OutOfMemoryError("oom"))
    assert not is_transient(PoisonedDispatchError("x"))
    assert is_poison(PoisonedDispatchError("x"))
    assert is_poison(FloatingPointError("nan"))
    assert not is_poison(TransientDispatchError("x"))
    assert not is_poison(ValueError("x"))
    # a kernel that fails to build or launch is a bug, never retried
    assert not is_transient(RuntimeError(
        "repro_torch: slack_propose kernel launch failed (cudaError 700)"))
    assert not is_transient(RuntimeError("repro_torch: nvcc failed for x"))


def test_run_with_recovery_walks_ladder_and_backoff():
    ladder = [("compact", "P0", None), ("cpu", "P1", "dev")]
    calls, naps = [], []

    def attempt(name, pol, dev):
        calls.append((name, pol, dev))
        if len(calls) < 3:
            raise TransientDispatchError("boom")
        return "ok"

    out, level, total = run_with_recovery(
        attempt, ladder, retries_per_level=2, backoff_s=0.01,
        sleep=naps.append)
    assert (out, level, total) == ("ok", 1, 3)
    assert [c[0] for c in calls] == ["compact", "compact", "cpu"]
    assert naps == [0.01, 0.02]              # exponential per rung

    def poisoned(name, pol, dev):
        raise PoisonedDispatchError("data")

    with pytest.raises(PoisonedDispatchError):
        run_with_recovery(poisoned, ladder, sleep=naps.append)

    def always(name, pol, dev):
        raise TransientDispatchError("always")

    with pytest.raises(TransientDispatchError):
        run_with_recovery(always, ladder, retries_per_level=1,
                          backoff_s=0.0)


def test_degradation_ladder_shape():
    """One rung on the service's own device: a policy on the card never
    gets a CPU rung (the reference's host-CPU rung is not ported)."""
    pol = DispatchPolicy(mode="compact", chunk=3, fused=True)
    rungs = degradation_ladder(pol)           # None: the card
    assert [r[0] for r in rungs] == ["compact"]
    assert rungs[0][1] is pol and rungs[0][2].type == "cuda"
    card = degradation_ladder(pol, "cuda:0")
    assert [(r[0], r[2]) for r in card] == [
        ("compact", torch.device("cuda", 0))]
    only = degradation_ladder(pol, "cpu")
    assert [r[0] for r in only] == ["compact"]
    assert only[0][2] == torch.device("cpu")


# --------------------------------------------------------------------------
# the scheduler's fault tolerance (reference test_faults.py)
# --------------------------------------------------------------------------

def _clean_costs(reqs, **kw):
    with _sched(eps=0.2, linger_ms=100, **kw) as clean:
        futs = [clean.submit(x, y) for x, y in reqs]
        assert clean.flush(timeout=WAIT)
        return [f.result(timeout=WAIT)["cost"] for f in futs]


def test_scheduler_quarantine_survivors_bit_identical():
    reqs = _cloud_batch(seed=7, n_req=5)
    clean_costs = _clean_costs(reqs)
    inj = FaultInjector(FaultPlan(poison_submits=(2,)))
    with _sched(eps=0.2, linger_ms=100, faults=inj) as sched:
        futs = [sched.submit(x, y) for x, y in reqs]
        assert sched.flush(timeout=WAIT)
        assert all(f.done() for f in futs)
        with pytest.raises(RequestRejected, match="request #2"):
            futs[2].result(timeout=0)
        for i in (0, 1, 3, 4):
            assert futs[i].result(timeout=0)["cost"] == clean_costs[i]
        sd = sched.stats_dict()
        assert sd["rejected"] == 1 and sd["requests"] == 4
    assert inj.log == [("poison", 2)]


def test_scheduler_bisection_isolates_dispatch_poison():
    reqs = _cloud_batch(seed=8, n_req=6)
    clean_costs = _clean_costs(reqs)
    inj = FaultInjector(FaultPlan(poison_dispatch_of=(3,)))
    with _sched(eps=0.2, linger_ms=100, faults=inj,
                validate=False) as sched:
        futs = [sched.submit(x, y) for x, y in reqs]
        assert sched.flush(timeout=WAIT)
        with pytest.raises(RequestRejected, match="bisection"):
            futs[3].result(timeout=0)
        for i in (0, 1, 2, 4, 5):
            assert futs[i].result(timeout=0)["cost"] == clean_costs[i]
        assert sched.stats_dict()["quarantined"] == 1
        f = sched.submit(*reqs[0], want=("cost",))
        assert f.result(timeout=WAIT).stats.quarantined == 0
    assert ("poison-dispatch", 0) in inj.log


def test_scheduler_debug_check_triggered_bisection():
    """With validation OFF and the sanitizer ON, a NaN input is caught
    mid-dispatch (DebugCheckError) and bisection still isolates it: the
    detection path the admission gate normally short-circuits. The
    counterpart of the reference's
    ``test_scheduler_checkify_triggered_bisection``; the compact policy,
    because the checks apply to the single-device compacting driver."""
    reqs = _cloud_batch(seed=9, n_req=4)
    clean_costs = _clean_costs(reqs)
    inj = FaultInjector(FaultPlan(poison_submits=(1,)))
    set_debug_checks(True)
    try:
        with _sched(eps=0.2, linger_ms=100, faults=inj, validate=False,
                    policy=DispatchPolicy(mode="compact")) as sched:
            futs = [sched.submit(x, y) for x, y in reqs]
            assert sched.flush(timeout=WAIT)
            assert all(f.done() for f in futs)
            with pytest.raises(RequestRejected, match="request #1"):
                futs[1].result(timeout=0)
            with pytest.raises(RequestRejected, match="nan"):
                futs[1].result(timeout=0)
            for i in (0, 2, 3):
                assert futs[i].result(timeout=0)["cost"] == clean_costs[i]
            assert sched.stats_dict()["quarantined"] == 1
    finally:
        set_debug_checks(None)


def test_debug_check_error_is_poison():
    err = DebugCheckError("finite-cost", 3, "nan or inf cost")
    assert is_poison(err) and not is_transient(err)
    assert (err.check, err.lane) == ("finite-cost", 3)
    assert "bucket lane 3" in str(err)


def _two_cpu_rungs(monkeypatch):
    """The ladder has one rung; these tests give it two CPU rungs so that
    ``run_with_recovery``'s descent can be observed through the
    scheduler."""
    real = ft.degradation_ladder

    def two_rungs(policy, device=None):
        rung = real(policy, device)[0]
        return [rung, ("cpu", rung[1], torch.device("cpu"))]

    monkeypatch.setattr(ft, "degradation_ladder", two_rungs)


def test_scheduler_transient_retries_down_ladder(monkeypatch):
    """Two transient failures with two retries a rung land the bucket on
    the second rung, with the clean run's results."""
    reqs = _cloud_batch(seed=10, n_req=3)
    with _sched(eps=0.2, linger_ms=100) as clean:
        clean_costs = [f.result(timeout=WAIT).cost
                       for f in [clean.submit(x, y, want=("cost",))
                                 for x, y in reqs]]
    _two_cpu_rungs(monkeypatch)
    inj = FaultInjector(FaultPlan(transient_dispatches=2))
    with _sched(eps=0.2, linger_ms=100, faults=inj, retries_per_level=2,
                retry_backoff_s=0.001) as sched:
        sols = [f.result(timeout=WAIT)
                for f in [sched.submit(x, y, want=("cost",))
                          for x, y in reqs]]
        st = sols[0].stats
        assert (st.attempts, st.ladder_level) == (3, 1)
        for sol, ref in zip(sols, clean_costs):
            assert sol.cost == ref
        assert sched.stats_dict()["retries"] == 2
    assert inj.log == [("transient", 0), ("transient", 1)]


def test_scheduler_spent_transients_split_the_bucket():
    """A bucket whose transient retries are spent is split in halves on
    its own device; the halves resolve at ladder level 0 with the clean
    run's results, and their attempts count the failed ones. A single
    request with its retries spent fails with the transient error."""
    reqs = _cloud_batch(seed=17, n_req=4)
    with _sched(eps=0.2, linger_ms=100) as clean:
        clean_costs = [f.result(timeout=WAIT).cost
                       for f in [clean.submit(x, y, want=("cost",))
                                 for x, y in reqs]]
    # a compact policy has a one-rung ladder (a mesh policy's second
    # rung: test_scheduler_mesh_ladder_walks_to_compact_then_splits)
    one_rung = DispatchPolicy(mode="compact")
    inj = FaultInjector(FaultPlan(transient_dispatches=2))
    sink = InMemorySink()
    with _sched(eps=0.2, linger_ms=100, faults=inj, retries_per_level=2,
                retry_backoff_s=0.001, sinks=(sink,),
                policy=one_rung) as sched:
        sols = [f.result(timeout=WAIT)
                for f in [sched.submit(x, y, want=("cost",))
                          for x, y in reqs]]
        assert [(s.stats.ladder_level, s.stats.attempts)
                for s in sols] == [(0, 3)] * 4
        assert [s.cost for s in sols] == clean_costs
        assert sched.stats_dict()["retries"] == 1
    (split,) = sink.events("split")
    assert split["batch"] == 4 and split["error"] == "TransientDispatchError"
    assert inj.log == [("transient", 0), ("transient", 1)]

    inj = FaultInjector(FaultPlan(transient_dispatches=2))
    with _sched(eps=0.2, faults=inj, retries_per_level=3,
                retry_backoff_s=0.001, policy=one_rung) as sched:
        f = sched.submit(*reqs[0], want=("cost",))
        assert sched.flush(timeout=WAIT)
        assert f.result(timeout=WAIT).stats.attempts == 3
        f = sched.submit(*reqs[1], want=("cost",))
        assert sched.flush(timeout=WAIT)
        assert f.result(timeout=0).stats.attempts == 1
    inj = FaultInjector(FaultPlan(transient_dispatches=5))
    with _sched(eps=0.2, faults=inj, retries_per_level=2,
                retry_backoff_s=0.001, policy=one_rung) as sched:
        f = sched.submit(*reqs[0], want=("cost",))
        assert sched.flush(timeout=WAIT)
        with pytest.raises(TransientDispatchError):
            f.result(timeout=0)
    assert inj.log == [("transient", 0), ("transient", 1)]


def test_scheduler_kernel_failure_is_not_retried(monkeypatch):
    """A kernel launch failure is a programming error: it fails the
    bucket's Futures at once instead of walking the ladder."""
    reqs = _cloud_batch(seed=16, n_req=2)
    tried = []

    def broken(*a, **k):
        tried.append(1)
        raise RuntimeError("repro_torch: slack_propose kernel launch "
                           "failed (cudaError 700)")

    _two_cpu_rungs(monkeypatch)
    monkeypatch.setattr("repro_torch.core.api.solve", broken)
    with _sched(eps=0.2, linger_ms=50) as sched:
        futs = [sched.submit(x, y) for x, y in reqs]
        assert sched.flush(timeout=WAIT)
        for f in futs:
            with pytest.raises(RuntimeError, match="cudaError"):
                f.result(timeout=0)
        assert sched.stats_dict()["retries"] == 0
    assert len(tried) == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_strands_no_future():
    reqs = _cloud_batch(seed=11, n_req=3)
    inj = FaultInjector(FaultPlan(kill_worker_at_dispatch=0))
    sched = _sched(eps=0.2, linger_ms=50, faults=inj)
    futs = [sched.submit(x, y) for x, y in reqs]
    assert sched.flush(timeout=WAIT)
    for f in futs:
        assert f.done()
        with pytest.raises(RuntimeError):
            f.result(timeout=0)
    sched.close()
    assert not sched._pending
    assert inj.log == [("kill", 0)]
    assert issubclass(WorkerDeath, SystemExit)


def test_chaos_combined_latency_transient_poison():
    reqs = _cloud_batch(seed=12, n_req=6)
    clean_costs = _clean_costs(reqs)
    inj = FaultInjector(FaultPlan(
        poison_submits=(1,), poison_dispatch_of=(4,),
        transient_dispatches=1, dispatch_latency_s=0.01))
    with _sched(eps=0.2, linger_ms=100, faults=inj, retries_per_level=2,
                retry_backoff_s=0.001) as sched:
        futs = [sched.submit(x, y) for x, y in reqs]
        assert sched.flush(timeout=WAIT)
        assert all(f.done() for f in futs)
        for i in (1, 4):
            with pytest.raises(RequestRejected):
                futs[i].result(timeout=0)
        for i in (0, 2, 3, 5):
            assert futs[i].result(timeout=0)["cost"] == clean_costs[i]
        sd = sched.stats_dict()
        assert sd["rejected"] == 1 and sd["quarantined"] == 1
        assert sd["retries"] >= 1
    kinds = [k for k, _ in inj.log]
    assert "poison" in kinds and "poison-dispatch" in kinds
    assert "transient" in kinds


def test_deadline_via_scheduler_degrades_not_fails():
    rng = np.random.default_rng(14)
    with _sched(eps=0.02, linger_ms=100,
                policy=DispatchPolicy(mode="compact", chunk=1)) as sched:
        futs = [sched.submit(_pts(rng, 48), _pts(rng, 48),
                             want=("cost", "duals"), deadline=0.0)
                for _ in range(2)]
        sols = [f.result(timeout=WAIT) for f in futs]
        assert all(s.degraded for s in sols)
        assert all(bool(s.dual_feasible()) for s in sols)
        assert all(np.isfinite(float(s.additive_gap())) for s in sols)
        sd = sched.stats_dict()
        assert sd["degraded"] == 2 and sd["deadline_hits"] >= 1
    with _sched(eps=0.2, linger_ms=0) as sched:
        f = sched.submit(_pts(rng, 10), _pts(rng, 10), want=("cost",),
                         deadline=600.0)
        assert f.result(timeout=WAIT).degraded is False


def test_deadline_requires_chunked_driver():
    c = np.abs(np.random.default_rng(2).standard_normal((2, 6, 6)))
    with pytest.raises(ValueError, match="deadline"):
        dispatch(ASSIGNMENT, {"c": np.float32(c)}, 0.1,
                 policy=DispatchPolicy(mode="lockstep"),
                 deadline=time.monotonic() + 9.0, device="cpu")


def test_service_quarantine_survivors_bit_identical():
    reqs = _cloud_batch(seed=15, n_req=4)
    clean = OTService(eps=0.2, device="cpu")
    for x, y in reqs:
        clean.submit(x, y)
    clean_costs = [r["cost"] for r in clean.run_batch()]
    svc = OTService(eps=0.2, device="cpu")
    for i, (x, y) in enumerate(reqs):
        if i == 2:
            x = x.copy()
            x[0, 0] = np.nan
        svc.submit(x, y)
    res = svc.run_batch()
    assert isinstance(res[2], RequestRejected) and res[2].code != 0
    for i in (0, 1, 3):
        assert res[i]["cost"] == clean_costs[i]
    bad = reqs[0][0].copy()
    bad[0, 0] = np.inf
    with pytest.raises(RequestRejected):
        OTService(eps=0.2, device="cpu").distance(bad, reqs[0][1])


def test_direct_validate_and_deadline_through_solve():
    """The direct API's all-or-nothing gate and the degraded flag."""
    rng = np.random.default_rng(13)
    c = np.abs(rng.standard_normal((2, 20, 20))).astype(np.float32)
    pol = DispatchPolicy(mode="compact", chunk=1, validate=True)
    sol = solve(ASSIGNMENT, {"c": c}, 0.02, pol, want=("cost", "duals"),
                deadline=time.monotonic(), device="cpu")
    assert sol.degraded().all() and sol.dual_feasible().all()
    c[0, 1, 2] = np.nan
    with pytest.raises(V.RequestRejected):
        solve(ASSIGNMENT, {"c": c}, 0.02, pol, device="cpu")
    with pytest.raises(V.RequestRejected):
        solve(OT, {"c": c[:1], "nu": np.full((1, 20), 0.05, np.float32),
                   "mu": np.full((1, 20), 0.05, np.float32)}, 0.1, pol,
              device="cpu")


# --------------------------------------------------------------------------
# shutdown (reference test_scheduler_shutdown.py)
# --------------------------------------------------------------------------

def _upts(rng, m):
    return rng.uniform(size=(int(m), 2)).astype(np.float32)


def test_close_races_live_submitters():
    rng = np.random.default_rng(0)
    sched = _sched(eps=0.2, linger_ms=2)
    sched.submit(_upts(rng, 12), _upts(rng, 12)).result(timeout=WAIT)
    futs: list = []
    rejected = threading.Event()

    def spam(seed):
        r = np.random.default_rng(seed)
        while True:
            try:
                futs.append(sched.submit(_upts(r, r.integers(8, 16)),
                                         _upts(r, r.integers(8, 16))))
            except RuntimeError:
                rejected.set()
                return
            time.sleep(0.005)

    threads = [threading.Thread(target=spam, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    time.sleep(0.25)
    sched.close()
    for t in threads:
        t.join(timeout=JOIN)
        assert not t.is_alive()
    assert rejected.is_set()
    assert len(futs) > 0
    for f in futs:
        assert f.done()
        assert "cost" in f.result(timeout=0)
    assert not sched._pending


def test_cancelled_future_does_not_poison_batch():
    rng = np.random.default_rng(1)
    with _sched(eps=0.2, linger_ms=100) as sched:
        f1 = sched.submit(_upts(rng, 10), _upts(rng, 10))
        f2 = sched.submit(_upts(rng, 11), _upts(rng, 11))
        cancelled = f1.cancel()
        assert sched.flush(timeout=WAIT)
        assert f2.done()
        assert "cost" in f2.result(timeout=0)
        assert f1.done()
        if cancelled:
            assert f1.cancelled()


def test_collate_error_fails_batch_but_scheduler_survives():
    rng = np.random.default_rng(2)
    with _sched(eps=0.2, linger_ms=0) as sched:
        bad = sched.submit(np.ones((7,), np.float32),
                           np.ones((7,), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=WAIT)
        ok = sched.submit(_upts(rng, 9), _upts(rng, 9))
        assert "cost" in ok.result(timeout=WAIT)


def test_dead_dispatch_worker_never_hangs():
    rng = np.random.default_rng(3)
    sched = _sched(eps=0.2, linger_ms=0)
    try:
        sched._work_q.put(None)
        sched._dispatch_t.join(timeout=JOIN)
        assert not sched._dispatch_t.is_alive()
        fut = sched.submit(_upts(rng, 8), _upts(rng, 8))
        t0 = time.monotonic()
        assert sched.flush(timeout=WAIT)
        assert time.monotonic() - t0 < WAIT
        assert fut.done()
        with pytest.raises(RuntimeError):
            fut.result(timeout=0)
        with pytest.raises(RuntimeError):
            sched.submit(_upts(rng, 8), _upts(rng, 8))
    finally:
        sched.close()
    assert not sched._pending


def test_dead_dispatcher_full_work_queue_never_wedges_collate():
    rng = np.random.default_rng(4)
    sched = _sched(eps=0.2, linger_ms=50)
    try:
        sched._work_q.put(None)
        sched._dispatch_t.join(timeout=JOIN)
        assert not sched._dispatch_t.is_alive()
        futs = [sched.submit(_upts(rng, m), _upts(rng, m))
                for m in (6, 18, 40, 7, 19, 41)]
        t0 = time.monotonic()
        assert sched.flush(timeout=WAIT)
        assert time.monotonic() - t0 < WAIT
        for f in futs:
            assert f.done()
            with pytest.raises(RuntimeError):
                f.result(timeout=0)
    finally:
        sched.close()
    assert not sched._collate_t.is_alive()
    assert not sched._pending


def test_close_raises_on_hung_worker():
    rng = np.random.default_rng(5)
    sched = _sched(eps=0.2, linger_ms=0, join_timeout_s=0.3)
    sched.submit(_upts(rng, 8), _upts(rng, 8)).result(timeout=WAIT)
    sched._work_q.put(None)
    sched._dispatch_t.join(timeout=JOIN)
    assert not sched._dispatch_t.is_alive()
    hang = threading.Event()
    dummy = threading.Thread(target=hang.wait, name="ot-dispatch",
                             daemon=True)
    dummy.start()
    sched._dispatch_t = dummy
    try:
        fut = sched.submit(_upts(rng, 9), _upts(rng, 9))
        time.sleep(0.2)
        with pytest.raises(RuntimeError, match="ot-dispatch"):
            sched.close()
        assert fut.done()
        with pytest.raises(RuntimeError):
            fut.result(timeout=0)
        assert not sched._pending
        sched.close()
    finally:
        hang.set()


def test_close_idempotent_and_reentrant():
    sched = _sched(eps=0.2)
    sched.close()
    sched.close()
    with pytest.raises(RuntimeError):
        sched.submit(np.ones((4, 2)), np.ones((4, 2)))


# --------------------------------------------------------------------------
# the portfolio behind the services (reference tests/test_portfolio.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["sinkhorn", "hybrid"])
def test_otservice_portfolio_end_to_end(solver):
    rng = np.random.default_rng(14)
    svc = OTService(eps=0.3, compact=True, solver=solver,
                    want=("cost", "duals", "stats"), device="cpu")
    for _ in range(2):
        x = rng.normal(size=(10, 2))
        y = rng.normal(size=(12, 2))
        nu = np.abs(rng.normal(size=10)) + 0.1
        mu = np.abs(rng.normal(size=12)) + 0.1
        svc.submit(x, y, nu=nu / nu.sum(), mu=mu / mu.sum())
    for s in svc.run_batch():
        assert s.stats.solver == solver
        assert bool(s.dual_feasible())
        assert s.additive_gap() <= s.additive_gap_bound() + 1e-6


def test_scheduler_portfolio_end_to_end():
    rng = np.random.default_rng(15)
    with _sched(eps=0.3, solver="sinkhorn", want=("cost", "duals", "stats"),
                linger_ms=5.0) as sched:
        futs = []
        for _ in range(2):
            x = rng.normal(size=(8, 2))
            y = rng.normal(size=(8, 2))
            nu = np.abs(rng.normal(size=8)) + 0.1
            mu = np.abs(rng.normal(size=8)) + 0.1
            futs.append(sched.submit(x, y, nu=nu / nu.sum(),
                                     mu=mu / mu.sum()))
        for f in futs:
            s = f.result(timeout=WAIT)
            assert s.stats.solver == "sinkhorn"
            assert s.additive_gap() <= s.additive_gap_bound() + 1e-6


# --------------------------------------------------------------------------
# mesh dispatch through the services (ROADMAP.md Queue 1 item 11)
# --------------------------------------------------------------------------

def _cpu_mesh(d):
    from repro_torch.launch.mesh import make_small_mesh

    return make_small_mesh((d,), ("data",), devices="cpu")


def test_scheduler_default_policy_is_mesh_like_the_reference():
    """The scheduler's default policy is mode "mesh" over its mesh, as the
    reference's is, and its buckets report it: one device on a CPU
    scheduler, whose mesh is built on its device."""
    reqs = _requests(21, count=4)
    with _sched(eps=0.1, linger_ms=50) as sched:
        assert sched._policy.resolved_mode() == "mesh"
        assert sched._policy.mesh.flat_devices == (torch.device("cpu"),)
        futs = [sched.submit(x, y, nu, mu, want=("cost",))
                for x, y, nu, mu in reqs]
        sols = [f.result(timeout=WAIT) for f in futs]
    for s in sols:
        assert (s.stats.mode, s.stats.devices, s.stats.placement) == (
            "mesh", 1, "batch")
    with JScheduler(eps=0.1, join_timeout_s=JOIN) as ref:
        assert ref._policy.resolved_mode() == "mesh"


def test_mesh_degradation_ladder_has_the_compact_rung():
    """Below a mesh policy: compact on the mesh's first device, with the
    policy's chunk, buckets and guarantee (the reference's middle rung);
    no CPU rung."""
    mesh = _cpu_mesh(2)
    pol = DispatchPolicy(mode="mesh", mesh=mesh, chunk=3, buckets=(16, 64),
                         guaranteed=True, fused=True)
    rungs = degradation_ladder(pol, "cpu")
    assert [r[0] for r in rungs] == ["mesh", "compact"]
    assert rungs[0][1] is pol and {r[2] for r in rungs} == {
        torch.device("cpu")}
    compact = rungs[1][1]
    assert (compact.mode, compact.chunk, compact.buckets,
            compact.guaranteed) == ("compact", 3, (16, 64), True)
    ref = ft_ref_ladder(JPolicy(mode="mesh", mesh=object(), chunk=3,
                                buckets=(16, 64), guaranteed=True))
    assert [r[0] for r in ref][:2] == ["mesh", "compact"]
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        degradation_ladder(pol, "meta")


def ft_ref_ladder(policy):
    from repro.serve.ft import degradation_ladder as jladder

    return jladder(policy)


def test_scheduler_mesh_ladder_walks_to_compact_then_splits():
    """On the default mesh policy, transients spend the mesh rung, then
    the compact rung, then split the bucket; the halves resolve on the
    mesh rung with the clean results."""
    reqs = _cloud_batch(seed=18, n_req=4)
    with _sched(eps=0.2, linger_ms=100) as clean:
        clean_costs = [f.result(timeout=WAIT).cost
                       for f in [clean.submit(x, y, want=("cost",))
                                 for x, y in reqs]]
    inj = FaultInjector(FaultPlan(transient_dispatches=3))
    with _sched(eps=0.2, linger_ms=100, faults=inj, retries_per_level=2,
                retry_backoff_s=0.001) as sched:
        sols = [f.result(timeout=WAIT)
                for f in [sched.submit(x, y, want=("cost",))
                          for x, y in reqs]]
        assert [(s.stats.ladder_level, s.stats.attempts, s.stats.mode)
                for s in sols] == [(1, 4, "compact")] * 4
        assert [s.cost for s in sols] == clean_costs
    inj = FaultInjector(FaultPlan(transient_dispatches=4))
    with _sched(eps=0.2, linger_ms=100, faults=inj, retries_per_level=2,
                retry_backoff_s=0.001) as sched:
        sols = [f.result(timeout=WAIT)
                for f in [sched.submit(x, y, want=("cost",))
                          for x, y in reqs]]
        assert [(s.stats.ladder_level, s.stats.attempts, s.stats.mode)
                for s in sols] == [(0, 5, "mesh")] * 4
        assert [s.cost for s in sols] == clean_costs
        assert sched.stats_dict()["retries"] == 3


@pytest.mark.parametrize("d", [1, 2, 4])
def test_services_and_ragged_on_a_mesh_equal_compact(d):
    """``OTService(mesh=...)``, ``AsyncOTScheduler(mesh=...)`` and
    ``solve_*_ragged(mesh=...)`` on a logical d-device CPU mesh give the
    compact results (costs, phases, integer state)."""
    from repro_torch.core import batched as tB

    reqs = _requests(22, count=6)
    mesh = _cpu_mesh(d)
    want = ("cost", "state")
    got_svc = OTService(eps=0.1, mesh=mesh, want=want)
    ref_svc = OTService(eps=0.1, want=want, device="cpu")
    for x, y, nu, mu in reqs:
        got_svc.submit(x, y, nu, mu)
        ref_svc.submit(x, y, nu, mu)
    for g, r in zip(got_svc.run_batch(), ref_svc.run_batch()):
        assert g.cost == r.cost and g.phases == r.phases
        assert (g.stats.mode, g.stats.devices) == ("mesh", d)
        for f, rv in r.state()._asdict().items():
            assert torch.equal(getattr(g.state(), f), rv), f
    legacy = OTService(eps=0.1, mesh=mesh)
    legacy.submit(*reqs[0])
    assert legacy.run_batch()[0]["devices"] == d
    with AsyncOTScheduler(eps=0.1, mesh=mesh, linger_ms=50,
                          join_timeout_s=JOIN) as sched:
        futs = [sched.submit(x, y, nu, mu, want=("cost",))
                for x, y, nu, mu in reqs]
        costs = [f.result(timeout=WAIT).cost for f in futs]
    ref_svc2 = OTService(eps=0.1, want=("cost",), device="cpu")
    for x, y, nu, mu in reqs:
        ref_svc2.submit(x, y, nu, mu)
    assert costs == [s.cost for s in ref_svc2.run_batch()]
    rng = np.random.default_rng(d)
    cs = [rng.uniform(size=(m, m + 3)).astype(np.float32)
          for m in (9, 12, 15, 20, 11)]
    got = tB.solve_assignment_ragged(cs, 0.1, mesh=mesh)
    ref = tB.solve_assignment_ragged(cs, 0.1, device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["matching"], r["matching"])
        assert g["cost"] == r["cost"] and g["phases"] == r["phases"]
    ot = [(x, y, nu, mu) for x, y, nu, mu in reqs if nu is not None]
    from repro_torch.core.costs import build_cost_matrix

    ot_in = [(build_cost_matrix(x, y, device="cpu").numpy(), nu, mu)
             for x, y, nu, mu in ot]
    got = tB.solve_ot_ragged(ot_in, 0.1, mesh=mesh)
    ref = tB.solve_ot_ragged(ot_in, 0.1, device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["plan"], r["plan"])
        assert g["phases"] == r["phases"]
