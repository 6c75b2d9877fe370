"""repro_torch.obs: registry and instrument semantics, sink round trips,
span trees and the ``torch.profiler`` hook (the reference's
``tests/test_obs.py`` on the port), the port's names held against the
reference's, and the scheduler's stats reconciled exactly with the event
stream under a 12-thread submit stress with injected faults (CPU,
``join_timeout_s`` <= 5, every wait bounded)."""
from __future__ import annotations

import json
import logging
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.obs import (
    InMemorySink,
    JSONLSink,
    LoggingSink,
    MetricsRegistry,
    MetricsSink,
    NullSink,
    Tracer,
    now,
    profiler,
    span_tree,
)

WAIT = 60


def test_obs_surface_equals_reference():
    assert tobs.__all__ == jobs.__all__
    assert tobs.now is jobs.now                  # both time.monotonic
    assert (tobs.MetricsRegistry.LATENCY_BOUNDS
            == jobs.MetricsRegistry.LATENCY_BOUNDS)
    assert tobs.profiler._ENV_DIR == jobs.profiler._ENV_DIR
    assert tobs.profiler._ENV_MATCH == jobs.profiler._ENV_MATCH
    assert tobs.profiler._ENV_CAPTURES == jobs.profiler._ENV_CAPTURES


def test_compaction_uses_the_serving_clock():
    from repro_torch.core import compaction

    assert compaction._now is tobs.now


# --------------------------------------------------------------------------
# Instruments + registry
# --------------------------------------------------------------------------

def test_counter_exact_under_threads():
    reg = MetricsRegistry()
    c = reg.counter("t.c")
    N, T = 5000, 8

    def work():
        for _ in range(N):
            c.add(1)

    ts = [threading.Thread(target=work) for _ in range(T)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert c.value == N * T
    assert reg.snapshot()["t.c"] == N * T


def test_counter_get_or_create_is_same_instrument():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_gauge_last_write_wins():
    reg = MetricsRegistry()
    g = reg.gauge("t.g")
    g.set(3.5)
    g.set(7.0)
    assert g.value == 7.0
    assert reg.snapshot()["t.g"] == 7.0


def test_histogram_explicit_bounds_placement():
    reg = MetricsRegistry()
    h = reg.histogram("t.h", bounds=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    agg = h.aggregate()
    assert agg["buckets"] == [1, 1, 1, 1]
    assert agg["count"] == 4
    assert agg["sum"] == pytest.approx(55.55)
    assert agg["bounds"] == [0.1, 1.0, 10.0]


def test_histogram_rejects_bad_bounds():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.histogram("bad", bounds=())
    with pytest.raises(ValueError):
        reg.histogram("bad2", bounds=(1.0, 1.0, 2.0))
    reg.histogram("ok", bounds=(1.0, 2.0))
    with pytest.raises(ValueError):
        reg.histogram("ok", bounds=(1.0, 3.0))


def test_history_is_bounded():
    reg = MetricsRegistry()
    ring = reg.history("t.occ", maxlen=3)
    for i in range(10):
        ring.append(i)
    assert ring.snapshot() == [7, 8, 9]
    assert ring.maxlen == 3


def test_sinks_satisfy_protocol():
    for s in (NullSink(), InMemorySink(), LoggingSink()):
        assert isinstance(s, MetricsSink)


def test_attach_streams_to_sink():
    sink = InMemorySink()
    reg = MetricsRegistry()
    reg.counter("a").add(1)
    reg.attach(sink)
    reg.counter("a").add(2)
    reg.gauge("g").set(4.0)
    reg.histogram("h", bounds=(1.0,)).observe(0.5)
    assert sink.counter_total("a") == 2
    assert reg.snapshot()["a"] == 3
    assert {r[0] for r in sink.records} == {"counter", "gauge", "histogram"}


def test_jsonl_sink_round_trip(tmp_path):
    path = tmp_path / "obs.jsonl"
    sink = JSONLSink(str(path))
    reg = MetricsRegistry(sinks=(sink,))
    reg.counter("c").add(3)
    tr = Tracer(reg)
    with tr.span("outer", trace_id="t-1") as sp:
        tr.event("ping", trace_id="t-1", parent_id=sp.span_id,
                 value=np.float32(1.5), tensor=torch.tensor(2.5))
    sink.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["kind"] for r in rows].count("counter") == 1
    evs = [r for r in rows if r["kind"] == "event"]
    assert {e["event"] for e in evs} == {"ping", "span"}
    ping = next(e for e in evs if e["event"] == "ping")
    assert ping["data"]["value"] == 1.5
    assert ping["data"]["tensor"] == 2.5          # torch scalars serialize
    span = next(e for e in evs if e["event"] == "span")
    assert span["data"]["name"] == "outer"
    assert span["data"]["dur_s"] >= 0.0
    sink.close()


def test_logging_sink(caplog):
    logger = logging.getLogger("test.torch.obs.sink")
    reg = MetricsRegistry(sinks=(LoggingSink(logger),))
    with caplog.at_level(logging.INFO, logger="test.torch.obs.sink"):
        reg.counter("c").add(1)
        reg.emit("boom", {"t": now()})
    assert any("counter c" in r.message for r in caplog.records)
    assert any("event boom" in r.message for r in caplog.records)


def test_span_tree_renders_hierarchy():
    sink = InMemorySink()
    tr = Tracer(MetricsRegistry(sinks=(sink,)))
    root = tr.start("root", trace_id="t-9")
    with tr.span("child", trace_id="t-9", parent=root.span_id):
        with tr.span("other-trace", trace_id="t-10"):
            pass
    root.end()
    lines = span_tree(sink.spans(), "t-9").splitlines()
    assert lines[0].startswith("root")
    assert lines[1].startswith("  child")
    assert "other-trace" not in "\n".join(lines)


def test_span_end_is_idempotent_and_error_annotated():
    sink = InMemorySink()
    tr = Tracer(MetricsRegistry(sinks=(sink,)))
    with pytest.raises(ValueError):
        with tr.span("will-fail", trace_id="t-1"):
            raise ValueError("boom")
    (sp,) = sink.spans("will-fail")
    assert sp["error"] == "ValueError"
    s = tr.start("once", trace_id="t-2")
    s.end(k=1)
    s.end(k=2)
    (sp2,) = sink.spans("once")
    assert sp2["k"] == 1


# --------------------------------------------------------------------------
# Profiler hook (torch.profiler)
# --------------------------------------------------------------------------

def test_profiler_claim_match_and_exhaustion(tmp_path):
    cap = profiler.TraceCapture()
    cap.arm(str(tmp_path), match="64x64", captures=1)
    assert cap.armed()
    assert cap.claim("dispatch:32x32:compact") is None
    d = cap.claim("dispatch:64x64:compact")
    assert d == str(tmp_path / "dispatch_64x64_compact.json")
    assert cap.claim("dispatch:64x64:compact") is None
    assert not cap.armed()


def test_profiler_env_arming(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_PROFILE_CAPTURES", "2")
    cap = profiler.TraceCapture()
    assert cap.armed()
    assert cap.claim("anything") is not None
    cap.disarm()
    assert not cap.armed()


def test_profiler_capture_writes_chrome_trace(tmp_path):
    cap = profiler.TraceCapture()
    cap.arm(str(tmp_path / "prof"), captures=1)
    with cap.capture("dispatch:tiny") as live:
        assert live
        (torch.ones((64, 64)) @ torch.ones((64, 64))).sum().item()
    path = tmp_path / "prof" / "dispatch_tiny.json"
    trace = json.loads(path.read_text())
    assert trace["traceEvents"]                   # a capture was written
    with cap.capture("dispatch:tiny") as live:
        assert not live


def test_profiler_failure_disarms_and_body_runs(monkeypatch):
    cap = profiler.TraceCapture()
    cap.arm("unused", captures=3)

    def refuse():
        raise RuntimeError("profiler already running")

    monkeypatch.setattr(profiler, "_start_profile", refuse)
    ran = []
    with cap.capture("dispatch:x") as live:
        ran.append(live)
    assert ran == [False] and not cap.armed()
    # the rule covers the profiler only: the body's own error propagates
    cap.arm("unused", captures=1)
    with pytest.raises(KeyError):
        with cap.capture("dispatch:y"):
            raise KeyError("solve failed")


# --------------------------------------------------------------------------
# Scheduler / service / driver integration
# --------------------------------------------------------------------------

def test_scheduler_stress_events_reconcile_with_stats():
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    from repro_torch.serve.scheduler import AsyncOTScheduler

    T, PER = 12, 3
    total = T * PER
    plan = FaultPlan(poison_submits=(5, 17), poison_dispatch_of=(11,),
                     transient_dispatches=2)
    inj = FaultInjector(plan=plan)
    sink = InMemorySink()
    rng = np.random.default_rng(0)
    xs = [rng.random((6, 2)) for _ in range(total)]
    ys = [rng.random((6, 2)) for _ in range(total)]
    # on the CPU the ladder has one rung: three attempts on it absorb the
    # two transient failures (the reference walks them down its rungs)
    with AsyncOTScheduler(eps=0.25, max_batch=8, linger_ms=2.0,
                          faults=inj, sinks=(sink,), device="cpu",
                          retries_per_level=3, retry_backoff_s=0.001,
                          join_timeout_s=5) as sched:
        futs: list = []
        flock = threading.Lock()

        def client(k):
            for i in range(PER):
                f = sched.submit(xs[k * PER + i], ys[k * PER + i])
                with flock:
                    futs.append(f)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(T)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert sched.flush(timeout=WAIT)
        stats = sched.stats
        resolved = rejected = quarantined = 0
        for f in futs:
            try:
                assert "cost" in f.result(timeout=WAIT)
                resolved += 1
            except Exception as e:
                assert type(e).__name__ == "RequestRejected"
                if "poison" in str(e):
                    quarantined += 1
                else:
                    rejected += 1
    assert rejected == len(plan.poison_submits)
    assert quarantined == len(plan.poison_dispatch_of)
    assert resolved == total - rejected - quarantined
    assert stats.requests == resolved
    assert stats.rejected == rejected == sink.count("rejected")
    assert stats.quarantined == quarantined == sink.count("quarantine")
    assert stats.retries == sum(e["n"] for e in sink.events("retry"))
    assert stats.retries >= plan.transient_dispatches
    assert stats.dispatches == sink.count("chunk")
    assert sink.count("submit") == total
    spans = sink.spans("request")
    assert len(spans) == total
    outcomes = [s["outcome"] for s in spans]
    assert outcomes.count("resolved") == resolved
    assert outcomes.count("rejected") == rejected
    assert outcomes.count("quarantined") == quarantined
    assert sink.counter_total("scheduler.requests") == stats.requests
    assert sink.counter_total("scheduler.rejected") == stats.rejected
    dspans = [s for s in sink.spans("dispatch")
              if s.get("outcome") == "resolved"]
    assert len(dspans) == stats.batches


def test_scheduler_results_bit_identical_with_and_without_sink():
    from repro_torch.serve.scheduler import AsyncOTScheduler

    rng = np.random.default_rng(7)
    pairs = [(rng.random((6, 2)), rng.random((6, 2))) for _ in range(4)]

    def run(sinks):
        with AsyncOTScheduler(eps=0.25, max_batch=4, linger_ms=5.0,
                              sinks=sinks, device="cpu",
                              join_timeout_s=5) as sched:
            futs = [sched.submit(x, y) for x, y in pairs]
            assert sched.flush(timeout=WAIT)
            return [f.result(timeout=WAIT) for f in futs]

    for ra, rb in zip(run(()), run((InMemorySink(),))):
        assert ra["cost"] == rb["cost"]
        assert np.array_equal(ra["matching"], rb["matching"])
        assert ra["phases"] == rb["phases"]


def test_occupancy_window_knob():
    from repro_torch.serve.scheduler import AsyncOTScheduler

    rng = np.random.default_rng(1)
    with AsyncOTScheduler(eps=0.25, max_batch=1, occupancy_window=2,
                          device="cpu", join_timeout_s=5) as sched:
        futs = [sched.submit(rng.random((6, 2)), rng.random((6, 2)))
                for _ in range(5)]
        assert sched.flush(timeout=WAIT)
        for f in futs:
            f.result(timeout=WAIT)
        d = sched.stats_dict()
    assert d["batches"] == 5
    assert d["occupancy_window"] == 2
    assert len(d["occupancy"]) <= 2


def test_scheduler_stats_keys_equal_reference():
    from repro.serve.scheduler import SchedulerStats as JStats
    from repro_torch.serve.scheduler import SchedulerStats as TStats

    assert TStats().as_dict().keys() == JStats().as_dict().keys()
    assert TStats._COUNTERS == JStats._COUNTERS


def test_service_stats_dict_is_registry_view():
    from repro_torch.serve.engine import OTService

    rng = np.random.default_rng(2)
    sink = InMemorySink()
    svc = OTService(eps=0.25, sinks=(sink,), device="cpu")
    for _ in range(3):
        svc.submit(rng.random((6, 2)), rng.random((6, 2)))
    assert len(svc.run_batch()) == 3
    d = svc.stats_dict()
    assert d["requests"] == 3 and d["batches"] >= 1
    assert d["dispatches"] == sink.count("chunk")
    assert sink.counter_total("service.requests") == d["requests"]
    names = {s["name"] for s in sink.spans()}
    assert {"bucket", "admission", "solve", "artifact-fetch"} <= names


def test_driver_chunk_events_carry_phase_progress():
    """Per-chunk events: bucket occupancy, phase progress, wall time; the
    reference's ``compiled`` (jit-cache delta) has no torch meaning."""
    from repro_torch.core.api import ASSIGNMENT, DispatchPolicy, solve

    rng = np.random.default_rng(3)
    c = rng.random((3, 8, 8))
    sink = InMemorySink()
    tr = Tracer(MetricsRegistry(sinks=(sink,)))
    sols = solve(ASSIGNMENT, {"c": c}, 0.25,
                 DispatchPolicy(mode="compact", chunk=2), want=("cost",),
                 obs=tr.bind(trace_id="drv-1"), device="cpu")
    chunks = sink.events("chunk")
    assert len(chunks) == sols.stats.dispatches
    for e in chunks:
        assert e["trace_id"] == "drv-1"
        assert 0 <= e["live"] <= e["bucket"]
        assert e["phases"] >= 0 and e["chunk_s"] >= 0.0
        assert "compiled" not in e
    (choice,) = sink.events("solver-choice")
    assert choice["solver"] == "pushrelabel"


def test_obs_scans_clean():
    """Both static gates stay clean over the observability layer: the
    lock-discipline scan (the repro_torch.obs targets included) and the
    host-sync audit over the instrumented driver loops."""
    from repro_torch.analysis import locks, syncaudit

    targets = locks.default_targets()
    assert {"MetricsRegistry", "JSONLSink", "History", "TraceCapture"} <= {
        t.class_name for t in targets}
    assert [f for t in targets for f in locks.scan_lock_discipline(t)] == []
    assert syncaudit.audit_targets(syncaudit.default_targets()) == []
