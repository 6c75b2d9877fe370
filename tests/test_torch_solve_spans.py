"""The solve path's spans and counters (``repro_torch.obs.tracing``'s
recorder) on the CPU: the span tree of small assignment and OT solves
against the driver's own accounting, the per-call counts of the root
span against ``core.device.sync_counts``, nothing taken with recording
off, the ranges in a ``torch.profiler`` trace and the anchor that places
the spans on its clock, nesting under the scheduler's ``dispatch`` span,
the JSONL export, and every device->host read of a solve and its
artifacts counted under a kind."""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import device as tdevice  # noqa: E402
from repro_torch.core.costs import build_cost_matrix  # noqa: E402
from repro_torch.obs import InMemorySink, new_id  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402

WAIT = 60
PHASES = ("solve.prepare", "solve.prologue", "driver.chunk",
          "core.rounds", "solve.epilogue")


@pytest.fixture
def recorder():
    """The recorder as the test leaves it: empty ring, the profiler
    deciding, the registry's sinks as they were."""
    sinks = tracing.REGISTRY._sinks_ro
    tracing.clear()
    yield tracing
    tracing.record(None)
    for s in tracing.REGISTRY._sinks_ro[len(sinks):]:
        s.close()
    tracing.REGISTRY._sinks_ro = sinks
    tracing.clear()


def _instances(problem: str, b: int, n: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(b, n, 2)).astype(np.float32)
    y = rng.uniform(size=(b, n, 2)).astype(np.float32)
    nu = rng.dirichlet(np.ones(n), size=b).astype(np.float32)
    mu = rng.dirichlet(np.ones(n), size=b).astype(np.float32)
    return x, y, nu, mu


def _solve(problem: str, b: int, want, n: int = 24):
    """Costs built and solved as the benchmark's calls do, on the CPU."""
    x, y, nu, mu = _instances(problem, b, n)
    c = build_cost_matrix(x, y, "euclidean", device="cpu")
    if problem == "assignment":
        return list(tapi.solve(tapi.ASSIGNMENT, {"c": c}, 0.1,
                               want=want, device="cpu"))
    return tapi.solve(tapi.OT, [(c[j], nu[j], mu[j]) for j in range(b)],
                      0.1, want=want, device="cpu")


def _by_trace(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s["trace_id"], []).append(s)
    return out


@pytest.mark.parametrize("problem", ["assignment", "ot"])
@pytest.mark.parametrize("b", [1, 4])
def test_span_tree_of_a_solve(recorder, problem, b):
    want = (("cost", "duals", "matching") if problem == "assignment"
            else ("cost", "duals", "plan_sparse"))
    recorder.record(True)
    tdevice.reset_sync_counts()
    sols = _solve(problem, b, want)
    syncs = dict(tdevice.sync_counts)
    spans = recorder.recorded()
    roots = [s for s in spans if s["parent_id"] is None]
    assert [s["name"] for s in roots] == ["costs.build", "solve"]
    build, root = roots
    # on the CPU the cost build runs the kernel's plain version: no launch
    assert build["metric"] == "euclidean" and "launches" not in build
    assert (root["problem"], root["B"], root["m"], root["n"]) == (
        problem, b, 24, 24)
    assert root["mode"] == "compact" and root["solver"] == "pushrelabel"
    tree = _by_trace(spans)[root["trace_id"]]
    ids = {s["span_id"]: s for s in tree}
    # every span of the trace hangs under the root, inside its interval
    for s in tree:
        if s is root:
            continue
        p = ids[s["parent_id"]]
        assert p["t_start"] <= s["t_start"] <= s["t_end"] <= p["t_end"]
        assert s["name"] in PHASES
    chunks = [s for s in tree if s["name"] == "driver.chunk"]
    stats = sols[0].stats
    assert len(chunks) == stats.dispatches == root["chunks"]
    assert [(s["bucket"], s["live"]) for s in chunks] == list(
        stats.occupancy)
    assert all(ids[s["parent_id"]]["name"] == "driver.chunk"
               for s in tree if s["name"] == "core.rounds")
    for name in ("solve.prepare", "solve.prologue", "solve.epilogue"):
        (s,) = [s for s in tree if s["name"] == name]
        assert s["parent_id"] == root["span_id"]
    rounds = [s["rounds"] for s in tree if s["name"] == "core.rounds"]
    assert sum(rounds) == root["rounds"]
    # the solve's reads, counted on its root; the artifacts' on theirs
    root_syncs = dict(root.get("syncs", {}))
    assert set(root["sync_wait_s"]) == set(root_syncs)
    assert all(v >= 0 for v in root["sync_wait_s"].values())
    assert root_syncs == {k: v for k, v in syncs.items() if v}
    assert root_syncs["chunk"] == stats.dispatches
    if problem == "ot":
        assert root_syncs["prepare"] == 1
    assert "epilogue" not in root_syncs

    # the artifacts: one solution.fetch root each, reads of kind "fetch"
    before = len(spans)
    tdevice.reset_sync_counts()
    for s in sols:
        s.cost, s.duals(), s.rounds
        if problem == "assignment":
            s.matching()
        else:
            s.plan_sparse()
    late = recorder.recorded()[before:]
    assert all(s["parent_id"] is None for s in late)
    assert {s["name"] for s in late} == {"solution.fetch"}
    arts = sorted(s["artifact"] for s in late)
    assert arts == sorted(["cost", "duals", "scalars",
                           "matching" if problem == "assignment"
                           else "plan_sparse"])
    assert sum(s["syncs"]["fetch"] for s in late) == tdevice.sync_counts[
        "fetch"]
    assert {k for k, v in tdevice.sync_counts.items() if v} == {"fetch"}
    if b == 1:
        assert sum(rounds) == sols[0].rounds


def test_certificates_span_and_count(recorder):
    sols = _solve("ot", 2, ("cost", "duals"))
    recorder.record(True)
    tdevice.reset_sync_counts()
    sols[0].dual_feasible(), sols[0].additive_gap_bound()
    sols[0].dual_objective()
    spans = recorder.recorded()
    roots = [s for s in spans if s["parent_id"] is None]
    certs = [s["certificate"] for s in spans
             if s["name"] == "solution.certificate"]
    assert sorted(set(certs)) == ["dual_feasible", "dual_objective",
                                  "mass", "scale"]
    # scale() inside dual_feasible() is a child of its span
    (feas,) = [s for s in roots if s.get("certificate") == "dual_feasible"]
    assert any(s["parent_id"] == feas["span_id"] for s in spans)
    total = sum(s.get("syncs", {}).get("fetch", 0) for s in roots)
    assert total == tdevice.sync_counts["fetch"] > 0


def test_nothing_recorded_with_recording_off(recorder, monkeypatch):
    """Profiler off and recording off: a span site makes no Span, no
    ``_Open``, no clock read, no ``record_function`` and takes no id."""
    def boom(*a, **k):
        raise AssertionError("span machinery ran with recording off")

    assert not tracing.recording()
    for name in ("Span", "_Open", "now", "_range", "_take_anchor",
                 "_child", "_nest"):
        monkeypatch.setattr(tracing, name, boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    first = new_id("probe")
    sols = _solve("ot", 2, ("cost", "duals", "plan_sparse"))
    sols[0].plan_sparse(), sols[0].dual_feasible()
    _solve("assignment", 1, None)
    assert new_id("probe") == f"probe-{int(first.split('-')[1]) + 1}"
    assert tracing.recorded() == [] and tracing.anchor() is None
    assert tracing.span("driver.chunk") is tracing._NULL
    assert tracing.root("solve") is tracing._NULL
    with tracing.root("solve") as sp:
        assert sp is None
    # the operator's off holds under a profiler too
    tracing.record(False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _solve("assignment", 1, ("cost",))
    assert tracing.recorded() == []


def test_spans_sit_in_the_profiler_trace(recorder):
    """Under a CPU ``torch.profiler`` session (no switch): every span is
    a kineto range of its name, and the anchor places its start within
    2 ms of the range's ``start_ns``."""
    assert not tracing.recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        sols = _solve("ot", 1, ("cost", "duals"))
        sols[0].cost
    assert not tracing.recording()
    spans = sorted(tracing.recorded(), key=lambda s: s["t_start"])
    names = {s["name"] for s in spans}
    assert {"costs.build", "solve", "solution.fetch",
            "core.rounds"} <= names
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            ranges.setdefault(e.name(), []).append(e.start_ns())
    assert tracing.anchor() is not None
    for name in names:
        mine = [tracing.epoch_ns(s["t_start"]) for s in spans
                if s["name"] == name]
        theirs = sorted(ranges.get(name, []))
        assert len(mine) == len(theirs), name
        for a, k in zip(mine, theirs):
            assert abs(a - k) < 2e6, (name, a - k)


def test_solve_spans_nest_under_the_scheduler_dispatch(recorder):
    from repro_torch.serve.scheduler import AsyncOTScheduler

    recorder.record(True)
    sink = InMemorySink()
    rng = np.random.default_rng(3)
    with AsyncOTScheduler(eps=0.25, max_batch=4, linger_ms=5.0,
                          sinks=(sink,), device="cpu",
                          policy=tapi.DispatchPolicy(mode="compact"),
                          join_timeout_s=5) as sched:
        futs = [sched.submit(rng.random((8, 2)), rng.random((8, 2)))
                for _ in range(3)]
        assert sched.flush(timeout=WAIT)
        for f in futs:
            f.result(timeout=WAIT)
    spans = sink.spans()
    ids = {s["span_id"]: s for s in spans}
    chunks = [s for s in spans if s["name"] == "driver.chunk"]
    assert chunks
    for s in chunks + [s for s in spans if s["name"] in PHASES]:
        names, p = [], s
        while p.get("parent_id") in ids:
            p = ids[p["parent_id"]]
            names.append(p["name"])
        assert "dispatch" in names, names
        assert p["trace_id"] == s["trace_id"]
    # the scheduler's solves went to its registry, not the process ring
    assert not [s for s in tracing.recorded() if s["name"] == "solve"]


def test_operator_switch_exports_jsonl(recorder, tmp_path):
    path = tmp_path / "spans.jsonl"
    recorder.record(True, jsonl=str(path))
    assert recorder.anchor() is not None
    _solve("assignment", 1, ("cost",))
    tracing.REGISTRY.sinks[-1].flush()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert {ln["event"] for ln in lines} == {"span"}
    got = sorted(ln["data"]["span_id"] for ln in lines)
    assert got == sorted(s["span_id"] for s in tracing.recorded())


@pytest.mark.parametrize("flag", ["1", "spans.jsonl"])
def test_the_environment_switch(tmp_path, flag):
    """``REPRO_SPANS`` at import: "1" records, a file name records and
    exports there."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from repro_torch.obs import tracing\n"
        "with torch.profiler.profile(activities=["
        "torch.profiler.ProfilerActivity.CPU]):\n"
        "    on = tracing.recording()\n"
        "    with tracing.root('solve'):\n"
        "        pass\n"
        "tracing.REGISTRY.close()\n"
        "print(on, len(tracing.recorded()))\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, REPRO_SPANS=flag, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=WAIT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "1"]
    if flag.endswith(".jsonl"):
        (line,) = (tmp_path / flag).read_text().splitlines()
        assert json.loads(line)["data"]["name"] == "solve"


@pytest.mark.parametrize("on, bare, profiled", [
    (True, True, True), (False, False, False), (None, False, True)])
def test_the_operator_switch(recorder, on, bare, profiled):
    """``record(True)`` records with or without a profiler, ``False``
    never, ``None`` (the default) while a profiler session is live."""
    tracing.record(on)
    assert tracing.recording() is bare
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.recording() is profiled


def test_a_worker_thread_records_under_the_switch_only(recorder):
    """The profiler's flag is per thread; the operator's switch is not."""
    seen = {}

    def work(key):
        seen[key] = tracing.recording()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=work, args=("profiler",))
        t.start()
        t.join(timeout=WAIT)
    recorder.record(True)
    t = threading.Thread(target=work, args=("switch",))
    t.start()
    t.join(timeout=WAIT)
    assert seen == {"profiler": False, "switch": True}


@pytest.mark.parametrize("problem", ["assignment", "ot"])
def test_every_read_of_a_solve_is_counted(monkeypatch, problem):
    """Every device->host read a solve and its artifacts make
    (``.cpu()``, ``.item()``, ``.tolist()``, or a tensor made a Python
    bool or number) is one counted read of ``core.device``."""
    raw = {"n": 0}
    for meth in ("cpu", "item", "tolist", "__bool__", "__int__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, meth)

        def counting(self, *a, _orig=orig, **k):
            raw["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, counting)
    want = (("cost", "duals", "matching", "plan_sparse")
            if problem == "assignment"
            else ("cost", "duals", "plan_sparse"))
    x, y, nu, mu = _instances(problem, 3)
    c = build_cost_matrix(x, y, "euclidean", device="cpu")
    tdevice.reset_sync_counts()
    raw["n"] = 0
    if problem == "assignment":
        sols = list(tapi.solve(tapi.ASSIGNMENT, {"c": c}, 0.1, want=want,
                               device="cpu"))
    else:
        sols = tapi.solve(tapi.OT, [(c[j], nu[j], mu[j])
                                    for j in range(3)], 0.1, want=want,
                          device="cpu")
    for s in sols:
        s.cost, s.duals(), s.rounds, s.theta if problem == "ot" else None
        s.plan_sparse(), s.dual_feasible(), s.additive_gap()
        if problem == "assignment":
            s.matching()
    assert raw["n"] == sum(tdevice.sync_counts.values()) > 0


def test_benchmark_metrics_read_the_recorded_spans(recorder, monkeypatch):
    """The benchmark's four span metrics (``portbench/metrics``) read
    the ring as recorded, per ``solve`` span; None from an empty ring or
    a program without the recorder."""
    from portbench.lib.harness import load_file

    names = ("driver.sync_wait_share.solo", "driver.sync_wait_share.batch",
             "driver.fixed_ms.solo", "core.round_host_us.solo")
    read = {n: load_file("metrics", n).read for n in names}
    assert {n: f(None) for n, f in read.items()} == dict.fromkeys(names)
    recorder.record(True)
    for _ in range(2):
        sols = _solve("ot", 1, ("cost", "duals", "plan_sparse"))
        sols[0].cost, sols[0].duals(), sols[0].plan_sparse()
    spans = tracing.recorded()
    top = [s for s in spans if s["parent_id"] is None]
    assert sorted({s["name"] for s in top}) == [
        "costs.build", "solution.fetch", "solve"]
    solves = [s for s in top if s["name"] == "solve"]
    chunk_s = sum(s["dur_s"] for s in spans if s["name"] == "driver.chunk")
    wait = sum(sum(s.get("sync_wait_s", {}).values()) for s in top)
    host = sum(s["dur_s"] for s in top)
    loops = [s for s in spans if s["name"] == "core.rounds"]
    want = {
        "driver.sync_wait_share.solo": 100 * wait / host,
        "driver.sync_wait_share.batch": 100 * wait / host,
        "driver.fixed_ms.solo": 1e3 * (host - chunk_s) / len(solves),
        "core.round_host_us.solo": 1e6 * sum(s["dur_s"] for s in loops)
        / sum(s["rounds"] for s in loops),
    }
    got = {n: f(None) for n, f in read.items()}
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got["driver.sync_wait_share.solo"] < 100
    monkeypatch.delattr(tracing, "recorded")
    assert {n: f(None) for n, f in read.items()} == dict.fromkeys(names)
