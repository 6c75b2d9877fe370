"""Lock discipline of the port's serving layer, the counterpart of
``tests/test_lock_discipline.py``: the static scan over
``AsyncOTScheduler`` and the locked pieces of ``repro_torch.obs``, the
``GuardedAttrProxy`` runtime guard, and the registry-backed stats
surface under a CPU stress (``join_timeout_s`` <= 5, every wait
bounded)."""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import locks as jlocks
from repro_torch.analysis.locks import (
    GuardedAttrProxy,
    LockTarget,
    default_targets,
    scan_class_source,
    scan_lock_discipline,
)
from repro_torch.serve.scheduler import AsyncOTScheduler

WAIT = 60


def _sched(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("join_timeout_s", 5)
    return AsyncOTScheduler(**kw)


# --------------------------------------------------------------------------
# Static scan
# --------------------------------------------------------------------------

def test_scheduler_scan_clean():
    """The port's scheduler holds the lock on every shared-field access
    (the same gate ``python -m repro_torch.analysis`` runs)."""
    for t in default_targets():
        assert scan_lock_discipline(t) == [], t.class_name


def test_default_targets_cover_obs():
    """The observability layer's locked pieces are in the default scan,
    its lock-free pieces recorded as exemptions (no fields, a note)."""
    by_class = {t.class_name: t for t in default_targets()}
    for cls in ("MetricsRegistry", "JSONLSink", "History", "TraceCapture"):
        assert by_class[cls].lock_attr == "_lock", cls
        assert by_class[cls].fields, cls
        assert "repro_torch" in by_class[cls].path, cls
    for cls in ("Counter", "Gauge", "Histogram", "InMemorySink",
                "Tracer", "Span", "OTService", "Engine"):
        assert by_class[cls].lock_attr is None, cls
        assert by_class[cls].note, cls
    assert "stats" not in by_class["AsyncOTScheduler"].fields


def test_default_targets_equal_reference_less_engine():
    """The reference's targets, field for field, the LLM Engine's
    included."""
    ref = {t.class_name: t for t in jlocks.default_targets()}
    got = {t.class_name: t for t in default_targets()}
    assert set(got) == set(ref)
    for name, t in got.items():
        assert (t.fields, t.lock_attr, t.exempt_methods) == (
            ref[name].fields, ref[name].lock_attr, ref[name].exempt_methods)


_VIOLATING_CLASS = '''
import threading

class Sched:
    def __init__(self):
        self._lock = threading.Condition()
        self.stats = 0
        self._outstanding = 0

    def good(self):
        with self._lock:
            self.stats += 1

    def bad(self):
        self.stats += 1                 # unguarded
        with self._lock:
            self._outstanding -= 1
        if self._outstanding > 0:       # unguarded re-read
            return True
'''


def test_scan_flags_unguarded_access():
    target = LockTarget(path="<fixture>", class_name="Sched",
                        fields=("stats", "_outstanding"),
                        lock_attr="_lock")
    keys = {f.key for f in scan_class_source(_VIOLATING_CLASS, target)}
    assert "lock-discipline:Sched.bad:unguarded:stats" in keys
    assert "lock-discipline:Sched.bad:unguarded:_outstanding" in keys
    assert not any(".good:" in k for k in keys)
    assert not any("__init__" in k for k in keys)


def test_scan_missing_class_reported():
    target = LockTarget(path="<fixture>", class_name="Nope",
                        fields=("x",), lock_attr="_lock")
    findings = scan_class_source("class Other: pass", target)
    assert any(f.detail == "missing-class" for f in findings)


def test_single_threaded_contract_scans_empty():
    target = LockTarget(path="<fixture>", class_name="Sched", fields=(),
                        lock_attr=None, note="single-threaded")
    assert scan_class_source(_VIOLATING_CLASS, target) == []


# --------------------------------------------------------------------------
# Runtime proxy
# --------------------------------------------------------------------------

class _Stats:
    def __init__(self):
        self.requests = 0


def test_proxy_records_unguarded_access():
    lock = threading.Condition()
    violations = []
    proxy = GuardedAttrProxy(_Stats(), lock, violations)
    proxy.requests += 1                     # get + set, no lock
    assert [v.op for v in violations] == ["get", "set"]
    assert all(v.attr == "requests" for v in violations)
    with lock:
        proxy.requests += 1                 # guarded: no new violations
        assert proxy.requests == 2
    assert len(violations) == 2
    assert "without lock" in str(violations[0])


def test_proxy_under_threads_records_only_unguarded():
    lock = threading.Condition()
    violations = []
    proxy = GuardedAttrProxy(_Stats(), lock, violations)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def guarded():
            for _ in range(200):
                with lock:
                    proxy.requests += 1

        threads = [threading.Thread(target=guarded) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    assert violations == []
    with lock:
        assert proxy.requests == 8 * 200   # no lost update under the lock


# --------------------------------------------------------------------------
# The stats surface under load
# --------------------------------------------------------------------------

def test_scheduler_stress_stats_consistent():
    """Hammer a live scheduler from several threads: the registry-backed
    stats view must come out exactly consistent (stats are lock-free
    per-thread cells, so consistency IS the contract)."""
    rng = np.random.default_rng(0)
    reqs = [(rng.random((6, 2)).astype(np.float32),
             rng.random((6, 2)).astype(np.float32)) for _ in range(24)]
    with _sched(eps=0.25, max_batch=8, linger_ms=2.0) as sched:
        futs = [None] * len(reqs)

        def submit(lo):
            for i in range(lo, len(reqs), 4):
                futs[i] = sched.submit(*reqs[i])

        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        assert sched.flush(timeout=WAIT)
        for f in futs:
            assert "cost" in f.result(timeout=WAIT)
        stats = sched.stats_dict()
        assert stats["requests"] == len(reqs)
        assert stats["batches"] >= 1
        assert stats["mean_wait_s"] == pytest.approx(
            stats["total_wait_s"] / stats["requests"])


def test_scheduler_stats_is_read_only_view():
    """``sched.stats`` is a snapshot property over the registry, not
    shared mutable state: assigning it is an error, and two reads give
    independent snapshots."""
    with _sched(eps=0.25) as sched:
        with pytest.raises(AttributeError):
            sched.stats = None
        a, b = sched.stats, sched.stats
        assert a is not b
        assert a.requests == b.requests == 0


def test_stats_dict_snapshot():
    with _sched(eps=0.25) as sched:
        d = sched.stats_dict()
    assert d["requests"] == 0 and d["batches"] == 0
    assert d["occupancy_window"] == 64
