"""Pluggable metrics: sinks, instruments, and the aggregating registry.

Port of ``repro.obs.metrics``; plain Python, the same names and logic.
Design constraints:

* **One clock.** ``now()`` is the monotonic time base shared by spans,
  deadlines, and wait/solve stats across the serving stack.  The chunked
  drivers compare ``deadline`` against the same clock, so a deadline
  computed from ``now()`` in the scheduler means the same instant inside
  ``core/compaction.py``.

* **Lock-free on the hot path.**  ``Counter.add`` / ``Gauge.set`` /
  ``Histogram.observe`` never take a lock: counters and histograms keep
  one cell per writer thread (keyed by ``threading.get_ident()``) so the
  only mutations are single-key updates of the writer's own cell, which
  are safe under the GIL.  Aggregation (``value`` / ``aggregate``) sums a
  point-in-time copy of the cells.  The registry's lock guards only
  instrument *creation* and the sink list rebind — never an observation.

* **Sinks own their thread-safety.**  The registry fans observations out
  to an immutable tuple (``_sinks_ro``) that is only ever rebound whole
  (atomic attribute read, no lock on the read side).  ``JSONLSink``
  serializes writes under its own lock; ``InMemorySink`` relies on
  ``deque.append`` atomicity; ``LoggingSink`` rides the logging module's
  per-handler locks.

Guarded state: ``MetricsRegistry._instruments``, ``JSONLSink._fh`` and
``History._items``, each under its object's ``_lock``; the instruments'
cells are the lock-free exception described above.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

#: THE monotonic clock for the serving stack.  Spans, request deadlines,
#: wait/solve accounting, and the chunk-loop deadline checks all read
#: this one function so their timestamps are mutually comparable.
now = time.monotonic

_DEFAULT_LATENCY_BOUNDS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0,
)


def jsonable(obj: Any) -> Any:
    """Best-effort conversion to something ``json.dumps`` accepts."""
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, deque)):
        return [jsonable(v) for v in obj]
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return jsonable(item())
        except Exception:
            pass
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        try:
            return jsonable(tolist())
        except Exception:
            pass
    return str(obj)


@runtime_checkable
class MetricsSink(Protocol):
    """Receiver for streamed observations and structured events.

    Implementations MUST be safe to call from multiple threads: the
    scheduler's collate and dispatch workers both emit.
    """

    def counter(self, name: str, value: float, t: float) -> None: ...

    def gauge(self, name: str, value: float, t: float) -> None: ...

    def histogram(self, name: str, value: float,
                  bounds: Tuple[float, ...], t: float) -> None: ...

    def event(self, kind: str, payload: Dict[str, Any]) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """A sink that drops everything (overhead-measurement control)."""

    def counter(self, name: str, value: float, t: float) -> None:
        pass

    def gauge(self, name: str, value: float, t: float) -> None:
        pass

    def histogram(self, name: str, value: float,
                  bounds: Tuple[float, ...], t: float) -> None:
        pass

    def event(self, kind: str, payload: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class InMemorySink:
    """Record every observation in memory; query helpers for tests.

    ``deque.append`` is atomic under the GIL, so concurrent emitters need
    no lock; query helpers snapshot the deque with ``list()`` (a single
    C-level call, so it cannot interleave with an append) before
    filtering.
    """

    def __init__(self) -> None:
        self.records: deque = deque()

    def counter(self, name: str, value: float, t: float) -> None:
        self.records.append(("counter", name, value, t))

    def gauge(self, name: str, value: float, t: float) -> None:
        self.records.append(("gauge", name, value, t))

    def histogram(self, name: str, value: float,
                  bounds: Tuple[float, ...], t: float) -> None:
        self.records.append(("histogram", name, value, t))

    def event(self, kind: str, payload: Dict[str, Any]) -> None:
        self.records.append(("event", kind, payload, payload.get("t")))

    def close(self) -> None:
        pass

    # -- query helpers (tests / demos) ---------------------------------
    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        out = []
        for ch, k, payload, _t in list(self.records):
            if ch == "event" and (kind is None or k == kind):
                rec = dict(payload)
                rec.setdefault("kind", k)
                out.append(rec)
        return out

    def count(self, kind: str) -> int:
        return len(self.events(kind))

    def counter_total(self, name: str) -> float:
        return sum(v for ch, n, v, _t in list(self.records)
                   if ch == "counter" and n == name)

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events("span")
                if name is None or e.get("name") == name]


class JSONLSink:
    """Append one JSON object per observation to a file.

    Serialization happens outside the lock; only the file write is
    serialized (``_fh`` is guarded by ``_lock``).
    """

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def _write(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(jsonable(obj), separators=(",", ":")) + "\n"
        with self._lock:
            if self._fh is not None:
                self._fh.write(line)

    def counter(self, name: str, value: float, t: float) -> None:
        self._write({"kind": "counter", "name": name, "value": value, "t": t})

    def gauge(self, name: str, value: float, t: float) -> None:
        self._write({"kind": "gauge", "name": name, "value": value, "t": t})

    def histogram(self, name: str, value: float,
                  bounds: Tuple[float, ...], t: float) -> None:
        self._write({"kind": "histogram", "name": name, "value": value,
                     "t": t})

    def event(self, kind: str, payload: Dict[str, Any]) -> None:
        self._write({"kind": "event", "event": kind, "data": payload})

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


class LoggingSink:
    """Forward observations to the stdlib ``logging`` module.

    The logging module serializes handler writes internally, so this
    sink carries no state of its own.
    """

    def __init__(self, logger: Optional[logging.Logger] = None,
                 level: int = logging.INFO) -> None:
        self.logger = logger or logging.getLogger("repro_torch.obs")
        self.level = level

    def counter(self, name: str, value: float, t: float) -> None:
        self.logger.log(self.level, "counter %s +%s", name, value)

    def gauge(self, name: str, value: float, t: float) -> None:
        self.logger.log(self.level, "gauge %s=%s", name, value)

    def histogram(self, name: str, value: float,
                  bounds: Tuple[float, ...], t: float) -> None:
        self.logger.log(self.level, "histogram %s<-%s", name, value)

    def event(self, kind: str, payload: Dict[str, Any]) -> None:
        self.logger.log(self.level, "event %s %s", kind, jsonable(payload))

    def close(self) -> None:
        pass


class Counter:
    """Monotonic counter with one cell per writer thread (lock-free add)."""

    __slots__ = ("name", "_reg", "_cells")

    def __init__(self, name: str, reg: "MetricsRegistry") -> None:
        self.name = name
        self._reg = reg
        self._cells: Dict[int, float] = {}

    def add(self, n: float = 1) -> None:
        cells = self._cells
        tid = threading.get_ident()
        cells[tid] = cells.get(tid, 0) + n
        sinks = self._reg._sinks_ro
        if sinks:
            t = now()
            for s in sinks:
                s.counter(self.name, n, t)

    @property
    def value(self) -> float:
        return sum(self._cells.copy().values())


class Gauge:
    """Last-write-wins scalar.  ``set`` is a single attribute rebind."""

    __slots__ = ("name", "_reg", "_value")

    def __init__(self, name: str, reg: "MetricsRegistry") -> None:
        self.name = name
        self._reg = reg
        self._value: float = 0.0

    def set(self, v: float) -> None:
        self._value = v
        sinks = self._reg._sinks_ro
        if sinks:
            t = now()
            for s in sinks:
                s.gauge(self.name, v, t)

    @property
    def value(self) -> float:
        return self._value


class _HistCell:
    __slots__ = ("counts", "total", "n")

    def __init__(self, nbuckets: int) -> None:
        self.counts = [0] * nbuckets
        self.total = 0.0
        self.n = 0


class Histogram:
    """Histogram with EXPLICIT bucket upper bounds (+inf implicit).

    Per-thread cells make ``observe`` lock-free; ``aggregate`` sums a
    copy of the cell map.
    """

    __slots__ = ("name", "bounds", "_reg", "_cells")

    def __init__(self, name: str, bounds: Sequence[float],
                 reg: "MetricsRegistry") -> None:
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(
                f"histogram {name!r} needs strictly increasing explicit "
                f"bucket bounds, got {b!r}")
        self.name = name
        self.bounds = b
        self._reg = reg
        self._cells: Dict[int, _HistCell] = {}

    def observe(self, v: float) -> None:
        cells = self._cells
        tid = threading.get_ident()
        cell = cells.get(tid)
        if cell is None:
            cell = cells[tid] = _HistCell(len(self.bounds) + 1)
        cell.counts[bisect_left(self.bounds, v)] += 1
        cell.total += v
        cell.n += 1
        sinks = self._reg._sinks_ro
        if sinks:
            t = now()
            for s in sinks:
                s.histogram(self.name, v, self.bounds, t)

    def aggregate(self) -> Dict[str, Any]:
        counts = [0] * (len(self.bounds) + 1)
        total = 0.0
        n = 0
        for cell in self._cells.copy().values():
            for i, c in enumerate(cell.counts):
                counts[i] += c
            total += cell.total
            n += cell.n
        return {"count": n, "sum": total, "bounds": list(self.bounds),
                "buckets": counts}

    @property
    def count(self) -> int:
        return sum(c.n for c in self._cells.copy().values())

    @property
    def sum(self) -> float:
        return sum(c.total for c in self._cells.copy().values())


class History:
    """Bounded ring of recent items (e.g. per-bucket occupancy curves).

    Appends are rare (once per bucket dispatch, not per observation) so
    a plain lock is fine; ``_items`` is guarded by ``_lock``.
    """

    __slots__ = ("name", "_lock", "_items")

    def __init__(self, name: str, maxlen: int) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._items: deque = deque(maxlen=int(maxlen))

    def append(self, item: Any) -> None:
        with self._lock:
            self._items.append(item)

    def snapshot(self) -> List[Any]:
        with self._lock:
            return list(self._items)

    @property
    def maxlen(self) -> int:
        with self._lock:
            return self._items.maxlen or 0


class MetricsRegistry:
    """Aggregating instrument registry with streaming sink fan-out.

    ``_lock`` guards the instrument table (``_instruments``) — i.e. the
    cold get-or-create path and ``snapshot()``.  Observations never
    enter the registry: instruments update their own lock-free cells and
    read the immutable ``_sinks_ro`` tuple directly (rebound whole under
    the lock by ``attach``; a plain attribute read is atomic).
    """

    LATENCY_BOUNDS = _DEFAULT_LATENCY_BOUNDS

    def __init__(self, sinks: Iterable[MetricsSink] = ()) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}
        self._sinks_ro: Tuple[MetricsSink, ...] = tuple(sinks)

    # -- sinks ---------------------------------------------------------
    def attach(self, sink: MetricsSink) -> None:
        with self._lock:
            self._sinks_ro = self._sinks_ro + (sink,)

    @property
    def sinks(self) -> Tuple[MetricsSink, ...]:
        return self._sinks_ro

    def emit(self, kind: str, payload: Dict[str, Any]) -> None:
        """Fan a structured event out to every sink."""
        for s in self._sinks_ro:
            s.event(kind, payload)

    # -- instruments ---------------------------------------------------
    def _get(self, name: str, cls, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name, self))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, self))

    def histogram(self, name: str,
                  bounds: Sequence[float] = _DEFAULT_LATENCY_BOUNDS
                  ) -> Histogram:
        h = self._get(name, Histogram, lambda: Histogram(name, bounds, self))
        if h.bounds != tuple(float(x) for x in bounds):
            raise ValueError(
                f"histogram {name!r} already registered with bounds "
                f"{h.bounds!r}")
        return h

    def history(self, name: str, maxlen: int = 64) -> History:
        return self._get(name, History, lambda: History(name, maxlen))

    # -- views ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time value of every instrument, keyed by name."""
        with self._lock:
            items = list(self._instruments.items())
        out: Dict[str, Any] = {}
        for name, inst in items:
            if isinstance(inst, (Counter, Gauge)):
                out[name] = inst.value
            elif isinstance(inst, Histogram):
                out[name] = inst.aggregate()
            else:
                out[name] = inst.snapshot()
        return out

    def close(self) -> None:
        for s in self._sinks_ro:
            s.close()
