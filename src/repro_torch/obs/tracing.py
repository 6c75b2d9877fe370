"""Hierarchical spans over the monotonic clock, emitted as events.

Port of ``repro.obs.tracing``; plain Python, the same names and logic.

A ``Span`` is one timed region (``t_start``/``t_end`` from
``metrics.now``) with a name, a trace id (per-request or per-bucket),
its own span id, and an optional parent span id — enough to rebuild the
tree submit → admission → collate → bucket dispatch → per-chunk solve →
artifact fetch from a flat event stream.  Spans are emitted ONCE, on
``end()``, as a single ``"span"`` event carrying both timestamps; there
is no partial state to lock.

``Tracer`` is the handle threaded through the serving stack: it holds
the registry (for sink fan-out), default trace/parent ids, and default
attributes.  ``bind()`` derives a child tracer with different defaults —
this is how the chunked drivers' per-chunk events get parented under the
dispatch's solve span without the drivers knowing about scheduling.

Thread-safety: span ids come from ``itertools.count`` (atomic in
CPython); a ``Span`` is only ever mutated by the thread that ends it;
``Tracer`` itself is immutable after construction.

The solve path's recorder (the second half of this module, beyond the
reference) puts the same ``Span``s on the layer boundaries of the port's
solve path: ``root(name, obs)`` at a front door (``costs.build``,
``solve``, ``solution.fetch``, ``solution.certificate``) and
``span(name)`` inside it (``solve.prepare``, ``solve.prologue``,
``driver.chunk``, ``core.rounds``, ``solve.epilogue``). It records only
while ``recording()``: a ``torch.profiler`` session is live on the
calling thread, or an operator switched it on (``record(True)``, or
``REPRO_SPANS=1`` or ``REPRO_SPANS=<file.jsonl>`` in the environment).
Off, a span site costs that one check and returns a shared no-op context
manager: no ``Span``, no dict, no clock read, no ``record_function``.
On, each span is an ``obs.Span`` on ``now()``; under a live profiler it
also opens a ``record_function`` range of the same name, so it sits in
the kineto trace, and ``anchor()`` places ``now()`` readings on that
trace's wall clock (``epoch_ns``). The outermost span open on a thread
(the root) carries the thread's counts made inside it (``add``): host
reads and the seconds they blocked by kind, kernel launches by name,
chunks and rounds. Spans go to the registry of the caller's ``Tracer``
when ``solve(obs=...)`` passes one (under its trace id and parent), else
to the recorder's own, whose sinks are a bounded in-memory ring
(``recorded()``) and any the operator attaches (``record(jsonl=...)``).
The recorder takes no lock: the open spans are a thread-local stack, the
ring a ``deque(maxlen=...)`` (atomic append), the switch one rebind.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .metrics import InMemorySink, JSONLSink, MetricsRegistry, now

_ids = itertools.count(1)


def new_id(prefix: str) -> str:
    """A process-unique id, e.g. ``new_id('req') -> 'req-17'``."""
    return f"{prefix}-{next(_ids)}"


class Span:
    """One timed region.  Emitted as a ``"span"`` event on ``end()``."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_start",
                 "t_end", "attrs", "_tracer")

    def __init__(self, name: str, trace_id: str, span_id: int,
                 parent_id: Optional[int], attrs: Dict[str, Any],
                 tracer: "Tracer") -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = now()
        self.t_end: Optional[float] = None
        self.attrs = attrs
        self._tracer = tracer

    def end(self, **attrs: Any) -> None:
        if self.t_end is not None:  # idempotent: first end wins
            return
        self.t_end = now()
        payload: Dict[str, Any] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "dur_s": self.t_end - self.t_start,
        }
        payload.update(self.attrs)
        payload.update(attrs)
        self._tracer.registry.emit("span", payload)

    def child(self, tracer_attrs: bool = False) -> "Tracer":
        """A tracer whose spans/events are parented under this span."""
        return self._tracer.bind(trace_id=self.trace_id,
                                 parent=self.span_id)


class Tracer:
    """Factory for spans and structured events over one registry."""

    __slots__ = ("registry", "trace_id", "parent_id", "attrs")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace_id: Optional[str] = None,
                 parent_id: Optional[int] = None,
                 **attrs: Any) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.attrs = attrs

    def bind(self, trace_id: Optional[str] = None,
             parent: Optional[int] = None, **attrs: Any) -> "Tracer":
        """Derive a tracer with new default trace/parent ids and attrs."""
        merged = dict(self.attrs)
        merged.update(attrs)
        return Tracer(self.registry,
                      trace_id=trace_id if trace_id is not None
                      else self.trace_id,
                      parent_id=parent if parent is not None
                      else self.parent_id,
                      **merged)

    def start(self, name: str, trace_id: Optional[str] = None,
              parent: Optional[int] = None, **attrs: Any) -> Span:
        """Begin a span; the caller must ``end()`` it (possibly on
        another thread — spans routinely cross the submit/dispatch
        thread boundary)."""
        merged = dict(self.attrs)
        merged.update(attrs)
        tid = trace_id if trace_id is not None else self.trace_id
        if tid is None:
            tid = new_id("trace")
        pid = parent if parent is not None else self.parent_id
        return Span(name, tid, next(_ids), pid, merged, self)

    @contextmanager
    def span(self, name: str, trace_id: Optional[str] = None,
             parent: Optional[int] = None, **attrs: Any) -> Iterator[Span]:
        s = self.start(name, trace_id=trace_id, parent=parent, **attrs)
        try:
            yield s
        except BaseException as e:
            s.end(error=type(e).__name__)
            raise
        else:
            s.end()

    def event(self, kind: str, **attrs: Any) -> None:
        """Emit a point-in-time structured event."""
        payload: Dict[str, Any] = {"t": now()}
        if self.trace_id is not None:
            payload["trace_id"] = self.trace_id
        if self.parent_id is not None:
            payload["parent_id"] = self.parent_id
        payload.update(self.attrs)
        payload.update(attrs)
        self.registry.emit(kind, payload)


def span_tree(events, trace_id: Optional[str] = None) -> str:
    """Render ``"span"`` events (dicts) as an indented tree — demo/debug
    helper."""
    spans = [e for e in events
             if e.get("name") is not None and "span_id" in e
             and (trace_id is None or e.get("trace_id") == trace_id)]
    by_parent: Dict[Optional[int], list] = {}
    ids = {s["span_id"] for s in spans}
    for s in spans:
        p = s.get("parent_id")
        by_parent.setdefault(p if p in ids else None, []).append(s)
    lines: list = []

    def walk(parent: Optional[int], depth: int) -> None:
        for s in sorted(by_parent.get(parent, []),
                        key=lambda x: x["t_start"]):
            lines.append("  " * depth
                         + f"{s['name']} [{s['trace_id']}] "
                         f"{1e3 * s['dur_s']:.2f} ms")
            walk(s["span_id"], depth + 1)

    walk(None, 0)
    return "\n".join(lines)


# --------------------------------------------------------------------------
# The solve path's recorder
# --------------------------------------------------------------------------

#: spans the in-process ring keeps (the newest)
RING_SPANS = 32768


def _follow() -> bool:
    """Whether a ``torch.profiler`` session records this thread, at the
    first call: binds torch's own flag (``_profiler_live``), and the
    switch to it when the profiler decides."""
    global _live, _profiler_live
    import torch

    _profiler_live = torch._C._autograd._profiler_enabled
    if _live is _follow:
        _live = _profiler_live
    return _profiler_live()


def _true() -> bool:
    return True


def _false() -> bool:
    return False


# torch's profiler flag (thread-local), bound at its first read; and the
# switch: the profiler's flag (the default), _true or _false, rebound
# whole, never mutated
_profiler_live = _follow
_live = _follow


def recording() -> bool:
    """Whether a span site records now (the one check it makes)."""
    return _live()


class _Ring(InMemorySink):
    """The recorder's in-process sink: the newest ``maxlen`` span events
    (``deque.append`` is atomic; other kinds are not kept)."""

    def __init__(self, maxlen: int) -> None:
        self.records = deque(maxlen=maxlen)

    def event(self, kind: str, payload: Dict[str, Any]) -> None:
        if kind == "span":
            self.records.append(("event", kind, payload, None))


RING = _Ring(RING_SPANS)
REGISTRY = MetricsRegistry([RING])
_TRACER = Tracer(REGISTRY)
_anchor: Optional[Tuple[int, int]] = None


def _take_anchor() -> None:
    """``(time.monotonic_ns(), time.time_ns())`` read together: the
    monotonic reading is the mean of one before and one after."""
    global _anchor
    m0 = time.monotonic_ns()
    wall = time.time_ns()
    m1 = time.monotonic_ns()
    _anchor = ((m0 + m1) // 2, wall)


def anchor() -> Optional[Tuple[int, int]]:
    """The ``(monotonic ns, wall ns)`` pair taken when recording began
    (the operator's switch, or the first span recorded since the last
    ``clear()``); None before."""
    return _anchor


def epoch_ns(t: float) -> Optional[int]:
    """A ``now()`` reading (seconds) on the wall clock of a kineto trace
    (``start_ns`` of its events), through ``anchor()``."""
    if _anchor is None:
        return None
    return _anchor[1] + int(round(t * 1e9)) - _anchor[0]


def record(on: Optional[bool] = True, jsonl: Optional[str] = None) -> None:
    """The operator's switch. ``True``: record on every thread, profiler
    or not; ``False``: never, not even under a profiler; ``None``: record
    while a ``torch.profiler`` session is live (the default). ``jsonl``
    appends every span the recorder's registry emits to that file, one
    JSON object a line (``JSONLSink``)."""
    global _live
    if jsonl is not None:
        REGISTRY.attach(JSONLSink(jsonl))
    if on:
        _take_anchor()
    _live = (_true if on else _false if on is not None
             else _profiler_live)


def recorded() -> List[Dict[str, Any]]:
    """The span events in the ring, oldest first (a snapshot)."""
    return RING.spans()


def clear() -> None:
    """Empty the ring and drop the anchor."""
    global _anchor
    RING.records.clear()
    _anchor = None


class _Stack(threading.local):
    def __init__(self) -> None:
        self.open: List["_Open"] = []


_STACK = _Stack()


def add(key: str, n: float = 1) -> None:
    """Add ``n`` to ``key`` in the counts of the root span open on this
    thread (nothing when none is, or recording is off). A dotted key
    ``"group.name"`` lands in the root's ``group`` dict."""
    if not _live():
        return
    st = _STACK.open
    if st:
        t = st[0].tally
        t[key] = t.get(key, 0) + n


def note(key: str, value: Any) -> None:
    """Set ``key`` to ``value`` on the innermost span open on this thread
    (nothing when none is, or recording is off); a later, different
    value for the same key (a ragged call's buckets that disagree) makes
    it "mixed"."""
    if not _live() or not _STACK.open:
        return
    attrs = _STACK.open[-1].span.attrs
    if attrs.setdefault(key, value) != value:
        attrs[key] = "mixed"


def _nest(tally: Dict[str, float]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tally.items():
        group, _, key = k.partition(".")
        if key:
            out.setdefault(group, {})[key] = v
        else:
            out[group] = v
    return out


def _range(name: str):
    """A ``record_function`` range of ``name`` while a profiler session
    records this thread (the fast variant where torch has it)."""
    if not _profiler_live():
        return None
    import torch

    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    return torch.autograd.profiler.record_function(name)


class _Open:
    """A recording span site: pushes its ``Span`` on the thread's stack
    for the body, then ends it (the root with its counts)."""

    __slots__ = ("span", "tally", "_rf")

    def __init__(self, span: Span, tally: Optional[Dict[str, float]],
                 rf) -> None:
        self.span = span
        self.tally = tally
        self._rf = rf

    def __enter__(self) -> Span:
        _STACK.open.append(self)
        if self._rf is not None:
            self._rf.__enter__()
        return self.span

    def __exit__(self, et, ev, tb) -> bool:
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        _STACK.open.pop()
        attrs = _nest(self.tally) if self.tally else {}
        if et is not None:
            attrs["error"] = et.__name__
        self.span.end(**attrs)
        return False


class _Null:
    """The span site with recording off: enters as None, does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, et, ev, tb) -> bool:
        return False


_NULL = _Null()


def _child(name: str):
    parent = _STACK.open[-1].span
    sp = Span(name, parent.trace_id, next(_ids), parent.span_id, {},
              parent._tracer)
    return _Open(sp, None, _range(name))


def span(name: str):
    """A span inside the front-door call open on this thread: a child of
    the innermost open span. With recording off, or no span open on the
    thread (a worker of the mesh driver), the no-op site."""
    if not _live() or not _STACK.open:
        return _NULL
    return _child(name)


def root(name: str, obs=None):
    """The span of one front-door call: a new trace on the recorder's
    registry, or on ``obs``'s registry under its trace id and parent
    when ``obs`` is a ``Tracer``. Inside another front-door call on the
    same thread (a fetch inside a certificate) it is a child instead.
    ``with root(...) as sp``: ``sp`` is the ``Span`` (set attributes on
    ``sp.attrs``), or None with recording off."""
    if not _live():
        return _NULL
    if _STACK.open:
        return _child(name)
    if _anchor is None:
        _take_anchor()
    tracer = obs if isinstance(obs, Tracer) else _TRACER
    return _Open(tracer.start(name), {}, _range(name))


def _from_env() -> None:
    """``REPRO_SPANS``: "1" records, any other non-empty value records
    and exports to that JSONL file."""
    flag = os.environ.get("REPRO_SPANS", "")
    if flag:
        record(True, jsonl=None if flag == "1" else flag)


_from_env()
