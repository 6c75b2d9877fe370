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
"""
from __future__ import annotations

import itertools
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

from .metrics import MetricsRegistry, now

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
