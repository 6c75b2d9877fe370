"""repro_torch.obs: live serving observability.

Port of ``repro.obs``. Three pieces, all import-light (stdlib only at
import time; ``torch`` is imported when a profile is captured):

* :mod:`repro_torch.obs.metrics`: the ``MetricsSink`` protocol (counters,
  gauges, histograms with explicit bucket bounds) with in-memory, JSONL
  and logging implementations, plus ``MetricsRegistry``, an aggregating
  registry that is lock-free on the observation hot path.
* :mod:`repro_torch.obs.tracing`: hierarchical ``Span``s on the monotonic
  clock with per-request trace ids, emitted as structured events covering
  submit -> admission -> collate -> bucket dispatch -> per-chunk solve ->
  artifact fetch (plus the fault events: retries, ladder level,
  quarantine, deadline cuts, degraded answers).
* :mod:`repro_torch.obs.profiler`: an opt-in ``torch.profiler`` capture
  hook around a named dispatch.

``now()`` is the one monotonic clock shared by spans, deadlines and
wait/solve stats across ``serve/`` and the chunked drivers.
"""
from . import profiler
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    History,
    InMemorySink,
    JSONLSink,
    LoggingSink,
    MetricsRegistry,
    MetricsSink,
    NullSink,
    jsonable,
    now,
)
from .tracing import Span, Tracer, new_id, span_tree

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "History",
    "InMemorySink",
    "JSONLSink",
    "LoggingSink",
    "MetricsRegistry",
    "MetricsSink",
    "NullSink",
    "Span",
    "Tracer",
    "jsonable",
    "new_id",
    "now",
    "profiler",
    "span_tree",
]
