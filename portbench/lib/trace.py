"""Reading ``torch.profiler`` over a traced part of the window.

The traced window is the benchmark's own ``portbench.window`` span; the
device is busy where any device activity (kernel, copy, set) runs, and
the busy time is the UNION of those intervals inside the window, so two
overlapping kernels count once. Each idle gap is charged to the host
operation that was running at its middle (the innermost one, by latest
start), or to the benchmark's own span around the call.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

WINDOW_SPAN = "portbench.window"
CALL_SPAN = "portbench.call"
TOP = 10
NAME_CHARS = 120
# the runtime and driver calls that launch a kernel
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
# how many host operations before a gap to search for one still running
_LOOKBACK = 64


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Total length of the union of ``(start, end)`` intervals, clipped to
    ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The gaps of ``[lo, hi]`` that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: float = 0.0          # summed durations of the kernels
    launches: int = 0              # kernels that ran on the device
    host_launches: int = 0         # kernel launches the host made
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def lost_records(t: TraceSummary) -> bool:
    """A session that lost device records (a known fault of some
    ``torch.profiler`` sessions on the card): fewer kernels on the
    device than the host launched."""
    return t.host_launches > 0 and t.launches < 0.98 * t.host_launches


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _annotation(e) -> bool:
    """A ``record_function`` range as kineto mirrors it on the device's
    timeline: no device activity of its own."""
    kind = getattr(e, "activity_type", None)
    kind = str(kind() if callable(kind) else kind).lower()
    return "annotation" in kind or e.name() in (WINDOW_SPAN, CALL_SPAN)


def summarize(events) -> TraceSummary:
    """A summary of kineto events (``prof.profiler.kineto_results
    .events()``): times in seconds."""
    dev, host, window, calls = [], [], None, []
    for e in events:
        name = e.name()
        s = e.start_ns() * 1e-9
        end = s + e.duration_ns() * 1e-9
        if str(e.device_type()).endswith("CUDA"):
            if not _annotation(e):
                dev.append((s, end, name))
        elif name == WINDOW_SPAN:
            window = (s, end)
        elif name == CALL_SPAN:
            calls.append((s, end))
        else:
            host.append((s, end, name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    lo, hi = window
    inside = [(s, e, n) for s, e, n in dev if e > lo and s < hi]
    kernels = [(s, e, n) for s, e, n in inside if not _is_copy(n)]
    host_launches = sum(1 for s, e, n in host if lo <= s <= hi
                        and n.startswith(_LAUNCH_CALLS))
    out = TraceSummary(window_s=hi - lo, host_launches=host_launches,
                       busy_s=union_seconds([(s, e) for s, e, _ in inside],
                                            lo, hi),
                       kernel_s=sum(e - s for s, e, _ in kernels),
                       launches=len(kernels))
    by_op: dict = {}
    for s, e, n in inside:
        key = n[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    out.device_ops = [[k, v] for k, v in sorted(
        by_op.items(), key=lambda kv: -kv[1])[:TOP]]
    gaps = idle_gaps([(s, e) for s, e, _ in inside], lo, hi)
    out.idle_gaps = _charge_gaps(gaps, host, calls)
    return out


def _charge_gaps(gaps, host, calls) -> List[list]:
    """Sum each gap's length under the host operation running at its
    middle; the top ``TOP`` of them."""
    if not gaps:
        return []
    mid = np.asarray([(a + b) / 2 for a, b in gaps])
    length = np.asarray([b - a for a, b in gaps])
    label = np.full(len(gaps), -1, np.int64)
    names = []
    if host:
        host.sort()
        starts = np.asarray([h[0] for h in host])
        ends = np.asarray([h[1] for h in host])
        names = [h[2][:NAME_CHARS] for h in host]
        last = np.searchsorted(starts, mid, side="right") - 1
        for k in range(_LOOKBACK):
            cand = last - k
            ok = (label < 0) & (cand >= 0)
            ok[ok] &= ends[cand[ok]] >= mid[ok]
            label[ok] = cand[ok]
    tally: dict = {}
    call_iv = sorted(calls)
    for i in range(len(gaps)):
        if label[i] >= 0:
            key = names[label[i]]
        elif any(s <= mid[i] <= e for s, e in call_iv):
            key = CALL_SPAN + " (no host op running)"
        else:
            key = "no host op running"
        tally[key] = tally.get(key, 0.0) + float(length[i])
    return [[k, v] for k, v in sorted(tally.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


class Tracer:
    """``torch.profiler`` over a part of the window, host and device
    activity, inside the benchmark's ``portbench.window`` span."""

    def __init__(self, torch, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._torch = torch
        self._device = device
        # the first session of a process pays the profiler's own start-up
        # (seconds); pay it here, in the set-up, and not in the window
        warm = torch.profiler.profile(activities=acts)
        warm.start()
        warm.stop()
        self._prof = torch.profiler.profile(activities=acts)
        self._span = None
        self.started = False
        self.summary = None
        self.host_s = {}           # seconds start() and stop() took

    def start(self) -> None:
        t = time.monotonic()
        self.started = True
        self._prof.start()
        self._span = self._torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.host_s["start"] = time.monotonic() - t

    def stop(self) -> TraceSummary:
        t = time.monotonic()
        if self._device.type == "cuda":
            self._torch.cuda.synchronize(self._device)
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.summary = summarize(self._prof.profiler.kineto_results.events())
        self._prof = None
        self.host_s["stop"] = time.monotonic() - t
        return self.summary

    def call_span(self):
        return self._torch.profiler.record_function(CALL_SPAN)
