#!/usr/bin/env python3
"""What the solve path's spans cost and cover, on a benchmark cell's
calls under ``torch.profiler``.

    python3 tools/span_cost.py --workload <cell> [--seed 7] [--pairs 8]
                               [--out build/span_cost.json]

Sets up a cell of ``portbench/`` as its runs do (inputs from the seed,
the kernels, a warm-up call) and makes ``--pairs`` pairs of its calls,
each pair in one ``torch.profiler`` session (CPU and CUDA), one call
with the program's spans recording (``repro_torch.obs.tracing``: they
record while the profiler runs) and one with them switched off
(``tracing.record(False)``), both on the same instances, the order
alternating pair by pair. Each call runs inside a ``portbench.call``
range, as the benchmark's traced calls do. Reports:

* ``call_s``: the host time of each call, spans on and off (p50 and all);
* ``coverage``: for each call with spans, the share of its
  ``portbench.call`` range that the program's top-level spans
  (``costs.build``, ``solve``, ``solution.*``) cover, placed on the
  trace's clock through ``tracing.anchor()``; for the least covered
  call, its uncovered ms and its longest uncovered stretch with the
  spans around it; and the uncovered ms of all calls by place;
* ``anchor_ns``: each span's start placed through the anchor less the
  ``start_ns`` of its kineto range (median, largest magnitude);
* ``lost``: sessions whose device kept fewer kernels than the host
  launched, with spans on and off;
* ``per_call``: what a call with spans recorded: spans, and the reads
  by kind summed over its top-level spans (their ``syncs``);
* ``site_us``: one span site's host time with recording off (no
  profiler), and with it on under a live profiler session, and one
  count (``tracing.add``) on; spans and counts a call times these give
  the spans' own cost, below the calls' noise.

Needs one CUDA device; run from the root of a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TOP = ("costs.build", "solve")


def _ranges(events, call_name: str):
    """``(call ranges [(start, end)], {name: [start_ns]} of the other
    host ranges)`` of one session's kineto events."""
    calls, ranges = [], {}
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            continue
        if e.name() == call_name:
            calls.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        else:
            ranges.setdefault(e.name(), []).append(e.start_ns())
    return sorted(calls), ranges


def _uncovered(spans, tracing, lo, hi) -> list:
    """The stretches ``(start, end, span before, span after)`` of
    ``[lo, hi]`` (ns) no top-level span covers."""
    tops = sorted(
        (tracing.epoch_ns(s["t_start"]), tracing.epoch_ns(s["t_end"]),
         s["name"])
        for s in spans if s["parent_id"] is None and (
            s["name"] in TOP or s["name"].startswith("solution.")))
    out, t, last = [], lo, "call start"
    for a, b, name in tops:
        if a > t:
            out.append((t, min(a, hi), last, name))
        if b > t:
            t, last = b, name
    out.append((t, hi, last, "call end"))
    return [g for g in out if g[1] > g[0]]


def _site_us(torch, tracing, n: int = 20000) -> dict:
    """Host us of one span site off, one on under a profiler, one count
    on."""
    def per(fn):
        t0 = time.perf_counter()
        fn()
        return 1e6 * (time.perf_counter() - t0) / n

    def sites():
        for _ in range(n):
            with tracing.span("site"):
                pass

    def counts():
        for _ in range(n):
            tracing.add("syncs.site")

    tracing.record(None)
    with tracing.root("site.root"):
        off = per(sites)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with tracing.root("site.root"):
        on, count = per(sites), per(counts)
    prof.stop()
    tracing.clear()
    return {"off": off, "on": on, "count_on": count}


def _per_call(spans) -> dict:
    """Spans, and reads by kind over the top-level spans, of one call."""
    reads: dict = {}
    for s in spans:
        if s["parent_id"] is None:
            for k, v in s.get("syncs", {}).items():
                reads[k] = reads.get(k, 0) + v
    return {"spans": len(spans), "reads": reads}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--out", default="build/span_cost.json")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA device", file=sys.stderr)
        return 1
    from portbench.entries.solve import _Caller
    from portbench.lib import gen, harness, trace
    from repro_torch.kernels import ops
    from repro_torch.obs import tracing

    harness.cache_dirs(ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = harness.load_cell(args.workload, ROOT)
    calls = gen.make_calls(cell.config, cell.params, args.seed)
    env = harness.Env(torch=torch, device=dev, cell=cell, seed=args.seed,
                      seconds=0.0, trace=True, t_start=time.monotonic(),
                      calls=calls)
    caller = _Caller(env)
    ops.build_kernels()
    for k in range(int(cell.params.get("warmup_calls", 1))):
        caller(calls[k % len(calls)], rounds=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    warm = torch.profiler.profile(activities=acts)
    warm.start()
    warm.stop()
    call_s = {"on": [], "off": []}
    lost = {"on": 0, "off": 0}
    coverage, offsets, per_call = [], [], []
    worst, uncovered_by = None, {}
    for k in range(args.pairs):
        order = ("on", "off") if k % 2 == 0 else ("off", "on")
        tracing.clear()
        call = calls[k % len(calls)]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            for mode in order:
                tracing.record(None if mode == "on" else False)
                t0 = time.monotonic()
                with torch.profiler.record_function(trace.CALL_SPAN):
                    caller(call, rounds=True)
                call_s[mode].append(time.monotonic() - t0)
            torch.cuda.synchronize(dev)
        prof.stop()
        tracing.record(None)
        events = prof.profiler.kineto_results.events()
        if trace.lost_records(trace.summarize(events)):
            for mode in order:
                lost[mode] += 1
        ranges, names = _ranges(events, trace.CALL_SPAN)
        spans = tracing.recorded()
        per_call.append(_per_call(spans))
        on = ranges[order.index("on")]
        gaps = _uncovered(spans, tracing, *on)
        for a, b, before, after in gaps:
            key = f"{before} -> {after}"
            uncovered_by[key] = uncovered_by.get(key, 0.0) + 1e-6 * (b - a)
        coverage.append(1.0 - sum(g[1] - g[0] for g in gaps)
                        / (on[1] - on[0]))
        if worst is None or coverage[-1] < worst["coverage"]:
            a, b, before, after = max(gaps, key=lambda g: g[1] - g[0],
                                      default=(0, 0, None, None))
            worst = {
                "coverage": coverage[-1],
                "uncovered_ms": 1e-6 * sum(g[1] - g[0] for g in gaps),
                "longest_ms": 1e-6 * (b - a),
                "longest_between": [before, after]}
        for name in {s["name"] for s in spans}:
            mine = sorted(tracing.epoch_ns(s["t_start"]) for s in spans
                          if s["name"] == name)
            theirs = sorted(names.get(name, []))
            if len(mine) == len(theirs):
                offsets.extend(a - b for a, b in zip(mine, theirs))
    site_us = _site_us(torch, tracing)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    off = np.asarray(offsets, np.float64)
    res = {
        "workload": args.workload, "seed": args.seed, "card": card,
        "torch": torch.__version__,
        "call_s": {m: {"p50": float(np.median(v)), "all": v}
                   for m, v in call_s.items()},
        "on_over_off_p50": float(np.median(np.asarray(call_s["on"])
                                           / np.asarray(call_s["off"]))),
        "coverage": {"min": float(min(coverage)),
                     "median": float(np.median(coverage)),
                     "all": coverage, "least": worst,
                     "uncovered_ms_by_place": uncovered_by},
        "anchor_ns": {"n": int(off.size),
                      "median": float(np.median(off)) if off.size else None,
                      "max_abs": float(np.abs(off).max())
                      if off.size else None},
        "lost": lost,
        "per_call": {
            "spans": float(np.mean([c["spans"] for c in per_call])),
            "reads": {k: float(np.mean([c["reads"].get(k, 0)
                                        for c in per_call]))
                      for k in sorted({k for c in per_call
                                       for k in c["reads"]})}},
        "site_us": site_us,
    }
    print(json.dumps(res), flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
