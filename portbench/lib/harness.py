"""One run of one cell: find everything by name, set up, hand the
window to the cell's entry, check the answers against the plain
reference, and build the result line.

Everything a cell is made of is found by its name:

  BENCHMARK.json                  the cell's configuration, traffic and
                                  which metrics it reports
  portbench/workloads/<cell>.json the traffic's parameters, the entry
                                  that drives the program, the check
  portbench/configs/<config>.json the problem as run, the reference and
                                  its guarantees; a point-cloud problem
                                  also its point law (``points``)
  portbench/entries/<entry>.py    drives the program through a window
  portbench/metrics/<metric>.py   reads one metric from the window
  portbench/reference/<ref>.py    the plain reference of a problem:
                                  ``check(instance, answer, config)``
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np

from . import gen

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry of BENCHMARK.json
    params: dict         # portbench/workloads/<cell>.json
    config: dict         # portbench/configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT    # the checkout its files were found in


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name``, as ``BENCHMARK.json`` lists it."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    path = root / "portbench" / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload file {path}")
    params = json.loads(path.read_text())
    entry = next(w for w in manifest["workloads"] if w["name"] == name)
    conf = next(c for c in manifest["configs"]
                if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    return Cell(
        name=name, entry=entry, params=params, config=config,
        end_to_end=[m for m in manifest["end_to_end"]
                    if _reported_in(m, name)],
        per_layer=[m for m in manifest["per_layer"]
                   if _reported_in(m, name)],
        root=root)


_MODULES: Dict[Path, Any] = {}


def load_file(kind: str, name: str, root: Path = ROOT):
    """The module ``<root>/portbench/<kind>/<name>.py``: an entry or a
    reference of this package by its package name (a reference may import
    its siblings), any other file by its path (a metric's name may hold
    dots)."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    if kind != "metrics" and Path(root).resolve() == ROOT:
        return importlib.import_module(f"portbench.{kind}.{name}")
    mod = _MODULES.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


@dataclass
class Window:
    """What an entry hands back: the raw readings of its window, from
    which every metric file computes its number."""
    setup_s: float = 0.0
    elapsed_s: float = 0.0           # the window, open to last answer
    attempted: int = 0               # instances attempted
    instances_done: int = 0          # ... answered
    calls_done: int = 0
    peak_bytes: int = 0              # max_memory_allocated in the window
    process_peak_bytes: int = 0      # ... since the process started
    sync_delta: Dict[str, int] = field(default_factory=dict)
    rounds: List[int] = field(default_factory=list)
    occupancy: List[tuple] = field(default_factory=list)
    trace: Any = None                # a lib.trace.TraceSummary
    traced_calls: int = 0
    traced_shapes: List[tuple] = field(default_factory=list)
    # (instance, the program's host answer) of every answer in the window
    answers: List[tuple] = field(default_factory=list)
    notes: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Env:
    """What an entry gets: the cell, the device, the seed, the closed
    loop's pool of calls, the window's length, whether to trace, and
    where the set-up started. The pool is drawn only for a configuration
    that names a point law (``points``); for any other, ``calls`` is
    empty and the entry makes its own inputs from ``seed``, each kind of
    draw from its own stream, ``gen.rng_for(seed, <stream>)``."""
    torch: Any
    device: Any
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    calls: List[gen.Call]
    clock: Callable[[], float] = time.monotonic

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        if self.device.type == "cuda":
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0


def check_answers(cell: Cell, answers: List[tuple], seed: int,
                  count: int) -> Dict[str, float]:
    """The worst of each reference number over a sample of ``count``
    answers drawn from the seed, the largest instance (by the product of
    its ``shape``) always among them. Each answer is judged by the
    configuration's reference, ``check(instance, answer, config)``."""
    ref = load_file("reference", cell.config["reference"], cell.root)
    if not answers:
        return {}
    rng = gen.rng_for(seed, "check")
    order = list(rng.permutation(len(answers)))
    largest = max(range(len(answers)),
                  key=lambda i: np.prod(answers[i][0].shape))
    pick = [largest] + [i for i in order if i != largest][:max(0, count - 1)]
    worst: Dict[str, float] = {}
    for i in pick:
        inst, out = answers[i]
        for k, v in ref.check(inst, out, cell.config).items():
            v = float(v)
            if k not in worst or not (v <= worst[k]):
                worst[k] = v
    worst["checked"] = float(len(pick))
    return worst


def limits_of(cell: Cell) -> Dict[str, float]:
    """Each compared number's limit: the configuration's guarantees, then
    the limits the cell set from its readings."""
    out = dict(cell.config.get("guarantees", {}))
    out.update(cell.params.get("limits", {}))
    return out


def judge(checks: Dict[str, float], limits: Dict[str, float]):
    """(every number within its limit, [[name, number, limit], ...])."""
    rows, ok = [], bool(checks)
    for name, limit in limits.items():
        v = checks.get(name, math.inf)
        rows.append([name, v, limit])
        ok &= bool(v <= limit)
    return ok, rows


def _finite(v: float) -> float:
    """JSON has no infinity: an infinite number prints as 1e308."""
    return v if math.isfinite(v) else math.copysign(1e308, v)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, *, torch=None):
    """One run: set up, the window, the reference's check. Returns the
    result line's object (without the device's name, which run.py adds)
    and notes for standard error."""
    if torch is None:
        import torch
    calls = (gen.make_calls(cell.config, cell.params, seed)
             if "points" in cell.config else [])
    env = Env(torch=torch, device=device, cell=cell, seed=seed,
              seconds=seconds, trace=trace, t_start=t_start, calls=calls)
    entry = load_file("entries", cell.params["entry"], cell.root)
    w = entry.run(env)
    t_check = time.monotonic()
    checks = check_answers(cell, w.answers, seed,
                           int(cell.params.get("check", 4)))
    w.notes["check_s"] = time.monotonic() - t_check
    limits = limits_of(cell)
    within, rows = judge(checks, limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_file("metrics", m["name"], cell.root).read(w)
        if v is not None:
            metrics[m["name"]] = {"value": _finite(float(v)),
                                  "unit": m["unit"]}
    correct = bool(within and w.attempted > 0
                   and w.instances_done == w.attempted)
    out = {"correct": correct, "attempted": w.attempted,
           "failed": w.attempted - w.instances_done, "metrics": metrics,
           "device": {"count": 1,
                      "memory_peak_bytes": w.process_peak_bytes}}
    if trace and w.trace is not None:
        out["device"]["busy_s"] = w.trace.busy_s
        out["device"]["window_s"] = w.trace.window_s
        out["breakdown"] = {"device_ops": w.trace.device_ops,
                            "idle_gaps": w.trace.idle_gaps}
    out["checks"] = {name: {"value": _finite(v), "limit": lim}
                     for name, v, lim in rows}
    notes = dict(w.notes, answers=len(w.answers),
                 answers_checked=int(checks.get("checked", 0)))
    return out, notes


def print_checks(result: dict, stream=sys.stderr) -> None:
    """The compared numbers beside their limits, one a line."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stream)


def cache_dirs(root: Path = ROOT) -> None:
    """Fixed build and kernel-cache directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "portbench" / sub)
