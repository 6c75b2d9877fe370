#!/usr/bin/env python3
"""Where the time of one ``solve`` goes on the card (PyTorch profiler).

    python3 tools/profile_solve.py [--seed 0] [--fused] [--portfolio]
                                   [--out build/profile.json]

Solves the Fig. 1 assignment (n = 10 000 points, eps = 0.01) and the
n = 4096 OT instance of ``chip_smoke.py`` once to warm up, then once more
under ``torch.profiler``; with ``--fused`` it does the same on the fused
route (``DispatchPolicy(fused=True)``) after each stepped case, on the
same inputs, so both routes are measured in one call on one card; with
``--portfolio`` it also profiles the OT instance under
``solver="sinkhorn"`` (stepped and fused) and ``solver="hybrid"``. It
reports for each: wall time (with the
profiler on, which slows the host side), the summed device time of every
kernel, the top kernels by device time, the host syncs and the launches
of the port's own kernels, and from the solve path's spans
(``repro_torch.obs.tracing``, recording under the profiler) the root
``solve`` span's per-call counts (reads and the seconds they blocked by
kind, launches by kernel, chunks, rounds) and the host seconds of each
phase (``solve.prepare``, ``solve.prologue``, ``driver.chunk``,
``core.rounds``, ``solve.epilogue``, the artifact fetches). Where
``slack_propose`` runs (the stepped route),
it also gives that kernel's launches, the sum of their live rows (counted
in the warm-up solve, one host read per launch), its summed device time
and the sum of each launch's bound (``chip_smoke.propose_bound``). Needs
one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


ROOT = Path(__file__).resolve().parents[1]


def _count_propose(ops, run):
    """Run ``run()`` with every ``slack_propose`` launch counted: launches,
    the sum of their live rows (a host read per launch) and the sum of
    their bounds (``chip_smoke.propose_bound``). Returns (counts, run's
    result)."""
    from chip_smoke import propose_bound

    counts = {"launches": 0, "active_rows": 0, "bound_ms": 0.0}
    orig = ops.slack_propose_batched

    def counting(c_int, *a, active_b=None):
        b, m, n = c_int.shape
        live = b * m if active_b is None else int(active_b.sum())
        counts["launches"] += 1
        counts["active_rows"] += live
        counts["bound_ms"] += propose_bound(b, m, n, live)[0]
        return orig(c_int, *a, active_b=active_b)

    ops.slack_propose_batched = counting
    try:
        out = run()
    finally:
        ops.slack_propose_batched = orig
    return counts, out


def span_summary(spans):
    """The root ``solve`` span's counts and the host seconds of each span
    name of the recorded calls."""
    root = next((s for s in spans if s["name"] == "solve"
                 and s["parent_id"] is None), None)
    host_s: dict = {}
    for s in spans:
        host_s[s["name"]] = host_s.get(s["name"], 0.0) + s["dur_s"]
    counts = {} if root is None else {
        k: root[k] for k in ("syncs", "sync_wait_s", "launches", "chunks",
                             "rounds") if k in root}
    return {"root": counts, "host_s": host_s}


def profile_case(torch, name, run):
    from chip_smoke import device_us
    from repro_torch.core import device as rdev
    from repro_torch.kernels import ops
    from repro_torch.obs import tracing

    # warm-up (kernel build, caches), with slack_propose's launches counted
    propose, _ = _count_propose(ops, run)
    ops.reset_launches()
    rdev.reset_sync_counts()
    tracing.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        info = run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # kernels only: an aten op also reports the device time of the
    # kernels it launched, which would count them twice
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, device_us(e)) for e in prof.key_averages()
            if e.device_type == cuda]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    if propose["launches"]:
        # the profiled run repeats the counted one launch for launch
        propose["same_launches"] = (propose["launches"]
                                    == ops.launches["slack_propose"])
        propose["device_ms"] = sum(
            us for k, _, us in rows if "slack_propose_kernel" in k) / 1e3
        propose["mean_active_rows"] = (propose["active_rows"]
                                       / propose["launches"])
    out = {"case": name, **info, "wall_s": wall,
           "kernel_s": sum(r[2] for r in rows) / 1e6,
           "syncs": dict(rdev.sync_counts), "launches": dict(ops.launches),
           "spans": span_summary(tracing.recorded()),
           **({"slack_propose": propose} if propose["launches"] else {}),
           "top": [{"name": k[:80], "count": c, "ms": us / 1e3}
                   for k, c, us in rows[:12]]}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", action="store_true",
                    help="also profile the fused route on the same inputs")
    ap.add_argument("--portfolio", action="store_true",
                    help="also profile the OT instance under the Sinkhorn "
                         "(stepped and fused) and hybrid solvers")
    ap.add_argument("--out", default="build/profile.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")

    def pts(n):
        return rng.uniform(size=(n, 2)).astype(np.float32)

    c_a = build_cost_matrix(pts(10_000), pts(10_000), "euclidean", device=dev)
    c_o = build_cost_matrix(pts(4096), pts(4096), "euclidean", device=dev)
    nu = rng.dirichlet(np.ones(4096)).astype(np.float32)
    mu = rng.dirichlet(np.ones(4096)).astype(np.float32)

    def assignment(fused):
        s = solve(ASSIGNMENT, {"c": c_a[None]}, 0.01,
                  DispatchPolicy(fused=fused), want=("cost",), device=dev)[0]
        return {"phases": s.phases, "rounds": s.rounds,
                "dispatches": s.stats.dispatches}

    def ot(fused, solver="pushrelabel"):
        s = solve(OT, [(c_o, nu, mu)], 0.05,
                  DispatchPolicy(fused=fused, solver=solver),
                  want=("cost",), device=dev)[0]
        return {"phases": s.phases, "rounds": s.rounds,
                "dispatches": s.stats.dispatches}

    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    routes = (False, True) if args.fused else (False,)
    cases = []
    for label, fn in (("assignment n=10000 eps=0.01", assignment),
                      ("ot n=4096 eps=0.05", ot)):
        for fused in routes:
            cases.append(profile_case(
                torch, f"{label} {'fused' if fused else 'stepped'}",
                lambda fn=fn, fused=fused: fn(fused)))
    if args.portfolio:
        for solver, fused in (("sinkhorn", False), ("sinkhorn", True),
                              ("hybrid", False)):
            cases.append(profile_case(
                torch, f"ot n=4096 eps=0.05 {solver}"
                + (" fused" if fused else ""),
                lambda solver=solver, fused=fused: ot(fused, solver)))
    res = {"card": smi, "torch": torch.__version__, "cases": cases}
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
