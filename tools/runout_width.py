#!/usr/bin/env python3
"""Wall time of a fused assignment bucket, run out in one launch against
chunked with lane retirement, over bucket widths and eps mixes.

    python3 tools/runout_width.py [--seed 0] [--reps 5] [--n 1024]
                                  [--widths 16,64,256] [--mixes MIXES]
                                  [--paths grid,lane8,...] [--out PATH]

For each width B and each eps mix, draws B instances of n uniform points
a side in the unit square (euclidean costs, built on the card), and
solves the bucket through ``solve(ASSIGNMENT, {"c": c}, eps)`` on the
fused route under three policies (without ``--paths``), in turns within
each repetition:

  * ``default``: ``DispatchPolicy()``, the driver's choice of chunk;
  * ``runout``: ``DispatchPolicy(chunk=cap + 1)``, one launch above every
    lane's phase cap (no retirement, one read);
  * ``k8``: ``DispatchPolicy(chunk=8)``, a read every 8 phases and lane
    retirement once occupancy halves.

``--paths`` replaces ``default`` and ``runout`` by the run-out chunk
with ``fused_assignment.cu``'s path forced (``kernels/ops.py``'s route
replaced for the solve), one for each path it lists: ``grid``,
``lane<C>``, the per-lane path in clusters of C blocks, or ``rule``, the
route's own choice. ``--n`` may list
several sizes (``1024,4096``), ``--mixes`` some of the eps mixes.

Eps mixes: ``same`` (every lane 0.01, the Fig. 1 batch cell's), ``ragged``
(log-uniform in [0.005, 0.05] per lane) and ``tail`` (every lane 0.05
but one at 0.005, a single slow lane). Every policy's final integer
state must equal the ``k8`` solve's (the driver's results do not depend
on k). Prints one JSON line per (B, mix) with the median wall seconds of
each policy (host clock around a solve that ends in a device
synchronize), the dispatches, and the lanes' phase counts; ``--out``
also writes them all as one JSON list. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

MIXES = ("same", "ragged", "tail")


def eps_mix(rng, mix: str, b: int) -> np.ndarray:
    if mix == "same":
        return np.full(b, 0.01)
    if mix == "ragged":
        return np.exp(rng.uniform(np.log(0.005), np.log(0.05), b))
    e = np.full(b, 0.05)
    e[int(rng.integers(b))] = 0.005
    return e


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n", default="1024")
    ap.add_argument("--widths", default="16,64,256")
    ap.add_argument("--mixes", default=",".join(MIXES))
    ap.add_argument("--paths", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    import torch
    if not torch.cuda.is_available():
        print("runout_width: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.api import ASSIGNMENT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.problem import FUSED_ASSIGNMENT, eps_array
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rule = ops.fused_assignment_route
    forced = {"grid": lambda b, m, n, sms: ops.Route("grid", 0),
              "rule": None}
    paths = list(filter(None, args.paths.split(",")))
    for p in paths:
        if p.startswith("lane") and p[4:].isdigit() \
                and int(p[4:]) in ops.LANE_CLUSTERS:
            forced[p] = (lambda cl: lambda b, m, n, sms: ops.Route(
                "lane", cl))(int(p[4:]))
        elif p not in forced:
            raise SystemExit(f"runout_width: unknown path {p!r}")
    rows = []
    ok = True
    for n_pts, b, mix in ((int(n), int(w), mix)
                      for n in args.n.split(",")
                      for w in args.widths.split(",")
                      for mix in args.mixes.split(",")):
        rng = np.random.default_rng([args.seed, b, MIXES.index(mix)])
        eps = eps_mix(rng, mix, b)
        c = torch.stack([
            build_cost_matrix(*(rng.uniform(size=(n_pts, 2))
                                .astype(np.float32) for _ in range(2)),
                              "euclidean", device=dev)
            for _ in range(b)])
        cap = int(FUSED_ASSIGNMENT.prepare(
            FUSED_ASSIGNMENT.canonicalize({"c": c}, dev),
            eps_array(eps, b, False)).phase_cap.max())
        pols = {"k8": (DispatchPolicy(fused=True, chunk=8), None)}
        if not paths:
            pols["default"] = (DispatchPolicy(fused=True), None)
            pols["runout"] = (DispatchPolicy(fused=True, chunk=cap + 1),
                              None)
        for p in paths:
            pols[f"runout@{p}"] = (
                DispatchPolicy(fused=True, chunk=cap + 1), forced[p])

        def run(pol):
            policy, route = pol
            ops.fused_assignment_route = route or rule
            try:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                r, st = solve(ASSIGNMENT, {"c": c}, eps, policy,
                              keep_state=True, device=dev)
                r.cost.cpu()
                torch.cuda.synchronize()
            finally:
                ops.fused_assignment_route = rule
            return time.monotonic() - t0, st

        for pol in pols.values():           # warm-up
            run(pol)
        walls = {k: [] for k in pols}
        stats = {}
        names = list(pols)
        for i in range(args.reps):
            for name in (names if i % 2 == 0 else names[::-1]):
                w, stats[name] = run(pols[name])
                walls[name].append(w)
        ref = stats["k8"].final_state
        same = {k: all(torch.equal(x, y) for x, y in
                       zip(st.final_state, ref))
                for k, st in stats.items()}
        ok &= all(same.values())
        phases = ref.phases[:b].cpu().numpy()
        row = {"B": b, "n": n_pts, "mix": mix,
               "route": list(rule(b, n_pts, n_pts, ops._sm_count(dev))),
               "eps_min": float(eps.min()), "eps_max": float(eps.max()),
               "cap": cap, "phases_max": int(phases.max()),
               "phases_median": float(np.median(phases)),
               "median_s": {k: statistics.median(v)
                            for k, v in walls.items()},
               "wall_s": walls,
               "chunk": {k: st.chunk for k, st in stats.items()},
               "dispatches": {k: st.dispatches
                              for k, st in stats.items()},
               "occupancy_k8": stats["k8"].occupancy,
               "state_equal": same}
        print(json.dumps({k: v for k, v in row.items()
                          if k not in ("wall_s", "occupancy_k8")}),
              flush=True)
        rows.append(row)
        del c
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
