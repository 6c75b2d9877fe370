#!/usr/bin/env python3
"""Wall time of a fused assignment bucket, run out in one launch against
chunked with lane retirement, over bucket widths and eps mixes.

    python3 tools/runout_width.py [--seed 0] [--reps 5] [--n 1024]
                                  [--widths 16,64,256] [--out PATH]

For each width B and each eps mix, draws B instances of n uniform points
a side in the unit square (euclidean costs, built on the card), and
solves the bucket through ``solve(ASSIGNMENT, {"c": c}, eps)`` on the
fused route under three policies, in turns within each repetition:

  * ``default``: ``DispatchPolicy()``, the driver's choice of chunk;
  * ``runout``: ``DispatchPolicy(chunk=cap + 1)``, one launch above every
    lane's phase cap (no retirement, one read);
  * ``k8``: ``DispatchPolicy(chunk=8)``, a read every 8 phases and lane
    retirement once occupancy halves.

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
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--widths", default="16,64,256")
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

    dev = torch.device("cuda")
    rows = []
    ok = True
    for b in (int(w) for w in args.widths.split(",")):
        for mix in MIXES:
            rng = np.random.default_rng([args.seed, b, MIXES.index(mix)])
            eps = eps_mix(rng, mix, b)
            c = torch.stack([
                build_cost_matrix(*(rng.uniform(size=(args.n, 2))
                                    .astype(np.float32) for _ in range(2)),
                                  "euclidean", device=dev)
                for _ in range(b)])
            cap = int(FUSED_ASSIGNMENT.prepare(
                FUSED_ASSIGNMENT.canonicalize({"c": c}, dev),
                eps_array(eps, b, False)).phase_cap.max())
            pols = {"default": DispatchPolicy(fused=True),
                    "runout": DispatchPolicy(fused=True, chunk=cap + 1),
                    "k8": DispatchPolicy(fused=True, chunk=8)}

            def run(pol):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                r, st = solve(ASSIGNMENT, {"c": c}, eps, pol,
                              keep_state=True, device=dev)
                r.cost.cpu()
                torch.cuda.synchronize()
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
            row = {"B": b, "n": args.n, "mix": mix,
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
