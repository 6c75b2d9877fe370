#!/usr/bin/env python3
"""Wall time of ``solve()`` on the Fig. 1 assignment cell, for A/B runs.

    python3 tools/time_solve.py [--seed 0] [--reps 3] [--label NAME]
                                [--fused]

Solves the n = 10 000 assignment of ``chip_smoke.py`` (uniform points in
the unit square, euclidean, eps = 0.01) once on the stepped route
(``DispatchPolicy(fused=False)``) to warm up, then ``reps`` times on it
and once under ``guaranteed=True``. With ``--fused`` each of those solves
is paired with the same solve on the fused route
(``DispatchPolicy(fused=True)``, the default on the card), in turns
(stepped, fused, fused, stepped, ...), so the two routes are
compared in one call on one card. Prints one JSON line: the wall seconds
of each solve (host clock around a solve that ends in a device
synchronize), phases, rounds and host syncs by kind. It imports
``repro_torch`` from the tree it sits in, so two versions are compared by
copying this file into the other tree's ``tools/`` and running both in
one call, alternating (A, B, B, A). Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--fused", action="store_true",
                    help="pair every solve with the fused route's")
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    import torch
    if not torch.cuda.is_available():
        print("time_solve: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import device as rdev
    from repro_torch.core.api import ASSIGNMENT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    x, y = (rng.uniform(size=(10_000, 2)).astype(np.float32)
            for _ in range(2))
    c = build_cost_matrix(x, y, "euclidean", device=dev)[None]

    def run(policy):
        rdev.reset_sync_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        s = solve(ASSIGNMENT, {"c": c}, 0.01, policy, want=("cost",),
                  device=dev)[0]
        cost = s.cost                       # ends in a device->host read
        torch.cuda.synchronize()
        return {"wall_s": time.monotonic() - t0, "phases": s.phases,
                "rounds": s.rounds, "cost": cost,
                "syncs": dict(rdev.sync_counts)}

    stepped = DispatchPolicy(fused=False)
    run(stepped)                            # warm-up (kernel build, caches)
    out = {"label": args.label, "tree": str(root)}
    if not args.fused:
        out["default"] = [run(stepped) for _ in range(args.reps)]
        out["guaranteed"] = run(DispatchPolicy(guaranteed=True, fused=False))
    else:
        run(DispatchPolicy(fused=True))     # warm-up of the fused route
        for key, kw in (("default", {}),
                        ("guaranteed", {"guaranteed": True})):
            reps = args.reps if key == "default" else 1
            for i in range(reps):
                order = (False, True) if i % 2 == 0 else (True, False)
                for fused in order:
                    name = f"fused_{key}" if fused else key
                    out.setdefault(name, []).append(
                        run(DispatchPolicy(fused=fused, **kw)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
