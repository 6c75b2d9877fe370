#!/usr/bin/env python3
"""Measure the solver portfolio on the card and fit the cost model behind
``DispatchPolicy(solver="auto")``.

    python3 tools/calibrate_portfolio.py [--seed 0] [--batch 4]
        [--sizes 256 1024 4096] [--eps 0.3 0.1 0.03]
        [--out src/repro_torch/portfolio/costmodel_default.json]
        [--records build/calibration.json]

The port of ``benchmarks/bench_portfolio.py --calibrate``. For every
(solver, n, eps) cell, with solver in push-relabel, Sinkhorn and hybrid,
it solves a batch of ``--batch`` OT instances (n uniform points in the unit
square against n others, euclidean costs, Dirichlet(1) masses: the paper's
setting and ``chip_smoke.py``'s OT cells) through ``solve()`` under the
default policy with that solver, once to warm up and then ``--reps`` times
(one time only when the warm-up took over ``--long`` seconds). It records
the median wall seconds per instance (host clock around a solve that ends
in a device synchronize) and the iterations or phases per lane, then fits
the table with ``portfolio.costmodel.fit`` (``mode`` "cuda", ``backend``
the card's ``nvidia-smi`` name and power limit) and writes it to
``--out``. Needs one CUDA device; refuses to run without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 1024, 4096])
    ap.add_argument("--eps", type=float, nargs="+", default=[0.3, 0.1, 0.03])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--long", type=float, default=15.0,
                    help="a warm-up longer than this many seconds is "
                         "followed by one timed solve, not --reps")
    root = Path(__file__).resolve().parents[1]
    ap.add_argument("--out", default=str(
        root / "src/repro_torch/portfolio/costmodel_default.json"))
    ap.add_argument("--records", default=None,
                    help="also write every cell's record here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("calibrate_portfolio: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.api import OT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.portfolio import SOLVERS, fit

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    records = []
    t_start = time.monotonic()
    for n in args.sizes:
        b = args.batch
        pts = rng.uniform(size=(2, b, n, 2)).astype(np.float32)
        c = build_cost_matrix(pts[0], pts[1], "euclidean", device=dev)
        nu = rng.dirichlet(np.ones(n), b).astype(np.float32)
        mu = rng.dirichlet(np.ones(n), b).astype(np.float32)
        inputs = {"c": c, "nu": nu, "mu": mu}
        for eps in args.eps:
            for solver in SOLVERS:
                policy = DispatchPolicy(solver=solver)

                def run():
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    sols = solve(OT, inputs, eps, policy,
                                 want=("cost", "stats"), device=dev)
                    sols.cost()
                    torch.cuda.synchronize()
                    return time.monotonic() - t0, sols

                warm, sols = run()
                reps = 1 if warm > args.long else args.reps
                times = [run()[0] for _ in range(reps)]
                rec = {"solver": solver, "n": n, "eps": eps, "batch": b,
                       "per_instance_s": statistics.median(times) / b,
                       "wall_s": times, "warmup_s": warm,
                       "phases": sols.phases().tolist()}
                records.append(rec)
                print(json.dumps(rec), flush=True)
    model = fit(records, mode="cuda", backend=smi)
    model.save(args.out)
    print(f"wrote {args.out}: {len(model.entries)} cells in "
          f"{time.monotonic() - t_start:.0f} s", flush=True)
    if args.records:
        Path(args.records).parent.mkdir(parents=True, exist_ok=True)
        Path(args.records).write_text(json.dumps(
            {"card": smi, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
