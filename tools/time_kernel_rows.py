#!/usr/bin/env python3
"""Time one kernel on chip_smoke's phase-2 rows, for A/B runs.

    python3 tools/time_kernel_rows.py [--kernel slack_propose|cost_matrix|
                                               sinkhorn_row_update]
                                      [--seed 0] [--label NAME] [--out FILE]

The rows are chip_smoke's own, built by its helpers from the same seed:

- ``--kernel slack_propose`` (the default): the two rounds with 95 % of
  the rows live (B = 1, 10 000^2 and B = 16, 1024^2; ``phase_kernels``'
  first draws) and the rounds the stepped route runs
  (``phase_propose_rounds``: round 0 of phase 280 of the Fig. 1 solve,
  169 live rows; of the first phase with at most 4000 free rows; a
  B = 16, 1024^2 batch with 5 % live). Each row: equal to the plain
  version bit for bit, the kernel's device time cold and warm
  (``chip_smoke.cuda_ms``, median of 20), under the profiler, the plain
  version's time and the bound.
- ``--kernel cost_matrix``: ``phase_cost_rows``' rows (every metric at
  B = 1, 10 000^2 and B = 16, 1024^2 with d = 2; l1 at 2048^2 with
  d = 784), from the draws ``phase_kernels`` makes after its
  ``slack_propose`` rows, each with its tolerance, bound and
  ``out_sha256`` (equal digests: bit-equal costs).
- ``--kernel sinkhorn_row_update``: ``phase_sinkhorn_kernel``'s rows
  (B = 1, 4096^2 and B = 8, 1024 x 1000) with their tolerance and
  ``out_sha256``.

Each row is printed as chip_smoke prints it (``[2] {...}``). The tool
imports ``repro_torch`` and ``chip_smoke`` from the tree it sits in, so
two versions of a kernel are compared by running it from two trees in
one call, in turns (A, B, B, A). Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="slack_propose",
                    choices=("slack_propose", "cost_matrix",
                             "sinkhorn_row_update"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernel_rows: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    ops.build_kernels()
    if args.kernel in ops.build_log:  # built by this process
        print(f"[1] ptxas {args.kernel}: "
              f"{json.dumps(cs.ptxas_summary(ops.build_log[args.kernel]))}",
              flush=True)
    rows = []
    if args.kernel == "sinkhorn_row_update":
        ok = cs.phase_sinkhorn_kernel(
            torch, ops, np.random.default_rng([args.seed, 3]), dev, rows, {})
    elif args.kernel == "cost_matrix":
        rng = np.random.default_rng(args.seed)
        for b, m, n in cs.SIZES["slack_propose"]:
            cs._propose_arrays(rng, b, m, n, 0.95)
        ok = cs.phase_cost_rows(torch, ops, rng, dev, rows, {})
    else:
        rng = np.random.default_rng(args.seed)
        for b, m, n in cs.SIZES["slack_propose"]:
            kargs, active = cs._propose_operands(torch, rng, dev, b, m, n,
                                                 0.95)
            rows.append(cs._propose_row(torch, ops, kargs, active,
                                        round="dense"))
            del kargs, active
            torch.cuda.empty_cache()
        ok = cs.phase_propose_rounds(
            torch, ops, cs.fig1_generator(args.seed),
            np.random.default_rng([args.seed, 5]), dev, rows)
    for row in rows:
        row.update(label=args.label, tree=str(ROOT), card=cs.smi_line())
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0 if ok and all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
