#!/usr/bin/env python3
"""Plan full-width cells on the production mesh and hold a plan against
the card: chip_smoke.py's phase 14 alone.

    python3 tools/dryrun_model.py [--seed 0] [--out FILE]

Runs ``chip_smoke.phase_dryrun`` as chip_smoke runs it ((a) six
full-width cells through ``launch.dryrun.run_cell`` on the 256- and
512-device production meshes; (b) phase 12's training configuration
planned on a (1, 1) mesh of the card, then placed and stepped there:
argument bytes, memory peak, FLOPs, step time against the plan's bound,
``fused_ot_phases`` launches against its custom calls; (c)
``lower_sharded_solver`` and ``solve_assignment_sharded`` on a logical
(2, 2) mesh of the card) without phases 1-13. Prints the phase's lines
(``[14] ...``), writes its record as JSON to ``--out`` (by default
``build/dryrun_model.json``) and exits 1 if any check failed. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/dryrun_model.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dryrun_model: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core import device as rdev
    from repro_torch.kernels import ops

    t0 = time.monotonic()
    print(cs.smi_line(), flush=True)
    ops.build_kernels()
    record = {"seed": args.seed, "phases": {}}
    launches = {}
    t14 = time.monotonic()
    ok = cs.phase_dryrun(torch, ops, rdev, torch.device("cuda"), record,
                         {"seed": args.seed}, launches)
    record["phases"]["dryrun"]["phase_s"] = time.monotonic() - t14
    record["launches"] = launches
    record["wall_s"] = time.monotonic() - t0
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str))
    print(f"dryrun_model: {'ok' if ok else 'FAILED'} in "
          f"{record['wall_s']:.1f} s (phase 14: "
          f"{record['phases']['dryrun']['phase_s']:.1f} s); record in "
          f"{args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
