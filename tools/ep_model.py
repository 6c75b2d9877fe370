#!/usr/bin/env python3
"""Serve and train deepseek-moe-16b at full width under expert
parallelism on logical mesh shards of one card: chip_smoke.py's phase 13
alone.

    python3 tools/ep_model.py [--seed 0] [--out FILE]

Runs ``chip_smoke.phase_ep`` as chip_smoke runs it (the bf16 model's
``Engine`` under a (2, 4) ('data', 'model') mesh and alone, under
``router="pushrelabel"`` and ``"topk"``, the router's flows and
``fused_ot_phases`` rows at a 'dp' shard's shapes, the 3-request
replicated batch, the float32 check against the per-shard single-device
forward, training under a (2, 2) mesh against its single-device twin and
card against CPU under the mesh) without phases 1-12. Prints the
phase's lines (``[13] ...``), writes its record as JSON to ``--out`` (by
default ``build/ep_model.json``) and exits 1 if any check failed. Needs
one CUDA device.
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
    ap.add_argument("--out", default="build/ep_model.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ep_model: needs a CUDA device", file=sys.stderr)
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
    t13 = time.monotonic()
    ok = cs.phase_ep(torch, ops, rdev, torch.device("cuda"), record,
                     {"seed": args.seed}, launches)
    record["phases"]["ep"]["phase_s"] = time.monotonic() - t13
    record["launches"] = launches
    record["profiler_misses"] = cs._TIMING.get("profiler_misses", [])
    record["wall_s"] = time.monotonic() - t0
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str))
    print(f"ep_model: {'ok' if ok else 'FAILED'} in "
          f"{record['wall_s']:.1f} s (phase 13 "
          f"{record['phases']['ep']['phase_s']:.1f} s); record in "
          f"{args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
