#!/usr/bin/env python3
"""Train deepseek-moe-16b at full width (4 layers) on one card:
chip_smoke.py's phase 12 alone.

    python3 tools/train_model.py [--seed 0] [--out FILE]

Runs ``chip_smoke.phase_train`` as chip_smoke runs it (float32 masters
and AdamW state on the card, a warm-up step and 6 counted steps under
``router="pushrelabel"`` with their ``fused_ot_phases`` launches, one
profiled step, the same under ``"topk"``, the determinism checks, card
against CPU on two reduced models, the ``Trainer``'s resume and
loss-decrease on the card) without phases 1-11. Prints the phase's lines
(``[12] ...``), writes its record as JSON to ``--out`` (by default
``build/train_model.json``) and exits 1 if any check failed. Needs one
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
    ap.add_argument("--out", default="build/train_model.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_model: needs a CUDA device", file=sys.stderr)
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
    ok = cs.phase_train(torch, ops, rdev, torch.device("cuda"), record,
                        {"seed": args.seed}, launches)
    record["launches"] = launches
    record["profiler_misses"] = cs._TIMING.get("profiler_misses", [])
    record["wall_s"] = time.monotonic() - t0
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str))
    print(f"train_model: {'ok' if ok else 'FAILED'} in "
          f"{record['wall_s']:.1f} s; record in {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
