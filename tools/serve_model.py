#!/usr/bin/env python3
"""Serve deepseek-moe-16b at full width through ``Engine`` on one card:
chip_smoke.py's phase 11 alone.

    python3 tools/serve_model.py [--seed 0] [--out FILE]

Runs ``chip_smoke.phase_models`` as chip_smoke runs it (the model built
on the card in bf16, ``Engine`` under ``router="topk"`` and
``"pushrelabel"`` after a warm-up run each, the router's flows and
``fused_ot_phases`` rows at the router's shapes, one profiled decode
step of each router, card against CPU on three reduced models) without
phases 1-10, in about a minute on an H100. Prints the phase's lines
(``[11] ...``), writes its record as JSON to ``--out`` (by default
``build/serve_model.json``) and exits 1 if any check failed. Needs one
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
    ap.add_argument("--out", default="build/serve_model.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_model: needs a CUDA device", file=sys.stderr)
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
    ok = cs.phase_models(torch, ops, rdev, torch.device("cuda"), record,
                         {"seed": args.seed}, {})
    record["wall_s"] = time.monotonic() - t0
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str))
    print(f"serve_model: {'ok' if ok else 'FAILED'} in "
          f"{record['wall_s']:.1f} s; record in {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
