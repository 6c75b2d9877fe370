#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        [--seeds 12] [--control-seeds 3] [--first-seed N] [--out FILE]

In one process, runs the cell at its own size and load for a short
window on ``--seeds`` seeds as the program stands, then on
``--control-seeds`` further seeds with the control switched on: every
cost the program builds rounded to bfloat16, the precision below the
configuration's float32 (a bf16 cost build, the step that would tempt a
later change, since the cost kernel is bound by the bytes it writes).
Prints each run's compared numbers and, per number, the lower reading
(the largest over the program's seeds) and the upper one (the smallest
over the control's). The benchmark's own runs never switch the control
on.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def bf16_costs():
    """Every cost matrix the program builds (``ops.cost_matrix_batched``,
    which the unbatched wrapper and the scheduler's collate call too)
    rounded to bfloat16 and handed on as float32."""
    import torch
    from repro_torch.kernels import ops

    orig = ops.cost_matrix_batched

    def lowered(x, y, metric="sqeuclidean"):
        return orig(x, y, metric).to(torch.bfloat16).to(torch.float32)

    ops.cost_matrix_batched = lowered
    try:
        yield
    finally:
        ops.cost_matrix_batched = orig


def readings(cell, seeds, control_seeds, seconds, device, log=print):
    """Each run's numbers, then per number ``(lower, upper)``."""
    from portbench.lib import harness

    runs = []
    for control, group in ((False, seeds), (True, control_seeds)):
        for seed in group:
            ctx = bf16_costs() if control else contextlib.nullcontext()
            with ctx:
                res, notes = harness.run_cell(cell, seed, seconds, False,
                                              device, time.monotonic())
            nums = {k: v["value"] for k, v in res["checks"].items()}
            row = {"seed": seed, "control": control,
                   "correct": res["correct"], "attempted": res["attempted"],
                   "failed": res["failed"], "numbers": nums,
                   "answers_checked": notes.get("answers_checked")}
            log(json.dumps(row))
            runs.append(row)
    summary = {}
    for name in runs[0]["numbers"]:
        low = max(r["numbers"][name] for r in runs if not r["control"])
        ups = [r["numbers"][name] for r in runs if r["control"]]
        summary[name] = {"lower": low, "upper": min(ups) if ups else None}
    return runs, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib import harness

    harness.cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    s0 = args.first_seed
    seeds = [s0 + 7919 * k for k in range(args.seeds)]
    cseeds = [s0 + 7919 * (args.seeds + k) for k in range(args.control_seeds)]
    runs, summary = readings(cell, seeds, cseeds, args.seconds,
                             torch.device("cuda", 0))
    out = {"workload": args.workload, "seconds": args.seconds,
           "device": torch.cuda.get_device_name(0), "runs": runs,
           "summary": summary, "wall_s": time.monotonic() - T_START}
    print(json.dumps({"summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
