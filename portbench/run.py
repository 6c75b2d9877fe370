#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Sets the cell up from the seed (inputs,
kernel load, warm-up), measures for ``--seconds``, checks a sample of
the answers drawn from the seed against the plain reference
(``portbench/reference/``), prints each compared number beside its limit
on standard error and, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when JAX or the JAX package was loaded.
"""
import time

T_START = time.monotonic()

import os  # noqa: E402

# one process with few threads: CPU thread pools that spin after their
# work (OpenMP, BLAS) would take host cores from the program's launch
# loop; the benchmark's own CPU work is single-threaded NumPy
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    from portbench.lib import harness

    harness.cache_dirs(ROOT)
    cell = harness.load_cell(args.workload, ROOT)
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result, notes = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), dev, T_START,
                                     torch=torch)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(dev),
                        **result["device"]}
    print("portbench notes: " + json.dumps(notes, default=str),
          file=sys.stderr)
    harness.print_checks(result)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
