#!/usr/bin/env python3
"""Split one ``slack_propose`` launch into its steps by ``%globaltimer``.

    python3 tools/propose_split.py [--source FILE] [--seed 0] [--reps 6]

Compiles the kernel source (default: this checkout's
``src/repro_torch/csrc/slack_propose.cu``) into this checkout's
``build/propose_split/`` with a timer at each step: thread 0 of every
block reads ``%globaltimer`` at entry, after the first and second rank
barriers, after the list barrier and at exit, and lane 0 of every warp
after its last item. It runs the copy on the rows of
``tools/time_kernel_rows.py`` (chip_smoke's 95 %-live rounds at 10 000^2
and B = 16, 1024^2, the late Fig. 1 round, the 5 %-live batch), each
launch after chip_smoke's cold-L2 spacer, checks it against the plain
version, and prints per row the medians over launches (the first is
dropped) of: the span (first entry to last exit), the steps' medians
over blocks (rank: entry to the first barrier; scan; list; items: list
barrier to the block's last item, median and slowest block) and the tail
after the last item, in microseconds. The stamps are placed by matching
lines of the source, and a source that no longer holds them is an error.
Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MAX_BLOCKS = 1024
PRELUDE = f"""
__device__ unsigned long long g_stamp[{MAX_BLOCKS}][40];
__device__ __forceinline__ unsigned long long stamp_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
"""
# (line of the source, what goes after it)
STAMPS = [
    ("  int carry = 0;  // live rows of the earlier passes\n",
     "  if (threadIdx.x == 0) g_stamp[blockIdx.x][0] = stamp_now();\n"),
    ("    if (threadIdx.x == 0) s_count = 0;\n    __syncthreads();\n",
     "    if (threadIdx.x == 0) g_stamp[blockIdx.x][1] = stamp_now();\n"),
    ("    const int live = s_live;\n",
     "    if (threadIdx.x == 0) g_stamp[blockIdx.x][2] = stamp_now();\n"),
    ("    const int R = s_count;\n",
     "    if (threadIdx.x == 0) g_stamp[blockIdx.x][3] = stamp_now();\n"),
    ("    carry += live;\n",
     "    if (lane == 0) g_stamp[blockIdx.x][8 + warp] = stamp_now();\n"),
]
EXIT = ("    __syncthreads();\n  }\n}\n",
        "    __syncthreads();\n  }\n"
        "  if (threadIdx.x == 0) g_stamp[blockIdx.x][4] = stamp_now();\n}\n")
READ = ('\nextern "C" int read_stamps(void *dst) {\n'
        '  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));\n'
        '}\n')


def instrument(src: str, csrc: Path) -> str:
    src = src.replace('#include "propose.cuh"',
                      f'#include "{csrc / "propose.cuh"}"\n{PRELUDE}')
    for anchor, add in STAMPS + [EXIT]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"propose_split: the source no longer holds "
                               f"one {anchor.strip()!r}")
        src = src.replace(anchor, anchor + add if anchor != EXIT[0] else add)
    return src + READ


def build(source: Path, ops):
    out_dir = ROOT / "build" / "propose_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "slack_propose_stamped.cu"
    cu.write_text(instrument(source.read_text(), source.parent))
    so = out_dir / "libslack_propose_stamped.so"
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.slack_propose_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    lib.read_stamps.restype = ctypes.c_int
    return fn, lib.read_stamps


def rows_of(torch, cs, ops, seed, dev):
    """(name, operands, active) of time_kernel_rows' rows, the mid round
    left out."""
    rng = np.random.default_rng(seed)
    for b, m, n in cs.SIZES["slack_propose"]:
        kargs, active = cs._propose_operands(torch, rng, dev, b, m, n, 0.95)
        yield f"95 % live, {b} x {m} x {n}", kargs, active
        del kargs, active
    late = cs.SIZES["fused_assignment_full"][2]
    c_int, _, _, _, states = cs.fig1_walk(torch, ops, cs.fig1_generator(seed),
                                          dev, k=1)
    for s in states:
        if int(s.phases[0]) >= late:
            break
    n = c_int.shape[2]
    yield (f"late, phase {int(s.phases[0])}",
           (c_int, s.y_b, s.y_a, torch.ones((1, n), dtype=torch.bool,
                                            device=dev),
            (s.phases * 7919).to(torch.int32)), s.match_ba < 0)
    del c_int, states
    b, m, n, frac = cs.SIZES["propose_rounds"]["batch"]
    kargs, active = cs._propose_operands(
        torch, np.random.default_rng([seed, 5]), dev, b, m, n, frac)
    yield f"{frac:.0%} live, {b} x {m} x {n}", kargs, active


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("propose_split: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.slack_propose import slack_propose_ref

    source = Path(args.source or ROOT / "src" / "repro_torch" / "csrc"
                  / "slack_propose.cu").resolve()
    dev = torch.device("cuda")
    fn, read = build(source, ops)
    ok_all = True
    for name, (c, y_b, y_a, avail, salt), active in rows_of(
            torch, cs, ops, args.seed, dev):
        b, m, n = c.shape
        col = torch.empty((b, m), dtype=torch.int32, device=dev)
        key = torch.empty((b, m), dtype=torch.int64, device=dev)
        vec = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                     for t in (c, y_a, avail)))
        runs = []
        for _ in range(args.reps):
            cs._spacer(torch, 1e-4, True)
            err = fn(c.data_ptr(), y_b.data_ptr(), y_a.data_ptr(),
                     avail.data_ptr(), active.data_ptr(), salt.data_ptr(),
                     col.data_ptr(), key.data_ptr(), b, m, n, vec,
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"propose_split: launch failed ({err})")
            t = np.zeros((MAX_BLOCKS, 40), np.uint64)
            read(t.ctypes.data)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            grid = min(b * m, max(sms, 64))     # the launcher's grid
            t = t[:grid].astype(np.int64)
            t = (t - t[:, 0].min()) / 1e3
            items = t[:, 8:40].max(1)
            runs.append({
                "span": t[:, 4].max(), "rank": np.median(t[:, 1] - t[:, 0]),
                "scan": np.median(t[:, 2] - t[:, 1]),
                "list": np.median(t[:, 3] - t[:, 2]),
                "items": np.median(items - t[:, 3]),
                "items_slowest_block": (items - t[:, 3]).max(),
                "tail": np.median(t[:, 4] - items), "grid": grid})
        rcol, rkey = slack_propose_ref(c, y_b, y_a, avail, salt, active)
        ok = bool(torch.equal(col, rcol) and torch.equal(key, rkey))
        ok_all &= ok
        us = {k: float(np.median([r[k] for r in runs[1:]])) for k in runs[0]}
        print(json.dumps({"row": name, "live_rows": int(active.sum()),
                          "same_as_plain": ok, "us": us,
                          "source": str(source)}), flush=True)
        torch.cuda.empty_cache()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
