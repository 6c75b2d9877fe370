#!/usr/bin/env python3
"""Time the two redesigns of ``sinkhorn_row_update`` that were measured and
not shipped beside the shipped kernel, at chip_smoke's row shapes.

    python3 tools/row_kernel_designs.py [--seed 0] [--out FILE]

Builds into this checkout's ``build/row_kernel_designs/`` (nvcc with the
port's flags, one process per build, all started together):

- ``tools/row_designs/staged.cu``: rows of c staged in shared memory by
  bulk asynchronous copies (``staged_plan`` sizes its ring), also with
  ``-DROW_NO_EXP`` (its data path alone) and ``-DROW_STAMPS`` (a
  ``%globaltimer`` split of one launch);
- ``tools/row_designs/async.cu``: per-warp rings of 16-byte ``cp.async``
  copies, at (float4 in flight a lane, blocks an SM) = (2, 4) and (4, 2),
  also with ``-DROW_NO_EXP``;

and the shipped kernel through ``repro_torch.kernels.ops``. Each design is
first held against the plain version (rtol 1e-5, atol 1e-5 max|f|) on
phase 2's two shapes; staged.cu also on shapes that drive its other paths
(rows in segments, with g in its slot and g in the stages; blocks whose
rows cross lanes; lanes that ``active`` marks off). Then every build is
timed on phase 2's two shapes (``chip_smoke.sinkhorn_row_arrays``, the
same draws): ``chip_smoke.cuda_ms`` (device time, cold L2, median of 20)
and ``profiler_ms``, in turns (shipped, designs, designs reversed,
shipped), beside ``c.sum()`` on the same c, a PyTorch read of every byte
once: the practical read floor. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DESIGNS = ROOT / "tools" / "row_designs"
BUILD = ROOT / "build" / "row_kernel_designs"

# staged.cu's plan (its kMaxStages, kParts and kBarrierBytes agree): a bulk
# copy moves a unit of at most UNIT_FLOATS floats, PARTS whole rows where
# they fit (a warp of the group takes a row each), else one row, else one
# segment of a longer row (a warp takes a quarter of its columns); a lane's
# g is staged whole in one of two slots up to G_WHOLE_MAX columns; the ring
# and the slots stay within SMEM bytes of shared memory.
UNIT_FLOATS = 4096
PARTS = 4
G_WHOLE_MAX = 8192
MAX_STAGES = 32
SMEM = 200 * 1024
BARRIER_BYTES = 2048


class StagedPlan(NamedTuple):
    seg: int            # floats of a row a stage holds (a multiple of 4)
    nseg: int           # segments a row
    rows: int           # rows a stage holds: 1 or PARTS
    stages: int         # S, the depth of the ring
    stage_bytes: int    # the unit's c, then the g segment when g rides along
    g_slot_bytes: int   # a g slot; 0: g rides in the stages
    smem: int           # dynamic shared memory of a block


def _up(v: int, to: int) -> int:
    return -(-v // to) * to


def staged_plan(n: int) -> StagedPlan:
    """staged.cu's units and ring for rows of ``n`` floats (n % 4 == 0,
    n > 0): PARTS whole rows where they fit a unit, else one row, else the
    fewest segments of at most UNIT_FLOATS floats, as even as a multiple of
    4 allows; as many stages (at most MAX_STAGES) as fit beside the g
    slots."""
    if n * PARTS <= UNIT_FLOATS:
        nseg, seg, rows = 1, n, PARTS
    elif n <= UNIT_FLOATS:
        nseg, seg, rows = 1, n, 1
    else:
        nseg = -(-n // UNIT_FLOATS)
        seg, rows = _up(-(-n // nseg), 4), 1
    g_slot = _up(4 * n, 128) if n <= G_WHOLE_MAX else 0
    stage = _up(4 * seg * rows * (1 if g_slot else 2), 128)
    stages = min(MAX_STAGES, (SMEM - BARRIER_BYTES - 2 * g_slot) // stage)
    return StagedPlan(seg, -(-n // seg), rows, stages, stage, g_slot,
                      BARRIER_BYTES + 2 * g_slot + stages * stage)


# build name -> (source, extra nvcc flags)
BUILDS = {
    "staged": ("staged.cu", []),
    "staged_noexp": ("staged.cu", ["-DROW_NO_EXP"]),
    "staged_stamps": ("staged.cu", ["-DROW_STAMPS"]),
    "async": ("async.cu", []),
    "async_noexp": ("async.cu", ["-DROW_NO_EXP"]),
}
ASYNC_CONFIGS = [(2, 4), (4, 2)]  # (float4 in flight a lane, blocks an SM)
# shapes beyond phase 2's on which staged.cu is held against the plain
# version: (B, m, n, lanes marked off)
STAGED_CHECKS = [(2, 40, 8192, ()), (2, 40, 12_000, ()),
                 (600, 3, 1000, (1, 4, 5, 300)), (3, 1000, 64, (1,))]


def _check_arrays(rng, b, m, n):
    """Operands for the extra checks: uniform costs, per-lane reg."""
    c = rng.uniform(size=(b, m, n)).astype(np.float32)
    g = rng.normal(0.0, 0.2, (b, n)).astype(np.float32)
    nu = rng.dirichlet(np.ones(m), b).astype(np.float32)
    log_nu = np.log(np.maximum(nu, 1e-30)).astype(np.float32)
    eps = np.resize([0.3, 0.1, 0.05, 0.03], b)
    reg = (eps / (4 * np.log(max(m, n)))).astype(np.float32)
    return c, g, log_nu, reg


def build(ops, cs) -> dict:
    """Build every entry of BUILDS; {name: ctypes library}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, flags) in BUILDS.items():
        so = BUILD / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, *flags, "-o", str(so),
             str(DESIGNS / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, failed = {}, []
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        print(f"[1] ptxas {name}: {json.dumps(cs.ptxas_summary(out))}",
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        fn = lib.row_design_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([p] * 7 + [i] * 8 + [p] if name.startswith("staged")
                       else [p] * 5 + [i] * 5 + [p])
    libs["staged_stamps"].row_design_stamps.argtypes = [p, i]
    return libs


def staged_call(torch, lib, c, g, log_nu, reg, out, active=None, f_in=None):
    b, m, n = c.shape
    pl = staged_plan(n)
    err = lib.row_design_launch(
        c.data_ptr(), g.data_ptr(), log_nu.data_ptr(), reg.data_ptr(),
        0 if active is None else active.data_ptr(),
        0 if f_in is None else f_in.data_ptr(), out.data_ptr(), b, m, n,
        pl.seg, pl.rows, pl.stages, pl.stage_bytes, pl.g_slot_bytes,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"staged launch failed (cudaError {err})")


def async_call(torch, lib, c, g, log_nu, reg, out, depth, per_sm):
    b, m, n = c.shape
    err = lib.row_design_launch(
        c.data_ptr(), g.data_ptr(), log_nu.data_ptr(), reg.data_ptr(),
        out.data_ptr(), b, m, n, depth, per_sm,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"async launch failed (cudaError {err})")


def close(torch, got, ref) -> tuple:
    """(within rtol 1e-5, atol 1e-5 max|f|, max error over that tolerance)."""
    tol = 1e-5 * float(ref.abs().max()) + 1e-5 * ref.abs()
    ratio = float(((got - ref).abs() / tol).max())
    return bool(torch.isfinite(got).all()) and ratio <= 1.0, ratio


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("row_kernel_designs: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref

    dev = torch.device("cuda")
    ops.build_kernels()
    libs = build(ops, cs)
    card = cs.smi_line()
    ok = True
    rows = []

    # staged.cu on the shapes of its other paths
    check_rng = np.random.default_rng([args.seed, 18])
    for b, m, n, off in STAGED_CHECKS:
        c, g, log_nu, reg = (torch.as_tensor(a, device=dev) for a in
                             _check_arrays(check_rng, b, m, n))
        ref = sinkhorn_row_ref(c, g, log_nu, reg)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        active[list(off)] = False
        f_in = torch.randn((b, m), device=dev)
        out = torch.empty((b, m), device=dev)
        staged_call(torch, libs["staged"], c, g, log_nu, reg, out, active,
                    f_in)
        torch.cuda.synchronize()
        good, ratio = close(torch, out[active], ref[active])
        good &= bool(torch.equal(out[~active], f_in[~active]))
        row = {"check": "staged", "shape": [b, m, n], "marked_off": off,
               "ok": good, "err_over_tol": ratio}
        print(json.dumps(row), flush=True)
        rows.append(row)
        ok &= good

    rng = np.random.default_rng([args.seed, 3])
    for b, m, n in cs.SIZES["sinkhorn_row"]:
        c, g, log_nu, reg = (torch.as_tensor(a, device=dev) for a in
                             cs.sinkhorn_row_arrays(rng, b, m, n))
        kargs = (c, g, log_nu, reg)
        ref = sinkhorn_row_ref(*kargs)
        out = torch.empty((b, m), device=dev)
        calls = {"shipped": lambda: ops.sinkhorn_row_update(*kargs)}
        for name in ("staged", "staged_noexp"):
            calls[name] = (lambda lib=libs[name]:
                           staged_call(torch, lib, *kargs, out))
        for name in ("async", "async_noexp"):
            for depth, per_sm in ASYNC_CONFIGS:
                calls[f"{name}_d{depth}x{per_sm}"] = (
                    lambda lib=libs[name], depth=depth, per_sm=per_sm:
                    async_call(torch, lib, *kargs, out, depth, per_sm))
        checks = {}
        for name, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            checks[name] = close(torch, out if got is None else got, ref)
            if "noexp" not in name:
                ok &= checks[name][0]
        designs = [k for k in calls if k != "shipped"]
        order = ["shipped", *designs, *designs[::-1], "shipped"]
        times = {k: [] for k in calls}
        for name in order:
            times[name].append(cs.cuda_ms(torch, calls[name], reps=20))
        floor_ms = cs.cuda_ms(torch, lambda: c.sum(), reps=20)
        nbytes = 4 * b * m * n + 4 * b * (n + 2 * m + 1)
        bound_ms = 1e3 * nbytes / cs.HBM_BYTES_PER_S
        for name, fn in calls.items():
            row = {"shape": [b, m, n], "build": name, "ok": checks[name][0],
                   "err_over_tol": checks[name][1], "ms": times[name],
                   "profiler_ms": cs.profiler_ms(torch, fn, "sinkhorn_row"),
                   "read_floor_ms": floor_ms, "bound_ms": bound_ms,
                   "card": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
        # where staged.cu's time goes: one cold launch, stamps per block
        lib = libs["staged_stamps"]
        blocks = min(torch.cuda.get_device_properties(dev)
                     .multi_processor_count, b * m)
        stamps = np.zeros((blocks, 4), np.uint64)
        lib.row_design_stamps(stamps.ctypes.data, blocks)  # zero them
        cs._spacer(torch, 1e-4, True)
        staged_call(torch, lib, *kargs, out)
        torch.cuda.synchronize()
        lib.row_design_stamps(stamps.ctypes.data, blocks)
        t = (stamps.astype(np.int64) - int(stamps[:, 0].min())) / 1e3
        split = {"shape": [b, m, n], "split_us": {
            "first_landing_median": float(np.median(t[:, 1])),
            "last_issue_median": float(np.median(t[:, 2])),
            "exit_median": float(np.median(t[:, 3])),
            "exit_max": float(t[:, 3].max())},
            "plan": staged_plan(n)._asdict()}
        print(json.dumps(split), flush=True)
        rows.append(split)
        del c, g, log_nu, reg, kargs, ref, out
        torch.cuda.empty_cache()
    if args.out:
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rows, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
