#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, in order; any failure exits non-zero:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions; build the CUDA kernels from ``src/repro_torch/csrc`` and
     print each entry function's registers, shared memory and spills
     (``ptxas -v``);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: ``slack_propose`` equal bit for bit,
     ``cost_matrix`` within the stated tolerance (each row with
     ``out_sha256``, the digest of the output, as the row kernel's rows
     too); CUDA-event times of kernel, plain version and library call
     beside the bound (``cost_bound``: an l1 term is two FP32
     instructions, an FFMA two flops). The fused
     kernels (``fused_assignment_phases`` at B = 16, 1024 x 1024;
     ``fused_ot_phases`` at B = 8, 512 x 512) run one k = 8 chunk from a
     state a few stepped phases in, every integer field equal to the
     plain version's and to the stepped core's; times of the chunk
     launch, the plain version and the stepped ``run_*_phases``.
     ``fused_assignment_phases`` also at full width: B = 1 on phase 3's
     Fig. 1 costs, one k = 8 chunk from phase 280 of that solve (reached
     on the fused route), against the plain version and the stepped
     core; ``fused_ot_phases`` also at full width: B = 1 at the OT
     cell's size (n = 4096, eps = 0.05) from the initial state, the
     whole solve in one chunk;
     ``sinkhorn_row_update`` at B = 1, 4096 x 4096 and at B = 8, 1024 x
     1000 (per-lane reg, ragged blocks, a zero-mass lane, half the lanes
     marked off by ``active_b``) within its stated tolerance;
     ``slack_propose`` also on the rounds the stepped route runs: round 0
     of phase 280 of phase 3's Fig. 1 solve (169 live rows), of an
     earlier phase with a few thousand, and a B = 16, 1024 x 1024 batch
     with 5 % of the rows live. Every kernel's time is device time
     (``cuda_ms``), cross-checked by ``torch.profiler``
     (``profiler_ms``);
  3. ``solve(ASSIGNMENT)`` at the paper's size (Fig. 1: n = 10 000 points
     in the unit square, euclidean, eps = 0.01) under the default policy
     and under ``guaranteed=True``, with their certificates and the
     kernel launch counts;
  4. ``solve(OT)`` at n = 4096 with Dirichlet masses, eps = 0.05, with its
     certificates, and an OT solve at n = 512 against scipy's exact LP;
  5. card against CPU on a ragged batch of 8 instances (n = 128 .. 512)
     for both problems: integer state equal field by field; the n = 2048
     assignment cost against ``linear_sum_assignment``;
  6. the fused route, ``DispatchPolicy(fused=True)``: the solves of
     phases 3 and 4 again, on the same inputs, with the same integer
     state and certificates, one fused launch per chunk dispatch, no
     ``slack_propose`` launch and no round flag read; the ragged batch of
     phase 5 in lockstep and compact mode against the CPU's stepped
     state;
  7. the solver portfolio on phase 4's inputs: ``solver="sinkhorn"``
     (stepped, then ``fused=True``, which launches ``sinkhorn_row_update``
     once per f-update), ``"hybrid"`` and ``"auto"`` at n = 4096, each
     with its certificates and, for Sinkhorn, plan marginals exact to
     f32; Sinkhorn and hybrid at n = 512 within their bound of scipy's LP
     optimum; then card against CPU on phase 5's ragged batch (Sinkhorn
     floats within a stated tolerance; the hybrid finish from the same
     warm duals with equal integer state);
  8. the serving path: (a) ``AsyncOTScheduler`` with 64 point-cloud
     requests (d = 2, euclidean, m and n from 256-2048, every other one
     OT with Dirichlet(1) masses, eps from {0.05, 0.1}, ``linger_ms=5``,
     ``validate=True``), one of them with a NaN point, which must come
     back ``RequestRejected`` while the rest of its bucket solves, then
     one request with an expired ``deadline``, which must come back
     ``degraded`` with a valid certificate; (b) ``OTService.run_batch``
     with 8 assignment requests of n = 1024-2048 784-pixel images each
     (l1, eps 0.1: Fig. 2's shape, the cost kernel's images instance);
     every healthy request at ladder level 0, not degraded, the
     ``cost_matrix`` and ``slack_propose`` counts moved; p50/p99 latency,
     instances/s; (c) every bucket's costs equal to the plain version
     on the card within ``tolerance(metric, d)`` (the serve shapes: B x
     2048^2 at d = 2, 8 x 2048^2 at d = 784), its integer state equal to
     a direct ``solve()`` of the same padded costs on the card, and lane
     (k mod B) of bucket k on the CPU; (d) (a)'s requests again under a
     ``FaultInjector`` transient, retried on the card, every request at
     ladder level 0 and every integer state equal to (a)'s; the memory
     peak ``torch.cuda.max_memory_allocated()`` of (a) + (b), whose
     recordings for (c) hold every bucket on the card, and of (d), which
     records nothing (the service's own peak);
  9. one JSON line with every kernel's numbers;
 10. last line: ``{"ok": true, "device": {...}}``.

Phases 3-4 (the stepped route), each part of phase 6 (the fused route),
each solve of phase 7 and phase 8's (a) and (b) together (the serve
route) are driven with the launch counts set to 0 just before and read
just after; the kernels line gives each kernel's launches on its route,
and on the serve route as ``serve_launches``.

It needs one card and exits non-zero when CUDA is unavailable or when it
is run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import copy
import gc
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
# int32 ALU instructions: the fp32 rate counts an FMA as 2 flops, so one
# instruction per lane per clock is half of it
INT32_OP_PER_S = FP32_FLOP_PER_S / 2

# the shapes of each phase (see the module docstring)
SIZES = {
    # (B, m, n)
    "slack_propose": [(1, 10_000, 10_000), (16, 1024, 1024)],
    # (metric, B, m, n, d)
    "cost_matrix": ([(mt, 1, 10_000, 10_000, 2)
                     for mt in ("euclidean", "sqeuclidean", "l1")]
                    + [(mt, 16, 1024, 1024, 2)
                       for mt in ("euclidean", "sqeuclidean", "l1")]
                    + [("l1", 1, 2048, 2048, 784)]),
    "assignment": (10_000, 0.01),                       # (n, eps)
    "ot": [(4096, 0.05, False), (512, 0.05, True)],     # (n, eps, exact)
    "card_vs_cpu": [128, 160, 200, 256, 300, 384, 450, 512],
    "assignment_exact": (2048, 0.05),                   # (n, eps)
    # fused kernels, phase 2: (B, n, eps, stepped phases before the chunk)
    "fused_assignment": (16, 1024, 0.01, 3),
    # (n, eps, phase the chunk starts at), on phase 3's Fig. 1 costs
    "fused_assignment_full": (10_000, 0.01, 280),
    "fused_ot": (8, 512, 0.02, 2),
    # (n, eps): the OT cell's solve, from the initial state
    "fused_ot_full": (4096, 0.05),
    "fused_k": 8,
    # slack_propose on the stepped route's rounds, phase 2: the Fig. 1
    # round with at most mid_free free rows, and (B, m, n, share of rows
    # active) of a batch
    "propose_rounds": {"mid_free": 4000, "batch": (16, 1024, 1024, 0.05)},
    # sinkhorn_row_update, phase 2: (B, m, n)
    "sinkhorn_row": [(1, 4096, 4096), (8, 1024, 1000)],
    # phase 8, serving: (a) scheduler requests (m, n drawn from sizes,
    # eps from eps, request nan_at poisoned), the expired-deadline
    # request (n, eps: far more phases than the first chunk's 8, so the
    # cut always leaves it degraded); (b) image_reqs assignment requests of n (drawn
    # from images) 784-pixel images each, l1, image_eps
    "serve": {"requests": 64, "sizes": (256, 2048), "eps": (0.05, 0.1),
              "nan_at": 11, "linger_ms": 5.0,
              "want": ("cost", "duals", "state"),
              "deadline": (2048, 0.01),
              "images": (1024, 2048), "image_reqs": 8, "image_eps": 0.1},
}

# kernel -> (source, Pallas kernel it replaces)
KERNELS = {
    "slack_propose": (
        "src/repro_torch/csrc/slack_propose.cu",
        "src/repro/kernels/slack_propose.py:86 (slack_propose; "
        "slack_propose_batched at :157)"),
    "cost_matrix": (
        "src/repro_torch/csrc/cost_matrix.cu",
        "src/repro/kernels/cost_matrix.py:76 (cost_matrix; "
        "cost_matrix_batched at :117)"),
    "fused_assignment_phases": (
        "src/repro_torch/csrc/fused_assignment.cu",
        "src/repro/kernels/fused_phase.py:181 (fused_assignment_phases; "
        "_assignment_kernel at :87)"),
    "fused_ot_phases": (
        "src/repro_torch/csrc/fused_ot.cu",
        "src/repro/kernels/fused_phase.py:334 (fused_ot_phases; "
        "_ot_kernel at :230)"),
    "sinkhorn_row_update": (
        "src/repro_torch/csrc/sinkhorn_row.cu",
        "src/repro/kernels/sinkhorn_step.py:50 (sinkhorn_row_update; "
        "pallas_call at :73)"),
}
# the route whose launches the kernels line gives for each kernel
ROUTE = {"slack_propose": "stepped", "cost_matrix": "stepped",
         "fused_assignment_phases": "fused_assignment",
         "fused_ot_phases": "fused_ot",
         "sinkhorn_row_update": "sinkhorn_fused"}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


FLUSH_BYTES = 256 << 20        # read before a cold call: > the 50 MB L2
_TIMING: dict = {}


def _spacer(torch, host_s: float, cold: bool) -> None:
    """Enqueue what the card runs just before a timed call: a spin
    (``torch.cuda._sleep``) of twice ``host_s`` plus 50 us (at most 20 ms),
    then, if ``cold``, a read of a ``FLUSH_BYTES`` scratch."""
    st = _TIMING.get("state")
    if st is None:
        flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        b.synchronize()
        st = _TIMING["state"] = {"flush": flush,
                                 "cycles_per_s": 1e9 / a.elapsed_time(b)}
    spin_s = min(2 * host_s + 50e-6, 20e-3)
    torch.cuda._sleep(int(spin_s * st["cycles_per_s"]))
    if cold:
        st["flush"].sum()


def _warm_up(torch, fn, warmup: int) -> float:
    """Run ``fn()`` ``warmup`` times (at least once); the host seconds the
    last call took to return, which is what the spacer must cover."""
    host = 0.0
    for _ in range(max(warmup, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host


def cuda_ms(torch, fn, reps: int, warmup: int = 2, cold: bool = True
            ) -> float:
    """Median device time in ms of ``fn()`` over ``reps`` calls, each
    bracketed by two CUDA events, after ``warmup`` calls.

    Before each first event the stream gets a spacer: a spin of twice the
    host time of one call, then (``cold``) a read of 256 MB. The card
    reaches the first event only after the host has enqueued the call and
    the second event, so the interval holds the call's kernels and the
    gaps between them on the card, not the wrapper's host work (checks,
    allocations, the ctypes call). Recorded on an idle card, the first
    event would let that host work into the interval, most of it for a
    kernel of a few tens of us. A function that reads the device
    from the host (the stepped cores) still waits on it inside the
    interval.

    The L2 is cold (the read evicts the call's operands; its lines are
    clean, so evicting them writes nothing), as the bounds assume: every
    operand byte read from HBM once. On their routes: ``slack_propose``'s
    operands exceed the L2 except in late rounds (169 live rows of
    10 000: 6.8 MB), whose rows the previous round read, with only (B, m)
    and (B, n) vectors touched between; those rows carry a ``warm_ms``
    (``cold=False``) beside. ``cost_matrix`` reads kilobytes and writes
    B m n floats, so the L2 does not matter. A fused chunk's c_int stays
    in L2 across the chunks of a solve only at B = 8, 512^2 (8 MB).
    ``sinkhorn_row_update`` follows the column update, which reads all of
    c (32-64 MB here), so at most c's tail is warm."""
    host = _warm_up(torch, fn, warmup)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _spacer(torch, host, cold)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_us(evt) -> float:
    """Device microseconds of one ``key_averages()`` entry."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profiler_ms(torch, fn, kernel: str, reps: int = 5, cold: bool = True):
    """The cross-check of ``cuda_ms``: mean device time in ms, per call
    of ``fn()``, of the CUDA kernels whose name contains ``kernel``, as
    ``torch.profiler`` records them (CUPTI's start and end of each
    kernel), with the same spacer before each call. None if the profiler
    saw no such kernel."""
    host = _warm_up(torch, fn, 1)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            _spacer(torch, host, cold)
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(e) for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")


def ptxas_summary(text: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {entry function: {"registers",
    "smem" (static bytes), "spill_stores", "spill_loads"}}."""
    out, entry = {}, None
    for line in text.splitlines():
        if (e := _PTXAS_ENTRY.search(line)):
            entry = e.group(1)
            out[entry] = {"registers": None, "smem": 0, "spill_stores": 0,
                          "spill_loads": 0}
        elif entry is None:
            continue
        elif (sp := _PTXAS_SPILL.search(line)):
            out[entry].update(spill_stores=int(sp.group(1)),
                              spill_loads=int(sp.group(2)))
        elif (u := _PTXAS_USED.search(line)):
            out[entry].update(registers=int(u.group(1)),
                              smem=int(u.group(2) or 0))
    return out


def out_sha256(t) -> str:
    """SHA-256 of a tensor's bytes (copied to the host): two kernels'
    outputs are bit-equal iff their digests are."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the full record of the run is written")
    args = ap.parse_args()

    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        return fail("src/repro_torch not found beside chip_smoke.py; run "
                    "it from a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script "
                    "drives the port on an NVIDIA GPU")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import device as rdev
    from repro_torch.kernels import ops

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    record = {"seed": args.seed, "phases": {}}
    t_start = time.monotonic()

    # -- 1. the card, the build --------------------------------------
    smi = smi_line()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    build_s = ops.build_kernels()
    log(f"[1] built {sorted(ops.build_log) or 'no'} kernels in "
        f"{build_s:.1f} s")
    record["ptxas"] = {name: ptxas_summary(text)
                       for name, text in sorted(ops.build_log.items())}
    for name, entries in record["ptxas"].items():
        log(f"[1] ptxas {name}: {json.dumps(entries)}")
    record["card"] = smi
    record["build_s"] = build_s

    # -- 2. kernels against their plain versions -----------------------
    kernel_rows = {}
    record["phases"]["kernels"] = rows = []
    if not phase_kernels(torch, ops, rng, dev, rows, kernel_rows):
        return fail("a kernel disagreed with its plain version")
    # its own generator, so phases 3-5 draw the inputs they always drew;
    # a copy of the main one draws phase 3's Fig. 1 points
    if not phase_fused_kernels(torch, ops, np.random.default_rng(
            [args.seed, 2]), dev, rows, kernel_rows,
            fig1_rng=copy.deepcopy(rng), seed=args.seed):
        return fail("a fused kernel disagreed with its plain version")
    if not phase_sinkhorn_kernel(torch, ops, np.random.default_rng(
            [args.seed, 3]), dev, rows, kernel_rows):
        return fail("sinkhorn_row_update disagreed with its plain version")
    if not phase_propose_rounds(torch, ops, copy.deepcopy(rng),
                                np.random.default_rng([args.seed, 5]), dev,
                                rows):
        return fail("slack_propose disagreed with its plain version on "
                    "the route's rounds")
    log(f"[2] done at {time.monotonic() - t_start:.0f} s")

    # -- 3-5: the stepped route, counted --------------------------------
    ctx = {"seed": args.seed}
    launches = {}
    ops.reset_launches()
    rdev.reset_sync_counts()
    ok = phase_assignment(torch, rng, dev, record, ctx)
    launches["stepped"] = main_launches = dict(ops.launches)
    log(f"[3] launches {main_launches}, syncs {dict(rdev.sync_counts)}; "
        f"done at {time.monotonic() - t_start:.0f} s")
    if not ok:
        return fail("full-size assignment")
    for name in ("slack_propose", "cost_matrix"):
        if main_launches[name] == 0:
            return fail(f"the main path never launched {name}")

    ops.reset_launches()
    rdev.reset_sync_counts()
    ok = phase_ot(torch, rng, dev, record, ctx)
    ot_launches = dict(ops.launches)
    log(f"[4] launches {ot_launches}, syncs {dict(rdev.sync_counts)}; "
        f"done at {time.monotonic() - t_start:.0f} s")
    if not ok:
        return fail("OT")
    if ot_launches["slack_propose"] == 0:
        return fail("the OT path never launched slack_propose")

    if not phase_card_vs_cpu(torch, rng, dev, record, ctx):
        return fail("card against CPU")
    log(f"[5] done at {time.monotonic() - t_start:.0f} s")

    # -- 6. the fused route, counted --------------------------------------
    if not phase_fused(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the fused route")
    log(f"[6] done at {time.monotonic() - t_start:.0f} s")

    # -- 7. the solver portfolio, counted ---------------------------------
    if not phase_portfolio(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the solver portfolio")
    if not phase_portfolio_card_vs_cpu(torch, dev, record, ctx):
        return fail("the solver portfolio, card against CPU")
    log(f"[7] done at {time.monotonic() - t_start:.0f} s")

    # -- 8. the serving path, counted -------------------------------------
    if not phase_serving(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the serving path")
    log(f"[8] done at {time.monotonic() - t_start:.0f} s")

    # -- 9. kernels line ------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = dict(kernel_rows[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[ROUTE[name]][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "ok": row["ok"], "shape": row["shape"],
            "serve_launches": launches["serve"][name],
            **({"stepped_ms": row["stepped_ms"]} if "stepped_ms" in row
               else {})})
    record["kernels"] = kernels
    record["launches"] = launches
    record["ot_launches"] = ot_launches
    record["wall_s"] = time.monotonic() - t_start
    out = root / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=float))
    log(f"[9] record written to {args.out}")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def propose_bound(b: int, m: int, n: int, n_active: int):
    """``(bound_ms, bound_by)`` of one ``slack_propose`` launch: bytes, the
    live rows of c_int read once (4 n per row) and the vectors (y_b,
    active, y_a, avail, salt) read once, the outputs (12 B per row)
    written once, over the HBM rate; operations, 3 int32 (add, compare,
    select) per element of the live rows, over the int32 rate."""
    nbytes = (4 * n_active * n + 4 * b * m + 4 * b * n + b * n + b * m
              + 4 * b + 12 * b * m)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * n_active * n / INT32_OP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _propose_row(torch, ops, kargs, active, reps=20, **extra):
    """``slack_propose`` on one set of operands against its plain version:
    equality bit for bit (col and key), the kernel's time (cold, warm
    and under the profiler), the plain version's, and the bound."""
    from repro_torch.kernels.slack_propose import slack_propose_ref

    c, y_b, y_a, avail, salt = kargs
    b, m, n = c.shape
    col, key = ops.slack_propose_batched(*kargs, active_b=active)
    rcol, rkey = slack_propose_ref(*kargs, active)
    torch.cuda.synchronize()
    ok = bool(torch.equal(col, rcol) and torch.equal(key, rkey))
    adm = float(((y_b[:, :, None] + y_a[:, None, :] == c + 1)
                 & avail[:, None, :]).float().mean())

    def kernel():
        return ops.slack_propose_batched(*kargs, active_b=active)
    ms = cuda_ms(torch, kernel, reps=reps)
    warm_ms = cuda_ms(torch, kernel, reps=reps, cold=False)
    prof_ms = profiler_ms(torch, kernel, "slack_propose_kernel")
    plain_ms = cuda_ms(torch, lambda: slack_propose_ref(*kargs, active),
                       reps=3, warmup=1)
    n_active = int(active.sum())
    bound_ms, bound_by = propose_bound(b, m, n, n_active)
    row = {"name": "slack_propose", "shape": [b, m, n], **extra,
           "active_rows": n_active, "admissible_frac": adm, "ok": ok,
           "max_abs_err": float((col - rcol).abs().max()), "ms": ms,
           "warm_ms": warm_ms, "profiler_ms": prof_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "proposing_rows": int((col >= 0).sum())}
    log(f"[2] {json.dumps(row)}")
    return row


def _propose_arrays(rng, b, m, n, active_frac):
    """Random ``slack_propose`` operands as numpy arrays ``(c, y_b, y_a,
    avail, salt, active)``: duals drawn so y_b + y_a - 1 lies in [0, 32)
    and c in [0, 32), so about 1/32 of the (available) edges are
    admissible; each row active with probability ``active_frac``."""
    c = rng.integers(0, 32, (b, m, n), dtype=np.int32)
    y_b = rng.integers(1, 17, (b, m), dtype=np.int32)
    y_a = rng.integers(0, 16, (b, n), dtype=np.int32)
    avail = rng.uniform(size=(b, n)) < 0.9
    active = rng.uniform(size=(b, m)) < active_frac
    salt = rng.integers(0, 2**31 - 1, b, dtype=np.int32)
    return c, y_b, y_a, avail, salt, active


def _propose_operands(torch, rng, dev, b, m, n, active_frac):
    """``_propose_arrays`` on ``dev``: ``(kargs, active)``."""
    *kargs, active = (torch.as_tensor(a, device=dev) for a in
                      _propose_arrays(rng, b, m, n, active_frac))
    return tuple(kargs), active


def _cost_arrays(rng, b, m, n, d):
    return (rng.uniform(size=(b, m, d)).astype(np.float32),
            rng.uniform(size=(b, n, d)).astype(np.float32))


def skip_kernel_draws(rng):
    """Advance ``rng`` past what ``phase_kernels`` draws from it, without
    running a kernel."""
    for b, m, n in SIZES["slack_propose"]:
        _propose_arrays(rng, b, m, n, 0.95)
    for _, b, m, n, d in SIZES["cost_matrix"]:
        _cost_arrays(rng, b, m, n, d)


def phase_kernels(torch, ops, rng, dev, rows, kernel_rows) -> bool:
    ok_all = True
    # slack_propose with 95 % of the rows active
    for b, m, n in SIZES["slack_propose"]:
        kargs, active = _propose_operands(torch, rng, dev, b, m, n, 0.95)
        row = _propose_row(torch, ops, kargs, active, round="dense")
        rows.append(row)
        ok_all &= row["ok"]
        kernel_rows.setdefault("slack_propose", row)
        del kargs, active
        torch.cuda.empty_cache()
    # then cost_matrix, from the same generator
    ok_cost = phase_cost_rows(torch, ops, rng, dev, rows, kernel_rows)
    return ok_all and ok_cost


def cost_bound(metric: str, b: int, m: int, n: int, d: int):
    """``(bound_ms, bound_by)`` of one ``cost_matrix`` launch: bytes, x and
    y read once and the (B, m, n) output written once, over the HBM rate;
    operations, the B m n d terms. A sqeuclidean or euclidean term is one
    FFMA, 2 flops at the fp32 rate. An l1 term |x - y| is two FP32
    instructions (FADD, then FADD with |.|) and no multiply, so it is
    counted as 2 instructions at the instruction rate, half the flop rate
    (which counts an FFMA as 2)."""
    nbytes = 4 * b * (m * d + n * d + m * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if metric == "l1":
        t_ops = 2 * b * m * n * d / (FP32_FLOP_PER_S / 2)
    else:
        t_ops = 2 * b * m * n * d / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_cost_rows(torch, ops, rng, dev, rows, kernel_rows) -> bool:
    """``cost_matrix`` at every metric on the 2-D shapes and l1 on 784-d
    images, against the plain version within ``tolerance(metric, d)``;
    each row carries ``out_sha256``, the digest of the kernel's output, so
    two versions' rows show whether their costs are bit-equal."""
    from repro_torch.kernels.cost_matrix import cost_matrix_ref, tolerance

    ok_all = True
    for metric, b, m, n, d in SIZES["cost_matrix"]:
        x, y = (torch.as_tensor(a, device=dev)
                for a in _cost_arrays(rng, b, m, n, d))
        out = ops.cost_matrix_batched(x, y, metric)
        ref = cost_matrix_ref(x, y, metric)
        torch.cuda.synchronize()
        rtol, atol = tolerance(metric, d)
        err = (out - ref).abs()
        ok = bool((err <= atol + rtol * ref.abs()).all())
        digest = out_sha256(out)
        ms = cuda_ms(torch, lambda: ops.cost_matrix_batched(x, y, metric),
                     reps=20)
        prof_ms = profiler_ms(torch, lambda: ops.cost_matrix_batched(
            x, y, metric), "cost_")
        plain_ms = cuda_ms(torch, lambda: cost_matrix_ref(x, y, metric),
                           reps=3, warmup=1)
        p = {"euclidean": 2.0, "l1": 1.0}.get(metric)
        library_ms = None if p is None else cuda_ms(
            torch, lambda: torch.cdist(x, y, p=p), reps=5, warmup=1)
        bound_ms, bound_by = cost_bound(metric, b, m, n, d)
        row = {"name": "cost_matrix", "metric": metric,
               "shape": [b, m, n, d], "ok": ok, "rtol": rtol, "atol": atol,
               "max_abs_err": float(err.max()), "out_sha256": digest,
               "ms": ms, "profiler_ms": prof_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms}
        log(f"[2] {json.dumps(row)}")
        rows.append(row)
        ok_all &= ok
        if metric == "euclidean" and b == 1:
            kernel_rows["cost_matrix"] = row
        del x, y, out, ref, err
        torch.cuda.empty_cache()
    return ok_all


def _points(rng, n):
    return rng.uniform(size=(n, 2)).astype(np.float32)


def _assignment_certificates(sol, n, guaranteed):
    """Gap, bound, dual feasibility and permutation of one Fig. 1 solve;
    see ``phase_assignment``."""
    gap, bound = sol.additive_gap(), sol.additive_gap_bound()
    limit = bound if guaranteed else 2 * bound
    res = {"cost": sol.cost, "phases": sol.phases, "rounds": sol.rounds,
           "additive_gap": gap, "additive_gap_bound": bound,
           "gap_limit": limit, "dual_feasible": sol.dual_feasible(),
           "perfect_matching": bool(np.array_equal(np.sort(sol.matching()),
                                                   np.arange(n))),
           "dispatches": sol.stats.dispatches}
    ok = bool(gap <= limit and res["dual_feasible"]
              and res["perfect_matching"] and np.isfinite(sol.cost))
    return ok, res


def phase_assignment(torch, rng, dev, record, ctx) -> bool:
    """The default policy, then ``guaranteed=True`` on the same costs.

    Certificates: with the default policy the run's eps bounds the gap by
    2 eps m max(c) (matched edges are tight in units of eps, so rounding
    adds < 1 unit per edge, and the <= eps m rows left free are completed
    at cost <= max(c) each, while the duals of free rows are >= 0); only
    ``guaranteed=True`` (eps/3 inside) brings it under eps m max(c), the
    ``additive_gap_bound``. The costs and each solve's integer state are
    kept in ``ctx`` for the fused route (phase 6)."""
    from repro_torch.core.api import ASSIGNMENT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix

    n, eps = SIZES["assignment"]
    c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                          device=dev)
    ctx["assignment_c"] = c
    ctx["assignment"] = []
    ok = True
    for guaranteed in (False, True):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        # the pre-batched form: a ragged list would pad n = 10 000 to the
        # ceil-pow2 bucket 16 384
        sol = solve(ASSIGNMENT, {"c": c[None]}, eps,
                    DispatchPolicy(guaranteed=guaranteed),
                    want=("cost", "duals", "matching", "state"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        cert_ok, cert = _assignment_certificates(sol, n, guaranteed)
        res = {"n": n, "eps": eps, "guaranteed": guaranteed, **cert,
               "wall_s": wall}
        log(f"[3] assignment {json.dumps(res, default=float)}")
        record["phases"].setdefault("assignment", []).append(res)
        ctx["assignment"].append((guaranteed, sol.state(), wall))
        ok &= cert_ok
    return ok


def _ot_certificates(sol, n, nu):
    gap, bound = sol.additive_gap(), sol.additive_gap_bound()
    plan = sol.plan_sparse()
    rows = np.zeros(n)
    np.add.at(rows, plan.rows, plan.vals)
    res = {"cost": sol.cost, "phases": sol.phases, "rounds": sol.rounds,
           "additive_gap": gap, "additive_gap_bound": bound,
           "dual_feasible": sol.dual_feasible(), "plan_nnz": plan.nnz,
           "row_marginal_err": float(np.abs(rows - nu).max()),
           "dispatches": sol.stats.dispatches}
    ok = bool(gap <= bound and res["dual_feasible"] and np.isfinite(sol.cost)
              and res["row_marginal_err"] < 1e-5)
    return ok, res


def phase_ot(torch, rng, dev, record, ctx) -> bool:
    """The OT cells; inputs and integer states are kept in ``ctx`` for
    the fused route (phase 6)."""
    from repro_torch.core.api import OT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.exact import exact_ot_cost

    ok = True
    ctx["ot"] = []
    for n, eps, exact in SIZES["ot"]:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                              device=dev)
        nu = rng.dirichlet(np.ones(n)).astype(np.float32)
        mu = rng.dirichlet(np.ones(n)).astype(np.float32)
        policy = DispatchPolicy(guaranteed=exact)
        sol = solve(OT, [(c, nu, mu)], eps, policy,
                    want=("cost", "duals", "plan_sparse", "state"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        cert_ok, cert = _ot_certificates(sol, n, nu)
        res = {"n": n, "eps": eps, "guaranteed": exact, **cert,
               "wall_s": wall}
        ok &= cert_ok
        if exact:
            t1 = time.monotonic()
            opt = exact_ot_cost(c.cpu().numpy(), nu, mu)
            res.update(exact_cost=opt, exact_s=time.monotonic() - t1)
            # guaranteed: cost <= OPT + eps * mass * max(c)
            bound = cert["additive_gap_bound"]
            ok &= bool(opt - 1e-6 <= sol.cost <= opt + bound + 1e-6)
            ctx.setdefault("exact_ot", {})[n] = opt
        log(f"[4] ot {json.dumps(res, default=float)}")
        record["phases"].setdefault("ot", []).append(res)
        ctx["ot"].append(((n, eps, exact), (c, nu, mu), sol.state(), wall))
    return ok


def _state_diff(a, b):
    """Fields of two integer states (on any devices) that differ."""
    out = []
    for f in a._fields:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if x.shape != y.shape or not bool((x == y).all()):
            out.append(f)
    return out


def phase_card_vs_cpu(torch, rng, dev, record, ctx) -> bool:
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.exact import exact_assignment_cost

    ok = True
    sizes = SIZES["card_vs_cpu"]
    costs = [build_cost_matrix(_points(rng, n), _points(rng, n),
                               "euclidean", device=dev) for n in sizes]
    host = [c.cpu() for c in costs]   # the same float matrices on both
    policy = DispatchPolicy(mode="compact")
    for name, spec, eps, insts_dev, insts_cpu in [
        ("assignment", ASSIGNMENT, 0.05, costs, host),
        ("ot", OT, 0.1, None, None),
    ]:
        if name == "ot":
            masses = [(rng.dirichlet(np.ones(n)).astype(np.float32),
                       rng.dirichlet(np.ones(n)).astype(np.float32))
                      for n in sizes]
            insts_dev = [(c, nu, mu) for c, (nu, mu) in zip(costs, masses)]
            insts_cpu = [(c, nu, mu) for c, (nu, mu) in zip(host, masses)]
        want = ("cost", "state")
        t0 = time.monotonic()
        on_card = solve(spec, insts_dev, eps, policy, want=want,
                        device=dev)
        t1 = time.monotonic()
        on_cpu = solve(spec, insts_cpu, eps, policy, want=want,
                       device="cpu")
        t2 = time.monotonic()
        fields_ok = True
        for a, b in zip(on_card, on_cpu):
            for f in _state_diff(a.state(), b.state()):
                log(f"[5] {name} n={a.shape} field {f} differs")
                fields_ok = False
        ctx.setdefault("ragged", {})[name] = (spec, eps, insts_dev,
                                              [b.state() for b in on_cpu])
        res = {"problem": name, "eps": eps, "sizes": sizes,
               "state_equal": fields_ok, "card_s": t1 - t0,
               "cpu_s": t2 - t1,
               "phases": [s.phases for s in on_card]}
        log(f"[5] {json.dumps(res)}")
        record["phases"].setdefault("card_vs_cpu", []).append(res)
        ok &= fields_ok

    n, eps = SIZES["assignment_exact"]
    c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                          device=dev)
    sol = solve(ASSIGNMENT, [c], eps, DispatchPolicy(guaranteed=True),
                want=("cost", "duals"), device=dev)[0]
    opt = exact_assignment_cost(c.cpu().numpy())
    res = {"n": n, "eps": eps, "guaranteed": True, "cost": sol.cost,
           "exact_cost": opt, "additive_gap_bound": sol.additive_gap_bound()}
    log(f"[5] exact {json.dumps(res, default=float)}")
    record["phases"]["assignment_exact"] = res
    # guaranteed: cost <= OPT + eps * m * max(c)
    ok &= bool(opt - 1e-3 <= sol.cost <= opt + sol.additive_gap_bound())
    return ok


def _count_scanned(ops, run):
    """Run ``run()`` with ``slack_propose`` counting what its active rows
    read; returns (elements read, distinct (lane, row) pairs read, run's
    result)."""
    seen, rows = [0], [None]
    orig = ops.slack_propose_batched

    def counting(c_int, *a, active_b=None):
        seen[0] += int(active_b.sum()) * int(c_int.shape[2])
        rows[0] = active_b if rows[0] is None else rows[0] | active_b
        return orig(c_int, *a, active_b=active_b)

    ops.slack_propose_batched = counting
    try:
        out = run()
    finally:
        ops.slack_propose_batched = orig
    return seen[0], 0 if rows[0] is None else int(rows[0].sum()), out


def _fused_row(torch, ops, name, shape, kernel, plain, stepped, state0,
               c_int, k, kernel_name, plain_reps=3):
    """One fused kernel against its plain version and the stepped core on
    the same state and k: equality, times and the bound. The work depends
    on the data, so the bound counts what this chunk needs, as the stepped
    run's ``slack_propose`` calls show it (they are the only reads of
    c_int): each row of c_int that a propose step reads, read once; the
    state read and written once; and 3 int32 operations (add, compare,
    select) per element the propose steps read."""
    got = kernel()
    ref = plain()
    scanned, rows_read, step = _count_scanned(ops, stepped)
    torch.cuda.synchronize()
    diff_plain = _state_diff(got, ref)
    diff_stepped = _state_diff(got, step)
    ok = not diff_plain and not diff_stepped
    err = max(int((getattr(got, f).cpu().long()
                   - getattr(ref, f).cpu().long()).abs().max())
              for f in got._fields)
    ms = cuda_ms(torch, kernel, reps=10)
    prof_ms = profiler_ms(torch, kernel, kernel_name)
    plain_ms = cuda_ms(torch, plain, reps=plain_reps, warmup=1)
    stepped_ms = cuda_ms(torch, stepped, reps=3, warmup=1)
    rounds = (got.rounds - state0.rounds).tolist()
    state_bytes = sum(t.numel() * 4 for t in state0)
    nbytes = rows_read * c_int.shape[2] * 4 + 2 * state_bytes
    nops = 3 * scanned
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / INT32_OP_PER_S
    row = {"name": name, "shape": list(shape), "k": k, "ok": ok,
           "differs_from_plain": diff_plain,
           "differs_from_stepped": diff_stepped, "max_abs_err": float(err),
           "ms": ms, "profiler_ms": prof_ms, "plain_ms": plain_ms,
           "stepped_ms": stepped_ms,
           "library_ms": None, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_bytes": nbytes, "bound_ops": nops, "rows_read": rows_read,
           "phases": (got.phases - state0.phases).tolist(),
           "rounds": rounds, "ms_per_round": ms / max(max(rounds), 1)}
    row["bound_share"] = row["bound_ms"] / ms
    return row


def fused_assignment_chunk(torch, rng, dev):
    """Phase 2's ``fused_assignment_phases`` chunk: B lanes of Fig. 1-like
    costs (n uniform points each side, euclidean) a few stepped phases in
    (``SIZES["fused_assignment"]``). Returns ``(c_int, state, threshold,
    phase_cap, m_valid)``; ``tools/fused_chunk_split.py`` times the same
    chunk."""
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.pushrelabel import (
        _max_phases, assignment_prologue, init_assignment_state,
        run_assignment_phases)

    b, n, eps, warm = SIZES["fused_assignment"]
    i32 = torch.int32
    c = torch.stack([build_cost_matrix(
        _points(rng, n), _points(rng, n), "euclidean", device=dev)
        for _ in range(b)])
    _, c_int, _, _, _ = assignment_prologue(
        c, torch.full((b,), eps, dtype=torch.float32, device=dev))
    thr = torch.full((b,), int(eps * n), dtype=i32, device=dev)
    cap = torch.full((b,), _max_phases(eps, n), dtype=i32, device=dev)
    mv = torch.full((b,), n, dtype=i32, device=dev)
    s0 = run_assignment_phases(c_int, init_assignment_state(b, n, n, dev),
                               thr, cap, warm)
    return c_int, s0, thr, cap, mv


def fused_assignment_full_chunk(torch, ops, rng, dev):
    """The same chunk at the Fig. 1 size: B = 1 on the costs of phase 3
    (``rng`` is the generator phase 3 draws its points from, see
    ``fig1_generator``), from phase ``SIZES["fused_assignment_full"][2]``
    of the default policy's solve, where few rows are still free; the
    state is reached by k = 8 fused chunks, as ``solve(..., fused=True)``
    would reach it."""
    start = SIZES["fused_assignment_full"][2]
    c_int, thr, cap, mv, states = fig1_walk(torch, ops, rng, dev)
    for s0 in states:
        if int(s0.phases[0]) >= start:
            break
    return c_int, s0, thr, cap, mv


def fig1_walk(torch, ops, rng, dev, k=None):
    """Phase 3's Fig. 1 costs in units of eps, B = 1 (``rng`` is the
    generator phase 3 draws its points from, see ``fig1_generator``), and
    the states the fused route passes at its chunk boundaries (every
    ``k`` phases, by default ``SIZES["fused_k"]``) from the initial state,
    as an iterator that ends when the solve does. Returns ``(c_int,
    threshold, phase_cap, m_valid, states)``."""
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.pushrelabel import (
        _max_phases, assignment_prologue, init_assignment_state)

    n, eps, _ = SIZES["fused_assignment_full"]
    i32 = torch.int32
    c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                          device=dev)[None]
    _, c_int, _, _, _ = assignment_prologue(
        c, torch.full((1,), eps, dtype=torch.float32, device=dev))
    del c
    thr = torch.full((1,), int(eps * n), dtype=i32, device=dev)
    cap = torch.full((1,), _max_phases(eps, n), dtype=i32, device=dev)
    mv = torch.full((1,), n, dtype=i32, device=dev)

    def states():
        s = init_assignment_state(1, n, n, dev)
        while True:
            yield s
            nxt = ops.fused_run_assignment_phases(
                c_int, s, thr, cap, k or SIZES["fused_k"], m_valid=mv)
            if int(nxt.phases[0]) == int(s.phases[0]):
                return
            s = nxt
    return c_int, thr, cap, mv, states()


def phase_propose_rounds(torch, ops, fig1_rng, rng, dev, rows) -> bool:
    """``slack_propose`` on the rounds the stepped route runs.

    Late and mid: round 0 of a phase of phase 3's Fig. 1 solve (B = 1,
    10 000^2; ``fig1_rng`` draws its points), with the operands that
    ``greedy_maximal_matching`` hands the kernel in a phase's first
    round: the free rows active, every column available, salt = phases *
    7919. Late is the state at phase ``SIZES["fused_assignment_full"][2]``
    (280: 169 free rows), mid the first phase with at most
    ``SIZES["propose_rounds"]["mid_free"]`` free rows (the walk goes one
    phase at a time: 803 rows are left at phase 8). Batch: B lanes of
    random operands (``_propose_operands``, from ``rng``) with a few
    percent of the rows active."""
    late = SIZES["fused_assignment_full"][2]
    cfg = SIZES["propose_rounds"]
    c_int, _, _, _, states = fig1_walk(torch, ops, fig1_rng, dev, k=1)
    picked = {}
    for s in states:
        if "mid" not in picked and int((s.match_ba < 0).sum()) <= \
                cfg["mid_free"]:
            picked["mid"] = s
        if int(s.phases[0]) >= late:
            break
    picked["late"] = s              # or the last state, if the solve ended
    picked.setdefault("mid", s)
    ok = True
    n = c_int.shape[2]
    for label in ("late", "mid"):
        s = picked[label]
        kargs = (c_int, s.y_b, s.y_a,
                 torch.ones((1, n), dtype=torch.bool, device=dev),
                 (s.phases * 7919).to(torch.int32))
        row = _propose_row(torch, ops, kargs, s.match_ba < 0, round=label,
                           phase=int(s.phases[0]))
        rows.append(row)
        ok &= row["ok"]
    del c_int, picked, states, kargs
    torch.cuda.empty_cache()

    b, m, n, frac = cfg["batch"]
    kargs, active = _propose_operands(torch, rng, dev, b, m, n, frac)
    row = _propose_row(torch, ops, kargs, active, round="batch")
    rows.append(row)
    return ok and row["ok"]


def fig1_generator(seed):
    """The generator in the state phase 3 draws its Fig. 1 points from:
    ``main``'s after phase 2's kernel checks (``skip_kernel_draws``)."""
    rng = np.random.default_rng(seed)
    skip_kernel_draws(rng)
    return rng


def phase_fused_kernels(torch, ops, rng, dev, rows, kernel_rows,
                        fig1_rng, seed) -> bool:
    """Each fused kernel for one k = 8 chunk from a state a few stepped
    phases in: Fig. 1-like point clouds (B lanes of n uniform points,
    euclidean), and Dirichlet masses for OT. Then both kernels at full
    width: the assignment kernel late in phase 3's solve
    (``fused_assignment_full_chunk``; ``fig1_rng`` draws phase 3's
    points), the OT kernel on the OT cell's whole solve
    (``fused_ot_full_chunk``). ``ms_per_round`` divides the chunk's time
    by its largest lane's rounds."""
    from repro_torch.core.pushrelabel import run_assignment_phases
    from repro_torch.kernels.fused_phase import fused_assignment_phases_ref

    k = SIZES["fused_k"]

    c_int, s0, thr, cap, mv = fused_assignment_chunk(torch, rng, dev)
    row_a = _fused_row(
        torch, ops, "fused_assignment_phases", tuple(c_int.shape),
        lambda: ops.fused_run_assignment_phases(c_int, s0, thr, cap, k,
                                                m_valid=mv),
        lambda: type(s0)(*fused_assignment_phases_ref(
            c_int, *s0, thr, cap, mv, k=k)),
        lambda: run_assignment_phases(c_int, s0, thr, cap, k, m_valid=mv),
        s0, c_int, k, "fused_assignment_kernel")
    del c_int, s0

    c_int, s0, thr, cap, mr = fused_ot_chunk(torch, rng, dev)
    row_o = _ot_row(torch, ops, c_int, s0, thr, cap, mr, k)
    del c_int, s0
    torch.cuda.empty_cache()

    # full width; the plain version takes ~0.4 s there, so it is timed once
    c_int, s0, thr, cap, mv = fused_assignment_full_chunk(torch, ops,
                                                          fig1_rng, dev)
    row_f = _fused_row(
        torch, ops, "fused_assignment_phases", tuple(c_int.shape),
        lambda: ops.fused_run_assignment_phases(c_int, s0, thr, cap, k,
                                                m_valid=mv),
        lambda: type(s0)(*fused_assignment_phases_ref(
            c_int, *s0, thr, cap, mv, k=k)),
        lambda: run_assignment_phases(c_int, s0, thr, cap, k, m_valid=mv),
        s0, c_int, k, "fused_assignment_kernel", plain_reps=1)
    row_f.update(start_phase=int(s0.phases[0]),
                 free_rows_before=int((s0.match_ba < 0).sum()))
    del c_int, s0
    torch.cuda.empty_cache()

    # the whole OT cell's solve in one chunk; the plain version is slow at
    # 4096^2, so it is timed once
    c_int, s0, thr, cap, mr = fused_ot_full_chunk(torch, seed, dev)
    row_of = _ot_row(torch, ops, c_int, s0, thr, cap, mr, k, plain_reps=1)
    del c_int, s0
    torch.cuda.empty_cache()
    done = (row_a, row_o, row_f, row_of)
    for row in done:
        log(f"[2] {json.dumps(row)}")
        rows.append(row)
        # the kernels line keeps the B = 16 and B = 8 rows, as in earlier
        # runs
        kernel_rows.setdefault(row["name"], row)
    return all(row["ok"] for row in done)


def _ot_row(torch, ops, c_int, s0, thr, cap, mr, k, plain_reps=3):
    """``_fused_row`` of ``fused_ot_phases`` on one chunk."""
    from repro_torch.core.transport import run_ot_phases
    from repro_torch.kernels.fused_phase import fused_ot_phases_ref

    return _fused_row(
        torch, ops, "fused_ot_phases", tuple(c_int.shape),
        lambda: ops.fused_run_ot_phases(c_int, s0, thr, cap, k, mr),
        lambda: type(s0)(*fused_ot_phases_ref(
            c_int, *s0, thr, cap, k=k, max_rounds=mr)),
        lambda: run_ot_phases(c_int, s0, thr, cap, k, mr),
        s0, c_int, k, "fused_ot_kernel", plain_reps=plain_reps)


def _ot_lanes(torch, rng, dev, b, n, eps):
    """B lanes of the OT cell's kind: n uniform points each side,
    euclidean, Dirichlet(1) masses, theta = 4n/eps. Returns ``(c_int,
    initial state, threshold, phase_cap, max_rounds)``."""
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.transport import (
        init_ot_state, ot_phase_cap, ot_prologue, ot_termination_threshold)

    i32 = torch.int32
    c = torch.stack([build_cost_matrix(
        _points(rng, n), _points(rng, n), "euclidean", device=dev)
        for _ in range(b)])
    nu = rng.dirichlet(np.ones(n), b).astype(np.float32)
    mu = rng.dirichlet(np.ones(n), b).astype(np.float32)
    theta = np.float32(4.0 * n / eps)
    theta_t = torch.full((b,), float(theta), dtype=torch.float32, device=dev)
    eps_t = torch.full((b,), eps, dtype=torch.float32, device=dev)
    c_int, s_int, d_int, _ = ot_prologue(
        c, torch.as_tensor(nu, device=dev), torch.as_tensor(mu, device=dev),
        theta_t, eps_t)
    thr = torch.as_tensor(
        [ot_termination_threshold(x, theta, eps) for x in nu], dtype=i32,
        device=dev)
    cap = torch.full((b,), ot_phase_cap(eps), dtype=i32, device=dev)
    return c_int, init_ot_state(s_int, d_int), thr, cap, 2 * n + 2


def fused_ot_chunk(torch, rng, dev):
    """Phase 2's ``fused_ot_phases`` chunk: B lanes of the OT cell's kind
    a few stepped phases in (``SIZES["fused_ot"]``). Returns ``(c_int,
    state, threshold, phase_cap, max_rounds)``;
    ``tools/fused_chunk_split.py`` times the same chunk."""
    from repro_torch.core.transport import run_ot_phases

    b, n, eps, warm = SIZES["fused_ot"]
    c_int, s0, thr, cap, mr = _ot_lanes(torch, rng, dev, b, n, eps)
    s0 = run_ot_phases(c_int, s0, thr, cap, warm, mr)
    return c_int, s0, thr, cap, mr


def fused_ot_full_chunk(torch, seed, dev):
    """The same chunk at the OT cell's size (``SIZES["fused_ot_full"]``:
    B = 1, n = 4096, eps = 0.05) from the initial state: one k = 8 chunk
    is the whole solve. The inputs are phase 4's distribution drawn from
    their own generator, ``default_rng([seed, 4])``."""
    n, eps = SIZES["fused_ot_full"]
    return _ot_lanes(torch, np.random.default_rng([seed, 4]), dev, 1, n,
                     eps)


def phase_fused(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The fused route on the inputs of phases 3-5: the same integer
    state and certificates, one fused launch per chunk dispatch, no
    ``slack_propose`` launch and no round flag read."""
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve

    ok = True

    def counted(route, fn):
        ops.reset_launches()
        rdev.reset_sync_counts()
        res = fn()
        launches[route] = dict(ops.launches)
        syncs = dict(rdev.sync_counts)
        log(f"[6] {route}: launches {launches[route]}, syncs {syncs}")
        return res, syncs

    def route_ok(route, kernel, dispatches, syncs):
        got = launches[route]
        good = (got[kernel] == dispatches and got["slack_propose"] == 0
                and syncs["round"] == 0 and dispatches > 0)
        if not good:
            log(f"[6] {route}: {kernel} launched {got[kernel]} times for "
                f"{dispatches} chunk dispatches, slack_propose "
                f"{got['slack_propose']}, round reads {syncs['round']}")
        return good

    # the Fig. 1 assignment, the costs of phase 3
    n, eps = SIZES["assignment"]
    c = ctx["assignment_c"]

    def assignment():
        out = []
        for guaranteed, state, stepped_wall in ctx["assignment"]:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            sol = solve(ASSIGNMENT, {"c": c[None]}, eps,
                        DispatchPolicy(guaranteed=guaranteed, fused=True),
                        want=("cost", "duals", "matching", "state"),
                        device=dev)[0]
            sol.cost
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            cert_ok, cert = _assignment_certificates(sol, n, guaranteed)
            diff = _state_diff(sol.state(), state)
            res = {"n": n, "eps": eps, "guaranteed": guaranteed, **cert,
                   "wall_s": wall, "stepped_wall_s": stepped_wall,
                   "state_differs": diff}
            log(f"[6] fused assignment {json.dumps(res, default=float)}")
            record["phases"].setdefault("fused_assignment", []).append(res)
            out.append((cert_ok and not diff, cert["dispatches"]))
        return out

    out, syncs = counted("fused_assignment", assignment)
    ok &= all(o for o, _ in out)
    ok &= route_ok("fused_assignment", "fused_assignment_phases",
                   sum(d for _, d in out), syncs)

    def transport():
        out = []
        for (n, eps, exact), (c, nu, mu), state, stepped_wall in ctx["ot"]:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            sol = solve(OT, [(c, nu, mu)], eps,
                        DispatchPolicy(guaranteed=exact, fused=True),
                        want=("cost", "duals", "plan_sparse", "state"),
                        device=dev)[0]
            sol.cost
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            cert_ok, cert = _ot_certificates(sol, n, nu)
            diff = _state_diff(sol.state(), state)
            res = {"n": n, "eps": eps, "guaranteed": exact, **cert,
                   "wall_s": wall, "stepped_wall_s": stepped_wall,
                   "state_differs": diff}
            log(f"[6] fused ot {json.dumps(res, default=float)}")
            record["phases"].setdefault("fused_ot", []).append(res)
            out.append((cert_ok and not diff, cert["dispatches"]))
        return out

    out, syncs = counted("fused_ot", transport)
    ok &= all(o for o, _ in out)
    ok &= route_ok("fused_ot", "fused_ot_phases", sum(d for _, d in out),
                   syncs)

    # the ragged batch of phase 5 against the CPU's stepped state
    def ragged():
        good = True
        for name, (spec, eps, insts, cpu_states) in ctx["ragged"].items():
            for mode in ("lockstep", "compact"):
                t0 = time.monotonic()
                sols = solve(spec, insts, eps,
                             DispatchPolicy(mode=mode, fused=True),
                             want=("cost", "state"), device=dev)
                wall = time.monotonic() - t0
                diffs = [_state_diff(s.state(), st)
                         for s, st in zip(sols, cpu_states)]
                res = {"problem": name, "mode": mode, "eps": eps,
                       "state_equal": not any(diffs), "card_s": wall}
                log(f"[6] fused ragged {json.dumps(res)}")
                record["phases"].setdefault("fused_ragged", []).append(res)
                good &= not any(diffs)
        return good

    good, syncs = counted("fused_ragged", ragged)
    got = launches["fused_ragged"]
    ok &= bool(good and got["fused_assignment_phases"] > 0
               and got["fused_ot_phases"] > 0 and got["slack_propose"] == 0
               and syncs["round"] == 0)
    return ok


def sinkhorn_row_arrays(rng, b, m, n):
    """The row kernel's operands ``(c, g, log_nu, reg)`` as numpy arrays,
    as ``phase_sinkhorn_kernel`` draws them (see there)."""
    c = rng.uniform(size=(b, m, n)).astype(np.float32)
    nu = rng.dirichlet(np.ones(m), b).astype(np.float32)
    g = rng.normal(0.0, 0.2, (b, n)).astype(np.float32)
    if b > 1:
        for i in range(b):
            mi, ni = m - 37 * i, n - 53 * i
            c[i, mi:], c[i, :, ni:], nu[i, mi:] = 0.0, 0.0, 0.0
        nu[-1] = 0.0
    nu_hat = nu / np.maximum(nu.sum(1, keepdims=True), 1e-30)
    log_nu = np.log(np.maximum(nu_hat, 1e-30)).astype(np.float32)
    eps = np.resize([0.05] if b == 1 else [0.3, 0.1, 0.05, 0.03], b)
    reg = (eps / (4 * np.log(max(m, n)))).astype(np.float32)
    return c, g, log_nu, reg


def phase_sinkhorn_kernel(torch, ops, rng, dev, rows, kernel_rows) -> bool:
    """``sinkhorn_row_update`` against its plain version at the shapes of
    the portfolio's solves: the OT cell of phase 4 (B = 1, 4096 x 4096)
    and a batch of 8 lanes of 1024 x 1000 with per-lane reg from eps in
    {0.3, 0.1, 0.05, 0.03}, ragged valid blocks (cost 0 and no mass
    outside, as the Sinkhorn spec's prepare leaves them) and a zero-mass
    lane; then the batch again with ``active_b`` marking off the odd
    lanes, which must get ``f`` back unchanged.

    Tolerance: rtol 1e-5, atol 1e-5 * max|f|. Both sum the same n terms
    exp(z - max) in another order (32 strided partial sums merged by a
    butterfly against 128-column tiles) and the card's expf is within 2
    ulp, so the log-sum differs by a few ulp of its value; f = reg *
    (log_nu - lse) can cancel, hence the absolute part scaled to max|f|.

    Bound: bytes, c read once (4 B m n) plus g, log_nu, reg and f (4 B (n
    + 2 m + 1)), over the HBM rate; operations, 4 fp32 operations per
    element (subtract, scale, exp, accumulate) over the fp32 rate. The
    library call is the stepped spec's row update, ``reg * (log_nu -
    torch.logsumexp((g - c) / reg))``."""
    from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref
    from repro_torch.portfolio.sinkhorn_spec import _row_update_torch

    ok_all = True
    for b, m, n in SIZES["sinkhorn_row"]:
        c, g, log_nu, reg = (torch.as_tensor(a, device=dev)
                             for a in sinkhorn_row_arrays(rng, b, m, n))
        kargs = (c, g, log_nu, reg)
        got = ops.sinkhorn_row_update(*kargs)
        ref = sinkhorn_row_ref(*kargs)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all() and (
            (got - ref).abs() <= 1e-5 * scale + 1e-5 * ref.abs()).all())
        masked_ok = None
        if b > 1:
            active = torch.arange(b, device=dev) % 2 == 0
            f_old = torch.full((b, m), 7.0, device=dev)
            masked = ops.sinkhorn_row_update(*kargs, active_b=active,
                                             f=f_old)
            torch.cuda.synchronize()
            masked_ok = bool(torch.equal(masked[~active], f_old[~active])
                             and torch.equal(masked[active], got[active]))
            ok &= masked_ok
        ms = cuda_ms(torch, lambda: ops.sinkhorn_row_update(*kargs), reps=20)
        prof_ms = profiler_ms(torch, lambda: ops.sinkhorn_row_update(*kargs),
                              "sinkhorn_row_kernel")
        plain_ms = cuda_ms(torch, lambda: sinkhorn_row_ref(*kargs), reps=3,
                           warmup=1)
        library_ms = cuda_ms(torch, lambda: _row_update_torch(*kargs),
                             reps=10)
        nbytes = 4 * b * m * n + 4 * b * (n + 2 * m + 1)
        nops = 4 * b * m * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S
        row = {"name": "sinkhorn_row_update", "shape": [b, m, n], "ok": ok,
               "rtol": 1e-5, "atol": 1e-5 * scale, "max_abs_err": err,
               "max_abs_f": scale, "active_b_ok": masked_ok,
               "out_sha256": out_sha256(got),
               "ms": ms, "profiler_ms": prof_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "reg * (log_nu - torch.logsumexp((g - c) / reg))",
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        row["bound_share"] = row["bound_ms"] / ms
        log(f"[2] {json.dumps(row)}")
        rows.append(row)
        ok_all &= ok
        kernel_rows.setdefault("sinkhorn_row_update", row)
        del c, g, got, ref
        torch.cuda.empty_cache()
    return ok_all


def _portfolio_certificates(sol, nu, mu, marginals: bool):
    """Gap, bound, dual feasibility and the plan's marginals (from the
    sparse plan, summed in float64 on the host)."""
    gap, bound = sol.additive_gap(), sol.additive_gap_bound()
    plan = sol.plan_sparse()
    rows = np.zeros(len(nu))
    cols = np.zeros(len(mu))
    np.add.at(rows, plan.rows, plan.vals)
    np.add.at(cols, plan.cols, plan.vals)
    res = {"cost": sol.cost, "phases": sol.phases,
           "additive_gap": gap, "additive_gap_bound": bound,
           "dual_feasible": sol.dual_feasible(), "plan_nnz": plan.nnz,
           "row_marginal_err": float(np.abs(rows - nu).max()),
           "col_marginal_err": float(np.abs(cols - mu).max()),
           "dispatches": sol.stats.dispatches, "solver": sol.stats.solver,
           "predicted_s": sol.stats.predicted_s}
    ok = bool(gap <= bound and res["dual_feasible"] and np.isfinite(sol.cost))
    if marginals:
        # AWR rounding puts the plan ON the transport polytope: exact up
        # to f32 sums (2e-6, the reference's own tolerance)
        ok &= res["row_marginal_err"] <= 2e-6
        ok &= res["col_marginal_err"] <= 2e-6
    return ok, res


def phase_portfolio(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The solver portfolio on phase 4's inputs. At n = 4096 (eps = 0.05):
    Sinkhorn stepped and fused (the row kernel launched once per
    f-update, and only there), hybrid, and auto (the port's cost-model
    table when one is committed, else push-relabel), each with its
    certificates; Sinkhorn plans' marginals exact to f32. At n = 512
    (``guaranteed=True``): Sinkhorn and hybrid within their bound of
    scipy's LP optimum."""
    from repro_torch.core.api import OT, DispatchPolicy, solve
    from repro_torch.portfolio import get_model, sinkhorn_spec

    ok = True
    (n, eps, _), (c, nu, mu), _, pr_wall = ctx["ot"][0]
    runs = [("sinkhorn", "sinkhorn", False), ("sinkhorn_fused", "sinkhorn",
                                               True),
            ("hybrid", "hybrid", False), ("auto", "auto", False)]
    model = get_model()
    log(f"[7] cost model: "
        + ("none committed: auto falls back to push-relabel"
           if model is None else f"{model.mode} table, {model.backend}"))
    for route, solver, fused in runs:
        ops.reset_launches()
        rdev.reset_sync_counts()
        sinkhorn_spec.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sol = solve(OT, [(c, nu, mu)], eps,
                    DispatchPolicy(solver=solver, fused=fused),
                    want=("cost", "duals", "plan_sparse", "stats"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches[route] = dict(ops.launches)
        f_updates = sinkhorn_spec.counts["f_updates"]
        ran = sol.stats.solver
        cert_ok, cert = _portfolio_certificates(sol, nu, mu,
                                                ran == "sinkhorn")
        kernel = launches[route]["sinkhorn_row_update"]
        if fused:
            # one launch per f-update, at least one per iteration run
            route_ok = kernel == f_updates >= sol.phases > 0
        else:
            route_ok = kernel == 0
        if solver == "auto":
            route_ok &= ran == ("pushrelabel" if model is None else
                                model.choose(n, eps)[0])
        res = {"n": n, "eps": eps, "route": route, **cert, "wall_s": wall,
               "f_updates": f_updates, "syncs": dict(rdev.sync_counts),
               "launches": launches[route],
               "pushrelabel_stepped_wall_s": pr_wall, "route_ok": route_ok}
        log(f"[7] portfolio {json.dumps(res, default=float)}")
        record["phases"].setdefault("portfolio", []).append(res)
        ok &= cert_ok and route_ok

    (n, eps, exact), (c, nu, mu), _, pr_wall = ctx["ot"][1]
    opt = ctx["exact_ot"][n]
    for solver in ("sinkhorn", "hybrid"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sol = solve(OT, [(c, nu, mu)], eps,
                    DispatchPolicy(solver=solver, guaranteed=exact),
                    want=("cost", "duals", "plan_sparse", "stats"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        cert_ok, cert = _portfolio_certificates(sol, nu, mu,
                                                solver == "sinkhorn")
        bound = cert["additive_gap_bound"]
        exact_ok = bool(opt - 1e-6 <= sol.cost <= opt + bound + 1e-6)
        res = {"n": n, "eps": eps, "guaranteed": exact, **cert,
               "exact_cost": opt, "within_bound_of_exact": exact_ok,
               "wall_s": wall, "pushrelabel_stepped_wall_s": pr_wall}
        log(f"[7] portfolio exact {json.dumps(res, default=float)}")
        record["phases"].setdefault("portfolio_exact", []).append(res)
        ok &= cert_ok and exact_ok
    return ok


def phase_portfolio_card_vs_cpu(torch, dev, record, ctx) -> bool:
    """Phase 5's ragged OT batch on the card and on the CPU.

    Sinkhorn (compact and lockstep): the card's exp, logsumexp and sums
    run in another order than the CPU's over a few hundred iterations,
    which the contraction of the iteration keeps small. Held: iteration
    counts equal or one apart (a lane whose error crossed tol within f32
    noise), and where equal, costs within rtol 1e-4 and duals within rtol
    1e-4, atol 1e-5 * max|y| of the CPU's.

    Hybrid, per instance: the warm duals come from the float stage 1, so
    the two devices' differ where a potential sits on a rounding boundary.
    The finish is given the card's warm duals on both devices and its
    integer state must be equal; the card's hybrid solve must equal that
    finish. The default policy's gap is held to twice the bound, as in
    phase 3 (only ``guaranteed=True`` promises the bound itself)."""
    from repro_torch.core.api import OT, DispatchPolicy, solve
    from repro_torch.portfolio.hybrid import WARM_OT, warm_duals

    ok = True
    _, eps, insts_dev, _ = ctx["ragged"]["ot"]
    insts_cpu = [(c.cpu(), nu, mu) for c, nu, mu in insts_dev]
    for mode in ("compact", "lockstep"):
        policy = DispatchPolicy(mode=mode, solver="sinkhorn")
        want = ("cost", "duals")
        t0 = time.monotonic()
        on_card = solve(OT, insts_dev, eps, policy, want=want, device=dev)
        t1 = time.monotonic()
        on_cpu = solve(OT, insts_cpu, eps, policy, want=want, device="cpu")
        t2 = time.monotonic()
        good, worst = True, {"cost_rel": 0.0, "dual_abs": 0.0}
        phases = []
        for a, b in zip(on_card, on_cpu):
            phases.append((a.phases, b.phases))
            good &= abs(a.phases - b.phases) <= 1
            if a.phases != b.phases:
                continue
            rel = abs(a.cost - b.cost) / max(abs(b.cost), 1e-30)
            worst["cost_rel"] = max(worst["cost_rel"], rel)
            good &= rel <= 1e-4
            for x, y in zip(a.duals(), b.duals()):
                d = np.abs(x - y)
                worst["dual_abs"] = max(worst["dual_abs"], float(d.max()))
                good &= bool((d <= 1e-4 * np.abs(y) + 1e-5
                              * np.abs(y).max()).all())
        res = {"solver": "sinkhorn", "mode": mode, "eps": eps,
               "phases_card_cpu": phases, **worst, "ok": good,
               "card_s": t1 - t0, "cpu_s": t2 - t1}
        log(f"[7] card vs cpu {json.dumps(res, default=float)}")
        record["phases"].setdefault("portfolio_card_vs_cpu", []).append(res)
        ok &= good

    diffs, phases = [], []
    t0 = time.monotonic()
    for c, nu, mu in insts_dev:
        one = {"c": c[None], "nu": torch.as_tensor(nu, device=dev)[None],
               "mu": torch.as_tensor(mu, device=dev)[None]}
        sol = solve(OT, one, eps, DispatchPolicy(solver="hybrid"),
                    want=("cost", "duals", "state"), device=dev)[0]
        y_b0, _ = warm_duals(WARM_OT.canonicalize(one, dev), eps,
                             device=dev)
        card, cpu = (solve(WARM_OT, {k: v.to(where) for k, v in one.items()},
                           eps, DispatchPolicy(), want=("cost", "state"),
                           device=where, y_b0=y_b0.to(where))[0]
                     for where in (dev, torch.device("cpu")))
        diffs.append(_state_diff(card.state(), cpu.state())
                     + [f"hybrid:{f}" for f in _state_diff(sol.state(),
                                                           card.state())])
        phases.append(sol.phases)
        ok &= bool(sol.dual_feasible()
                   and sol.additive_gap() <= 2 * sol.additive_gap_bound())
    res = {"solver": "hybrid", "eps": eps, "state_differs": diffs,
           "phases": phases,
           "card_s": time.monotonic() - t0}
    log(f"[7] card vs cpu {json.dumps(res, default=float)}")
    record["phases"].setdefault("portfolio_card_vs_cpu", []).append(res)
    return ok and not any(diffs)


def _images(rng, n):
    """``n`` L1-normalized 784-pixel images (28 x 28, Fig. 2's shape):
    sparse non-negative intensities, most pixels dark."""
    x = rng.uniform(size=(n, 784)).astype(np.float32) ** 4
    x[rng.uniform(size=(n, 784)) < 0.8] = 0.0
    x[:, 0] += 1e-3                      # no all-dark image
    return x / x.sum(axis=1, keepdims=True)


def serving_requests(rng):
    """Phase 8 (a)'s requests: ``SIZES["serve"]["requests"]`` point
    clouds (d = 2, uniform in the unit square), m and n drawn from
    256-2048, every other one OT with Dirichlet(1) masses, eps from
    {0.05, 0.1}; request ``nan_at`` is a copy of the shapes of the one
    before it with a NaN point, so the two share a bucket."""
    cfg = SIZES["serve"]
    lo, hi = cfg["sizes"]
    out = []
    for i in range(cfg["requests"]):
        m, n = (int(v) for v in rng.integers(lo, hi + 1, size=2))
        if i == cfg["nan_at"]:
            m, n = out[-1][0].shape[0], out[-1][1].shape[0]
        x, y = _points(rng, m), _points(rng, n)
        nu = mu = None
        if i % 2:
            nu = rng.dirichlet(np.ones(m)).astype(np.float32)
            mu = rng.dirichlet(np.ones(n)).astype(np.float32)
        if i == cfg["nan_at"]:
            x[0, 0] = np.nan
        out.append((x, y, nu, mu, float(rng.choice(cfg["eps"]))))
    return out


class _RecordSolves:
    """Record every bucket ``core.api.solve`` call the services make
    (they import it at call time): ``(spec, inputs, eps, sizes, device,
    result)``, so each bucket can be solved again directly; and every
    ``ops.cost_matrix_batched`` launch of their collate: ``(x, y, metric,
    out)``, the padded points and the kernel's costs. Both hold their
    tensors on the card."""

    def __init__(self):
        self.calls, self.costs = [], []

    def __enter__(self):
        from repro_torch.core import api
        from repro_torch.kernels import ops

        self._api, self._solve = api, api.solve
        self._ops, self._cost = ops, ops.cost_matrix_batched

        def solve(spec, inputs, eps, policy=None, **kw):
            out = self._solve(spec, inputs, eps, policy, **kw)
            self.calls.append((spec, dict(inputs), eps, kw.get("sizes"),
                               kw.get("device"), out))
            return out

        def cost(x, y, metric="sqeuclidean"):
            out = self._cost(x, y, metric)
            self.costs.append((x, y, metric, out))
            return out

        api.solve, ops.cost_matrix_batched = solve, cost
        return self

    def __exit__(self, *exc):
        self._api.solve = self._solve
        self._ops.cost_matrix_batched = self._cost
        return False


def _bucket_costs_equal(torch, costs) -> tuple:
    """Each recorded collate launch of ``cost_matrix`` against the plain
    version on the same padded points, on the card, within
    ``tolerance(metric, d)`` (phase 2's); a NaN point must give NaN
    exactly where the plain version does. Returns (rows, all ok)."""
    from repro_torch.kernels.cost_matrix import cost_matrix_ref, tolerance

    rows, ok = [], True
    for x, y, metric, out in costs:
        ref = cost_matrix_ref(x, y, metric)
        rtol, atol = tolerance(metric, int(x.shape[-1]))
        nan_same = torch.equal(out.isnan(), ref.isnan())
        fin = ~ref.isnan()
        err = (out[fin] - ref[fin]).abs()
        good = bool(nan_same and (err <= atol + rtol * ref[fin].abs()).all())
        rows.append({"metric": metric, "shape": list(x.shape[:2])
                     + [int(y.shape[1]), int(x.shape[2])], "ok": good,
                     "max_abs_err": float(err.max()) if err.numel() else 0.0,
                     "rtol": rtol, "atol": atol})
        ok &= good
        del ref, err, fin
    return rows, ok


def _bucket_states_equal(torch, dev, calls) -> tuple:
    """Each recorded bucket's integer state against a direct ``solve()``
    of the same padded costs (the stepped compact policy): every lane on
    the card, and lane (k mod B) of bucket k on the CPU, so lanes past 0
    are covered too. Lanes never interact, so one lane alone at the
    bucket's padded shape is that lane of the bucket; the CPU's plain
    versions take seconds per lane at 2048^2, and all lanes of all
    buckets took over 800 s on the H100 machine's CPU. Returns
    (mismatches, seconds on the card, on the CPU)."""
    from repro_torch.core.api import DispatchPolicy, solve
    from repro_torch.core.problem import tree_map

    bad, secs = [], {"card": 0.0, "cpu": 0.0}
    for j, (spec, inputs, eps, sizes, _, batch) in enumerate(calls):
        b = int(inputs["c"].shape[0])
        eps = np.broadcast_to(np.asarray(eps, np.float64), (b,))
        for where, lanes in ((dev, slice(None)),
                             (torch.device("cpu"),
                              slice(j % b, j % b + 1))):
            t0 = time.monotonic()
            direct = solve(spec, {k: v[lanes].to(where)
                                  for k, v in inputs.items()},
                           eps[lanes], DispatchPolicy(mode="compact"),
                           sizes=None if sizes is None else sizes[lanes],
                           want=("state",), device=where)
            mine = tree_map(lambda a: a[lanes], batch.state())
            diff = _state_diff(mine, direct.state())
            secs["card" if where == dev else "cpu"] += (time.monotonic()
                                                        - t0)
            if diff:
                bad.append((spec.name, tuple(inputs["c"].shape),
                            str(where), lanes.start, diff))
    return bad, secs["card"], secs["cpu"]


def _latency_row(lat, wall, n_done):
    lat = np.sort(np.asarray(lat, np.float64))
    return {"p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)),
            "instances_per_s": n_done / wall, "wall_s": wall,
            "resolved": n_done}


def _run_scheduler(torch, dev, reqs, *, faults=None, sink=None,
                   deadline_req=None, record=True):
    """Submit ``reqs`` to one ``AsyncOTScheduler`` on ``dev`` and wait;
    then, alone in a second round, ``deadline_req`` with an expired
    budget. Returns (futures, latencies of the resolved ones, deadline
    future, wall seconds of the first round, stats, the
    ``_RecordSolves`` or None without ``record``)."""
    import contextlib

    from repro_torch.serve.scheduler import AsyncOTScheduler

    cfg = SIZES["serve"]
    done_t = {}
    rec = _RecordSolves() if record else contextlib.nullcontext()
    with rec, AsyncOTScheduler(
            eps=0.1, metric="euclidean", linger_ms=cfg["linger_ms"],
            validate=True, device=dev, faults=faults, join_timeout_s=30,
            sinks=() if sink is None else (sink,),
            retry_backoff_s=0.001) as sched:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        futs = []
        for i, (x, y, nu, mu, eps) in enumerate(reqs):
            f = sched.submit(x, y, nu, mu, eps=eps, want=cfg["want"])
            f.add_done_callback(
                lambda _f, i=i: done_t.__setitem__(i, time.monotonic()))
            futs.append((f, time.monotonic()))
        if not sched.flush(timeout=600):
            raise RuntimeError("the scheduler did not drain in 600 s")
        wall = time.monotonic() - t0
        lat = [done_t[i] - t for i, (f, t) in enumerate(futs)
               if f.exception(timeout=0) is None]
        dl = None
        if deadline_req is not None:
            x, y, nu, mu, eps = deadline_req
            dl = sched.submit(x, y, nu, mu, eps=eps,
                              want=("cost", "duals"), deadline=0.0)
            if not sched.flush(timeout=600):
                raise RuntimeError("the deadline request did not resolve")
        stats = sched.stats_dict()
        stats.pop("occupancy")          # long; dispatches says enough
    return ([f for f, _ in futs], lat, dl, wall, stats,
            rec if record else None)


def phase_serving(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The serving path on the card (see the module docstring, phase 8):
    (a) ``AsyncOTScheduler`` and (b) ``OTService.run_batch`` driven with
    the launch counts set to 0 just before and read just after; then (c)
    every bucket of both against the plain costs and a direct ``solve()``
    on the card and the CPU, and (d) (a)'s requests again, unrecorded,
    under a transient fault retried on the card."""
    from repro_torch.core.problem import tree_map
    from repro_torch.obs import InMemorySink
    from repro_torch.serve.engine import OTService
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    from repro_torch.serve.ft import RequestRejected

    cfg = SIZES["serve"]
    card = smi_line()           # beside every number of the phase
    rng = np.random.default_rng([ctx["seed"], 8])
    reqs = serving_requests(rng)
    m_dl, eps_dl = cfg["deadline"]
    deadline_req = (_points(rng, m_dl), _points(rng, m_dl), None, None,
                    eps_dl)
    n_lo, n_hi = cfg["images"]
    images = [(_images(rng, n), _images(rng, n))
              for n in rng.integers(n_lo, n_hi + 1, size=cfg["image_reqs"])]
    ok = True

    # -- (a) + (b), counted ---------------------------------------------
    sink = InMemorySink()
    ops.reset_launches()
    rdev.reset_sync_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    futs, lat, dl, wall, stats, rec = _run_scheduler(
        torch, dev, reqs, sink=sink, deadline_req=deadline_req)
    torch.cuda.synchronize()
    sched_launches = dict(ops.launches)
    svc = OTService(eps=cfg["image_eps"], metric="l1", device=dev,
                    want=("cost", "duals", "state"))
    for x, y in images:
        svc.submit(x, y)
    with _RecordSolves() as svc_rec:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sols_b = svc.run_batch()
        for s in sols_b:
            s.cost
        torch.cuda.synchronize()
        wall_b = time.monotonic() - t0
    launches["serve"] = dict(ops.launches)
    peak_recorded = torch.cuda.max_memory_allocated(dev)
    svc_launches = {k: launches["serve"][k] - sched_launches[k]
                    for k in sched_launches}
    syncs = dict(rdev.sync_counts)

    # (a)'s outcomes
    nan_at = cfg["nan_at"]
    sols, levels, degraded = {}, [], 0
    for i, f in enumerate(futs):
        exc = f.exception(timeout=0)
        if i == nan_at:
            ok &= isinstance(exc, RequestRejected) and exc.code == 1
            continue
        if exc is not None:
            log(f"[8] request {i} failed: {exc!r}")
            ok = False
            continue
        sols[i] = sol = f.result(timeout=0)
        levels.append(sol.stats.ladder_level)
        degraded += int(sol.degraded)
        ok &= bool(np.isfinite(sol.cost) and sol.dual_feasible())
    # the NaN request's bucket went on without it
    rej = sink.events("rejected")
    kept = [s.get("kept") for s in sink.spans("collate")
            if len(rej) == 1 and s["trace_id"] == rej[0]["trace_id"]]
    dl_sol = dl.result(timeout=0)
    res_a = {
        "card": card, "requests": len(reqs),
        **_latency_row(lat, wall, len(sols)),
        "buckets": len(rec.calls), "stats": stats,
        "ladder_levels": sorted(set(levels)), "degraded": degraded,
        "nan_request_rejected": isinstance(futs[nan_at].exception(0),
                                           RequestRejected),
        "nan_bucket_kept": kept,
        "deadline": {"degraded": dl_sol.degraded,
                     "dual_feasible": dl_sol.dual_feasible(),
                     "additive_gap": dl_sol.additive_gap(),
                     "dispatches": dl_sol.stats.dispatches},
        "launches": sched_launches}
    log(f"[8] (a) scheduler {json.dumps(res_a, default=float)}")
    ok &= (set(levels) == {0} and degraded == 0 and len(kept) == 1
           and kept[0] >= 1 and dl_sol.degraded
           and dl_sol.dual_feasible() and stats["rejected"] == 1
           and stats["degraded"] == 1 and stats["retries"] == 0)

    # (b)'s outcomes
    levels_b = {s.stats.ladder_level for s in sols_b}
    ok_b = (levels_b == {0} and not any(s.degraded for s in sols_b)
            and all(np.isfinite(s.cost) and s.dual_feasible()
                    for s in sols_b))
    res_b = {"card": card, "requests": len(images), "n": [int(x.shape[0])
                                           for x, _ in images],
             "wall_s": wall_b, "instances_per_s": len(sols_b) / wall_b,
             "buckets": len(svc_rec.calls), "ladder_levels":
             sorted(levels_b), "launches": svc_launches,
             "stats": svc.stats_dict()}
    log(f"[8] (b) service {json.dumps(res_b, default=float)}")
    ok &= ok_b
    for name in ("cost_matrix", "slack_propose"):
        ok &= sched_launches[name] > 0 and svc_launches[name] > 0
    # one cost launch per bucket (the deadline request's bucket too)
    ok &= sched_launches["cost_matrix"] == len(rec.costs) == len(rec.calls)
    ok &= svc_launches["cost_matrix"] == len(svc_rec.costs)

    # -- (c) every bucket: costs against the plain version, state against
    # direct solve on the card and the CPU -------------------------------
    t0 = time.monotonic()
    cost_rows, costs_ok = _bucket_costs_equal(torch,
                                              rec.costs + svc_rec.costs)
    torch.cuda.synchronize()
    cost_s = time.monotonic() - t0
    # the deadline request's bucket was cut: a direct solve runs on
    bad, card_s, cpu_s = _bucket_states_equal(
        torch, dev, rec.calls[:-1] + svc_rec.calls)
    res_c = {"card": card, "costs": cost_rows, "costs_ok": costs_ok,
             "cost_check_s": cost_s,
             "buckets": len(rec.calls) - 1 + len(svc_rec.calls),
             "mismatches": bad, "card_s": card_s, "cpu_lane_s": cpu_s,
             "wall_s": time.monotonic() - t0}
    log(f"[8] (c) buckets against plain costs and direct solve "
        f"{json.dumps(res_c)}")
    ok &= costs_ok and not bad

    # -- (d) (a) again with nothing recorded, a transient retried on the
    # card; its peak is the service's own --------------------------------
    states_a = {i: tree_map(lambda t: t.cpu(), sol.state())
                for i, sol in sols.items()}
    del futs, f, exc, sols, sol, dl, dl_sol, rec, svc_rec, sols_b, s, svc
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    inj = FaultInjector(FaultPlan(transient_dispatches=1))
    futs_d, lat_d, _, wall_d, stats_d, _ = _run_scheduler(
        torch, dev, reqs, faults=inj, record=False)
    torch.cuda.synchronize()
    peak_service = torch.cuda.max_memory_allocated(dev)
    same, levels_d, retried = True, set(), 0
    for i, f in enumerate(futs_d):
        exc = f.exception(timeout=0)
        if i == nan_at:
            same &= isinstance(exc, RequestRejected)
            continue
        if exc is not None:
            log(f"[8] (d) request {i} failed: {exc!r}")
            same = False
            continue
        sol = f.result(timeout=0)
        levels_d.add(sol.stats.ladder_level)
        retried += sol.stats.attempts == 2
        same &= not _state_diff(sol.state(), states_a[i])
    res_d = {"card": card, "log": inj.log, "ladder_levels":
             sorted(levels_d), "requests_retried_on_card": retried,
             "state_equal_to_a": bool(same), "stats": stats_d,
             **_latency_row(lat_d, wall_d, len(futs_d) - 1)}
    log(f"[8] (d) transient retried on the card "
        f"{json.dumps(res_d, default=float)}")
    ok &= bool(same and levels_d == {0} and retried > 0
               and stats_d["retries"] == 1
               and inj.log == [("transient", 0)])
    res_mem = {"card": card, "serve": launches["serve"], "syncs": syncs,
               "max_memory_allocated_recorded_a_b": peak_recorded,
               "max_memory_allocated_service_d": peak_service,
               "memory_allocated_before_d": held}
    log(f"[8] launches and memory {json.dumps(res_mem)}")
    record["phases"]["serving"] = {"a": res_a, "b": res_b, "c": res_c,
                                   "d": res_d, **res_mem}
    return ok

if __name__ == "__main__":
    sys.exit(main())
