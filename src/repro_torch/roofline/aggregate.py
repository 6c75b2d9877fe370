"""Render the dry-run and roofline tables from the dry-run's records
(``results/dryrun_torch/*.json``, written by ``launch/dryrun.py``).

Port of ``repro.roofline.aggregate``. The records are plans (see
``launch/dryrun.py``): the terms are the plan's counts over the H100
SXM's data-sheet rates (``roofline.analysis``), not measurements.

    PYTHONPATH=src python -m repro_torch.roofline.aggregate [DIR]
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .analysis import CONSTANTS


def load(out_dir="results/dryrun_torch"):
    cells = {}
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        key = (r["arch"], r["shape"], "mp" if r.get("multi_pod") else "sp")
        extra = os.path.basename(p).replace(".json", "").split("__")[3:]
        if extra:
            key = key + tuple(extra)
        cells[key] = r
    return cells


def dryrun_table(cells) -> str:
    lines = [
        "| arch | shape | mesh | status | plan_s | GiB/dev | coll ops (AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in sorted(cells):
        if len(key) > 3:
            continue
        r = cells[key]
        arch, shape, mesh = key
        if r.get("skipped"):
            lines.append(
                f"| {arch} | {shape} | {mesh} | SKIP ({r['skipped'].split(':')[0]}) | - | - | - |")
            continue
        if not r.get("ok"):
            lines.append(
                f"| {arch} | {shape} | {mesh} | **FAIL** {r.get('error','')[:60]} | {r.get('compile_s')} | - | - |")
            continue
        c = r["roofline"]["collective"]["counts"]
        coll = (f"{c['all-reduce']}/{c['all-gather']}/{c['reduce-scatter']}"
                f"/{c['all-to-all']}/{c['collective-permute']}")
        lines.append(
            f"| {arch} | {shape} | {mesh} | ok | {r['compile_s']} | "
            f"{r['memory']['peak_per_device_gb']} | {coll} |")
    return "\n".join(lines)


def roofline_table(cells) -> str:
    lines = [
        "| arch | shape | t_comp (ms) | t_mem raw/adj (ms) | t_coll (ms) "
        "| dominant | roofline frac | MODEL/plan flops "
        "| what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(cells):
        if len(key) > 3 or key[2] != "sp":
            continue
        r = cells[key]
        arch, shape, _ = key
        if r.get("skipped") or not r.get("ok"):
            continue
        t = r["roofline"]
        note = _note(r)
        adj = t["t_memory_adjusted_s"]
        mark = " (scaled)" if r.get("periods_scaled") else ""
        shape = shape + mark
        lines.append(
            f"| {arch} | {shape} | {t['t_compute_s']*1e3:.1f} | "
            f"{t['t_memory_s']*1e3:.1f}/{adj*1e3:.1f} | "
            f"{t['t_collective_s']*1e3:.1f} | "
            f"{t['dominant']} | {t['roofline_fraction']:.3f} | "
            f"{r['hlo_flops_ratio']:.2f} | {note} |")
    return "\n".join(lines)


def _note(r) -> str:
    t = r["roofline"]
    by = r["roofline"]["collective"]["by_op"]
    if t["dominant"] == "memory":
        return ("shrink activation traffic: fuse elementwise chains and "
                "the blocked attention / bf16 intermediates / "
                "sequence-shard the residual stream")
    if t["dominant"] == "collective":
        top = max(by, key=by.get)
        return (f"dominant {top}: overlap with compute, reduce payload "
                f"dtype, or re-shard to cut the gather volume")
    return ("tensor-core-bound: raise per-card utilization (layout, "
            "fusion), or scale out")


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    cells = load(out_dir)
    n_ok = sum(1 for r in cells.values() if r.get("ok"))
    n_fail = sum(1 for r in cells.values() if not r.get("ok"))
    n_skip = sum(1 for r in cells.values() if r.get("skipped"))
    print(f"## Dry-run summary: {len(cells)} cells, {n_ok} ok "
          f"({n_skip} skipped-by-design), {n_fail} failed\n")
    print("### Dry-run table\n")
    print(dryrun_table(cells))
    print(f"\n### Roofline table (single-pod 16x16 mesh, 256 x "
          f"{CONSTANTS['card']}; plans, not measurements)\n")
    print(roofline_table(cells))


if __name__ == "__main__":
    main()
