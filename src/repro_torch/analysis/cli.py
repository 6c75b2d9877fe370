"""``python -m repro_torch.analysis``: run every audit pass over the port.

Port of ``repro.analysis.cli``. Passes, in order:

  1. the op-log rules (``rules.py``) over every registered entry point,
     recorded on the CPU;
  2. the hot-loop sync audit (``syncaudit.py``) over the chunk-loop
     drivers;
  3. the lock-discipline scan (``locks.py``) over the serving layer;
  4. the dynamic bucket-ladder audit: a mixed-eps compacting solve whose
     descent visits several buckets, one counted read per chunk, the
     same buckets again for the same and for other eps values, and, on
     a card, no kernel built or loaded anew after the first solve (the
     torch meaning of the reference's "one program per (shape, k, B)").
     It runs on the card; ``--device cpu`` asks for the CPU, and
     without a card and without it the audit raises.

Findings are filtered through the baseline suppressions
(``baseline.py``); ``--strict`` exits 1 on any unsuppressed finding or
stale baseline entry.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

from . import registry
from .baseline import DEFAULT_BASELINE, apply_baseline, load_baseline
from .rules import Finding, audit_entries


def audit_bucket_ladder(spec_name: str = "assignment", b: int = 16,
                        mn: int = 8, k: int = 3,
                        device=None) -> List[Finding]:
    """Dynamic audit over a real compaction descent.

    Solves a mixed-eps batch (half the lanes at eps 0.45, half at 0.02)
    with chunk size ``k`` on ``device`` (``core.device.resolve_device``:
    the card unless the CPU is asked for; it raises without a card), then
    checks:

      * the descent visits at least two buckets;
      * ``sync_counts["chunk"]`` grows by exactly ``stats.dispatches``
        (one counted read per chunk);
      * a second identical solve and a third with eps x 0.9 visit the
        same buckets (eps is an operand of the chunks, never a property
        of a bucket);
      * on a card, no kernel is built or loaded after the first solve.

    Debug checks are pinned OFF for the duration: under
    ``REPRO_DEBUG_CHECKS=1`` the driver dispatches the checked functions,
    whose extra reads are counted under "debug" and covered by
    tests/test_torch_checks.py.
    """
    from . import _DEBUG_CHECKS, set_debug_checks

    prior = _DEBUG_CHECKS
    set_debug_checks(False)
    try:
        return _audit_bucket_ladder_plain(spec_name, b, mn, k, device)
    finally:
        set_debug_checks(prior)


def _audit_bucket_ladder_plain(spec_name: str, b: int, mn: int,
                               k: int, device) -> List[Finding]:
    import numpy as np

    from ..core import compaction as C
    from ..core.device import resolve_device, sync_counts
    from ..core.problem import ASSIGNMENT, OT
    from ..kernels import ops

    spec = {"assignment": ASSIGNMENT, "ot": OT}[spec_name]
    entry = f"bucket-ladder[{spec_name}]"
    device = resolve_device(device).type
    findings: List[Finding] = []

    rng = np.random.default_rng(0)
    c = rng.random((b, mn, mn)).astype(np.float32)
    eps = np.where(np.arange(b) < b // 2, 0.45, 0.02)
    inputs = {"c": c}
    if spec_name == "ot":
        inputs["nu"] = np.full((b, mn), 1.0 / mn, np.float32)
        inputs["mu"] = np.full((b, mn), 1.0 / mn, np.float32)

    def run(e):
        before = sync_counts["chunk"]
        _, stats = C.solve_compacting(spec, inputs, e, k=k, device=device)
        return sorted({bb for bb, _ in stats.occupancy}), stats, \
            sync_counts["chunk"] - before

    buckets, stats, reads = run(eps)
    libs = dict(ops._libs)
    if len(buckets) < 2:
        findings.append(Finding(
            rule="recompile-hazard", entry=entry, detail="no-descent",
            message=(f"the audit batch never descended (buckets "
                     f"{buckets}): the mixed-eps workload no longer "
                     "exercises the pow2 ladder - retune the audit"),
        ))
    if reads != stats.dispatches:
        findings.append(Finding(
            rule="recompile-hazard", entry=entry, detail="reads-per-chunk",
            message=(f"{reads} counted chunk reads for {stats.dispatches} "
                     "chunk dispatches: the driver must read the device "
                     "exactly once per chunk"),
        ))
    for round_name, e in (("identical", eps), ("different-eps", eps * 0.9)):
        again, _, _ = run(e)
        if again != buckets:
            findings.append(Finding(
                rule="recompile-hazard", entry=entry,
                detail=f"retrace:{round_name}",
                message=(f"re-solving ({round_name}) visited buckets "
                         f"{again}, the first solve {buckets}: eps or "
                         "another operand leaked into the bucket shapes"),
            ))
        if device == "cuda" and (ops._libs.keys() != libs.keys() or any(
                ops._libs[name] is not lib for name, lib in libs.items())):
            findings.append(Finding(
                rule="recompile-hazard", entry=entry,
                detail=f"rebuild:{round_name}",
                message=(f"re-solving ({round_name}) built or loaded a "
                         "kernel again: every bucket must reuse the "
                         "kernels the first solve loaded"),
            ))
    return findings


def collect_findings(dynamic: bool = True, device=None
                     ) -> Tuple[List[Finding], List[str]]:
    """All findings plus human-readable coverage lines; the dynamic audit
    runs on ``device`` (the card by default)."""
    from . import locks, syncaudit

    report: List[str] = []
    findings: List[Finding] = []

    entries = registry.build_entries()
    fs, n = audit_entries(entries)
    findings += fs
    report.append(f"op-log rules: {n} entry points audited "
                  f"({sum(len(e.ops) for e in entries)} recorded ops)")

    sync_targets = syncaudit.default_targets()
    findings += syncaudit.audit_targets(sync_targets)
    report.append("hot-loop sync audit: "
                  + ", ".join(t.label for t in sync_targets))

    for t in locks.default_targets():
        fs = locks.scan_lock_discipline(t)
        findings += fs
        if t.lock_attr is None:
            report.append(f"lock scan: {t.class_name} exempt ({t.note})")
        else:
            report.append(f"lock scan: {t.class_name} "
                          f"({len(t.fields)} shared fields)")

    if dynamic:
        from ..core.device import resolve_device

        where = resolve_device(device).type
        findings += audit_bucket_ladder(device=where)
        report.append(f"bucket-ladder audit ({where}): a descent, one read "
                      "per chunk, the same buckets for any eps"
                      + (", no kernel rebuilt" if where == "cuda" else ""))
    return findings, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="op-log audit of the port's solver entry points")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any unsuppressed finding or stale "
                         "baseline entry")
    ap.add_argument("--no-dynamic", action="store_true",
                    help="skip the dynamic bucket-ladder audit")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline suppressions file")
    ap.add_argument("--list", action="store_true",
                    help="list registered entry points and exit")
    ap.add_argument("--device", default=None,
                    help="where the dynamic audit runs: the card by "
                         "default (an error without one), 'cpu' to ask "
                         "for the CPU")
    args = ap.parse_args(argv)

    if args.list:
        for spec in registry.entry_specs():
            print(spec.name)
        return 0

    findings, report = collect_findings(dynamic=not args.no_dynamic,
                                        device=args.device)
    baseline = load_baseline(args.baseline)
    active, suppressed, stale = apply_baseline(findings, baseline)

    for line in report:
        print(f"  {line}")
    if suppressed:
        print(f"{len(suppressed)} suppressed (baselined) finding(s):")
        for f, reason in suppressed:
            print(f"  {f.key}\n      accepted: {reason}")
    if stale:
        print(f"{len(stale)} STALE baseline entr(ies) matched nothing:")
        for key in stale:
            print(f"  {key}")
    if active:
        print(f"{len(active)} finding(s):")
        for f in active:
            print(f"  {f.key}\n      {f.message}")
    else:
        print("no unsuppressed findings")

    if args.strict and (active or stale):
        return 1
    return 0
