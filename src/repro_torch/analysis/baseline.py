"""Baseline suppressions for known-accepted findings.

Port of ``repro.analysis.baseline``; the port keeps its own file of
accepted findings beside it.

Format of ``baseline_suppressions.txt`` (one entry per line):

    <finding-key> -- <justification>

where ``<finding-key>`` is ``rule:entry:detail`` as printed by the CLI.
A justification is MANDATORY: an accepted finding with no recorded
reason is indistinguishable from a rotted suppression. Unused baseline
entries are reported (and fail ``--strict``) so the file cannot
accumulate dead keys as the code evolves.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple

from .rules import Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline_suppressions.txt")
_SEP = " -- "


def load_baseline(path: str = DEFAULT_BASELINE) -> Dict[str, str]:
    """key -> justification; raises on entries missing a justification."""
    out: Dict[str, str] = {}
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if _SEP not in line:
                raise ValueError(
                    f"{path}:{lineno}: baseline entry has no "
                    f"justification (expected '<key>{_SEP}<reason>'): "
                    f"{line!r}")
            key, reason = line.split(_SEP, 1)
            key, reason = key.strip(), reason.strip()
            if not reason:
                raise ValueError(
                    f"{path}:{lineno}: empty justification for {key!r}")
            out[key] = reason
    return out


def apply_baseline(
    findings: Iterable[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[Tuple[Finding, str]], List[str]]:
    """Split findings into (active, suppressed-with-reason) and report
    baseline keys that matched nothing (stale entries)."""
    active: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    used: set = set()
    for f in findings:
        if f.key in baseline:
            suppressed.append((f, baseline[f.key]))
            used.add(f.key)
        else:
            active.append(f)
    stale = sorted(set(baseline) - used)
    return active, suppressed, stale
