"""Rule 4: hot-loop sync audit (AST-based).

Port of ``repro.analysis.syncaudit`` over the port's own loops. The
compacting drivers read the device from the host once per chunk and no
more: the ``(B,)`` converged mask and the per-lane phase counters,
stacked into one tensor, cross in one counted read,
``both = host_numpy("chunk", ...)`` (the reference's ``conv, ph =
jax.device_get(...)``). The reference once paid a second hidden sync
per chunk fetching ``state.phases`` on its own; this audit pins the
contract so it cannot come back.

The scan parses the driver module, finds the audited loop function
(``compaction._drive``, the one chunk loop: the mesh's batch placement
and lockstep run through it too), and flags every host-transfer marker
inside a ``for`` / ``while`` body:

  * ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``;
  * ``np.asarray(...)`` / ``np.array(...)``;
  * ``host_numpy(...)`` / ``host_flags(...)`` (the counted reads of
    ``core/device.py``);
  * ``torch.cuda.synchronize(...)``.

Whitelisted: a ``host_numpy("chunk", ...)`` whose result is bound to
``both``, the one sanctioned read. Host -> device copies
(``torch.as_tensor``, ``.to(device)``) stay legal. The sanitizer's
reads (``checked.py``, kind "debug") live inside the wrapped chunk
function, outside this loop. So do the runner's methods
(``compaction.OneDevice``, ``distributed._MeshRunner``), which the loop
calls and which read nothing back: the chunk's stacked result comes back
to the loop as a device tensor.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .rules import Finding

_NP_CALLS = {"asarray", "array"}
_METHOD_CALLS = {"item", "cpu", "tolist", "numpy"}
_READ_CALLS = {"host_numpy", "host_flags"}
_ALLOWED_TARGET = "both"
_ALLOWED_KIND = "chunk"


@dataclass(frozen=True)
class SyncTarget:
    path: str           # module file path
    func: str           # function whose loops are audited
    label: str          # entry label used in finding keys


def _call_marker(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id == "np" and \
                f.attr in _NP_CALLS:
            return f"np.{f.attr}"
        if f.attr == "synchronize" and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "cuda":
            return "torch.cuda.synchronize"
        if f.attr in _READ_CALLS:
            return f.attr
        if f.attr in _METHOD_CALLS:
            return f".{f.attr}()"
    if isinstance(f, ast.Name) and f.id in _READ_CALLS:
        return f.id
    return None


def _is_sanctioned(node: ast.Assign) -> bool:
    """``both = host_numpy("chunk", ...)``."""
    if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name) \
            or node.targets[0].id != _ALLOWED_TARGET:
        return False
    v = node.value
    return (isinstance(v, ast.Call) and _call_marker(v) == "host_numpy"
            and bool(v.args) and isinstance(v.args[0], ast.Constant)
            and v.args[0].value == _ALLOWED_KIND)


def _scan_loop_body(loop: ast.AST, label: str, func: str) -> List[Finding]:
    findings: List[Finding] = []
    whitelisted = {id(node.value) for node in ast.walk(loop)
                   if isinstance(node, ast.Assign) and _is_sanctioned(node)}
    for node in ast.walk(loop):
        if not isinstance(node, ast.Call):
            continue
        marker = _call_marker(node)
        if marker is None or id(node) in whitelisted:
            continue
        findings.append(Finding(
            rule="hot-loop-sync", entry=label,
            detail=f"{func}:{marker}:{ast.unparse(node)[:60]}",
            message=(f"host transfer '{ast.unparse(node)[:80]}' inside "
                     f"the chunk loop of {func} (line {node.lineno}): "
                     "only the converged-mask read (both = host_numpy("
                     "\"chunk\", ...)) is whitelisted - fold the value "
                     "into that read or move it out of the loop"),
        ))
    return findings


def audit_function_source(source: str, func: str, label: str
                          ) -> List[Finding]:
    """Audit every loop inside ``func`` of ``source``; also flags the
    function missing entirely (a rename must update the audit)."""
    tree = ast.parse(source)
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
               and n.name == func), None)
    if fn is None:
        return [Finding(
            rule="hot-loop-sync", entry=label, detail=f"missing:{func}",
            message=(f"audited function '{func}' not found - update the "
                     "sync-audit target list to follow the rename"))]
    findings: List[Finding] = []
    seen: set = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.While)):
            for f in _scan_loop_body(node, label, func):
                if f.key not in seen:      # nested loops are re-walked
                    seen.add(f.key)
                    findings.append(f)
    return findings


def audit_targets(targets: Sequence[SyncTarget]) -> List[Finding]:
    findings: List[Finding] = []
    for t in targets:
        with open(t.path, "r", encoding="utf-8") as fh:
            findings.extend(audit_function_source(fh.read(), t.func,
                                                  t.label))
    return findings


def default_targets() -> List[SyncTarget]:
    from ..core import compaction

    return [
        SyncTarget(path=compaction.__file__, func="_drive",
                   label="core.compaction._drive"),
    ]
