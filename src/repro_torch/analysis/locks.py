"""Lock-discipline layer for the serving front end.

Port of ``repro.analysis.locks``. ``AsyncOTScheduler``
(``serve/scheduler.py``) shares mutable state between the caller, the
collate worker and the dispatch worker; every access to a shared field
must hold ``self._lock``. The reference shipped three unguarded accesses
(stats mutations in the dispatch loop, the stranded re-check in
``flush``, the belt-and-braces check in ``close``); this module pins the
discipline two ways:

  * a STATIC scan (:func:`scan_lock_discipline`): attributes every
    ``self.<field>`` access in the class body to its lexically enclosing
    ``with self._lock:`` block and flags unguarded ones. ``__init__`` is
    exempt (no concurrent reader exists before the workers start).
  * a RUNTIME proxy (:class:`GuardedAttrProxy`): wraps a shared object
    so every attribute touch asserts lock ownership
    (``Condition._is_owned``), recording violations for stress tests to
    assert empty.

Scheduler *stats* live in lock-free ``repro_torch.obs`` instruments
(per-thread cells), not under ``_lock``: the scan covers the remaining
locked scheduler state plus the locked pieces of ``repro_torch.obs``
(``MetricsRegistry``'s instrument table, ``JSONLSink``'s file handle,
``History``'s ring, ``TraceCapture``'s arming state). The deliberately
lock-free instruments (``Counter``/``Gauge``/``Histogram``,
``InMemorySink``, ``Tracer``) are recorded as empty-field exemption
targets so the audit names WHY each one needs no lock.

``serve/engine.py``'s ``Engine``/``OTService`` are single-threaded by
contract (no worker threads, no lock); they are scanned with an empty
field set so the audit records the exemption explicitly.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from .rules import Finding


@dataclass(frozen=True)
class LockTarget:
    path: str
    class_name: str
    fields: Tuple[str, ...]          # shared attrs needing the lock
    lock_attr: Optional[str]         # None -> single-threaded contract
    exempt_methods: Tuple[str, ...] = ("__init__",)
    note: str = ""


def _attr_root_field(node: ast.Attribute) -> Optional[str]:
    """For ``self.a.b.c`` return ``a``; None when the chain's root is not
    ``self``."""
    chain = []
    cur: ast.AST = node
    while isinstance(cur, ast.Attribute):
        chain.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name) and cur.id == "self":
        return chain[-1]
    return None


def _is_lock_with(node: ast.With, lock_attr: str) -> bool:
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                and e.value.id == "self" and e.attr == lock_attr:
            return True
    return False


def _scan_stmt(node: ast.AST, guarded: bool, target: LockTarget,
               method: str, findings: List[Finding], seen: set) -> None:
    if isinstance(node, ast.With) and target.lock_attr and \
            _is_lock_with(node, target.lock_attr):
        for child in ast.iter_child_nodes(node):
            _scan_stmt(child, True, target, method, findings, seen)
        return
    if isinstance(node, ast.Attribute):
        root = _attr_root_field(node)
        if root in target.fields and not guarded:
            key = (method, root)
            if key not in seen:
                seen.add(key)
                findings.append(Finding(
                    rule="lock-discipline",
                    entry=f"{target.class_name}.{method}",
                    detail=f"unguarded:{root}",
                    message=(f"access to shared field 'self.{root}' in "
                             f"{target.class_name}.{method} (line "
                             f"{node.lineno}) without holding "
                             f"self.{target.lock_attr}"),
                ))
    for child in ast.iter_child_nodes(node):
        _scan_stmt(child, guarded, target, method, findings, seen)


def scan_lock_discipline(target: LockTarget) -> List[Finding]:
    with open(target.path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    cls = next((n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
                and n.name == target.class_name), None)
    if cls is None:
        return [Finding(
            rule="lock-discipline", entry=target.class_name,
            detail="missing-class",
            message=(f"audited class '{target.class_name}' not found in "
                     f"{target.path} - update the lock-scan target list"))]
    if target.lock_attr is None or not target.fields:
        return []   # single-threaded contract, recorded by the caller
    findings: List[Finding] = []
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in target.exempt_methods:
            continue
        seen: set = set()
        for child in ast.iter_child_nodes(node):
            _scan_stmt(child, False, target, node.name, findings, seen)
    return findings


def scan_class_source(source: str, target: LockTarget) -> List[Finding]:
    """Scan ``source`` directly (test fixtures); same semantics as
    :func:`scan_lock_discipline` minus the file read."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".py")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(source)
        return scan_lock_discipline(LockTarget(
            path=path, class_name=target.class_name, fields=target.fields,
            lock_attr=target.lock_attr,
            exempt_methods=target.exempt_methods, note=target.note))
    finally:
        os.unlink(path)


def default_targets() -> List[LockTarget]:
    from ..obs import metrics, profiler, tracing
    from ..serve import engine, scheduler

    # scheduler stats are not on this list: they are lock-free
    # repro_torch.obs instruments (per-thread cells), not locked state
    shared = ("_outstanding", "_pending", "_closed",
              "_close_called", "_submit_seq")
    return [
        LockTarget(path=scheduler.__file__, class_name="AsyncOTScheduler",
                   fields=shared, lock_attr="_lock"),
        LockTarget(path=engine.__file__, class_name="Engine", fields=(),
                   lock_attr=None,
                   note="single-threaded by contract (no worker threads)"),
        LockTarget(path=engine.__file__, class_name="OTService", fields=(),
                   lock_attr=None,
                   note="single-threaded by contract (no worker threads; "
                        "stats live in lock-free obs instruments)"),
        # repro_torch.obs: the locked pieces...
        LockTarget(path=metrics.__file__, class_name="MetricsRegistry",
                   fields=("_instruments",), lock_attr="_lock",
                   note="lock guards instrument creation only; "
                        "observations go through lock-free instruments"),
        LockTarget(path=metrics.__file__, class_name="JSONLSink",
                   fields=("_fh",), lock_attr="_lock",
                   note="serialization outside the lock, write under it"),
        LockTarget(path=metrics.__file__, class_name="History",
                   fields=("_items",), lock_attr="_lock"),
        LockTarget(path=profiler.__file__, class_name="TraceCapture",
                   fields=("_dir", "_match", "_remaining", "_env_checked"),
                   lock_attr="_lock",
                   exempt_methods=("__init__", "_check_env_locked"),
                   note="_check_env_locked is called with _lock held by "
                        "every caller (locked-suffix naming convention)"),
        # ...and the deliberately lock-free pieces, recorded as audited
        # exemptions so the scan output names why each needs no lock.
        LockTarget(path=metrics.__file__, class_name="Counter", fields=(),
                   lock_attr=None,
                   note="per-thread cells; single-key dict update is "
                        "atomic under the GIL"),
        LockTarget(path=metrics.__file__, class_name="Gauge", fields=(),
                   lock_attr=None,
                   note="single attribute rebind is atomic"),
        LockTarget(path=metrics.__file__, class_name="Histogram", fields=(),
                   lock_attr=None,
                   note="per-thread cells; aggregation copies the cell map"),
        LockTarget(path=metrics.__file__, class_name="InMemorySink",
                   fields=(), lock_attr=None,
                   note="deque.append is atomic; queries snapshot via "
                        "list() before filtering"),
        LockTarget(path=metrics.__file__, class_name="NullSink", fields=(),
                   lock_attr=None, note="stateless"),
        LockTarget(path=tracing.__file__, class_name="Tracer", fields=(),
                   lock_attr=None,
                   note="immutable after construction; span ids from "
                        "itertools.count (atomic in CPython)"),
        LockTarget(path=tracing.__file__, class_name="Span", fields=(),
                   lock_attr=None,
                   note="mutated only by the thread that ends it; emitted "
                        "once on end()"),
    ]


# --------------------------------------------------------------------------
# Runtime companion: instrumented shared-attribute proxy
# --------------------------------------------------------------------------

@dataclass
class LockViolation:
    attr: str
    op: str          # "get" | "set"
    thread: str

    def __str__(self) -> str:
        return f"{self.op} of '{self.attr}' without lock [{self.thread}]"


class GuardedAttrProxy:
    """Attribute-interception proxy over a shared object: every get/set
    asserts the guarding lock is held by the current thread and records a
    :class:`LockViolation` otherwise (recording, not raising, so a stress
    test observes ALL violations instead of dying on the first)."""

    __slots__ = ("_obj", "_lock", "_violations")

    def __init__(self, obj: Any, lock: Any,
                 violations: List[LockViolation]):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_lock", lock)
        object.__setattr__(self, "_violations", violations)

    def _check(self, attr: str, op: str) -> None:
        import threading

        lock = object.__getattribute__(self, "_lock")
        owned = getattr(lock, "_is_owned", lambda: False)()
        if not owned:
            object.__getattribute__(self, "_violations").append(
                LockViolation(attr=attr, op=op,
                              thread=threading.current_thread().name))

    def __getattr__(self, attr: str):
        self._check(attr, "get")
        return getattr(object.__getattribute__(self, "_obj"), attr)

    def __setattr__(self, attr: str, value: Any) -> None:
        self._check(attr, "set")
        setattr(object.__getattribute__(self, "_obj"), attr, value)
