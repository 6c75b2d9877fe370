"""repro_torch.analysis: the audit layer of the port, a static audit of
the solver entry points plus a sanitizer for the compacting driver.

Port of ``repro.analysis``. The three worst bugs of the reference's
history were silent device-semantics bugs, and each rule of ``rules.py``
names the one it guards against:

  * the OT termination threshold computed on the device in f32, which
    rounds the wrong way for some (eps, total mass) pairs;
  * ``init_ot_state`` sharing the caller's rounded masses with the
    solver state, so the first chunk's update overwrote them under the
    epilogue;
  * eps reaching a program as a Python scalar instead of as an operand,
    which recompiles the reference's jitted programs for every value.

Every solver entry point registers itself in ``registry``; the CLI
(``python -m repro_torch.analysis``) records each one as a log of aten
operations (the torch counterpart of a jaxpr) and runs the rules over it,
plus an AST scan of the drivers' loops for host syncs (``syncaudit.py``)
and of the serving layer for lock discipline (``locks.py``).
``checked.py`` is the runtime companion: explicit invariant checks around
the compacting driver's dispatches, on with ``set_debug_checks(True)`` or
``REPRO_DEBUG_CHECKS=1``.

This module stays import-light: core modules import it (and
``registry``) when they are imported, to register themselves, so nothing
here may import ``repro_torch.core``.
"""
from __future__ import annotations

import os

from . import registry  # noqa: F401  (re-export: the registration hub)

_DEBUG_CHECKS: bool | None = None


def debug_checks_enabled() -> bool:
    """Whether the compacting driver dispatches the checked functions of
    ``checked.py`` instead of the plain ones. Off by default; on through
    ``set_debug_checks`` or the ``REPRO_DEBUG_CHECKS`` environment
    variable (any value but "", "0", "false" and "off")."""
    if _DEBUG_CHECKS is not None:
        return _DEBUG_CHECKS
    return os.environ.get("REPRO_DEBUG_CHECKS", "").lower() not in (
        "", "0", "false", "off")


def set_debug_checks(enabled: bool | None) -> None:
    """Override the debug-checks flag (None restores the environment's)."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = enabled
