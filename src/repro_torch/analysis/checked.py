"""The sanitizer: explicit invariant checks around the compacting
driver's dispatches.

Port of ``repro.analysis.checkified``. The solver cores are numerically
silent by design: a NaN-poisoned cost matrix rounds to garbage integers
and the solve "converges" to nonsense; a corrupted state walks wild
indices without complaint. The reference instruments its dispatches with
``jax.experimental.checkify``, which has no torch form; this module
checks the same things explicitly, on the state's own device:

  * prologue: no NaN or inf in the valid region of ``c`` (and of ``nu``
    and ``mu``);
  * chunk, BEFORE it runs: the reference's structural invariants
    (``match_ba`` in [-1, n) and ``match_ab`` in [-1, m); free masses
    and flows >= 0; finite Sinkhorn potentials and ``reg > 0``), with the
    reference's messages. A corrupted state is refused before any kernel
    reads it: on the card an out-of-range index would fault the device;
  * epilogue: every float output is finite.

Each check is a set of masked per-lane reductions, fetched in ONE
counted device->host read (kind ``"debug"`` in
``core.device.sync_counts``): one per chunk, plus one for the prologue's
and one for the epilogue's check, so ``dispatches + 2`` a solve. The
read happens inside the wrapped functions, never in the driver's loop,
which keeps its one ``"chunk"`` read. A failed check raises
:class:`DebugCheckError`, naming the check and the first offending lane
of the bucket.

Enabled through the driver: ``repro_torch.analysis.set_debug_checks(True)``
(or ``REPRO_DEBUG_CHECKS=1``) makes ``solve_compacting`` dispatch these
functions. Fused specs run through their stepped base
(:func:`checked_spec_fns`), as in the reference: a fused kernel keeps its
state on the card between phases, where no check can see it, and its
trajectory equals the stepped core's bit for bit, so the stepped chunk
checks exactly the states the kernel would produce.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.device import host_numpy


class DebugCheckError(RuntimeError):
    """A sanitizer check failed: ``check`` names it, ``lane`` is the first
    offending lane of the bucket it ran on."""

    def __init__(self, check: str, lane: int, message: str):
        self.check = check
        self.lane = int(lane)
        super().__init__(f"{message} [check {check!r}, bucket lane "
                         f"{self.lane}]")


def _per_lane(bad: torch.Tensor) -> torch.Tensor:
    """(B,) any over every axis but the first."""
    return bad.reshape(bad.shape[0], -1).any(dim=1)


def _raise_first(checks) -> None:
    """One counted read of every check's (B,) flags; raises for the first
    failed check at its first offending lane."""
    flags = torch.stack([bad for _, _, bad in checks])
    host = host_numpy("debug", flags)
    for (check, message, _), row in zip(checks, host):
        lanes = np.flatnonzero(row)
        if lanes.size:
            raise DebugCheckError(check, int(lanes[0]), message)


# --------------------------------------------------------------------------
# Input checks (prologue)
# --------------------------------------------------------------------------

def _nonfinite(t, mask=None):
    """(B,) lanes of ``t`` holding a NaN or an inf (inside ``mask``)."""
    bad = ~torch.isfinite(t)
    return _per_lane(bad if mask is None else bad & mask)


_NAN_COST = "nan or inf cost in the valid region of c (poisoned input)"
_NAN_MASS = "nan or inf mass in nu or mu (poisoned input)"


def _assignment_inputs(ops):
    _, m, n = ops["c"].shape
    dev = ops["c"].device
    rok = torch.arange(m, device=dev)[None, :] < ops["m_valid"][:, None]
    cok = torch.arange(n, device=dev)[None, :] < ops["n_valid"][:, None]
    return [("finite-cost", _NAN_COST,
             _nonfinite(ops["c"], rok[:, :, None] & cok[:, None, :]))]


def _mass_inputs(ops):
    # OT, warm OT and Sinkhorn: prepare zeroed everything outside each
    # instance's valid block, so the whole tensors are the valid region
    return [("finite-cost", _NAN_COST, _nonfinite(ops["c"])),
            ("finite-mass", _NAN_MASS,
             _nonfinite(ops["nu"]) | _nonfinite(ops["mu"]))]


# --------------------------------------------------------------------------
# Structural invariants (before each chunk)
# --------------------------------------------------------------------------

def _assignment_invariants(data, state):
    _, m, n = data["c_int"].shape
    return [
        ("match_ba-range",
         "assignment matching index out of range: match_ba must lie in "
         f"[-1, {n}) (corrupted state / donated-buffer reuse?)",
         _per_lane((state.match_ba < -1) | (state.match_ba >= n))),
        ("match_ab-range",
         "assignment matching index out of range: match_ab must lie in "
         f"[-1, {m}) (corrupted state / donated-buffer reuse?)",
         _per_lane((state.match_ab < -1) | (state.match_ab >= m))),
    ]


def _ot_invariants(data, state):
    return [
        ("free-mass",
         "negative free mass in OT state (corrupted state / donated-buffer "
         "reuse?)",
         _per_lane(state.free_b < 0) | _per_lane(state.free_a < 0)),
        ("flow",
         "negative flow in OT state (corrupted state / donated-buffer "
         "reuse?)",
         _per_lane(state.f_hi < 0) | _per_lane(state.f_lo < 0)),
    ]


def _sinkhorn_invariants(data, state):
    return [
        ("potentials",
         "non-finite Sinkhorn potentials (poisoned costs / corrupted "
         "state / donated-buffer reuse?)",
         _nonfinite(state.f) | _nonfinite(state.g)),
        ("reg",
         "non-positive Sinkhorn regularization (schedule corrupted?)",
         ~(data["reg"] > 0)),
    ]


_INPUTS = {"assignment": _assignment_inputs, "ot": _mass_inputs,
           "warm_ot": _mass_inputs, "sinkhorn": _mass_inputs}
_INVARIANTS = {"assignment": _assignment_invariants, "ot": _ot_invariants,
               "warm_ot": _ot_invariants,
               "sinkhorn": _sinkhorn_invariants}


# --------------------------------------------------------------------------
# Output checks (epilogue)
# --------------------------------------------------------------------------

def _output_checks(r):
    return [(f"finite-{f}",
             f"non-finite {f} in the solver output (poisoned input / "
             "corrupted state?)", _nonfinite(v))
            for f, v in zip(r._fields, r)
            if isinstance(v, torch.Tensor) and v.is_floating_point()]


def checked_spec_fns(spec, k: int):
    """``(prologue, init, chunk, conv, epilogue)`` with the signatures of
    ``compaction.spec_fns``, the prologue, chunk and epilogue checked.
    Fused specs route through their stepped base BEFORE the cache, so
    fused and stepped share one checked family."""
    return _checked_spec_fns(getattr(spec, "stepped", spec), k)


@lru_cache(maxsize=None)
def _checked_spec_fns(spec, k: int):
    from ..core.compaction import spec_fns

    plain_prologue, init, plain_chunk, conv, plain_epilogue = spec_fns(
        spec, k)
    inputs = _INPUTS[spec.name]
    invariants = _INVARIANTS[spec.name]

    def prologue(ops):
        _raise_first(inputs(ops))
        return plain_prologue(ops)

    def chunk(data, state):
        _raise_first(invariants(data, state))
        return plain_chunk(data, state)

    def epilogue(ctx, state):
        r = plain_epilogue(ctx, state)
        _raise_first(_output_checks(r))
        return r

    return prologue, init, chunk, conv, epilogue
