"""Fault-tolerance helpers shared by the serving layers.

Port of ``repro.serve.ft``. Three concerns live here so ``OTService`` and
``AsyncOTScheduler`` agree on them exactly:

  * request validation (:func:`require_mass_pair`, the one home of the
    "provide both nu and mu" rule, naming the failing request/tenant);
  * failure classification (:func:`is_transient` against
    :func:`is_poison`): a transient failure (device out of memory,
    injected chaos) is worth retrying, while poison (a check of the
    sanitizer failing, a ``FloatingPointError``, a request tagged
    ``poisoned_instance``) is a property of the DATA: retrying
    reproduces it, so the right move is bisection and quarantine;
  * the degradation ladder (:func:`degradation_ladder` and
    :func:`run_with_recovery`): transient failures retry with exponential
    backoff on the device the service was built for. No rung moves work
    to another device: a bucket whose operands sit on the card is never
    re-solved on the host CPU, where the plain versions would hide the
    card's faults and run far slower. Once a bucket's
    retries are spent the scheduler splits it in halves on the same
    device (less memory per dispatch) and fails a single request with
    the last error.

The transient set is narrower than the reference's: it is
:class:`TransientDispatchError` and ``torch.cuda.OutOfMemoryError`` and
nothing else. A kernel that fails to build (``ops.build_kernels``) or to
launch (a cudaError from ``ops._launch``) is a programming error: it
propagates at once and is never retried.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..analysis.checked import DebugCheckError
from ..core.validate import RequestRejected  # noqa: F401  (re-exported:
#   the serving layers raise it for admission and dispatch-time poison)

__all__ = [
    "RequestRejected",
    "TransientDispatchError",
    "require_mass_pair",
    "is_transient",
    "is_poison",
    "degradation_ladder",
    "run_with_recovery",
]


class TransientDispatchError(RuntimeError):
    """A dispatch failure worth retrying: the inputs are fine, the
    attempt was not (device out of memory, injected chaos)."""


def require_mass_pair(nu, mu, *, who: str = "request") -> bool:
    """The one home of the nu/mu pairing rule: both present (general OT)
    or both absent (assignment distance). Returns ``has_mass``; raises a
    ``ValueError`` that names the offending request/tenant."""
    if (nu is None) != (mu is None):
        supplied = "nu" if nu is not None else "mu"
        raise ValueError(
            f"provide both nu and mu (general OT) or neither (assignment "
            f"distance): {who} supplied only {supplied}")
    return nu is not None


def is_transient(exc: BaseException) -> bool:
    """Worth retrying? An injected :class:`TransientDispatchError` or the
    card running out of memory (an attempt property: a later attempt, or
    half the bucket, may fit). Nothing else: a kernel build or launch
    failure is a bug and is never retried."""
    return isinstance(exc, (TransientDispatchError,
                            torch.cuda.OutOfMemoryError))


def is_poison(exc: BaseException) -> bool:
    """A data-dependent failure: retrying the same lanes reproduces it,
    so the caller should bisect and quarantine instead. Matches the
    sanitizer's :class:`~repro_torch.analysis.checked.DebugCheckError`
    (``REPRO_DEBUG_CHECKS=1``: a NaN input or a broken invariant),
    ``FloatingPointError`` and anything tagged ``poisoned_instance`` (the
    fault-injection harness)."""
    if isinstance(exc, (DebugCheckError, FloatingPointError)):
        return True
    return bool(getattr(exc, "poisoned_instance", False))


def degradation_ladder(policy, device=None) -> List[Tuple[str, Any, Any]]:
    """``[(level_name, policy, device), ...]``: the rungs a transient
    failure retries down.

    Level 0 is the caller's policy on the caller's ``device`` (None:
    CUDA); a mesh policy runs on its mesh, whose first device must be
    ``device`` when one is given. Below a mesh policy comes the
    reference's middle rung: ``compact`` (no mesh, no cross-device
    traffic, one device) on the mesh's first device, with the policy's
    chunk, buckets, guarantee and route (``fused``). The reference's host-CPU rung is not
    ported: a service built for the card keeps every attempt on the
    card, and a service built with ``device="cpu"`` runs on the CPU from
    level 0."""
    from ..core.api import DispatchPolicy

    if policy.resolved_mode() != "mesh":
        dev = torch.device("cuda" if device is None else device)
        return [(policy.resolved_mode(), policy, dev)]
    pol, dev0 = policy.on_mesh(device)
    compact = DispatchPolicy(mode="compact", chunk=policy.chunk,
                             buckets=policy.buckets,
                             guaranteed=policy.guaranteed,
                             fused=policy.fused)
    return [("mesh", pol, dev0), ("compact", compact, dev0)]


def run_with_recovery(
    attempt: Callable[[str, Any, Any], Any],
    ladder: List[Tuple[str, Any, Any]],
    *,
    retries_per_level: int = 2,
    backoff_s: float = 0.05,
    sleep: Callable[[float], None] = time.sleep,
    transient: Callable[[BaseException], bool] = is_transient,
) -> Tuple[Any, int, int]:
    """Run ``attempt(level_name, policy, device)`` down the ladder.

    Transient failures retry ``retries_per_level`` times per rung with
    exponential backoff (``backoff_s * 2**attempt_on_level``), then fall
    to the next rung. Non-transient failures (poison, programming errors)
    propagate immediately. Returns ``(result, level_index,
    total_attempts)``; exhausting the ladder re-raises the last error.
    """
    last: Optional[BaseException] = None
    total = 0
    for level, (name, pol, dev) in enumerate(ladder):
        for a in range(max(1, retries_per_level)):
            total += 1
            try:
                return attempt(name, pol, dev), level, total
            except Exception as e:
                if not transient(e):
                    raise
                last = e
                if backoff_s > 0:
                    sleep(backoff_s * (2 ** a))
    assert last is not None
    raise last
