"""Deterministic fault injection for the serving layers (chaos harness).

Port of ``repro.serve.faults``; plain Python, the same plan and log.

The fault-tolerance claims in serve/ — no Future stranded, no healthy
request lost to a neighbor's poison, every degraded answer re-validated
by its certificate — are only claims until something actually fails.
This module injects the failures, deterministically, from a seeded
:class:`FaultPlan`:

  * **NaN poison** — ``on_submit`` corrupts chosen submit ordinals'
    supply points with NaN, exercising the admission gate;
  * **dispatch exceptions** — ``on_dispatch`` raises
    :class:`~repro_torch.serve.ft.TransientDispatchError` for the first N
    dispatch attempts, exercising the retry/backoff degradation ladder;
  * **poisoned dispatch** — raising :class:`PoisonedDispatchError` when
    a chosen request is present in the dispatched bucket, exercising
    bisection;
  * **artificial latency** — a sleep before every dispatch attempt,
    exercising deadline budgets;
  * **worker-thread death** — :class:`WorkerDeath` derives from
    ``SystemExit``, so it escapes the dispatch worker's ``except
    Exception`` recovery exactly like a real thread crash and kills the
    thread silently; ``flush()``/``close()`` must then fail the stranded
    Futures.

The injector is its own lock domain (it is called from scheduler worker
threads and the submitting thread) and counts submits/dispatch attempts
itself, so a plan replays bit-identically for a fixed request sequence.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .ft import TransientDispatchError

__all__ = [
    "FaultPlan",
    "FaultInjector",
    "PoisonedDispatchError",
    "WorkerDeath",
]


class PoisonedDispatchError(RuntimeError):
    """Injected data-dependent dispatch failure: deterministic for the
    same lanes, like a real NaN trip — ``is_poison`` routes it
    to bisection, not to the retry ladder."""
    poisoned_instance = True


class WorkerDeath(SystemExit):
    """Injected worker-thread death. Derives from ``SystemExit`` (not
    ``Exception``) so no recovery path can catch it — the worker thread
    dies mid-item, exactly the failure mode flush()/close() must mop up
    after."""


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative chaos schedule (all ordinals are 0-based).

    ``poison_submits`` NaN-corrupts those submit ordinals' inputs;
    ``poison_rate`` additionally poisons each submit with this seeded
    probability. ``poison_dispatch_of`` raises
    :class:`PoisonedDispatchError` whenever one of those submit ordinals
    is present in a dispatched bucket (dispatch-time poison: survives
    admission, triggers bisection). ``transient_dispatches`` fails the
    first N dispatch attempts with a retryable error;
    ``dispatch_latency_s`` sleeps before every attempt;
    ``kill_worker_at_dispatch`` raises :class:`WorkerDeath` on that
    attempt ordinal."""
    seed: int = 0
    poison_submits: Tuple[int, ...] = ()
    poison_rate: float = 0.0
    poison_dispatch_of: Tuple[int, ...] = ()
    transient_dispatches: int = 0
    dispatch_latency_s: float = 0.0
    kill_worker_at_dispatch: Optional[int] = None


@dataclass
class FaultInjector:
    """Runtime companion of a :class:`FaultPlan`; hand one to
    ``AsyncOTScheduler(faults=...)`` / ``OTService(faults=...)``.

    ``log`` records every injected fault as ``(kind, ordinal)`` so chaos
    tests can assert the plan actually fired."""
    plan: FaultPlan = field(default_factory=FaultPlan)
    log: List[Tuple[str, int]] = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.plan.seed)
        self._submits = 0
        self._dispatches = 0

    # -- submit-side ----------------------------------------------------

    def on_submit(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        """Account one submit; returns ``(possibly-poisoned x, submit
        ordinal)``. Poison is a NaN written into the first supply point —
        it propagates into the batched cost matrix, which is what the
        admission gate actually inspects."""
        with self._lock:
            seq = self._submits
            self._submits += 1
            hit = seq in self.plan.poison_submits or (
                self.plan.poison_rate > 0.0
                and float(self._rng.random()) < self.plan.poison_rate)
            if hit:
                self.log.append(("poison", seq))
        if not hit:
            return x, seq
        x = np.array(x, dtype=np.asarray(x).dtype, copy=True)
        x.reshape(-1)[0] = np.nan
        return x, seq

    # -- dispatch-side --------------------------------------------------

    def on_dispatch(self, submit_seqs: Tuple[int, ...] = ()) -> None:
        """Called at the top of every dispatch attempt with the submit
        ordinals in the bucket; raises per the plan (latency is applied
        first so even failing attempts take wall-clock time)."""
        with self._lock:
            att = self._dispatches
            self._dispatches += 1
            kill = (self.plan.kill_worker_at_dispatch is not None
                    and att == self.plan.kill_worker_at_dispatch)
            transient = att < self.plan.transient_dispatches
            poisoned = sorted(
                set(submit_seqs) & set(self.plan.poison_dispatch_of))
            if kill:
                self.log.append(("kill", att))
            elif transient:
                self.log.append(("transient", att))
            elif poisoned:
                self.log.append(("poison-dispatch", att))
        if self.plan.dispatch_latency_s > 0.0:
            time.sleep(self.plan.dispatch_latency_s)
        if kill:
            raise WorkerDeath(f"fault injection: worker death at dispatch "
                              f"attempt {att}")
        if transient:
            raise TransientDispatchError(
                f"fault injection: transient failure at dispatch attempt "
                f"{att}")
        if poisoned:
            raise PoisonedDispatchError(
                f"fault injection: poisoned request(s) {poisoned} in "
                f"dispatched bucket (attempt {att})")
