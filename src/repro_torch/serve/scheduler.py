"""Async multi-tenant front end for the OT service: queues -> shape
buckets -> dispatch on the card, with host-side batch preparation
overlapping in-flight device work.

Port of ``repro.serve.scheduler``. ``OTService`` (serve/engine.py) is
synchronous: callers submit, then one ``run_batch()`` call blocks while
it buckets, pads, builds cost matrices and solves. ``AsyncOTScheduler``
splits that into a two-stage pipeline:

  submit(x, y[, nu, mu][, eps]) -> Future     (any thread, any tenant)
      |
  [collate worker]  drains the request queue (whatever is queued, up to
      ``max_batch``, after an optional ``linger_ms`` batching window),
      groups by (point dimension, solver mode) and shape bucket, pads,
      builds the bucket's costs in one ``cost_matrix`` launch and runs the
      admission check
      |
  [dispatch worker] feeds prepared buckets through the ``core/api.solve``
      front door (the compacting driver; its propose steps launch
      ``slack_propose``, or the fused kernels under a fused policy) and
      resolves the per-request Futures

with a bounded handoff queue between the stages: while the dispatch
worker waits inside a solve, the collate worker pads and builds the NEXT
bucket.

Both workers launch on the device's current stream of their own thread,
which for a thread that never set one is the device's default stream:
the cost kernel the collate worker enqueues is therefore ordered before
every kernel the dispatch worker enqueues on that bucket, and the
caching allocator needs no ``record_stream``. Each worker makes the
scheduler's device its current device before it starts.

Each resolved Future carries the same result dict as
``OTService.run_batch`` plus scheduling stats: ``wait_s`` (submit ->
dispatch start), ``solve_s`` (bucket solve wall time), ``devices``,
``dispatches``, ``occupancy`` (the compaction curve of its bucket), and
``batch_size``/``bucket``. Per-request ``eps`` is supported (eps is data
to the compacting driver: mixed-accuracy tenants share one dispatch).
Per-request ``want=`` (or the scheduler-level default) makes the Future
resolve to a ``Solution`` view, and each bucket declares only the UNION
of its tenants' artifacts.

Results do not depend on how requests happen to be batched: the
compacting driver's lanes never interact. That composition invariance is
what makes the fault-tolerance layer sound:

  * every collated bucket passes the admission check
    (core/validate.py); poisoned lanes fail their own Future with
    ``RequestRejected`` while the rest of the bucket dispatches;
  * a dispatch that fails on data-dependent poison is BISECTED:
    contiguous halves re-dispatch until the offending request(s) are
    isolated and quarantined;
  * transient dispatch failures (the card out of memory, injected chaos)
    retry with exponential backoff on the scheduler's device; once a
    bucket's retries are spent it is SPLIT into contiguous halves on the
    same device (less memory a dispatch), down to a single request,
    which fails with the last error. Nothing moves to the host CPU
    (``SolveStats.attempts`` counts the failed ones too). A
    kernel that fails to build or launch is not transient and fails its
    requests;
  * ``submit(..., deadline=)`` gives a request a wall-clock budget; its
    bucket stops dispatching k-phase chunks when the earliest budget is
    at risk and resolves best-so-far ``Solution``s flagged
    ``degraded=True``, re-validated per request by their certificates.

Observability (repro_torch.obs): ``stats`` / ``stats_dict()`` are views
over the scheduler's ``MetricsRegistry``; pass ``sinks=`` to stream
counters, histograms and events live. Each request gets a root
``"request"`` span (trace id ``req-<seq>``); each collated bucket its own
trace (``bucket-<n>``) with ``collate`` -> ``admission`` -> ``dispatch``
-> ``solve`` (one per ladder attempt) -> ``artifact-fetch`` spans, the
driver's ``"chunk"`` events under the solve span, and the fault events
(``rejected``, ``retry``, ``ladder``, ``split``, ``quarantine``,
``deadline-cut``, ``degraded``). All timestamps share the clock ``repro_torch.obs.now``.
The opt-in ``repro_torch.obs.profiler`` hook captures a
``torch.profiler`` trace around a named dispatch when armed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..obs import MetricsRegistry, Tracer, new_id, profiler as _profiler
from ..obs import now as _now
from . import ft as _ft
from .collate import collate_bucket, keep_lanes


def _fulfil(fut: Future, result) -> bool:
    """set_result tolerating caller-side cancellation: a tenant cancelling
    its Future must not poison the rest of the batch."""
    try:
        fut.set_result(result)
        return True
    except Exception:          # cancelled / already resolved
        return False


def _fail(fut: Future, exc: BaseException) -> bool:
    try:
        if not fut.done():
            fut.set_exception(exc)
            return True
    except Exception:
        pass
    return False


@dataclass
class _Pending:
    x: np.ndarray
    y: np.ndarray
    nu: Optional[np.ndarray]
    mu: Optional[np.ndarray]
    eps: float
    future: Future
    t_submit: float
    want: Optional[tuple] = None    # None -> legacy result dict
    deadline: Optional[float] = None  # absolute repro_torch.obs.now()
    tenant: Optional[str] = None
    seq: int = -1                   # submit ordinal (fault plans key on it)
    span: Any = None                # root "request" span (submit->resolve)


def _who(req: _Pending) -> str:
    """Name a request for exception messages: its tenant if it gave one,
    its submit ordinal otherwise."""
    return (f"tenant {req.tenant!r}" if req.tenant is not None
            else f"request #{req.seq}")


@dataclass
class _WorkItem:
    has_mass: bool
    c: Any                      # (B, M, N) batched costs (on the device)
    nu: Any                     # (B, M) or None
    mu: Any                     # (B, N) or None
    sizes: np.ndarray           # (B, 2)
    eps: np.ndarray             # (B,) per-request eps
    reqs: List[_Pending]
    bucket: tuple
    t_prepared: float
    # mutable accounting shared across bisection halves of one original
    # bucket (the dispatch worker processes halves sequentially, so no
    # lock is needed): requests quarantined from the bucket so far
    shared: dict = field(default_factory=dict)
    tid: str = ""                   # bucket trace id ("bucket-<n>")
    # dispatch attempts of this item, with those of the bucket it was
    # split from when that one spent its transient retries
    attempts: int = 0


def _split_item(item: _WorkItem, attempts: int = 0):
    """Bisect a work item into contiguous halves (the shared accounting
    dict rides along; each half starts at ``attempts``). Lane-sliced
    operands keep per-lane results bit-identical — batched solves are
    composition-invariant."""
    h = len(item.reqs) // 2

    def sub(lo: int, hi: int) -> _WorkItem:
        return _WorkItem(
            has_mass=item.has_mass, c=item.c[lo:hi],
            nu=None if item.nu is None else item.nu[lo:hi],
            mu=None if item.mu is None else item.mu[lo:hi],
            sizes=item.sizes[lo:hi], eps=item.eps[lo:hi],
            reqs=item.reqs[lo:hi], bucket=item.bucket,
            t_prepared=item.t_prepared, shared=item.shared, tid=item.tid,
            attempts=attempts)

    return sub(0, h), sub(h, len(item.reqs))


@dataclass
class SchedulerStats:
    """Point-in-time SNAPSHOT of the scheduler's metrics registry.

    Since the observability refactor this is no longer a mutable tally
    the workers write into: ``AsyncOTScheduler.stats`` builds one from
    the lock-free registry instruments on every read
    (:meth:`from_registry`), so there is exactly one source of truth and
    ``stats``/``stats_dict()``/attached sinks can never drift apart.

    ``occupancy`` keeps only the most recent ``occupancy_window`` curves
    (bounded: a long-lived scheduler must not grow a list forever)."""
    requests: int = 0
    batches: int = 0
    total_wait_s: float = 0.0
    total_solve_s: float = 0.0
    dispatches: int = 0
    occupancy: "deque" = field(
        default_factory=lambda: deque(maxlen=64))
    # fault-tolerance accounting
    rejected: int = 0        # failed the admission gate (pre-dispatch)
    quarantined: int = 0     # isolated by dispatch-time bisection
    retries: int = 0         # extra dispatch attempts (ladder/backoff)
    degraded: int = 0        # requests resolved best-so-far on deadline
    deadline_hits: int = 0   # buckets cut by a wall-clock budget
    occupancy_window: int = 64   # the bound on len(occupancy)

    #: registry instrument names backing each counter field
    _COUNTERS = ("requests", "batches", "dispatches", "rejected",
                 "quarantined", "retries", "degraded", "deadline_hits")

    @classmethod
    def from_registry(cls, reg, window: int = 64) -> "SchedulerStats":
        snap = reg.snapshot()
        kw = {f: int(snap.get(f"scheduler.{f}", 0)) for f in cls._COUNTERS}
        wait = snap.get("scheduler.wait_s") or {}
        solve = snap.get("scheduler.solve_s") or {}
        return cls(
            total_wait_s=float(wait.get("sum", 0.0)),
            total_solve_s=float(solve.get("sum", 0.0)),
            occupancy=deque(snap.get("scheduler.occupancy", ()),
                            maxlen=window),
            occupancy_window=int(window),
            **kw,
        )

    def as_dict(self) -> dict:
        """Every field of the dataclass, JSON-serializably (the
        stats-surface drift test holds this to completeness).
        ``occupancy`` is TRUNCATED to the most recent
        ``occupancy_window`` bucket curves (the constructor knob on
        ``AsyncOTScheduler``) — older curves are dropped, not summarized;
        ``occupancy_window`` is included so consumers can tell a short
        history from a truncated one."""
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_wait_s": (self.total_wait_s / self.requests
                            if self.requests else 0.0),
            "total_wait_s": self.total_wait_s,
            "total_solve_s": self.total_solve_s,
            "dispatches": self.dispatches,
            "occupancy": [[list(p) for p in curve]
                          for curve in self.occupancy],
            "occupancy_window": self.occupancy_window,
            "rejected": self.rejected,
            "quarantined": self.quarantined,
            "retries": self.retries,
            "degraded": self.degraded,
            "deadline_hits": self.deadline_hits,
        }


class AsyncOTScheduler:
    """Asynchronous bucket scheduler over the batched OT solvers, on one
    device.

    Args:
      eps: default additive error (per-request override via ``submit``).
      metric: point-cloud cost metric.
      mesh: multi-device dispatch, not ported yet (ROADMAP.md Queue 1 item
        11): anything but None raises ``NotImplementedError``. Without it
        the scheduler dispatches on the compacting driver, as the
        reference does on a single device.
      buckets: shape-bucket boundaries (core/batched.py defaults).
      chunk: k, phases per dispatch of the compacting driver.
      max_batch: max requests drained into one collate round.
      linger_ms: optional batching window — after the first request of a
        round arrives, keep draining for this long so co-tenant requests
        share a dispatch. 0 dispatches whatever is instantaneously queued.
      validate: run the vectorized admission gate on every collated
        bucket; poisoned lanes fail their own Future with
        ``RequestRejected``, the rest dispatch.
      admission_tol: relative mass-imbalance tolerance of the gate.
      faults: optional :class:`~repro_torch.serve.faults.FaultInjector`
        (chaos harness).
      retries_per_level / retry_backoff_s: transient-failure retry policy
        per degradation-ladder rung (one rung: the scheduler's device);
        a bucket that spends them is split in halves.
      join_timeout_s: how long close() waits for each worker to exit
        before declaring it hung, failing pending Futures, and raising.
      policy: override the dispatch policy wholesale (e.g. a fused or
        chunk-1 policy); default ``DispatchPolicy(mode="compact", chunk,
        buckets, solver)``.
      sinks: metrics sinks (:class:`~repro_torch.obs.MetricsSink`) to
        stream counters/histograms/spans/events to, live. Empty (the
        default) costs one tuple check per observation.
      occupancy_window: how many recent per-bucket occupancy curves the
        ``stats`` view retains (the ``SchedulerStats.occupancy``
        bound). ``stats_dict()`` reports the window alongside the
        truncated history.
      device: where buckets are built and solved; None means CUDA, and
        raises at construction when CUDA is missing. ``"cpu"`` runs the
        plain versions of the kernels.
    """

    def __init__(self, eps: float = 0.05, metric: str = "euclidean",
                 mesh=None, buckets=None, chunk: Optional[int] = None,
                 max_batch: int = 256, linger_ms: float = 0.0,
                 want: Optional[tuple] = None, validate: bool = True,
                 admission_tol: Optional[float] = None, faults=None,
                 retries_per_level: int = 2, retry_backoff_s: float = 0.05,
                 join_timeout_s: float = 30.0,
                 policy=None, sinks=(), occupancy_window: int = 64,
                 solver: str = "pushrelabel", device=None):
        from ..core import batched as B
        from ..core import compaction as C
        from ..core import validate as V
        from ..core.api import DispatchPolicy
        from ..core.costs import COSTS

        if mesh is not None:
            raise NotImplementedError(
                "mesh dispatch is not ported yet (ROADMAP.md Queue 1 item "
                "11, multi-device)")
        if metric not in COSTS:
            raise ValueError(f"unknown metric {metric!r}; expected one of "
                             f"{tuple(COSTS)}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the workers are new threads: name the card explicitly
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.eps = float(eps)
        self.metric = metric
        self.mesh = mesh
        self.buckets = tuple(buckets) if buckets else B.DEFAULT_BUCKETS
        self.chunk = C.DEFAULT_CHUNK if chunk is None else int(chunk)
        # every bucket dispatch goes through core/api.solve under this one
        # policy; ``solver`` routes OT buckets through the solver
        # portfolio (ignored when an explicit ``policy`` is passed)
        self._policy = policy if policy is not None else DispatchPolicy(
            mode="compact", chunk=self.chunk, buckets=self.buckets,
            solver=solver)
        self.validate = bool(validate)
        self.admission_tol = (V.DEFAULT_TOL if admission_tol is None
                              else float(admission_tol))
        self._faults = faults
        self._retries_per_level = int(retries_per_level)
        self._retry_backoff_s = float(retry_backoff_s)
        self._join_timeout_s = float(join_timeout_s)
        # transient dispatch failures retry on this ladder (one rung, on
        # self.device), re-raising when every retry is spent
        self._ladder = _ft.degradation_ladder(self._policy, self.device)
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_ms) / 1e3
        # default artifact declaration for submits that don't pass their
        # own ``want``; None -> legacy result dicts
        self.want = None if want is None else tuple(want)
        self._B = B
        # ONE metrics registry: stats/stats_dict() are views over it and
        # attached sinks stream the same observations — no parallel tally
        self.metrics = MetricsRegistry(sinks=sinks)
        self._tracer = Tracer(self.metrics)
        self.occupancy_window = int(occupancy_window)
        reg = self.metrics
        self._c_requests = reg.counter("scheduler.requests")
        self._c_batches = reg.counter("scheduler.batches")
        self._c_dispatches = reg.counter("scheduler.dispatches")
        self._c_rejected = reg.counter("scheduler.rejected")
        self._c_quarantined = reg.counter("scheduler.quarantined")
        self._c_retries = reg.counter("scheduler.retries")
        self._c_degraded = reg.counter("scheduler.degraded")
        self._c_deadline_hits = reg.counter("scheduler.deadline_hits")
        self._h_wait = reg.histogram("scheduler.wait_s",
                                     MetricsRegistry.LATENCY_BOUNDS)
        self._h_solve = reg.histogram("scheduler.solve_s",
                                      MetricsRegistry.LATENCY_BOUNDS)
        self._occ = reg.history("scheduler.occupancy",
                                maxlen=self.occupancy_window)

        self._submit_seq = 0          # next submit ordinal (under _lock)
        self._submit_q: "queue.Queue" = queue.Queue()
        # bounded handoff: collate may run at most this many batches ahead
        # of the dispatcher (backpressure, and the overlap window)
        self._work_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._outstanding = 0
        # every un-resolved Future, so shutdown can always account for
        # in-flight work even if a worker dies mid-batch (futures are
        # resolved or failed, never silently stranded)
        self._pending: set = set()
        self._lock = threading.Condition()
        self._closed = False          # no new submits (close() or abort)
        self._close_called = False    # close() ran (joins done once)
        self._collate_t = threading.Thread(target=self._collate_loop,
                                           name="ot-collate", daemon=True)
        self._dispatch_t = threading.Thread(target=self._dispatch_loop,
                                            name="ot-dispatch", daemon=True)
        self._collate_t.start()
        self._dispatch_t.start()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, x, y, nu=None, mu=None,
               eps: Optional[float] = None,
               want: Optional[tuple] = None,
               deadline: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Queue one distance request; returns a Future. (nu, mu) both
        present -> general OT; both absent -> assignment distance.

        ``want`` (per-request, defaulting to the scheduler-level setting)
        declares the artifacts this tenant will read: the Future then
        resolves to a typed :class:`~repro_torch.core.solution.Solution`
        instead of the legacy dict, and only the batch's UNION of
        declared artifacts is ever fetched from device — a bucket of
        cost-only tenants moves O(B) scalars, no dense plans. With
        ``want=None`` the Future resolves to the historical result dict
        (bit-identical adapter).

        ``deadline`` is a RELATIVE wall-clock budget in seconds. The
        request's bucket stops dispatching solver chunks when the
        earliest co-batched budget is at risk; any request still
        unconverged resolves best-so-far with ``degraded=True`` and an
        honestly larger ``additive_gap()`` (duals stay eps-feasible at
        every phase, so the certificate remains valid). ``tenant`` is an
        optional label used in rejection/validation messages."""
        with self._lock:
            who = (f"tenant {tenant!r}" if tenant is not None
                   else f"request #{self._submit_seq}")
        has_mass = _ft.require_mass_pair(nu, mu, who=who)
        fut: Future = Future()
        # closed-check, ordinal reservation, and outstanding-increment
        # share the lock close() takes to flip _closed, so a submit can
        # never slip in after the shutdown sentinel and strand its Future
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            seq = self._submit_seq
            self._submit_seq += 1
            self._outstanding += 1
            self._pending.add(fut)
        # the injector hook runs only after the reservation succeeded, so
        # its submit ordinals stay aligned with ours
        if self._faults is not None:
            x, _ = self._faults.on_submit(np.asarray(x))
        # one monotonic clock (repro_torch.obs.now) for the submit time,
        # the absolute deadline, and every span: the drivers compare the
        # deadline against the same clock inside the chunk loop
        root = self._tracer.start("request", trace_id=f"req-{seq}",
                                  seq=seq, tenant=tenant)
        req = _Pending(x=np.asarray(x), y=np.asarray(y),
                       nu=None if not has_mass else np.asarray(nu),
                       mu=None if not has_mass else np.asarray(mu),
                       eps=self.eps if eps is None else float(eps),
                       future=fut, t_submit=root.t_start,
                       want=(self.want if want is None else tuple(want)),
                       deadline=(None if deadline is None
                                 else root.t_start + float(deadline)),
                       tenant=tenant, seq=seq, span=root)
        self._tracer.event("submit", trace_id=f"req-{seq}",
                           parent_id=root.span_id, seq=seq, tenant=tenant)
        self._submit_q.put(req)
        return fut

    def _workers_alive(self) -> bool:
        return self._collate_t.is_alive() and self._dispatch_t.is_alive()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved (normally,
        exceptionally, or — if a worker thread died — by having its Future
        failed here rather than stranded). Returns False on timeout."""
        deadline = None if timeout is None else _now() + timeout
        with self._lock:
            while self._outstanding > 0:
                if not self._workers_alive():
                    break               # fall through to the abort path
                remaining = (None if deadline is None
                             else deadline - _now())
                if remaining is not None and remaining <= 0:
                    return False
                # wake periodically to re-check worker liveness
                self._lock.wait(timeout=0.2 if remaining is None
                                else min(0.2, remaining))
            # read the verdict while still holding the lock: a bare
            # re-read outside it races _done()/_abort_pending
            stranded = self._outstanding > 0
        if stranded:
            self._abort_pending(RuntimeError(
                "scheduler worker thread died; request abandoned"))
        return True

    def _abort_pending(self, exc: BaseException):
        """Resolve every still-pending Future with ``exc`` (last-resort
        shutdown path: a worker died or close() found undrained work).
        Queued work items are discarded."""
        with self._lock:
            # the pipeline is broken (a worker died or close() found
            # stragglers): refuse further submits — an accepted request
            # with no live worker would strand its Future
            self._closed = True
        for q in (self._submit_q, self._work_q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            # re-seed the shutdown sentinel: draining may have swallowed
            # one a still-live worker was waiting for, and a broken
            # pipeline (one worker dead) should wind the other down too
            try:
                q.put_nowait(None)
            except queue.Full:
                pass
        with self._lock:
            for fut in list(self._pending):
                _fail(fut, exc)
            self._pending.clear()
            self._outstanding = 0
            self._lock.notify_all()

    def close(self):
        """Stop accepting work, drain what was submitted, stop workers.
        Every accepted Future is resolved (or failed) before this returns
        — shutdown never strands a pending Future, even racing in-flight
        collate/dispatch work or a dead worker thread. If a worker is
        still ALIVE after ``join_timeout_s`` (hung, not dead), pending
        Futures are failed and a ``RuntimeError`` naming the hung
        worker(s) is raised — silently returning with live threads would
        leak them and whatever device state they hold."""
        with self._lock:
            if self._close_called:
                return
            self._close_called = True
            self._closed = True          # no new submits past this point
        # bounded: a hung worker must not wedge close() before it even
        # reaches the joins (the timeout only fires when a worker exceeds
        # it — a draining pipeline returns as soon as it's empty)
        self.flush(timeout=self._join_timeout_s)
        self._submit_q.put(None)          # collate sentinel
        self._collate_t.join(timeout=self._join_timeout_s)
        self._dispatch_t.join(timeout=self._join_timeout_s)
        hung = [t.name for t in (self._collate_t, self._dispatch_t)
                if t.is_alive()]
        with self._lock:
            stranded = bool(self._pending)
        if stranded or hung:
            # a worker hung past the join timeout (or died with futures
            # unaccounted): fail everything still pending, loudly
            self._abort_pending(RuntimeError(
                "scheduler closed with hung worker(s): "
                f"{', '.join(hung)}" if hung
                else "scheduler closed"))
        if hung:
            raise RuntimeError(
                f"scheduler worker(s) {', '.join(hung)} still alive "
                f"after join(timeout={self._join_timeout_s}); pending "
                "futures were failed")

    @property
    def stats(self) -> SchedulerStats:
        """A point-in-time :class:`SchedulerStats` snapshot built from
        the metrics registry. Reading it while the workers run is always
        safe (each instrument aggregates its lock-free cells); after
        ``flush()`` it is exact."""
        return SchedulerStats.from_registry(self.metrics,
                                            window=self.occupancy_window)

    def stats_dict(self) -> dict:
        """Serializable snapshot of the aggregate stats — a VIEW over the
        same metrics registry the sinks stream from, not a parallel
        tally. ``occupancy`` holds only the most recent
        ``occupancy_window`` bucket curves (older history is truncated;
        the window rides along under ``"occupancy_window"``). Safe from
        any thread; each value is exact, though distinct counters read
        while the workers are mid-bucket may straddle an update."""
        return self.stats.as_dict()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # workers
    # ------------------------------------------------------------------

    def _drain(self) -> Optional[List[_Pending]]:
        """Block for the first request, then drain whatever else is queued
        (up to max_batch, within the linger window). None on shutdown."""
        first = self._submit_q.get()
        if first is None:
            return None
        batch = [first]
        deadline = _now() + self.linger_s
        while len(batch) < self.max_batch:
            timeout = deadline - _now()
            try:
                nxt = (self._submit_q.get_nowait() if timeout <= 0
                       else self._submit_q.get(timeout=timeout))
            except queue.Empty:
                break
            if nxt is None:               # propagate shutdown after batch
                self._submit_q.put(None)
                break
            batch.append(nxt)
        return batch

    def _enter_device(self) -> None:
        """Make the scheduler's card the worker thread's current device
        (a new thread starts on device 0)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _handoff(self, item) -> None:
        """Backpressure put that cannot block forever: if the dispatch
        worker died, the queue never drains — raise so the batch's
        futures are failed instead of wedging the collate thread."""
        while True:
            try:
                self._work_q.put(item, timeout=1.0)
                return
            except queue.Full:
                if not self._dispatch_t.is_alive():
                    raise RuntimeError("dispatch worker died; work "
                                       "item abandoned") from None

    def _collate_loop(self):
        self._enter_device()
        while True:
            batch = self._drain()
            if batch is None:
                try:
                    self._handoff(None)     # dispatch shutdown sentinel
                except RuntimeError:
                    pass                    # dispatcher already gone
                return
            packaged: set = set()
            try:
                modes: Dict[tuple, List[_Pending]] = {}
                for r in batch:
                    key = (r.x.shape[1], r.nu is not None)
                    modes.setdefault(key, []).append(r)
                for (_, has_mass), sub in sorted(modes.items()):
                    shapes = [(r.x.shape[0], r.y.shape[0]) for r in sub]
                    for grp in self._B.bucket_instances(shapes,
                                                        self.buckets):
                        reqs = [sub[j] for j in grp.indices]
                        tid = new_id("bucket")
                        csp = self._tracer.start(
                            "collate", trace_id=tid, bucket=list(grp.key),
                            batch=len(reqs),
                            seqs=[r.seq for r in reqs])
                        c, nu, mu, codes = collate_bucket(
                            [r.x for r in reqs], [r.y for r in reqs],
                            [r.nu for r in reqs] if has_mass else None,
                            [r.mu for r in reqs] if has_mass else None,
                            grp.key, grp.sizes, device=self.device,
                            metric=self.metric, validate=self.validate,
                            tol=self.admission_tol, tracer=self._tracer,
                            trace_id=tid, parent=csp.span_id,
                            batch=len(reqs))
                        sizes = grp.sizes
                        bad = np.flatnonzero(codes != 0)
                        if bad.size:
                            # poisoned lanes fail their own Future; the
                            # healthy rest of the bucket proceeds
                            rejected = [reqs[j] for j in bad]
                            for j in bad:
                                _fail(reqs[j].future, _ft.RequestRejected(
                                    _who(reqs[j]), int(codes[j])))
                                self._tracer.event(
                                    "rejected", trace_id=tid,
                                    seq=reqs[j].seq, code=int(codes[j]))
                                if reqs[j].span is not None:
                                    reqs[j].span.end(outcome="rejected",
                                                     code=int(codes[j]))
                            self._done(rejected)
                            self._c_rejected.add(int(bad.size))
                            packaged.update(id(r) for r in rejected)
                            keep = np.flatnonzero(codes == 0)
                            if keep.size == 0:
                                csp.end(kept=0)
                                continue
                            c, nu, mu, sizes = keep_lanes(c, nu, mu, sizes,
                                                          keep)
                            reqs = [reqs[j] for j in keep]
                        csp.end(kept=len(reqs))
                        item = _WorkItem(
                            has_mass=has_mass, c=c, nu=nu, mu=mu,
                            sizes=sizes,
                            eps=np.asarray([r.eps for r in reqs]),
                            reqs=reqs, bucket=grp.key,
                            t_prepared=_now(),
                            shared={"quarantined": int(bad.size)},
                            tid=tid,
                        )
                        self._handoff(item)      # blocks: backpressure
                        packaged.update(id(r) for r in reqs)
            except Exception as e:
                # fail only the requests that never made it into a work
                # item; packaged ones are resolved by the dispatcher
                missed = [r for r in batch if id(r) not in packaged]
                for r in missed:
                    _fail(r.future, e)
                    if r.span is not None:
                        r.span.end(outcome="error",
                                   error=type(e).__name__)
                self._done(missed)

    @staticmethod
    def _union_want(item) -> tuple:
        """The batch-level artifact declaration: the union of every
        co-batched tenant's ``want`` (legacy-dict tenants need the full
        legacy artifact set). Only this union is ever fetchable — a
        bucket of cost-only tenants never ships a dense plan."""
        legacy = (("cost", "plan") if item.has_mass
                  else ("cost", "matching", "duals"))
        union: set = set()
        for r in item.reqs:
            union |= set(legacy if r.want is None else r.want)
        return tuple(sorted(union))

    def _dispatch_loop(self):
        self._enter_device()
        while True:
            item = self._work_q.get()
            if item is None:
                return
            self._dispatch_item(item)

    def _solve_with_ladder(self, item, dspan=None):
        """One bucket solve through the unified front door, with
        transient failures retrying down the degradation ladder. Returns
        ``(SolutionBatch, ladder_level)`` and adds its attempts to
        ``item.attempts``; poison, spent transients and programming errors
        propagate to the caller's bisection/quarantine logic untouched.

        Each attempt runs under its own ``"solve"`` span (named with the
        ladder rung) parented under ``dspan``, with the chunked driver's
        per-chunk events parented under the attempt's span; the opt-in
        profiler hook (repro_torch.obs.profiler) can capture one
        ``torch.profiler`` trace around a named dispatch. Each rung names
        its device (the scheduler's own)."""
        from ..core.api import ASSIGNMENT, OT, solve

        if item.has_mass:
            spec = OT
            inputs = {"c": item.c, "nu": item.nu, "mu": item.mu}
        else:
            spec = ASSIGNMENT
            inputs = {"c": item.c}
        want = self._union_want(item)
        budgets = [r.deadline for r in item.reqs if r.deadline is not None]
        deadline = min(budgets) if budgets else None
        seqs = tuple(r.seq for r in item.reqs)
        parent = None if dspan is None else dspan.span_id

        tried = [0]

        def attempt(name, pol, dev):
            tried[0] += 1
            if self._faults is not None:
                self._faults.on_dispatch(seqs)
            cap = f"dispatch:{item.bucket[0]}x{item.bucket[1]}:{name}"
            with self._tracer.span("solve", trace_id=item.tid,
                                   parent=parent, level=name,
                                   attempt=tried[0]) as sp, \
                    _profiler.capture(cap):
                return solve(spec, inputs, item.eps, pol,
                             sizes=item.sizes, want=want,
                             deadline=deadline,
                             obs=self._tracer.bind(trace_id=item.tid,
                                                   parent=sp.span_id),
                             device=dev)

        try:
            batch, level, _ = _ft.run_with_recovery(
                attempt, self._ladder,
                retries_per_level=self._retries_per_level,
                backoff_s=self._retry_backoff_s)
            return batch, level
        finally:
            # count retries even when the run ends in a poison raise —
            # the transient retries before it still happened
            item.attempts += tried[0]
            if tried[0] > 1:
                self._c_retries.add(tried[0] - 1)
                self._tracer.event("retry", trace_id=item.tid,
                                   n=tried[0] - 1)

    def _dispatch_item(self, item):
        """Solve one work item and resolve its Futures; on data-dependent
        poison (a FloatingPointError, an injected poisoned dispatch) BISECT into
        contiguous halves until the offender(s) are isolated and
        quarantined — composition invariance guarantees the survivors'
        results are bit-identical to a clean run. A transient failure
        whose retries are spent splits the bucket the same way, on the
        same device, and fails a single request with the error."""
        t0 = _now()
        dspan = self._tracer.start("dispatch", trace_id=item.tid,
                                   bucket=list(item.bucket),
                                   batch=len(item.reqs))
        try:
            batch, level = self._solve_with_ladder(item, dspan)
        except Exception as e:
            if _ft.is_transient(e) and len(item.reqs) > 1:
                # every retry spent (the card out of memory): half the
                # bucket needs half the memory, on the same device
                dspan.end(outcome="transient-split",
                          error=type(e).__name__)
                self._tracer.event("split", trace_id=item.tid,
                                   batch=len(item.reqs),
                                   error=type(e).__name__)
                for half in _split_item(item, item.attempts):
                    self._dispatch_item(half)
                return
            if _ft.is_poison(e) and len(item.reqs) > 1:
                dspan.end(outcome="poison-bisect",
                          error=type(e).__name__)
                left, right = _split_item(item)
                self._dispatch_item(left)
                self._dispatch_item(right)
                return
            if _ft.is_poison(e):
                # singleton: this IS the offender — quarantine it
                req = item.reqs[0]
                item.shared["quarantined"] = (
                    item.shared.get("quarantined", 0) + 1)
                self._c_quarantined.add(1)
                self._tracer.event("quarantine", trace_id=item.tid,
                                   seq=req.seq)
                dspan.end(outcome="quarantined")
                _fail(req.future, _ft.RequestRejected(
                    _who(req), 0,
                    reason=("dispatch-time poison isolated by "
                            f"bisection: {e}")))
                if req.span is not None:
                    req.span.end(outcome="quarantined")
                self._done(item.reqs)
                return
            dspan.end(outcome="error", error=type(e).__name__)
            for req in item.reqs:
                _fail(req.future, e)
                if req.span is not None:
                    req.span.end(outcome="error",
                                 error=type(e).__name__)
            self._done(item.reqs)
            return
        if level:
            # the bucket resolved below the primary rung: record which
            # one (the fault events contract: retries, ladder level,
            # quarantine, deadline cuts, degraded are all in the stream)
            self._tracer.event("ladder", trace_id=item.tid, level=level,
                              attempts=item.attempts)
        dspan.end(outcome="resolved", level=level, attempts=item.attempts)
        try:
            self._resolve_item(item, batch, t0, level)
        except Exception as e:
            for req in item.reqs:
                _fail(req.future, e)
                if req.span is not None:
                    req.span.end(outcome="error",
                                 error=type(e).__name__)
            self._done(item.reqs)

    def _resolve_item(self, item, batch, t0, level):
        """Fetch the batch's declared artifacts and resolve every Future
        (typed Solution views or legacy dicts)."""
        with self._tracer.span("artifact-fetch", trace_id=item.tid,
                               batch=len(item.reqs)):
            # O(B)-scalar UNGATED fetch: blocks until the bucket is
            # solved whatever the tenants' want union declares,
            # without materializing any big artifact on host
            batch.phases()
            if any(r.want is None for r in item.reqs):
                # legacy solve_s includes the legacy artifact
                # device->host fetches, as the pre-Solution surface
                # measured it
                batch.cost()
                if item.has_mass:
                    batch.plan()
                else:
                    batch.matching()
                    batch.duals()
        solve_s = _now() - t0
        # graft the fault-tolerance accounting onto the batch's stats so
        # every Solution view (and legacy dict) reports it uniformly
        batch.stats = dataclasses.replace(
            batch.stats, attempts=item.attempts, ladder_level=level,
            quarantined=int(item.shared.get("quarantined", 0)))
        st = batch.stats
        deg = batch.degraded()
        # one shared (read-only) occupancy curve for the whole
        # batch, not a copy per request
        occupancy = st.occupancy
        waits = [t0 - req.t_submit for req in item.reqs]
        # aggregate accounting goes to the lock-free registry instruments
        # (stats/stats_dict() are views over them); no scheduler lock on
        # this path — the registry's per-thread cells make the updates
        # race-free by construction
        self._c_batches.add(1)
        self._h_solve.observe(solve_s)
        self._c_dispatches.add(st.dispatches)
        self._occ.append(occupancy)
        self._c_requests.add(len(item.reqs))
        for w in waits:
            self._h_wait.observe(w)
        ndeg = int(deg.sum())
        if ndeg:
            self._c_degraded.add(ndeg)
            self._tracer.event("degraded", trace_id=item.tid, n=ndeg)
        if st.deadline_hit:
            self._c_deadline_hits.add(1)
        for i, req in enumerate(item.reqs):
            wait_s = waits[i]
            if req.span is not None:
                req.span.end(outcome="resolved", bucket_trace=item.tid,
                             wait_s=wait_s, solve_s=solve_s,
                             degraded=bool(deg[i]))
            if req.want is not None:
                # typed surface: the Future resolves to the
                # per-request Solution view (lazy artifacts,
                # uniform Solution.stats)
                _fulfil(req.future, batch[i])
                continue
            m, n = item.sizes[i]
            sol = batch[i]
            out: Dict[str, Any] = {
                "phases": sol.phases,
                "batch_size": len(item.reqs),
                "bucket": item.bucket,
                "wait_s": wait_s,
                "solve_s": solve_s,
                "devices": 1,            # one device until item 11
                "dispatches": st.dispatches,
                "occupancy": occupancy,
                "eps": float(item.eps[i]),
            }
            if deg[i]:
                # new-surface-only key (absent on every converged
                # result, so pre-deadline consumers see identical dicts)
                out["degraded"] = True
            if item.has_mass:
                out["cost"] = sol.cost
                out["plan"] = sol.plan()
            else:
                y_b, y_a = sol.duals()
                out["cost"] = sol.cost / m
                out["matching"] = sol.matching()
                out["dual_lower_bound"] = float(
                    (y_b.sum() + y_a.sum()) / m
                )
            _fulfil(req.future, out)
        self._done(item.reqs)

    def _done(self, reqs):
        with self._lock:
            for r in reqs:
                # only decrement for futures still tracked: a worker
                # finishing an in-flight item AFTER _abort_pending already
                # accounted for it must not drive the counter negative
                # (that would let a later flush() return early)
                if r.future in self._pending:
                    self._pending.discard(r.future)
                    self._outstanding -= 1
            self._lock.notify_all()
