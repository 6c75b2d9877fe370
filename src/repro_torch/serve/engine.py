"""The paper's OT solver as a batched service: ``OTRequest`` and
``OTService``.

Port of the OT half of ``repro.serve.engine``. The reference module's LLM
``Engine`` (prefill and decode of a language model) waits for its own
slice of the port (ROADMAP.md Queue 1 item 13).

``OTService`` runs on the CUDA device unless it is given ``device="cpu"``
(and raises at construction when CUDA is asked for but missing). Each
bucket's cost matrices are built by one launch of the ``cost_matrix``
kernel (``serve/collate.py``; its plain version on the CPU), then
solved through the ``core/api.solve`` front door, whose propose steps
launch ``slack_propose`` (or the fused kernels under a fused policy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.device import resolve_device
from ..obs import MetricsRegistry, Tracer, new_id
from ..obs import now as _now
from .collate import collate_bucket, keep_lanes

__all__ = ["OTRequest", "OTService"]


@dataclass
class OTRequest:
    x: np.ndarray                      # (m, d) supply points
    y: np.ndarray                      # (n, d) demand points
    nu: Optional[np.ndarray] = None    # (m,) masses -> general-OT mode
    mu: Optional[np.ndarray] = None    # (n,) masses


class OTService:
    """Batched OT-distance endpoint (the paper's solver as a service).

    ``submit()`` queues distance requests; ``run_batch()`` groups them by
    point dimension and mode into shape buckets, pads each bucket, builds
    its costs in one kernel launch and dispatches it through
    ``core/api.solve`` under one policy (``compact=True``: the compacting
    driver; ``compact=False``: lockstep). Point-set requests (no masses)
    run the assignment solver; requests with (nu, mu) the general OT
    solver. ``distance()`` is the one-shot wrapper.

    ``want=`` (artifact names, e.g. ``("cost", "plan_sparse")``) makes
    ``run_batch`` return per-request ``Solution`` views, and only the
    declared artifacts cross to the host; ``want=None`` returns the
    reference's per-request dicts.

    With ``validate=True`` (default) each bucket passes the admission
    check first: a poisoned ticket's slot holds its ``RequestRejected``
    while the healthy tickets of its bucket solve.

    Observability: the service owns a ``repro_torch.obs.MetricsRegistry``
    (attach sinks with ``sinks=``). Every bucket gets its own trace
    (``svc-N``) with bucket / admission / solve / artifact-fetch spans,
    one event per rejected ticket, and the driver's per-chunk events
    under the solve span. ``stats_dict()`` is a view over the registry.
    """

    def __init__(self, eps: float = 0.05, metric: str = "euclidean",
                 buckets=None, compact: bool = True,
                 chunk: Optional[int] = None, mesh=None,
                 want: Optional[tuple] = None, validate: bool = True,
                 admission_tol: Optional[float] = None, sinks=(),
                 solver: str = "pushrelabel", device=None):
        from ..core import batched as B
        from ..core import compaction as C
        from ..core import validate as V
        from ..core.api import DispatchPolicy
        from ..core.costs import COSTS

        if metric not in COSTS:
            raise ValueError(f"unknown metric {metric!r}; expected one of "
                             f"{tuple(COSTS)}")
        self.device = resolve_device(device)
        self.eps = eps
        self.metric = metric
        self.validate = bool(validate)
        self.admission_tol = (V.DEFAULT_TOL if admission_tol is None
                              else float(admission_tol))
        self.buckets = tuple(buckets) if buckets else B.DEFAULT_BUCKETS
        self.compact = compact
        self.chunk = C.DEFAULT_CHUNK if chunk is None else int(chunk)
        # from_legacy owns the compact/mesh keyword mapping (a mesh raises
        # NotImplementedError until multi-device dispatch is ported)
        self._policy = DispatchPolicy.from_legacy(
            compact, mesh, chunk=self.chunk, buckets=self.buckets,
            solver=solver)
        self.want = None if want is None else tuple(want)
        self.mesh = mesh
        self.queue: List[OTRequest] = []
        self._B = B
        self.metrics = MetricsRegistry(sinks=sinks)
        self._tracer = Tracer(self.metrics)
        reg = self.metrics
        self._c_requests = reg.counter("service.requests")
        self._c_batches = reg.counter("service.batches")
        self._c_rejected = reg.counter("service.rejected")
        self._c_dispatches = reg.counter("service.dispatches")
        self._h_solve = reg.histogram("service.solve_s",
                                      MetricsRegistry.LATENCY_BOUNDS)

    def stats_dict(self) -> Dict[str, Any]:
        """Service counters as a plain dict: a view over the registry."""
        snap = self.metrics.snapshot()
        solve_h = snap.get("service.solve_s", {"count": 0, "sum": 0.0})
        return {
            "requests": snap.get("service.requests", 0),
            "batches": snap.get("service.batches", 0),
            "rejected": snap.get("service.rejected", 0),
            "dispatches": snap.get("service.dispatches", 0),
            "total_solve_s": solve_h["sum"],
        }

    def submit(self, x: np.ndarray, y: np.ndarray,
               nu: Optional[np.ndarray] = None,
               mu: Optional[np.ndarray] = None) -> int:
        """Queue one distance request; returns its ticket (position in the
        result list of the next run_batch)."""
        from .ft import require_mass_pair

        require_mass_pair(nu, mu, who=f"ticket #{len(self.queue)}")
        self.queue.append(OTRequest(x=np.asarray(x), y=np.asarray(y),
                                    nu=nu, mu=mu))
        return len(self.queue) - 1

    def run_batch(self) -> List[Any]:
        """Solve all queued requests by bucketed batched dispatch; returns
        results in submission order: per-request dicts (``want=None``) or
        ``Solution`` views, and ``RequestRejected`` instances in the slots
        of quarantined tickets."""
        if not self.queue:
            return []
        from ..core.api import ASSIGNMENT, OT, solve
        from ..core.validate import RequestRejected

        reqs, self.queue = self.queue, []
        results: List[Optional[Any]] = [None] * len(reqs)
        modes: Dict[tuple, List[int]] = {}
        for i, r in enumerate(reqs):
            modes.setdefault((r.x.shape[1], r.nu is not None), []).append(i)
        for (_, has_mass), sub in sorted(modes.items()):
            shapes = [(reqs[i].x.shape[0], reqs[i].y.shape[0]) for i in sub]
            for grp in self._B.bucket_instances(shapes, self.buckets):
                idx = [sub[j] for j in grp.indices]
                (mb, nb), sizes = grp.key, grp.sizes
                tid = new_id("svc")
                bsp = self._tracer.start("bucket", trace_id=tid,
                                         bucket=[int(mb), int(nb)],
                                         batch=len(idx),
                                         tickets=[int(i) for i in idx])
                gt0 = bsp.t_start
                c, nu, mu, codes = collate_bucket(
                    [reqs[i].x for i in idx], [reqs[i].y for i in idx],
                    [reqs[i].nu for i in idx] if has_mass else None,
                    [reqs[i].mu for i in idx] if has_mass else None,
                    grp.key, sizes, device=self.device, metric=self.metric,
                    validate=self.validate, tol=self.admission_tol,
                    tracer=self._tracer, trace_id=tid, parent=bsp.span_id)
                bad = np.flatnonzero(codes != 0)
                if bad.size:
                    # the rejection goes in the result list (run_batch has
                    # no Future to fail); the rest of the bucket solves
                    self._c_rejected.add(int(bad.size))
                    for j in bad:
                        self._tracer.event(
                            "rejected", trace_id=tid, parent_id=bsp.span_id,
                            ticket=int(idx[j]), code=int(codes[j]))
                        results[idx[j]] = RequestRejected(
                            f"ticket #{idx[j]}", int(codes[j]))
                    keep = np.flatnonzero(codes == 0)
                    if keep.size == 0:
                        bsp.end(outcome="all-rejected")
                        continue
                    c, nu, mu, sizes = keep_lanes(c, nu, mu, sizes, keep)
                    idx = [idx[j] for j in keep]
                if has_mass:
                    spec, inputs = OT, {"c": c, "nu": nu, "mu": mu}
                    legacy_want = ("cost", "plan")
                else:
                    spec, inputs = ASSIGNMENT, {"c": c}
                    legacy_want = ("cost", "matching", "duals")
                want = legacy_want if self.want is None else self.want
                with self._tracer.span("solve", trace_id=tid,
                                       parent=bsp.span_id,
                                       batch=len(idx)) as ssp:
                    batch = solve(spec, inputs, self.eps, self._policy,
                                  sizes=sizes, want=want,
                                  obs=self._tracer.bind(
                                      trace_id=tid, parent=ssp.span_id),
                                  device=self.device)
                with self._tracer.span("artifact-fetch", trace_id=tid,
                                       parent=bsp.span_id):
                    # the O(B)-scalar phase fetch waits for the bucket
                    # whatever the declared want; big artifacts stay on
                    # the device unless requested
                    batch.phases()
                    if self.want is None:
                        batch.cost()
                        if has_mass:
                            batch.plan()
                        else:
                            batch.matching()
                            batch.duals()
                gdt = _now() - gt0
                st = batch.driver_stats
                self._c_batches.add(1)
                self._c_requests.add(len(idx))
                self._h_solve.observe(gdt)
                if st is not None:
                    self._c_dispatches.add(int(st.dispatches))
                bsp.end(kept=len(idx), solve_s=gdt)
                for k, i in enumerate(idx):
                    sol = batch[k]
                    if self.want is not None:
                        results[i] = sol
                        continue
                    m, n = sizes[k]
                    if has_mass:
                        out: Dict[str, Any] = {
                            "cost": sol.cost,
                            "plan": sol.plan(),
                            "phases": sol.phases,
                            "batch_size": len(idx),
                            "bucket": (mb, nb),
                            "latency_s": gdt,
                        }
                    else:
                        y_b, y_a = sol.duals()
                        out = {
                            "cost": sol.cost / m,
                            "matching": sol.matching(),
                            "phases": sol.phases,
                            "dual_lower_bound": float(
                                (y_b.sum() + y_a.sum()) / m
                            ),
                            "batch_size": len(idx),
                            "bucket": (mb, nb),
                            "latency_s": gdt,
                        }
                    if st is not None:
                        out["dispatches"] = st.dispatches
                    results[i] = out
        assert all(r is not None for r in results)
        return results  # submission order

    def distance(self, x: np.ndarray, y: np.ndarray,
                 nu: Optional[np.ndarray] = None,
                 mu: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """One-shot convenience: solve just this request. Queued requests
        and their tickets are left untouched for the next run_batch()."""
        held, self.queue = self.queue, []
        try:
            self.submit(x, y, nu=nu, mu=mu)
            out = self.run_batch()[0]
            if isinstance(out, BaseException):
                raise out        # one-shot callers want the exception
            return out
        finally:
            self.queue = held
