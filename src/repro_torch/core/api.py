"""The ``solve()`` front door: one entry point for every dispatch path.

Port of ``repro.core.api``. ``solve(spec, instances, eps, policy)`` routes
a ragged list of instances or one pre-batched bucket through the driver
the :class:`DispatchPolicy` selects:

  * ``lockstep``  every lane of a bucket runs until it terminates, in one
                  chunk;
  * ``compact``   the convergence-compacting chunked-phase driver
                  (``core/compaction.py``), per-instance eps supported.

Results are identical across the two, lane for lane. It runs on the CUDA
device unless ``device="cpu"`` is passed. On the card the stepped route
(the default) launches the ``slack_propose`` kernel in every propose
round; ``DispatchPolicy(fused=True)`` swaps the spec for its fused variant
(``FUSED_ASSIGNMENT`` / ``FUSED_OT``), which runs a whole k-phase chunk in
one launch of the fused kernel, with the same results bit for bit.

``DispatchPolicy(solver=...)`` picks the algorithm for OT batches from the
solver portfolio (``repro_torch.portfolio``): push-relabel (the default),
log-domain Sinkhorn (``SINKHORN``; with ``fused=True`` its f-update is the
``sinkhorn_row_update`` kernel), the hybrid Sinkhorn -> push-relabel warm
start, or "auto", routed per bucket by the measured cost model.

``want=`` (artifact names, also settable on the policy) returns the typed
Solution surface (``core/solution.py``): a ``SolutionBatch`` for the dict
form, a list of per-instance ``Solution`` views for the ragged form. With
``want=None`` the legacy surfaces come back: ``(result, stats)`` for the
dict form, per-instance dicts for the ragged form.

``DispatchPolicy(validate=True)`` runs the admission check
(``core/validate.py``) on every bucket and raises ``RequestRejected``
before any phase runs; ``deadline=`` cuts the compacting driver's chunk
loop at a wall-clock budget and flags the cut lanes
``Solution.degraded``.

Multi-device dispatch (``mode="mesh"``, ``mesh=``) is not ported yet and
raises ``NotImplementedError`` naming its ``ROADMAP.md`` item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..obs.metrics import now as _now
from .compaction import DEFAULT_CHUNK, CompactionStats, solve_compacting
from .device import resolve_device
from .problem import (  # noqa: F401  (re-exported with solve)
    ASSIGNMENT,
    FUSED_ASSIGNMENT,
    FUSED_OT,
    OT,
    fused_variant,
)
from . import solution as solution_mod
from .solution import Solution, SolutionBatch, SolveStats

_MODES = ("auto", "lockstep", "compact", "mesh")
_SOLVERS = ("pushrelabel", "sinkhorn", "hybrid", "auto")


@dataclass(frozen=True)
class DispatchPolicy:
    """How a batch is dispatched. The fields are the reference's.

    Args:
      mode: "auto" (compact), "lockstep" or "compact"; "mesh" is not
        ported yet.
      mesh, placement: multi-device dispatch, not ported yet (``mesh``
        must stay None).
      chunk: k, phases per chunk of the compacting driver.
      buckets: shape-bucket boundaries for ragged input (None -> the
        ``core/batched.py`` defaults).
      guaranteed: run at eps/3 for the paper's <= OPT + eps*m bound.
      want: artifacts of the typed Solution surface; None keeps the
        legacy return surface. ``solve(..., want=...)`` overrides it.
      fused: run each chunk as one launch of the fused kernel
        (``FUSED_ASSIGNMENT`` / ``FUSED_OT``); same results. With
        ``solver="sinkhorn"``, every f-update launches the
        ``sinkhorn_row_update`` kernel (``SINKHORN_KERNEL``).
      solver: the algorithm for OT-family batches: "pushrelabel" (the
        paper's solver, guaranteed at every eps), "sinkhorn" (log-domain,
        AWR schedule, the same additive-eps certificate), "hybrid" (coarse
        Sinkhorn duals warm-start the push-relabel finish, keeping its
        guarantee) or "auto" (routed per bucket by the measured cost model,
        ``repro_torch.portfolio.costmodel``; deterministic for a loaded
        table, so "auto" equals naming its choice). Assignment batches
        ignore it. The chosen solver and the prediction land in
        ``SolveStats``.
      validate: run the admission check (``core/validate.py``) on every
        dispatched bucket and raise ``RequestRejected`` naming the
        offending lanes before any phase runs. The serving layers
        quarantine per request instead (one Future fails, the bucket
        goes on); this flag is the all-or-nothing direct-API equivalent.
    """
    mode: str = "auto"
    mesh: Any = None
    placement: str = "auto"
    chunk: Optional[int] = None
    buckets: Optional[Tuple[int, ...]] = None
    guaranteed: bool = False
    want: Optional[Tuple[str, ...]] = None
    validate: bool = False
    fused: bool = False
    solver: str = "pushrelabel"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown dispatch mode {self.mode!r}; "
                             f"expected one of {_MODES}")
        if self.solver not in _SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}; "
                             f"expected one of {_SOLVERS}")
        if self.mode == "lockstep" and self.mesh is not None:
            raise ValueError("mode='lockstep' cannot dispatch over a mesh")
        if self.mode == "mesh" or self.mesh is not None:
            raise NotImplementedError(
                "mesh dispatch is not ported yet (ROADMAP.md Queue 1 item "
                "11, multi-device)")

    def resolved_mode(self) -> str:
        return "compact" if self.mode == "auto" else self.mode

    @classmethod
    def from_legacy(cls, compact: bool, mesh=None, *, chunk=None,
                    buckets=None, guaranteed: bool = False,
                    placement: str = "auto",
                    want: Optional[Tuple[str, ...]] = None,
                    solver: str = "pushrelabel") -> "DispatchPolicy":
        """Map the legacy ``compact=`` / ``mesh=`` keywords
        (``solve_*_ragged``, ``OTService``) onto a policy: the one place
        that mapping and its mesh-requires-compact rule live. A ``mesh``
        raises ``NotImplementedError`` (multi-device dispatch is ROADMAP.md
        Queue 1 item 11)."""
        if mesh is not None and not compact:
            raise ValueError("mesh dispatch requires compact=True (the "
                             "distributed driver is the compacting "
                             "driver)")
        mode = ("mesh" if mesh is not None
                else ("compact" if compact else "lockstep"))
        return cls(mode=mode, mesh=mesh, placement=placement, chunk=chunk,
                   buckets=None if buckets is None else tuple(buckets),
                   guaranteed=guaranteed,
                   want=None if want is None else tuple(want),
                   solver=solver)


def _resolve_solver(spec, policy: DispatchPolicy, inputs, eps):
    """(solver name, dispatch spec, predicted per-instance seconds) for ONE
    pre-batched bucket. Deterministic and side-effect free: ``solve``
    calls it again to pick the spec that wraps the result, and an "auto"
    dispatch equals naming its choice. Only the OT family reroutes;
    assignment (and specs already rerouted, like the hybrid finish) pass
    through as push-relabel. The shape comes from the tensor: nothing is
    copied to the host."""
    base = getattr(spec, "stepped", spec)
    if policy.solver == "pushrelabel" or base is not OT:
        return "pushrelabel", spec, None
    from .. import portfolio

    solver = policy.solver
    n_eff = int(max(inputs["c"].shape[1:]))
    eps_min = float(np.min(np.asarray(eps, np.float64)))
    if solver == "auto":
        solver, predicted = portfolio.choose(n_eff, eps_min)
    else:
        model = portfolio.get_model()
        predicted = (None if model is None
                     else model.predict(solver, n_eff, eps_min))
    if solver == "sinkhorn":
        # the stepped spec here; policy.fused upgrades it to the row
        # kernel's spec downstream through fused_variant
        return "sinkhorn", portfolio.SINKHORN, predicted
    return solver, spec, predicted


def dispatch(spec, inputs: Dict[str, Any], eps, *, sizes=None,
             policy: Optional[DispatchPolicy] = None,
             keep_state: bool = False, deadline: Optional[float] = None,
             obs=None, device=None, **prep_kw):
    """Solve ONE pre-batched bucket (dict of (B, ...) operands) under
    ``policy`` on ``device`` (default CUDA). Returns ``(result, stats)``:
    ``stats`` is None for plain lockstep, a CompactionStats for compact
    (and for lockstep with ``keep_state``). ``deadline`` is an absolute
    ``repro_torch.obs.now()`` budget for the compacting driver (lockstep
    has no chunk loop to cut, so the combination raises).

    ``policy.solver`` routes the bucket through the solver portfolio; the
    chosen solver, the cost model's prediction and the dispatch wall time
    are set on the stats (``solver`` / ``predicted_s`` / ``solve_s``) and
    sent to ``obs`` as a ``"solver-choice"`` event."""
    policy = policy or DispatchPolicy()
    dev = resolve_device(device)
    inputs = spec.canonicalize(inputs, dev)
    solver, spec, predicted = _resolve_solver(spec, policy, inputs, eps)
    t0 = _now()
    if solver == "hybrid":
        from ..portfolio.hybrid import dispatch_hybrid

        r, stats = dispatch_hybrid(inputs, eps, sizes=sizes, policy=policy,
                                   keep_state=keep_state, deadline=deadline,
                                   obs=obs, device=dev, **prep_kw)
    else:
        r, stats = _dispatch_one(spec, inputs, eps, sizes=sizes,
                                 policy=policy, keep_state=keep_state,
                                 deadline=deadline, obs=obs, device=dev,
                                 **prep_kw)
    solve_s = _now() - t0
    if stats is not None:
        stats.solve_s = solve_s
        stats.solver = solver
        stats.predicted_s = predicted
    if obs is not None:
        obs.event("solver-choice", solver=solver, predicted_s=predicted,
                  solve_s=solve_s)
    return r, stats


def _dispatch_one(spec, inputs: Dict[str, Any], eps, *, sizes=None,
                  policy: DispatchPolicy, keep_state: bool = False,
                  deadline: Optional[float] = None, obs=None, device=None,
                  **prep_kw):
    mode = policy.resolved_mode()
    if policy.fused:
        spec = fused_variant(spec)
    if policy.validate:
        from .validate import check_admission
        check_admission(inputs, sizes=sizes)
    if mode == "lockstep":
        if deadline is not None:
            raise ValueError(
                "deadline requires a chunked driver (mode='compact'); the "
                "lockstep path runs one unbounded chunk that cannot be "
                "cut mid-flight")
        eps_u = np.unique(np.asarray(eps, np.float64))
        if eps_u.size > 1:
            raise ValueError("per-instance eps requires compact=True")
        r, state = spec.solve_lockstep(
            inputs, float(eps_u[0]), sizes=sizes,
            guaranteed=policy.guaranteed, keep_state=keep_state,
            device=device, **prep_kw)
        if keep_state:
            b = int(spec.batch_shape(inputs)[0])
            st = CompactionStats(batch=b, dispatched_batch=b, chunk=0,
                                 dispatches=1, final_state=state)
            return r, st
        return r, None
    k = DEFAULT_CHUNK if policy.chunk is None else int(policy.chunk)
    return solve_compacting(
        spec, inputs, eps, sizes=sizes, k=k, guaranteed=policy.guaranteed,
        keep_state=keep_state, deadline=deadline, obs=obs, device=device,
        **prep_kw)


def _wrap_solution(spec, inputs: Dict[str, Any], eps, policy: DispatchPolicy,
                   r, stats, *, sizes, want: Optional[Tuple[str, ...]],
                   bucket: Optional[Tuple[int, int]] = None,
                   solver: str = "pushrelabel",
                   predicted: Optional[float] = None) -> SolutionBatch:
    """Wrap one dispatched bucket in a SolutionBatch; the tensors stay on
    the device until an artifact is fetched."""
    b = int(spec.batch_shape(inputs)[0])
    eps_user = np.broadcast_to(np.asarray(eps, np.float64), (b,)).copy()
    eps_internal = eps_user / 3.0 if policy.guaranteed else eps_user
    sstats = SolveStats.from_driver(stats, mode=policy.resolved_mode(),
                                    batch=b, bucket=bucket, solver=solver,
                                    predicted_s=predicted)
    state = getattr(stats, "final_state", None) if stats is not None else None
    un = getattr(stats, "unconverged", None) if stats is not None else None
    degraded = None if un is None else np.asarray(un, bool)[:b]
    return SolutionBatch(
        spec, r, stats=sstats, driver_stats=stats, inputs=inputs,
        sizes=sizes, eps=eps_user, eps_internal=eps_internal,
        guaranteed=policy.guaranteed, want=want, state=state,
        degraded=degraded)


def solve(spec, instances: Union[Sequence, Dict[str, Any]], eps,
          policy: Optional[DispatchPolicy] = None, *, sizes=None,
          keep_state: bool = False, want: Optional[Sequence[str]] = None,
          deadline: Optional[float] = None, obs=None, device=None,
          **prep_kw
          ) -> Union[SolutionBatch, List[Solution], Tuple[Any, Any],
                     List[dict]]:
    """The front door. Two input forms:

    * a DICT of pre-batched (B, ...) operands (``{"c"}`` for
      ``ASSIGNMENT``, ``{"c", "nu", "mu"}`` for ``OT``; ``sizes`` gives
      the true shapes inside the padding): one bucket is dispatched.
      Returns a :class:`SolutionBatch` when ``want`` is declared, else
      ``(result, stats)``.
    * a ragged LIST (cost matrices for ``ASSIGNMENT``, ``(c, nu, mu)``
      triples for ``OT``): instances are grouped into shape buckets,
      padded and dispatched per bucket. Returns per-instance
      :class:`Solution` views (input order) when ``want`` is declared,
      else per-instance dicts. ``eps`` may be per instance; lockstep
      sub-groups each bucket by eps value.

    ``want`` declares the artifacts (``spec.artifacts``); asking for
    ``state`` (or ``keep_state=True``) retains the pre-completion integer
    state. ``obs`` is any object with ``event(name, **fields)``.
    ``device`` defaults to CUDA; inputs may be numpy arrays or tensors and
    are moved there.

    ``deadline`` (absolute ``repro_torch.obs.now()``, the
    ``time.monotonic`` clock) stops the compacting driver's dispatches
    when the next chunk would overrun it; lanes cut before their
    termination predicate fired come back ``Solution.degraded=True``,
    still primal-feasible with eps-feasible duals, so
    ``dual_feasible()`` / ``additive_gap()`` re-validate each answer.
    """
    policy = policy or DispatchPolicy()
    dev = resolve_device(device)
    if want is None:
        want = policy.want
    if want is not None:
        want = tuple(want)
        unknown = [w for w in want if w not in spec.artifacts]
        if unknown:
            raise ValueError(f"unknown artifact(s) {unknown} for spec "
                             f"{spec.name!r}; available: {spec.artifacts}")
        if keep_state and "state" not in want:
            want = want + ("state",)
        keep_state = keep_state or "state" in want
    if isinstance(instances, dict):
        inputs = spec.canonicalize(instances, dev)
        r, stats = dispatch(spec, inputs, eps, sizes=sizes, policy=policy,
                            keep_state=keep_state, deadline=deadline,
                            obs=obs, device=dev, **prep_kw)
        if want is None:
            return r, stats
        # re-resolve (deterministic) to wrap with the spec that produced r:
        # SINKHORN's result for sinkhorn routing, OT for the hybrid (its
        # finish is a push-relabel solve)
        solver, wspec, predicted = _resolve_solver(spec, policy, inputs,
                                                   eps)
        return _wrap_solution(wspec, inputs, eps, policy, r, stats,
                              sizes=sizes, want=want, solver=solver,
                              predicted=predicted)
    sols = _solve_ragged(spec, list(instances), eps, policy,
                         keep_state=keep_state, want=want,
                         deadline=deadline, obs=obs, device=dev, **prep_kw)
    if want is not None:
        return sols
    out = []
    for s in sols:
        d = s.legacy_dict()
        if keep_state:
            d["state"] = s.state()
        out.append(d)
    return out


def _solve_ragged(spec, instances: list, eps, policy: DispatchPolicy, *,
                  keep_state: bool = False,
                  want: Optional[Tuple[str, ...]] = None,
                  deadline: Optional[float] = None, obs=None,
                  device=None, **prep_kw) -> List[Solution]:
    from .batched import DEFAULT_BUCKETS, bucket_instances

    shapes = [spec.instance_shape(x) for x in instances]
    eps_arr = np.broadcast_to(np.asarray(eps, np.float64),
                              (len(instances),))
    buckets = (DEFAULT_BUCKETS if policy.buckets is None
               else tuple(policy.buckets))
    lockstep = policy.resolved_mode() == "lockstep"
    results: List[Optional[Solution]] = [None] * len(instances)
    for grp in bucket_instances(shapes, buckets):
        if lockstep:
            # lockstep runs one eps per bucket: sub-group by eps value
            by_eps: Dict[float, List[int]] = {}
            for i in grp.indices:
                by_eps.setdefault(float(eps_arr[i]), []).append(i)
            subgroups = [by_eps[e] for e in sorted(by_eps)]
        else:
            subgroups = [grp.indices]
        for idx in subgroups:
            inputs = spec.canonicalize(
                spec.pad_group([instances[i] for i in idx], grp.key), device)
            sz = np.asarray([shapes[i] for i in idx], np.int32)
            r, stats = dispatch(spec, inputs, eps_arr[idx], sizes=sz,
                                policy=policy, keep_state=keep_state,
                                deadline=deadline, obs=obs, device=device,
                                **prep_kw)
            # per-bucket re-resolution ("auto" may route buckets to
            # different solvers); deterministic, so it matches dispatch
            solver, wspec, predicted = _resolve_solver(spec, policy, inputs,
                                                       eps_arr[idx])
            batch = _wrap_solution(wspec, inputs, eps_arr[idx], policy, r,
                                   stats, sizes=sz, want=want,
                                   bucket=grp.key, solver=solver,
                                   predicted=predicted)
            # per-instance views share the batch's tensors and fetch cache
            for j, i in enumerate(idx):
                results[i] = batch[j]
    return results
