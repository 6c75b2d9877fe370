"""The ``solve()`` front door: one entry point for every dispatch path.

Port of ``repro.core.api``. ``solve(spec, instances, eps, policy)`` routes
a ragged list of instances or one pre-batched bucket through the one
compacting driver (``core/compaction.py``) as the :class:`DispatchPolicy`
selects:

  * ``lockstep``  the driver's run-out: every lane of a bucket runs until
                  it terminates, in one chunk;
  * ``compact``   the convergence-compacting chunked-phase loop,
                  per-instance eps supported;
  * ``mesh``      over the devices of a ``launch.mesh.Mesh``
                  (``core/distributed.py``): batch placement is the same
                  loop with the mesh's runner, which splits the batch
                  axis; matrix placement solves each instance (row, col)
                  block-sharded. ``placement`` chooses ("auto" applies
                  ``choose_placement``).

Results are identical across lockstep, compact and mesh/batch, lane for
lane; mesh/matrix has the same integer state, and floats equal up to
reassociation. It runs on the CUDA device unless ``device="cpu"`` is
passed; under mesh mode the mesh decides the devices (a ``device=`` that
is not the mesh's first device raises). The stepped route launches the
``slack_propose`` kernel in every propose round, a host-driven loop of
~40-58 launches and one flag read a round; the fused route swaps the spec
for its fused variant (``FUSED_ASSIGNMENT`` / ``FUSED_OT``), which runs a
whole k-phase chunk in one launch of the fused kernel, with the same
results bit for bit. ``DispatchPolicy()`` (``fused=None``) takes the fused
route for push-relabel buckets on a CUDA device and the stepped route on
the CPU (``DispatchPolicy.fused_for``); ``fused=True`` / ``False`` force
one.

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
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs import tracing as _tracing
from ..obs.metrics import now as _now
from .compaction import CompactionStats, solve_compacting
from .device import resolve_device
from .distributed import same_device, solve_mesh
from .problem import (  # noqa: F401  (re-exported with solve)
    ASSIGNMENT,
    FUSED_ASSIGNMENT,
    FUSED_OT,
    OT,
    fused_variant,
    has_fused_variant,
)
from . import solution as solution_mod
from .solution import Solution, SolutionBatch, SolveStats

_MODES = ("auto", "lockstep", "compact", "mesh")
_SOLVERS = ("pushrelabel", "sinkhorn", "hybrid", "auto")


@dataclass(frozen=True)
class DispatchPolicy:
    """How a batch is dispatched. The fields are the reference's.

    Args:
      mode: "auto" (mesh when ``mesh`` is set, else compact), "lockstep",
        "compact" or "mesh".
      mesh: a ``launch.mesh.Mesh`` (``make_batch_mesh()``, or
        ``make_small_mesh(..., devices=...)`` for logical shards); None
        under mode="mesh" means ``make_batch_mesh()``.
      placement: mesh-mode placement: "auto", "batch" or "matrix".
      chunk: k, phases per chunk of the compacting driver, honoured as
        given. None (the default) is the driver's choice
        (``compaction.chunk_for``): on the fused route with no
        ``deadline``, one chunk above every lane's phase cap, so each
        bucket runs to termination in one launch and one read; with a
        deadline, on the stepped route and under the debug checks, 8.
      buckets: shape-bucket boundaries for ragged input (None -> the
        ``core/batched.py`` defaults).
      guaranteed: run at eps/3 for the paper's <= OPT + eps*m bound.
      want: artifacts of the typed Solution surface; None keeps the
        legacy return surface. ``solve(..., want=...)`` overrides it.
      fused: run each chunk as one launch of the fused kernel
        (``FUSED_ASSIGNMENT`` / ``FUSED_OT``); same results. Under mesh
        batch placement each shard's chunk is one fused launch; matrix
        placement runs the stepped kernels (the fused kernel is a
        whole-instance program). With
        ``solver="sinkhorn"``, every f-update launches the
        ``sinkhorn_row_update`` kernel (``SINKHORN_KERNEL``). None (the
        default): fused where a fused kernel runs the chunk, as
        :meth:`fused_for` resolves it per bucket.
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
    fused: Optional[bool] = None
    solver: str = "pushrelabel"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown dispatch mode {self.mode!r}; "
                             f"expected one of {_MODES}")
        if self.solver not in _SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}; "
                             f"expected one of {_SOLVERS}")
        if self.mode == "lockstep" and self.mesh is not None:
            raise ValueError("mode='lockstep' cannot dispatch over a mesh "
                             "- use mode='compact' or mode='mesh' (the "
                             "distributed driver is the compacting driver)")
        if self.placement not in ("auto", "batch", "matrix"):
            raise ValueError(f"unknown placement {self.placement!r}; "
                             "expected 'auto', 'batch' or 'matrix'")

    def fused_for(self, spec, device, solver: str = "pushrelabel") -> bool:
        """Whether a bucket of ``spec`` on ``device``, routed to
        ``solver``, runs its chunks on the fused kernels. ``fused`` set:
        that. None: push-relabel specs with a fused variant on a CUDA
        device, where a chunk becomes one launch instead of a host round
        loop; stepped on the CPU (the fused spec there is an eager twin
        that saves nothing), for the Sinkhorn solver (its row kernel
        stays opt-in) and for specs without a fused variant. Matrix
        placement runs the stepped kernels whatever this says."""
        if self.fused is not None:
            return self.fused
        return (solver == "pushrelabel" and _on_card(device)
                and has_fused_variant(spec))

    def resolved_mode(self) -> str:
        if self.mode != "auto":
            return self.mode
        return "mesh" if self.mesh is not None else "compact"

    def on_mesh(self, device=None) -> Tuple["DispatchPolicy", Any]:
        """``(policy, device)`` with the mesh resolved: under mesh mode a
        None mesh becomes ``make_batch_mesh()`` and the device is the
        mesh's first (a ``device`` naming another raises); otherwise the
        policy as it is and ``resolve_device(device)``."""
        if self.resolved_mode() != "mesh":
            return self, resolve_device(device)
        pol = self
        if pol.mesh is None:
            from ..launch.mesh import make_batch_mesh

            pol = replace(pol, mesh=make_batch_mesh())
        dev0 = pol.mesh.flat_devices[0]
        if device is not None and not same_device(device, dev0):
            raise ValueError(
                f"device={device!r} disagrees with the mesh, whose first "
                f"device is {dev0}; the mesh decides where a mesh "
                "dispatch runs")
        return pol, dev0

    @classmethod
    def from_legacy(cls, compact: bool, mesh=None, *, chunk=None,
                    buckets=None, guaranteed: bool = False,
                    placement: str = "auto",
                    want: Optional[Tuple[str, ...]] = None,
                    solver: str = "pushrelabel") -> "DispatchPolicy":
        """Map the legacy ``compact=`` / ``mesh=`` keywords
        (``solve_*_ragged``, ``OTService``) onto a policy: the one place
        that mapping and its mesh-requires-compact rule live."""
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


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


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
    sent to ``obs`` as a ``"solver-choice"`` event. ``policy.fused_for``
    picks the route; the driver that runs the chunks sets it on the
    ``solve`` span as ``route``."""
    policy, dev = (policy or DispatchPolicy()).on_mesh(device)
    inputs = spec.canonicalize(inputs, dev)
    solver, spec, predicted = _resolve_solver(spec, policy, inputs, eps)
    t0 = _now()
    if solver == "hybrid":
        from ..portfolio.hybrid import dispatch_hybrid

        r, stats = dispatch_hybrid(inputs, eps, sizes=sizes, policy=policy,
                                   keep_state=keep_state, deadline=deadline,
                                   obs=obs, device=dev, **prep_kw)
    else:
        fused = policy.fused_for(spec, dev, solver)
        r, stats = _dispatch_one(fused_variant(spec) if fused else spec,
                                 inputs, eps, sizes=sizes, policy=policy,
                                 keep_state=keep_state, deadline=deadline,
                                 obs=obs, device=dev, **prep_kw)
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
    if policy.validate:
        from .validate import check_admission
        check_admission(inputs, sizes=sizes)
    if mode == "lockstep":
        if deadline is not None:
            raise ValueError(
                "deadline requires a chunked driver (mode='compact' or "
                "'mesh'); the "
                "lockstep path runs one unbounded chunk that cannot be "
                "cut mid-flight")
        eps_u = np.unique(np.asarray(eps, np.float64))
        if eps_u.size > 1:
            raise ValueError("per-instance eps requires compact=True")
        r, st = solve_compacting(
            spec, inputs, float(eps_u[0]), sizes=sizes,
            guaranteed=policy.guaranteed, keep_state=keep_state,
            device=device, lockstep=True, **prep_kw)
        if keep_state:
            b = int(spec.batch_shape(inputs)[0])
            return r, CompactionStats(batch=b, dispatched_batch=b, chunk=0,
                                      dispatches=1,
                                      final_state=st.final_state)
        return r, None
    # None goes through: the driver resolves it per bucket (chunk_for)
    k = None if policy.chunk is None else int(policy.chunk)
    if mode == "mesh":
        return solve_mesh(
            spec, inputs, eps, policy.mesh, sizes=sizes, k=k,
            guaranteed=policy.guaranteed, placement=policy.placement,
            keep_state=keep_state, deadline=deadline, obs=obs,
            device=device, **prep_kw)
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
    if not isinstance(instances, dict):
        instances = list(instances)
    with _tracing.root("solve", obs) as sp:
        policy, dev = (policy or DispatchPolicy()).on_mesh(device)
        if sp is not None:
            sp.attrs.update(_solve_attrs(spec, instances, policy))
        return _front_door(spec, instances, eps, policy, dev, sizes=sizes,
                           keep_state=keep_state, want=want,
                           deadline=deadline, obs=obs, **prep_kw)


def _solve_attrs(spec, instances, policy: DispatchPolicy) -> Dict[str, Any]:
    """The root ``solve`` span's attributes: problem, B, m, n (the
    largest instance's), mode and solver; the driver adds the route.
    A malformed input gets no sizes here; the front door raises on it."""
    out = {"problem": spec.name, "mode": policy.resolved_mode(),
           "solver": policy.solver}
    if isinstance(instances, dict):
        shape = tuple(np.shape(instances["c"]))
    else:
        sizes = [spec.instance_shape(x) for x in instances]
        shape = (len(instances),) + (tuple(max(d) for d in zip(*sizes))
                                     if sizes else (0, 0))
    if len(shape) == 3:
        out.update(B=int(shape[0]), m=int(shape[1]), n=int(shape[2]))
    return out


def _front_door(spec, instances, eps, policy: DispatchPolicy, dev, *,
                sizes, keep_state: bool, want, deadline, obs, **prep_kw):
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
    sols = _solve_ragged(spec, instances, eps, policy,
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
