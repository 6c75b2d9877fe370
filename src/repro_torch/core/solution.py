"""Typed ``Solution`` result surface: lazy artifact fetch, compact sparse
plans, and a-posteriori certificates.

Port of ``repro.core.solution``. A ``SolutionBatch`` holds the batched
result on the device; each artifact accessor copies only its own tensors
to the host, once (``fetched_bytes`` counts them). Artifacts must be
declared with ``solve(..., want=...)``; an undeclared accessor raises
:class:`ArtifactNotRequested`.

  ``cost``         the primal objective <plan, C>.
  ``duals``        the eps-feasible approximate duals (y_b, y_a), and with
                   them the certificates: ``dual_objective``,
                   ``additive_gap = cost - dual_objective`` and
                   ``dual_feasible`` (reduced on the device, O(B) scalars
                   fetched).
  ``plan`` /       the primal plan, dense or as COO triplets
  ``plan_sparse``  (``SparsePlan.to_dense()`` reproduces the dense plan).
  ``matching``     Algorithm 1's row -> column matching.
  ``state``        the integer pre-completion solver state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..obs import tracing as _tracing
from .device import host_numpy
from .problem import pow2_at_least, tree_map

__all__ = [
    "ArtifactNotRequested",
    "SolveStats",
    "SparsePlan",
    "SparsePlanBatch",
    "Solution",
    "SolutionBatch",
]


class ArtifactNotRequested(ValueError):
    """Accessing an artifact that was not declared in ``want=``."""


@dataclass(frozen=True)
class SolveStats:
    """Per-dispatch accounting with explicit defaults on every path."""
    mode: str                      # "lockstep" | "compact" | "mesh"
    batch: int                     # real instances in the dispatch
    bucket: Optional[Tuple[int, int]] = None   # padded dispatch shape
    dispatches: int = 1
    devices: int = 1
    placement: str = "batch"
    chunk: Optional[int] = None
    occupancy: Tuple[Tuple[int, int], ...] = ()
    collapsed_at: Optional[int] = None
    # fault-tolerance accounting (the serving layers fill these in)
    deadline_hit: bool = False     # chunk loop cut by a wall-clock budget
    attempts: int = 1              # dispatch attempts incl. ladder retries
    ladder_level: int = 0          # 0 = configured policy; higher = degraded
    quarantined: int = 0           # requests quarantined from this bucket
    # solver-portfolio accounting (core/api records these when
    # DispatchPolicy.solver routes away from the default)
    solver: str = "pushrelabel"    # solver that produced this result
    predicted_s: Optional[float] = None  # cost-model per-batch prediction
    actual_s: Optional[float] = None     # dispatch wall seconds

    @classmethod
    def from_driver(cls, st: Any, *, mode: str, batch: int,
                    bucket: Optional[Tuple[int, int]] = None,
                    solver: str = "pushrelabel",
                    predicted_s: Optional[float] = None) -> "SolveStats":
        """Fold a driver stats object (CompactionStats,
        DistributedStats, or None for the plain lockstep path) into the
        uniform surface."""
        if st is None:
            return cls(mode=mode, batch=batch, bucket=bucket, solver=solver,
                       predicted_s=predicted_s)
        return cls(
            mode=mode, batch=batch, bucket=bucket,
            dispatches=int(st.dispatches) or 1,
            devices=int(getattr(st, "devices", 1)),
            placement=str(getattr(st, "placement", "batch")),
            chunk=int(st.chunk) if st.chunk else None,
            occupancy=tuple(tuple(o) for o in st.occupancy),
            collapsed_at=getattr(st, "collapsed_at", None),
            deadline_hit=bool(st.deadline_hit),
            solver=solver, predicted_s=predicted_s, actual_s=st.solve_s,
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "mode": self.mode, "batch": self.batch, "bucket": self.bucket,
            "dispatches": self.dispatches, "devices": self.devices,
            "placement": self.placement, "chunk": self.chunk,
            "occupancy": [list(o) for o in self.occupancy],
            "collapsed_at": self.collapsed_at,
            "deadline_hit": self.deadline_hit, "attempts": self.attempts,
            "ladder_level": self.ladder_level,
            "quarantined": self.quarantined,
            "solver": self.solver, "predicted_s": self.predicted_s,
            "actual_s": self.actual_s,
        }


# --------------------------------------------------------------------------
# Device-side reductions (O(B) scalars cross to the host)
# --------------------------------------------------------------------------

def _valid(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(B, k) mask of the first ``size[b]`` entries of each lane."""
    k = v.shape[1]
    return torch.arange(k, device=v.device)[None, :] < size[:, None]


def _block_mask(c, m_valid, n_valid, col_live=None):
    rok = _valid(c[:, :, 0], m_valid)
    cok = _valid(c[:, 0, :], n_valid)
    if col_live is not None:
        cok = cok & col_live
    return rok[:, :, None] & cok[:, None, :]


def _masked_max(c, m_valid, n_valid):
    """(B,) max cost over each instance's valid block (the solver's
    rescaling factor)."""
    # a zero of c's dtype, not a Python 0.0 whose dtype follows the
    # operand's (dtype-drift audit, weak-literal)
    return torch.where(_block_mask(c, m_valid, n_valid), c,
                       c.new_zeros(())).amax(dim=(1, 2))


def _masked_sum(v, valid):
    return torch.where(_valid(v, valid), v, v.new_zeros(())).sum(dim=1)


def _dual_obj_assignment(y_b, y_a, m_valid, n_valid):
    return _masked_sum(y_b, m_valid) + _masked_sum(y_a, n_valid)


def _dual_obj_ot(y_b, y_a, nu, mu, m_valid, n_valid):
    return _masked_sum(nu * y_b, m_valid) + _masked_sum(mu * y_a, n_valid)


def _feasibility_margin(c, y_b, y_a, m_valid, n_valid, col_live):
    """(B,) max over each instance's live edges of y_b[i] + y_a[j] - c[i,j]
    (eps-feasibility holds when this is <= eps * scale up to f32 slop)."""
    s = y_b[:, :, None] + y_a[:, None, :] - c
    mask = _block_mask(c, m_valid, n_valid, col_live)
    return torch.where(mask, s, s.new_full((), float("-inf"))).amax(
        dim=(1, 2))


def _count_nnz(plan):
    """(B,) int32 support size of each lane of a (B, M, N) plan."""
    return (plan.reshape(plan.shape[0], -1) != 0).sum(dim=1,
                                                      dtype=torch.int32)


# --------------------------------------------------------------------------
# Compact sparse transport plans
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SparsePlan:
    """One instance's transport plan as COO triplets; ``to_dense()``
    scatters the f32 values back, reproducing the dense plan."""
    rows: np.ndarray    # (nnz,) int32
    cols: np.ndarray    # (nnz,) int32
    vals: np.ndarray    # (nnz,) float32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.cols.nbytes + self.vals.nbytes)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        out[self.rows, self.cols] = self.vals
        return out


@dataclass(frozen=True)
class SparsePlanBatch:
    """Batched COO plans at a shared pow2 capacity; ``idx`` is flat
    row-major with fill ``m * n`` past each instance's ``nnz``."""
    idx: np.ndarray     # (B, K) int32 flat indices, fill = m * n
    vals: np.ndarray    # (B, K) float32
    nnz: np.ndarray     # (B,) int32
    shape: Tuple[int, int]          # padded bucket shape (m, n)

    @property
    def nbytes(self) -> int:
        return int(self.idx.nbytes + self.vals.nbytes + self.nnz.nbytes)

    def instance(self, j: int, shape: Optional[Tuple[int, int]] = None
                 ) -> SparsePlan:
        m, n = self.shape
        k = int(self.nnz[j])
        idx = self.idx[j, :k].astype(np.int64)
        return SparsePlan(rows=(idx // n).astype(np.int32),
                          cols=(idx % n).astype(np.int32),
                          vals=self.vals[j, :k],
                          shape=tuple(shape) if shape else (m, n))


def sparse_from_dense_device(plan: torch.Tensor, batch: int
                             ) -> SparsePlanBatch:
    """COO-extract a (B, M, N) device plan: the support is found on the
    device (``torch.nonzero``, row-major like ``jnp.nonzero``), padded per
    lane to the pow2 capacity of the largest support, and only the
    triplets are copied to the host."""
    b, m, n = plan.shape
    flat = plan.reshape(b, m * n)
    nnz_t = _count_nnz(plan)
    hits = torch.nonzero(flat)                 # (total, 2), lane-major
    nnz = host_numpy("fetch", nnz_t)
    k = min(pow2_at_least(int(nnz[:batch].max(initial=1))), m * n)
    lane, pos_flat = hits[:, 0], hits[:, 1]
    start = torch.cumsum(nnz_t, 0, dtype=torch.int64) - nnz_t
    pos = torch.arange(hits.shape[0], device=plan.device) - start[lane]
    keep = pos < k
    idx = torch.full((b, k), m * n, dtype=torch.int32, device=plan.device)
    vals = torch.zeros((b, k), dtype=torch.float32, device=plan.device)
    idx[lane[keep], pos[keep]] = pos_flat[keep].to(torch.int32)
    vals[lane[keep], pos[keep]] = flat[lane[keep], pos_flat[keep]]
    return SparsePlanBatch(idx=host_numpy("fetch", idx[:batch]),
                           vals=host_numpy("fetch", vals[:batch]),
                           nnz=nnz[:batch], shape=(int(m), int(n)))


# --------------------------------------------------------------------------
# The Solution surface
# --------------------------------------------------------------------------

class SolutionBatch:
    """Typed, lazily-fetched view over one dispatched batch result.

    The batched tensors stay on the device; each artifact accessor copies
    exactly its own tensors to the host, once. ``want`` gates the
    accessors; ``None`` allows everything. ``batch[i]`` gives per-instance
    :class:`Solution` views sharing this batch's fetch cache.
    """

    def __init__(self, spec: Any, result: Any, *, stats: SolveStats,
                 driver_stats: Any = None, inputs: Dict[str, Any],
                 sizes: Optional[np.ndarray], eps: np.ndarray,
                 eps_internal: np.ndarray, guaranteed: bool = False,
                 want: Optional[Tuple[str, ...]] = None,
                 state: Any = None,
                 degraded: Optional[np.ndarray] = None) -> None:
        self.spec = spec
        self.stats = stats
        self.guaranteed = guaranteed
        self._r = result
        self._driver_stats = driver_stats
        self._inputs = inputs
        self._state = state
        b, m, n = spec.batch_shape(inputs) if inputs else (0, 0, 0)
        self.batch = int(stats.batch)
        self.padded_shape = (int(m), int(n))
        if sizes is None:
            sizes = np.stack(
                [np.full((self.batch,), m, np.int32),
                 np.full((self.batch,), n, np.int32)], axis=1)
        self.sizes = np.asarray(sizes, np.int32)
        self._degraded = (None if degraded is None
                          else np.asarray(degraded, bool)[:self.batch])
        self.eps = np.asarray(eps, np.float64)
        self.eps_internal = np.asarray(eps_internal, np.float64)
        self.want = None if want is None else tuple(want)
        if self.want is not None:
            unknown = [w for w in self.want if w not in spec.artifacts]
            if unknown:
                raise ValueError(
                    f"unknown artifact(s) {unknown} for spec "
                    f"{spec.name!r}; available: {spec.artifacts}")
        self._host: Dict[str, Dict[str, np.ndarray]] = {}
        self._sparse: Optional[SparsePlanBatch] = None
        self._plan_dense: Optional[np.ndarray] = None
        self._derived: Dict[str, np.ndarray] = {}
        self._prune_unwanted()

    def _prune_unwanted(self) -> None:
        """With a declared ``want``, drop the references to big device
        buffers the gating forbids reading (dense plan, flow matrices,
        and the cost inputs when ``duals`` is not declared)."""
        if self.want is None:
            return
        r = self._r
        kw = {}
        if ("plan" not in self.want and "plan_sparse" not in self.want
                and getattr(r, "plan", None) is not None):
            kw["plan"] = None
        if "state" not in self.want:
            self._state = None
            if getattr(r, "state", None) is not None:
                kw["state"] = None
        if kw and hasattr(r, "_replace"):
            self._r = r._replace(**kw)
        if "duals" not in self.want:
            self._inputs = None

    # -- fetch machinery ----------------------------------------------

    def _check(self, name: str) -> None:
        if self.want is not None and name not in self.want:
            raise ArtifactNotRequested(
                f"artifact {name!r} was not requested: this solve declared "
                f"want={self.want}; add {name!r} to fetch it")

    def _fetch(self, name: str) -> Dict[str, np.ndarray]:
        """Host arrays for one artifact, fetched at most once, under a
        ``solution.fetch`` span."""
        cached = self._host.get(name)
        if cached is None:
            with _tracing.root("solution.fetch") as sp:
                if sp is not None:
                    sp.attrs["artifact"] = name
                dev = self.spec.artifact_device(name, self._r, self._state)
                cached = {k: host_numpy("fetch", v) for k, v in dev.items()}
            self._host[name] = cached
        return cached

    def _sizes_t(self, col: int) -> torch.Tensor:
        return torch.as_tensor(self.sizes[:, col],
                               device=self._inputs["c"].device)

    @property
    def driver_stats(self) -> Any:
        """The raw driver stats (CompactionStats; None for lockstep)."""
        return self._driver_stats

    @property
    def fetched_bytes(self) -> int:
        """Device->host bytes materialized by this batch so far."""
        total = 0
        for group in self._host.values():
            total += sum(int(a.nbytes) for a in group.values())
        if self._sparse is not None:
            total += self._sparse.nbytes
        total += sum(int(a.nbytes) for a in self._derived.values())
        return total

    # -- batch-level artifact accessors -------------------------------

    def cost(self) -> np.ndarray:
        self._check("cost")
        return self._fetch("cost")["cost"][:self.batch]

    def degraded(self) -> np.ndarray:
        """(B,) bool: lanes whose chunk loop was cut by a deadline before
        their termination predicate fired. A degraded lane's answer is
        still primal-feasible with eps-feasible duals (invariant I2 holds
        at every phase), so its certificates stay valid; only its
        ``additive_gap()`` is larger. Not gated by ``want``: O(B) bools
        known at dispatch time."""
        if self._degraded is None:
            return np.zeros((self.batch,), bool)
        return self._degraded

    def phases(self) -> np.ndarray:
        return self._fetch("scalars")["phases"][:self.batch]

    def rounds(self) -> np.ndarray:
        return self._fetch("scalars")["rounds"][:self.batch]

    def theta(self) -> np.ndarray:
        sc = self._fetch("scalars")
        if "theta" not in sc:
            raise AttributeError(f"spec {self.spec.name!r} has no theta")
        return sc["theta"][:self.batch]

    def duals(self) -> Tuple[np.ndarray, np.ndarray]:
        """((B, M), (B, N)) scaled approximate duals (padded shapes)."""
        self._check("duals")
        d = self._fetch("duals")
        return d["y_b"][:self.batch], d["y_a"][:self.batch]

    def matching(self) -> np.ndarray:
        self._check("matching")
        return self._fetch("matching")["matching"][:self.batch]

    def plan(self) -> np.ndarray:
        """(B, M, N) dense plans; prefer :meth:`plan_sparse`."""
        self._check("plan")
        if self._plan_dense is None:
            self._plan_dense = self.spec.artifact_plan_dense(
                self._fetch("plan"), self.batch, self.padded_shape)
        return self._plan_dense

    def plan_sparse(self) -> SparsePlanBatch:
        """Batched COO plans at the pow2 capacity of the largest support."""
        self._check("plan_sparse")
        if self._sparse is None:
            with _tracing.root("solution.fetch") as sp:
                if sp is not None:
                    sp.attrs["artifact"] = "plan_sparse"
                self._sparse = self.spec.artifact_plan_sparse(
                    self._r, self._fetch, self.batch, self.padded_shape)
        return self._sparse

    def state(self) -> Any:
        """The integer pre-completion state (batched, padded bucket shape)."""
        self._check("state")
        st = self.spec.artifact_state(self._r, self._state)
        if st is None:
            raise ArtifactNotRequested(
                "pre-completion state was not retained by this dispatch; "
                "request it up front with want=('state', ...)")
        return st

    # -- certificates (device-side reductions) ------------------------

    def scale(self) -> np.ndarray:
        """(B,) max cost over each valid block: the rescaling factor the
        additive bounds are stated against. Requires ``"duals"``."""
        self._check("duals")
        if "scale" not in self._derived:
            with _tracing.root("solution.certificate") as sp:
                if sp is not None:
                    sp.attrs["certificate"] = "scale"
                self._derived["scale"] = host_numpy("fetch", _masked_max(
                    self._inputs["c"], self._sizes_t(0),
                    self._sizes_t(1)))[:self.batch]
        return self._derived["scale"]

    def dual_objective(self) -> np.ndarray:
        """(B,) dual objective: sum(y) for assignment, <nu, y_b> +
        <mu, y_a> for OT; >= OPT - eps * m * scale."""
        self._check("duals")
        if "dual_objective" not in self._derived:
            with _tracing.root("solution.certificate") as sp:
                if sp is not None:
                    sp.attrs["certificate"] = "dual_objective"
                mv, nv = self._sizes_t(0), self._sizes_t(1)
                y_b, y_a = self._r.y_b, self._r.y_a
                if "nu" in self._inputs:
                    obj = _dual_obj_ot(y_b, y_a, self._inputs["nu"],
                                       self._inputs["mu"], mv, nv)
                else:
                    obj = _dual_obj_assignment(y_b, y_a, mv, nv)
                self._derived["dual_objective"] = host_numpy(
                    "fetch", obj)[:self.batch]
        return self._derived["dual_objective"]

    def mass(self) -> np.ndarray:
        """(B,) total supply mass (rows for assignment, sum(nu) for OT).
        Requires ``"duals"``."""
        self._check("duals")
        if "mass" not in self._derived:
            with _tracing.root("solution.certificate") as sp:
                if sp is not None:
                    sp.attrs["certificate"] = "mass"
                if "nu" in self._inputs:
                    self._derived["mass"] = host_numpy("fetch", _masked_sum(
                        self._inputs["nu"], self._sizes_t(0)))[:self.batch]
                else:
                    self._derived["mass"] = self.sizes[
                        :self.batch, 0].astype(np.float64)
        return self._derived["mass"]

    def additive_gap(self) -> np.ndarray:
        """(B,) a-posteriori primal-dual gap ``cost - dual_objective``;
        under ``guaranteed=True`` it is <= eps * m * scale."""
        return self.cost().astype(np.float64) - self.dual_objective()

    def additive_gap_bound(self) -> np.ndarray:
        """(B,) the paper's bound ``eps * m * scale``."""
        return self.eps[:self.batch] * self.mass() * self.scale()

    def dual_feasible(self, tol: float = 1e-5) -> np.ndarray:
        """(B,) bool: y(b) + y(a) <= c + eps * scale on every live edge
        (invariant I2), ``tol`` absorbing the f32 scaling."""
        self._check("duals")
        with _tracing.root("solution.certificate") as sp:
            if sp is not None:
                sp.attrs["certificate"] = "dual_feasible"
            c = self._inputs["c"]
            if "mu" in self._inputs:
                # only columns with demand carry copies and hence
                # constraints
                live = self._inputs["mu"] > 0
            else:
                live = torch.ones((c.shape[0], c.shape[2]),
                                  dtype=torch.bool, device=c.device)
            margin = host_numpy("fetch", _feasibility_margin(
                c, self._r.y_b, self._r.y_a,
                self._sizes_t(0), self._sizes_t(1), live))
            slack = (self.eps_internal[:self.batch] * self.scale()
                     + tol * np.maximum(self.scale(), 1.0))
            return margin[:self.batch] <= slack

    # -- per-instance views --------------------------------------------

    def __len__(self) -> int:
        return self.batch

    def __getitem__(self, j: int) -> "Solution":
        if not (0 <= j < self.batch):
            raise IndexError(j)
        return Solution(self, j)

    def __iter__(self) -> Iterator["Solution"]:
        return (self[j] for j in range(self.batch))


class Solution:
    """One instance's view into a :class:`SolutionBatch`, trimmed to its
    true (m, n) inside the padded bucket."""

    def __init__(self, batch: SolutionBatch, j: int) -> None:
        self._b = batch
        self._j = j
        self.shape: Tuple[int, int] = (int(batch.sizes[j, 0]),
                                       int(batch.sizes[j, 1]))

    @property
    def spec_name(self) -> str:
        return self._b.spec.name

    @property
    def eps(self) -> float:
        return float(self._b.eps[self._j])

    @property
    def stats(self) -> SolveStats:
        return self._b.stats

    @property
    def degraded(self) -> bool:
        """True when this lane was cut by a deadline; re-validate with
        ``dual_feasible()`` / ``additive_gap()`` (still sound)."""
        return bool(self._b.degraded()[self._j])

    @property
    def cost(self) -> float:
        return float(self._b.cost()[self._j])

    @property
    def phases(self) -> int:
        return int(self._b.phases()[self._j])

    @property
    def rounds(self) -> int:
        return int(self._b.rounds()[self._j])

    @property
    def theta(self) -> float:
        return float(self._b.theta()[self._j])

    def duals(self) -> Tuple[np.ndarray, np.ndarray]:
        mi, ni = self.shape
        y_b, y_a = self._b.duals()
        return y_b[self._j, :mi], y_a[self._j, :ni]

    def matching(self) -> np.ndarray:
        mi, _ = self.shape
        return self._b.matching()[self._j, :mi]

    def plan(self) -> np.ndarray:
        mi, ni = self.shape
        return self._b.plan()[self._j, :mi, :ni]

    def plan_sparse(self) -> SparsePlan:
        return self._b.plan_sparse().instance(self._j, self.shape)

    def state(self) -> Any:
        """This instance's integer state (leaves at the padded shape)."""
        return tree_map(lambda a: a[self._j], self._b.state())

    def dual_objective(self) -> float:
        return float(self._b.dual_objective()[self._j])

    def additive_gap(self) -> float:
        return float(self._b.additive_gap()[self._j])

    def additive_gap_bound(self) -> float:
        return float(self._b.additive_gap_bound()[self._j])

    def dual_feasible(self, tol: float = 1e-5) -> bool:
        return bool(self._b.dual_feasible(tol)[self._j])

    def legacy_dict(self) -> Dict[str, Any]:
        """The per-instance dict of the reference's ragged front end."""
        out = self._b.spec.legacy_instance_dict(self)
        out["batch_size"] = self._b.batch
        if self._b.stats.bucket is not None:
            out["bucket"] = self._b.stats.bucket
        st = self._b._driver_stats
        if st is not None:
            out["dispatches"] = st.dispatches
        if self.degraded:
            # absent on every non-degraded result, as in the reference
            out["degraded"] = True
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"Solution({self.spec_name}, shape={self.shape}, "
                f"eps={self.eps}, mode={self.stats.mode!r})")


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the certificate reductions. The
# "certificate" tag turns on the strict dtype rules (no Python float
# literals, f32 sums reported): a certificate computed in a drifted dtype
# is the device-threshold bug applied to the paper's additive-gap bound
# instead of the solver loop.
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _certificate_specs():
    b, m, n = 2, 4, 4
    c = torch.zeros((b, m, n), dtype=torch.float32)
    y_b = torch.zeros((b, m), dtype=torch.float32)
    y_a = torch.zeros((b, n), dtype=torch.float32)
    nu = torch.full((b, m), 0.25, dtype=torch.float32)
    mu = torch.full((b, n), 0.25, dtype=torch.float32)
    mv = torch.full((b,), m, dtype=torch.int32)
    nv = torch.full((b,), n, dtype=torch.int32)
    live = torch.ones((b, n), dtype=torch.bool)
    plan = torch.zeros((b, m, n), dtype=torch.float32)
    mk = lambda name, fn, args: _audit.EntrySpec(  # noqa: E731
        name=name,
        build=lambda: _audit.trace_entry(
            name=name, fn=fn, args=args, tags={"certificate"},
            source=__name__),
        source=__name__,
    )
    return [
        mk("core.solution._masked_max", _masked_max,
           {"c": c, "m_valid": mv, "n_valid": nv}),
        mk("core.solution._dual_obj_assignment", _dual_obj_assignment,
           {"y_b": y_b, "y_a": y_a, "m_valid": mv, "n_valid": nv}),
        mk("core.solution._dual_obj_ot", _dual_obj_ot,
           {"y_b": y_b, "y_a": y_a, "nu": nu, "mu": mu,
            "m_valid": mv, "n_valid": nv}),
        mk("core.solution._feasibility_margin", _feasibility_margin,
           {"c": c, "y_b": y_b, "y_a": y_a, "m_valid": mv, "n_valid": nv,
            "col_live": live}),
        mk("core.solution._masked_sum", _masked_sum,
           {"v": y_b, "valid": mv}),
        mk("core.solution._count_nnz", _count_nnz, {"plan": plan}),
    ]


for _es in _certificate_specs():
    _audit.register(_es.name, _es.build, source=_es.source)
del _es
