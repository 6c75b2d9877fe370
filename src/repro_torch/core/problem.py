"""ProblemSpec: the stepped-core contract shared by assignment and OT.

Port of ``repro.core.problem``. Both solvers share one skeleton: scale and
round the instance to integers, run phases until the free supply drops
below a termination threshold, then complete and price the result. Each
driver (lockstep, convergence compaction) is written once against this
contract and bound to a problem by a spec object:

  ``prepare``     host-side batch prep: padding masks, per-instance
                  eps/theta, the host-float64 termination thresholds
                  (``int(eps * m)`` for Algorithm 1, ``int(eps *
                  sum(s_int))`` for Algorithm 2), phase caps, and
                  power-of-two batch padding with born-converged lanes.
  ``prologue``    scaling and rounding to the integer instance; returns
                  ``(data, ctx)``: ``data`` feeds the phases, ``ctx`` the
                  epilogue.
  ``init_state``  all supply free, y(b) = 1 unit, y(a) = 0, zero flow.
  ``run_phases``  at most k phases; chaining is exact for any k.
  ``converged``   free supply <= threshold, or the phase cap hit.
  ``epilogue``    completion and pricing.

Unlike the reference, the per-instance functions take the batch axis
directly (the reference ``vmap``s them). ``FUSED_ASSIGNMENT`` /
``FUSED_OT`` are the same specs with ``run_phases`` on the fused kernels
(``fused_variant`` maps one to the other); the sharded hooks of the
reference specs wait for a later slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Protocol, Tuple

import numpy as np
import torch

from ..kernels import ops
from .device import as_f32, resolve_device
from .pushrelabel import (
    AssignmentResult,
    PushRelabelState,
    _max_phases,
    assignment_converged,
    assignment_epilogue,
    assignment_prologue,
    init_assignment_state,
    run_assignment_phases,
)
from .transport import (
    OTResult,
    OTState,
    init_ot_state,
    ot_converged,
    ot_epilogue,
    ot_phase_cap,
    ot_prologue,
    run_ot_phases,
)


def pow2_at_least(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a NamedTuple / dict / tensor tree;
    other leaves (None, floats) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def eps_array(eps, b: int, guaranteed: bool) -> np.ndarray:
    """(b,) host-float64 per-instance eps (the /3 of the guaranteed bound
    applied); shared by every driver so the scaling can never diverge."""
    arr = np.broadcast_to(np.asarray(eps, np.float64), (b,)).copy()
    if guaranteed:
        arr = arr / 3.0
    if (arr <= 0).any():
        raise ValueError("eps must be positive")
    return arr


class PreparedBatch(NamedTuple):
    """Output of ``prepare``: device operands with the (bp,) dispatched
    batch leading, plus host copies of the per-lane thresholds/caps."""
    ops: Dict[str, Any]        # operands for the prologue (device tensors)
    threshold: np.ndarray      # (bp,) int32 host-float64-derived
    phase_cap: np.ndarray      # (bp,) int32 safety bound per lane
    bp: int                    # dispatched batch (power of two)


class ProblemSpec(Protocol):
    """The stepped-core contract (see the module docstring); every
    function takes the batch axis in front. Implementations are
    stateless. The reference's matrix-placement hooks (``matrix_instance``
    / ``matrix_stack``) wait for multi-device dispatch (ROADMAP.md Queue
    1 item 11)."""
    name: str
    # ``ops`` entries the epilogue consumes verbatim (merged into ctx by
    # the drivers instead of passing through the prologue)
    ctx_ops: Tuple[str, ...]
    # artifacts of the Solution surface, and whether the result already
    # carries the pre-completion state
    artifacts: Tuple[str, ...]
    state_on_result: bool

    def canonicalize(self, inputs: Dict[str, Any],
                     device=None) -> Dict[str, Any]: ...
    def batch_shape(self, inputs: Dict[str, Any]) -> Tuple[int, int, int]: ...
    def prepare(self, inputs, eps, *, sizes=None, guaranteed: bool = False,
                min_batch: int = 1, **kw) -> PreparedBatch: ...
    def prologue(self, ops: Dict[str, Any]): ...
    def init_state(self, data: Dict[str, Any], ctx: Dict[str, Any]): ...
    def run_phases(self, data: Dict[str, Any], state, k: int): ...
    def converged(self, data: Dict[str, Any], state): ...
    def epilogue(self, ctx: Dict[str, Any], state): ...
    def empty_result(self, m: int, n: int, device=None): ...
    def trim(self, r, b: int): ...
    def instance_shape(self, inst) -> Tuple[int, int]: ...
    def pad_group(self, insts, key) -> Dict[str, Any]: ...
    def solve_lockstep(self, inputs, eps: float, *, sizes=None,
                       guaranteed: bool = False, keep_state: bool = False,
                       device=None, **kw): ...
    def artifact_device(self, name: str, r, state) -> Dict[str, Any]: ...
    def artifact_plan_dense(self, host: Dict[str, np.ndarray], batch: int,
                            shape: Tuple[int, int]) -> np.ndarray: ...
    def artifact_plan_sparse(self, r, fetch, batch: int,
                             shape: Tuple[int, int]): ...
    def artifact_state(self, r, state): ...
    def legacy_instance_dict(self, sol) -> Dict[str, Any]: ...


def _sizes_arrays(sizes, b, m, n):
    """Host-side (B,) m_valid / n_valid arrays (full shape when None)."""
    if sizes is None:
        return (np.full((b,), m, np.int32), np.full((b,), n, np.int32))
    sizes = np.asarray(sizes, np.int32)
    if sizes.shape != (b, 2):
        raise ValueError(f"sizes must be ({b}, 2), got {sizes.shape}")
    if (sizes[:, 0] > m).any() or (sizes[:, 1] > n).any():
        raise ValueError("instance size exceeds padded bucket shape")
    return sizes[:, 0].copy(), sizes[:, 1].copy()


def _theta_array(sizes_m, sizes_n, eps, theta) -> np.ndarray:
    """Per-instance theta = 4*max(m, n)/eps in host float64, cast to f32
    (bit-identical to the unbatched default). ``eps`` scalar or (B,)."""
    if theta is not None:
        return np.broadcast_to(np.asarray(theta, np.float32),
                               sizes_m.shape).copy()
    eps = np.asarray(eps, np.float64)
    return (4.0 * np.maximum(sizes_m, sizes_n) / eps).astype(np.float32)


def _mask_ot_inputs(c, nu, mu, m_valid, n_valid, theta, eps):
    """Zero mass/cost outside each instance's block and compute the
    per-instance thresholds in host float64 from the masked masses,
    exactly as the unbatched ``ot_termination_threshold``."""
    b, m, n = c.shape
    dev = c.device
    row_ok = np.arange(m)[None, :] < m_valid[:, None]
    col_ok = np.arange(n)[None, :] < n_valid[:, None]
    eps_b = np.broadcast_to(np.asarray(eps, np.float64), (b,))
    nu_h = np.where(row_ok, nu.cpu().numpy(), np.float32(0.0))
    s_rows = np.floor(nu_h * np.asarray(theta, np.float32)[:, None])
    thr = (eps_b * s_rows.sum(axis=1, dtype=np.float64)).astype(np.int64) \
        .astype(np.int32)
    rok = torch.as_tensor(row_ok, device=dev)
    cok = torch.as_tensor(col_ok, device=dev)
    c = torch.where(rok[:, :, None] & cok[:, None, :], c, 0.0)
    nu = torch.where(rok, nu, 0.0)
    mu = torch.where(cok, mu, 0.0)
    return c, nu, mu, thr


def _pad_lanes(bp: int, b: int, arrays: Dict[str, Any], device,
               fills: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Move every (b, ...) array to ``device`` and pad it to ``bp`` lanes
    (born-converged empty instances: zero valid rows / zero mass). ``fills``
    overrides the pad value per key: eps/theta stay nonzero so the
    prologue's divisions remain finite."""
    out = {}
    for k, a in arrays.items():
        t = torch.as_tensor(a, device=device)
        if bp > b:
            fill = (fills or {}).get(k, 0)
            pad = torch.full((bp - b,) + tuple(t.shape[1:]), fill,
                             dtype=t.dtype, device=device)
            t = torch.cat([t, pad])
        out[k] = t
    return out


# --------------------------------------------------------------------------
# Assignment (paper Algorithm 1)
# --------------------------------------------------------------------------

class BatchedAssignmentResult(NamedTuple):
    matching: torch.Tensor   # (B, M) int32, -1 beyond each instance's rows
    cost: torch.Tensor       # (B,) float32
    y_b: torch.Tensor        # (B, M) float32 scaled duals
    y_a: torch.Tensor        # (B, N) float32 scaled duals
    phases: torch.Tensor     # (B,) int32
    rounds: torch.Tensor     # (B,) int32
    matched_before_completion: torch.Tensor  # (B,) int32


class AssignmentSpec:
    """ProblemSpec of the assignment solver (Algorithm 1)."""

    name = "assignment"

    def canonicalize(self, inputs, device=None):
        """The operands as contiguous f32 tensors on ``device`` (None:
        CUDA, raising without it)."""
        dev = resolve_device(device)
        c = as_f32(inputs["c"], dev)
        if c.ndim != 3:
            raise ValueError(f"expected (B, M, N) costs, got shape "
                             f"{tuple(c.shape)}")
        return {"c": c}

    def batch_shape(self, inputs):
        return tuple(inputs["c"].shape)

    def prepare(self, inputs, eps, *, sizes=None, guaranteed: bool = False,
                min_batch: int = 1) -> PreparedBatch:
        """Padding masks, host-float64 thresholds ``int(eps * m)``, phase
        caps, and padding of the batch to ``max(pow2(B), min_batch)``."""
        c = inputs["c"]
        b, m, n = c.shape
        m_valid, n_valid = _sizes_arrays(sizes, b, m, n)
        eps_arr = eps_array(eps, b, guaranteed)
        threshold = np.asarray(
            [int(e * int(mi)) for e, mi in zip(eps_arr, m_valid)], np.int32)
        phase_cap = np.asarray([_max_phases(float(e), m) for e in eps_arr],
                               np.int32)
        bp = max(pow2_at_least(b), pow2_at_least(min_batch))
        ops = _pad_lanes(bp, b, {
            "c": c, "eps": eps_arr.astype(np.float32),
            "m_valid": m_valid, "n_valid": n_valid,
            "threshold": threshold, "phase_cap": phase_cap,
        }, c.device, fills={"eps": float(np.float32(eps_arr[0]))})
        thr = np.concatenate([threshold, np.zeros(bp - b, np.int32)])
        cap = np.concatenate([phase_cap, np.zeros(bp - b, np.int32)])
        return PreparedBatch(ops=ops, threshold=thr, phase_cap=cap, bp=bp)

    ctx_ops = ("eps",)

    def prologue(self, ops):
        cm, c_int, scale, row_ok, col_ok = assignment_prologue(
            ops["c"], ops["eps"], ops["m_valid"], ops["n_valid"])
        data = {"c_int": c_int, "threshold": ops["threshold"],
                "phase_cap": ops["phase_cap"], "m_valid": ops["m_valid"]}
        ctx = {"cm": cm, "scale": scale, "row_ok": row_ok, "col_ok": col_ok}
        return data, ctx

    def init_state(self, data, ctx) -> PushRelabelState:
        b, m, n = data["c_int"].shape
        return init_assignment_state(b, m, n, data["c_int"].device)

    def run_phases(self, data, state, k: int):
        return run_assignment_phases(
            data["c_int"], state, data["threshold"], data["phase_cap"], k,
            m_valid=data["m_valid"])

    def converged(self, data, state):
        return assignment_converged(state, data["threshold"],
                                    data["phase_cap"],
                                    m_valid=data["m_valid"])

    def epilogue(self, ctx, state) -> AssignmentResult:
        return assignment_epilogue(ctx["cm"], ctx["scale"], state,
                                   ctx["eps"], ctx["row_ok"], ctx["col_ok"])

    # -- result shaping ------------------------------------------------

    def empty_result(self, m: int, n: int, device=None):
        def z(*s):
            return torch.zeros(s, dtype=torch.float32, device=device)

        def zi(*s):
            return torch.zeros(s, dtype=torch.int32, device=device)
        return BatchedAssignmentResult(
            matching=zi(0, m), cost=z(0), y_b=z(0, m), y_a=z(0, n),
            phases=zi(0), rounds=zi(0), matched_before_completion=zi(0))

    def trim(self, r, b: int):
        return BatchedAssignmentResult(
            matching=r.matching[:b], cost=r.cost[:b], y_b=r.y_b[:b],
            y_a=r.y_a[:b], phases=r.phases[:b], rounds=r.rounds[:b],
            matched_before_completion=r.matched_before_completion[:b])

    # -- ragged front door / lockstep ----------------------------------

    def instance_shape(self, inst):
        return tuple(np.shape(inst))

    def pad_group(self, insts, key):
        from .batched import pad_stack

        return {"c": pad_stack(list(insts), key)}

    def solve_lockstep(self, inputs, eps: float, *, sizes=None,
                       guaranteed: bool = False, keep_state: bool = False,
                       device=None):
        from .batched import solve_lockstep

        return solve_lockstep(self, inputs, eps, sizes=sizes,
                              guaranteed=guaranteed, keep_state=keep_state,
                              device=device)

    # -- per-artifact producers ----------------------------------------

    artifacts = ("cost", "duals", "matching", "plan", "plan_sparse",
                 "state", "stats")
    state_on_result = False

    def artifact_device(self, name, r, state):
        if name == "cost":
            return {"cost": r.cost}
        if name == "scalars":
            return {"phases": r.phases, "rounds": r.rounds}
        if name == "duals":
            return {"y_b": r.y_b, "y_a": r.y_a}
        if name in ("matching", "plan"):
            # the dense plan is derived from the matching on the host
            return {"matching": r.matching}
        raise KeyError(name)

    def artifact_plan_dense(self, host, batch, shape):
        m, n = shape
        matching = host["matching"][:batch]
        out = np.zeros((batch, m, n), np.float32)
        b_idx, r_idx = np.nonzero(matching >= 0)
        out[b_idx, r_idx, matching[b_idx, r_idx]] = 1.0
        return out

    def artifact_plan_sparse(self, r, fetch, batch, shape):
        from .solution import SparsePlanBatch

        m, n = shape
        matching = fetch("matching")["matching"][:batch].astype(np.int64)
        valid = matching >= 0
        nnz = valid.sum(axis=1).astype(np.int32)
        k = min(pow2_at_least(int(nnz.max(initial=1))), max(m * n, 1))
        idx = np.full((batch, k), m * n, np.int32)
        vals = np.zeros((batch, k), np.float32)
        for j in range(batch):
            rows = np.flatnonzero(valid[j])
            idx[j, :rows.size] = rows * n + matching[j, rows]
            vals[j, :rows.size] = 1.0
        return SparsePlanBatch(idx=idx, vals=vals, nnz=nnz,
                               shape=(int(m), int(n)))

    def artifact_state(self, r, state):
        return state

    def legacy_instance_dict(self, sol):
        y_b, y_a = sol.duals()
        return {"matching": sol.matching(), "cost": sol.cost,
                "phases": sol.phases, "rounds": sol.rounds,
                "y_b": y_b, "y_a": y_a}


# --------------------------------------------------------------------------
# General OT (paper Algorithm 2)
# --------------------------------------------------------------------------

class OTSpec:
    """ProblemSpec of the general OT solver (Algorithm 2)."""

    name = "ot"

    def canonicalize(self, inputs, device=None):
        """The operands as contiguous f32 tensors on ``device`` (None:
        CUDA, raising without it)."""
        dev = resolve_device(device)
        c = as_f32(inputs["c"], dev)
        if c.ndim != 3:
            raise ValueError(f"expected (B, M, N) costs, got shape "
                             f"{tuple(c.shape)}")
        return {"c": c, "nu": as_f32(inputs["nu"], dev),
                "mu": as_f32(inputs["mu"], dev)}

    def batch_shape(self, inputs):
        return tuple(inputs["c"].shape)

    def prepare(self, inputs, eps, *, sizes=None, guaranteed: bool = False,
                min_batch: int = 1, theta=None) -> PreparedBatch:
        """Masks, host-float64 thresholds (shared with the lockstep path
        through ``_mask_ot_inputs``), phase caps, pow2 batch padding."""
        c, nu, mu = inputs["c"], inputs["nu"], inputs["mu"]
        b, m, n = c.shape
        m_valid, n_valid = _sizes_arrays(sizes, b, m, n)
        eps_arr = eps_array(eps, b, guaranteed)
        th = _theta_array(m_valid, n_valid, eps_arr, theta)
        phase_cap = np.asarray([ot_phase_cap(float(e)) for e in eps_arr],
                               np.int32)
        c, nu, mu, threshold = _mask_ot_inputs(c, nu, mu, m_valid, n_valid,
                                               th, eps_arr)
        bp = max(pow2_at_least(b), pow2_at_least(min_batch))
        ops = _pad_lanes(bp, b, {
            "c": c, "nu": nu, "mu": mu,
            "eps": eps_arr.astype(np.float32), "theta": th,
            "threshold": threshold, "phase_cap": phase_cap,
        }, c.device, fills={"eps": float(np.float32(eps_arr[0])),
                            "theta": 1.0})
        thr = np.concatenate([threshold, np.zeros(bp - b, np.int32)])
        cap = np.concatenate([phase_cap, np.zeros(bp - b, np.int32)])
        return PreparedBatch(ops=ops, threshold=thr, phase_cap=cap, bp=bp)

    ctx_ops = ("c", "nu", "mu", "theta", "eps")

    def prologue(self, ops):
        c_int, s_int, d_int, scale = ot_prologue(
            ops["c"], ops["nu"], ops["mu"], ops["theta"], ops["eps"])
        data = {"c_int": c_int, "threshold": ops["threshold"],
                "phase_cap": ops["phase_cap"]}
        ctx = {"scale": scale, "s_int": s_int, "d_int": d_int}
        return data, ctx

    def init_state(self, data, ctx) -> OTState:
        return init_ot_state(ctx["s_int"], ctx["d_int"])

    def run_phases(self, data, state, k: int):
        _, m, n = data["c_int"].shape
        return run_ot_phases(data["c_int"], state, data["threshold"],
                             data["phase_cap"], k, int(m + n + 2))

    def converged(self, data, state):
        return ot_converged(state, data["threshold"], data["phase_cap"])

    def epilogue(self, ctx, state) -> OTResult:
        return ot_epilogue(ctx["c"], ctx["nu"], ctx["mu"], ctx["theta"],
                           ctx["eps"], ctx["scale"], ctx["s_int"],
                           ctx["d_int"], state)

    # -- result shaping ------------------------------------------------

    def empty_result(self, m: int, n: int, device=None):
        def zf(*s):
            return torch.zeros(s, dtype=torch.float32, device=device)

        def zi(*s):
            return torch.zeros(s, dtype=torch.int32, device=device)
        return OTResult(
            plan=zf(0, m, n), cost=zf(0), y_b=zf(0, m), y_a=zf(0, n),
            phases=zi(0), rounds=zi(0),
            state=OTState(y_b=zi(0, m), ya_hi=zi(0, n), free_b=zi(0, m),
                          free_a=zi(0, n), f_hi=zi(0, m, n),
                          f_lo=zi(0, m, n), phases=zi(0), rounds=zi(0)),
            theta=zf(0), s_int=zi(0, m), d_int=zi(0, n))

    def trim(self, r, b: int):
        return tree_map(lambda a: a[:b], r)

    # -- ragged front door / lockstep ----------------------------------

    def instance_shape(self, inst):
        return tuple(np.shape(inst[0]))

    def pad_group(self, insts, key):
        from .batched import pad_stack

        mb, nb = key
        return {"c": pad_stack([c for c, _, _ in insts], (mb, nb)),
                "nu": pad_stack([nu for _, nu, _ in insts], (mb,)),
                "mu": pad_stack([mu for _, _, mu in insts], (nb,))}

    def solve_lockstep(self, inputs, eps: float, *, sizes=None,
                       guaranteed: bool = False, keep_state: bool = False,
                       theta=None, device=None):
        from .batched import solve_lockstep

        r, _ = solve_lockstep(self, inputs, eps, sizes=sizes,
                              guaranteed=guaranteed, theta=theta,
                              device=device)
        # the OT result already carries its pre-completion state
        return (r, r.state) if keep_state else (r, None)

    # -- per-artifact producers ----------------------------------------

    artifacts = ("cost", "duals", "plan", "plan_sparse", "state", "stats")
    state_on_result = True

    def artifact_device(self, name, r, state):
        if name == "cost":
            return {"cost": r.cost}
        if name == "scalars":
            return {"phases": r.phases, "rounds": r.rounds,
                    "theta": r.theta}
        if name == "duals":
            return {"y_b": r.y_b, "y_a": r.y_a}
        if name == "plan":
            return {"plan": r.plan}
        raise KeyError(name)

    def artifact_plan_dense(self, host, batch, shape):
        return host["plan"][:batch]

    def artifact_plan_sparse(self, r, fetch, batch, shape):
        from .solution import sparse_from_dense_device

        # compacted on the device: only the COO triplets cross to the host
        return sparse_from_dense_device(r.plan, batch)

    def artifact_state(self, r, state):
        return state if state is not None else r.state

    def legacy_instance_dict(self, sol):
        return {"plan": sol.plan(), "cost": sol.cost, "phases": sol.phases,
                "rounds": sol.rounds, "theta": sol.theta}


# --------------------------------------------------------------------------
# Fused-kernel spec variants
# --------------------------------------------------------------------------
#
# Same protocol, prologue, epilogue and result surface; only ``run_phases``
# differs: it launches one fused kernel per chunk (``kernels/ops.py``,
# ``csrc/fused_*.cu``) that runs the phase and round loops on the card,
# instead of the stepped cores' launches and host reads per round. The
# fused kernels equal the stepped cores bit for bit, so chained
# resumability, lockstep == compact and padded-lane inertness carry over.
# ``name`` stays "assignment" / "ot", so result shaping and bucketing
# treat them as the same problem; ``stepped`` points back at the base
# spec.


class FusedAssignmentSpec(AssignmentSpec):
    """AssignmentSpec whose k-phase loop is the fused kernel."""

    fused = True

    def run_phases(self, data, state, k: int):
        return ops.fused_run_assignment_phases(
            data["c_int"], state, data["threshold"], data["phase_cap"], k,
            m_valid=data["m_valid"])

    def _lockstep_k(self, eps_arr, m: int) -> int:
        return max(_max_phases(float(e), m) for e in eps_arr) + 1

    def solve_lockstep(self, inputs, eps: float, *, sizes=None,
                       guaranteed: bool = False, keep_state: bool = False,
                       device=None):
        return _fused_lockstep(self, inputs, eps, sizes=sizes,
                               guaranteed=guaranteed, keep_state=keep_state,
                               device=device)


class FusedOTSpec(OTSpec):
    """OTSpec whose k-phase loop is the fused kernel."""

    fused = True

    def run_phases(self, data, state, k: int):
        _, m, n = data["c_int"].shape
        return ops.fused_run_ot_phases(
            data["c_int"], state, data["threshold"], data["phase_cap"], k,
            int(m + n + 2))

    def _lockstep_k(self, eps_arr, m: int) -> int:
        return max(ot_phase_cap(float(e)) for e in eps_arr) + 1

    def solve_lockstep(self, inputs, eps: float, *, sizes=None,
                       guaranteed: bool = False, keep_state: bool = False,
                       theta=None, device=None):
        return _fused_lockstep(self, inputs, eps, sizes=sizes,
                               guaranteed=guaranteed, keep_state=keep_state,
                               device=device, theta=theta)


def _fused_lockstep(spec, inputs, eps, *, sizes, guaranteed, keep_state,
                    device, **prep_kw):
    """Lockstep for the fused specs: one compacting dispatch with k above
    every lane's phase cap, so the whole batch runs to termination in a
    single launch and no compaction ever fires. Returns ``(result, state
    or None)``."""
    from .compaction import solve_compacting

    b, m, _ = (int(s) for s in np.shape(inputs["c"]))
    k_all = spec._lockstep_k(eps_array(eps, b, guaranteed), m)
    r, stats = solve_compacting(
        spec, inputs, eps, sizes=sizes, k=k_all, guaranteed=guaranteed,
        keep_state=keep_state, device=device, **prep_kw)
    return r, (stats.final_state if keep_state else None)


ASSIGNMENT = AssignmentSpec()
OT = OTSpec()
FUSED_ASSIGNMENT = FusedAssignmentSpec()
FUSED_OT = FusedOTSpec()
FusedAssignmentSpec.stepped = ASSIGNMENT
FusedOTSpec.stepped = OT
AssignmentSpec.fused = False
OTSpec.fused = False


def fused_variant(spec):
    """Map a base spec to its fused-kernel variant (identity on the fused
    specs themselves). A spec defined elsewhere registers its own by a
    ``fused_spec`` attribute. Raises for a spec without one."""
    if getattr(spec, "fused", False):
        return spec
    if spec is ASSIGNMENT:
        return FUSED_ASSIGNMENT
    if spec is OT:
        return FUSED_OT
    alt = getattr(spec, "fused_spec", None)
    if alt is not None:
        return alt
    raise ValueError(f"no fused variant registered for spec {spec!r}")
