"""Hybrid solver: coarse Sinkhorn duals warm-start the push-relabel core.

Port of ``repro.portfolio.hybrid``. Sinkhorn's log-domain potentials
(f, g) on the normalized costs c_hat = c/max(c) price the same dual the
push-relabel integer duals live in (units of eps on the same
normalization). A cheap low-accuracy Sinkhorn run (eps clamped loose,
iteration-capped) gives an initial ``y_b`` that starts the push-relabel
solve closer to termination than the paper's cold y(b) = 1; the finish IS
the push-relabel solver, so the result keeps its <= OPT + eps * m bound.

Correctness does not rest on the Sinkhorn duals: ``round_duals`` clips
the rounded warm duals into the invariant polytope

    1 <= y_b(b) <= min_{a live} c_int(b, a) + 1          (I1 + I2, y_a = 0)

so every invariant the paper's analysis needs (``core/feasibility.py``)
holds by construction whatever stage 1 returned.

``WARM_OT`` is an OTSpec whose ``init_state`` seeds ``y_b`` from the
extra ``y_b0`` operand; it rides the compacting driver, lockstep
included, which forwards ``**prep_kw``.
"""
from __future__ import annotations

from dataclasses import replace as _dc_replace

import numpy as np
import torch

from ..core.compaction import DEFAULT_CHUNK, solve_compacting
from ..core.problem import OTSpec, PreparedBatch, _pad_lanes, eps_array
from ..core.transport import init_ot_state
from .sinkhorn_spec import SINKHORN

# Columns with no demand never constrain the row dual; stand-in "+inf"
# for the int32 min-reduction over live columns.
_INT_BIG = 2 ** 30
# Stage-1 accuracy/effort: the warm start needs direction, not
# convergence. eps is clamped to at least this ...
_COARSE_EPS = 0.25
# ... and the Sinkhorn sweep count is capped outright.
_WARM_ITERS = 64


def round_duals(c, mu, f, g, eps):
    """(B, m) int32 warm row duals from batched Sinkhorn potentials.
    ``c`` (B, m, n) f32, ``mu`` (B, n), ``f`` (B, m), ``g`` (B, n), ``eps``
    (B,) f32: the INTERNAL accuracy of the finishing solve (already
    divided by 3 under ``guaranteed``), the integer grid the push-relabel
    instance is rounded on.

    f, g live on c/scale, so f/eps is the natural rounding. The column
    potential is absorbed conservatively (g's max over live columns) and
    the result clipped to [1, min_live c_int + 1]; a lane with no live
    demand gets the cold-start value 1. ``c_int = floor(c / (scale *
    eps))`` as the reference's jitted program computes it (its source
    writes ``c / scale / eps``, which XLA rewrites; ROADMAP Queue 3)."""
    scale = c.amax(dim=(1, 2)).clamp_min(1e-30)
    c_int = torch.floor(c / (scale * eps)[:, None, None]).to(torch.int32)
    live = mu > 0
    any_live = live.any(dim=1)
    gmax = torch.where(live, g, float("-inf")).amax(dim=1)
    # a lane without live columns takes the cold value below; 0 keeps its
    # float -> int cast defined
    gmax = torch.where(any_live, gmax, 0.0)
    # clamped before the cast, which saturates like the reference's
    y_f = torch.floor((f + gmax[:, None]) / eps[:, None])
    y_raw = y_f.clamp(-_INT_BIG, _INT_BIG).to(torch.int32) + 1
    cap = torch.where(live[:, None, :], c_int, _INT_BIG).amin(dim=2) + 1
    y_b = torch.minimum(y_raw.clamp_min(1), cap)
    return torch.where(any_live[:, None], y_b, 1).to(torch.int32)


class _WarmOTSpec(OTSpec):
    """OTSpec whose initial state takes ``y_b`` from a ``y_b0`` operand
    (cold-start 1s when absent, so the spec degrades to plain OT)."""

    name = "warm_ot"

    def prepare(self, inputs, eps, *, sizes=None, guaranteed: bool = False,
                min_batch: int = 1, theta=None, y_b0=None) -> PreparedBatch:
        p = super().prepare(inputs, eps, sizes=sizes, guaranteed=guaranteed,
                            min_batch=min_batch, theta=theta)
        b, m, _ = inputs["c"].shape
        dev = inputs["c"].device
        if y_b0 is None:
            y_b0 = torch.ones((b, m), dtype=torch.int32, device=dev)
        elif isinstance(y_b0, torch.Tensor):
            y_b0 = y_b0.to(device=dev, dtype=torch.int32)
        else:
            y_b0 = torch.tensor(np.asarray(y_b0, np.int32), device=dev)
        ops_ = dict(p.ops)
        # padded lanes warm-start at the cold value (they are born
        # converged; the fill keeps the state invariant-clean)
        ops_.update(_pad_lanes(p.bp, b, {"y_b0": y_b0}, dev,
                               fills={"y_b0": 1}))
        return p._replace(ops=ops_)

    ctx_ops = OTSpec.ctx_ops + ("y_b0",)

    def init_state(self, data, ctx):
        st = init_ot_state(ctx["s_int"], ctx["d_int"])
        # a fresh copy: the phases update y_b in place, and ctx["y_b0"]
        # is kept for the epilogue's ctx
        return st._replace(y_b=ctx["y_b0"].clone())

    def matrix_instance(self, inputs, i, mi, ni, mp, np_, eps_i, mesh2,
                        row_axis, col_axis, **kw):
        # OTSpec's hook would solve from the cold start and drop y_b0
        raise NotImplementedError(
            "the warm-started finish supports batch placement only "
            "(dispatch_hybrid asks for it)")


WARM_OT = _WarmOTSpec()


def warm_duals(inputs, eps, *, sizes=None, guaranteed: bool = False,
               chunk=None, deadline=None, obs=None, device=None,
               warm_iters: int = _WARM_ITERS):
    """Stages 1 and 2 of the hybrid: a coarse iteration-capped Sinkhorn
    run (always compacting: it is the cheap stage), then the potentials
    rounded onto the finish solve's integer grid (the INTERNAL eps: /3
    under ``guaranteed``). ``inputs`` are canonicalized tensors;
    ``deadline`` cuts the Sinkhorn run like any compacting solve. Returns
    ``((B, m) int32 y_b0, the Sinkhorn run's CompactionStats)``."""
    b = int(inputs["c"].shape[0])
    eps_user = np.broadcast_to(np.asarray(eps, np.float64), (b,)).copy()
    _, st1 = solve_compacting(
        SINKHORN, inputs, np.maximum(eps_user, _COARSE_EPS), sizes=sizes,
        k=chunk or DEFAULT_CHUNK, keep_state=True, deadline=deadline,
        obs=obs, device=device, max_iters=warm_iters)
    warm = st1.final_state
    dev = inputs["c"].device
    eps_int = torch.as_tensor(eps_array(eps_user, b, guaranteed),
                              dtype=torch.float32, device=dev)
    # the rounding sees the canonical inputs; f/g outside a lane's valid
    # block are inert and the clip bounds them anyway
    return round_duals(inputs["c"], inputs["mu"], warm.f, warm.g,
                       eps_int), st1


def dispatch_hybrid(inputs, eps, *, sizes=None, policy=None,
                    keep_state: bool = False, deadline=None, obs=None,
                    device=None, theta=None,
                    warm_iters: int = _WARM_ITERS):
    """Solve one pre-batched OT bucket hybrid-style: ``warm_duals``, then
    the push-relabel finish (``WARM_OT``) dispatched under ``policy``'s
    mode and chunk with the warm ``y_b0``, on the stepped route (under
    a mesh, with batch placement). Returns
    ``(OTResult, stats)`` with the finish driver's stats; the stage-1
    dispatches are folded into ``stats.dispatches``. ``deadline`` bounds
    both stages: the warm start stops early, and the finish is cut
    like any compacting solve."""
    from ..core.api import DispatchPolicy, dispatch

    policy = policy or DispatchPolicy()
    inputs = WARM_OT.canonicalize(inputs, device)
    y_b0, st1 = warm_duals(inputs, eps, sizes=sizes,
                           guaranteed=policy.guaranteed, chunk=policy.chunk,
                           deadline=deadline, obs=obs, device=device,
                           warm_iters=warm_iters)
    # the warm start is per lane, so a mesh finish splits the batch
    finish = _dc_replace(policy, solver="pushrelabel", fused=False,
                         placement="batch")
    r, stats = dispatch(WARM_OT, inputs, eps, sizes=sizes, policy=finish,
                        keep_state=keep_state, deadline=deadline, obs=obs,
                        device=device, theta=theta, y_b0=y_b0)
    if stats is not None:
        stats.dispatches += int(st1.dispatches)
    return r, stats


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the warm-start state chain (the
# seeded y_b must be a fresh buffer, not the retained y_b0 operand) and
# the dual rounding itself (eps must arrive as a tensor; its integer
# clamps keep the precision rules clean).
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _trace_round_duals():
    b, m, n = 2, 4, 4
    return _audit.trace_entry(
        name="portfolio.hybrid.round_duals",
        fn=lambda c, mu, f, g, eps: {"y_b0": round_duals(c, mu, f, g,
                                                         eps)},
        args={
            "c": torch.linspace(0.0, 1.0, b * m * n).reshape(b, m, n),
            "mu": torch.full((b, n), 1.0 / n, dtype=torch.float32),
            "f": torch.zeros((b, m), dtype=torch.float32),
            "g": torch.zeros((b, n), dtype=torch.float32),
            "eps": torch.full((b,), 0.1, dtype=torch.float32),
        },
        must_trace={"eps"},
        tags={"hybrid"},
        source=__name__,
    )


def _trace_warm_state_chain():
    m = n = 8

    def chain(c, nu, mu, theta, eps, y_b0):
        data, ctx = WARM_OT.prologue({
            "c": c, "nu": nu, "mu": mu, "theta": theta, "eps": eps,
            "threshold": torch.tensor([0], dtype=torch.int32),
            "phase_cap": torch.tensor([64], dtype=torch.int32)})
        ctx = {**ctx, "y_b0": y_b0}
        state = WARM_OT.init_state(data, ctx)
        return {"state": state,
                "retained": {"c_int": data["c_int"],
                             "s_int": ctx["s_int"],
                             "d_int": ctx["d_int"],
                             "y_b0": y_b0}}

    return _audit.trace_entry(
        name="portfolio.hybrid.warm_state_chain",
        fn=chain,
        args={
            "c": torch.zeros((1, m, n), dtype=torch.float32),
            "nu": torch.full((1, m), 1.0 / m, dtype=torch.float32),
            "mu": torch.full((1, n), 1.0 / n, dtype=torch.float32),
            "theta": torch.tensor([320.0], dtype=torch.float32),
            "eps": torch.tensor([0.1], dtype=torch.float32),
            "y_b0": torch.ones((1, m), dtype=torch.int32),
        },
        retained={"c", "nu", "mu", "y_b0"},
        tags={"state-init-chain", "hybrid"},
        source=__name__,
    )


_audit.register("portfolio.hybrid.round_duals", _trace_round_duals,
                source=__name__)
_audit.register("portfolio.hybrid.warm_state_chain",
                _trace_warm_state_chain, source=__name__)
