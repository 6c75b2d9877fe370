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
extra ``y_b0`` operand; it rides the lockstep and compacting drivers,
which forward ``**prep_kw``.
"""
from __future__ import annotations

from dataclasses import replace as _dc_replace

import numpy as np
import torch

from ..core.compaction import DEFAULT_CHUNK, solve_compacting
from ..core.problem import OTSpec, PreparedBatch, _pad_lanes, eps_array
from ..core.transport import init_ot_state, ot_phase_cap
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

    def solve_lockstep(self, inputs, eps: float, *, sizes=None,
                       guaranteed: bool = False, keep_state: bool = False,
                       theta=None, y_b0=None, device=None):
        # one compacting dispatch with k above the phase cap: lockstep
        # semantics without teaching core/batched a warm-start operand
        b = int(inputs["c"].shape[0])
        eps_arr = eps_array(eps, b, guaranteed)
        k_all = max(ot_phase_cap(float(e)) for e in eps_arr) + 1
        r, stats = solve_compacting(
            self, inputs, eps, sizes=sizes, k=k_all, guaranteed=guaranteed,
            keep_state=keep_state, device=device, theta=theta, y_b0=y_b0)
        return r, (stats.final_state if keep_state else None)


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
    mode and chunk with the warm ``y_b0``, on the stepped route. Returns
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
    finish = _dc_replace(policy, solver="pushrelabel", fused=False)
    r, stats = dispatch(WARM_OT, inputs, eps, sizes=sizes, policy=finish,
                        keep_state=keep_state, deadline=deadline, obs=obs,
                        device=device, theta=theta, y_b0=y_b0)
    if stats is not None:
        stats.dispatches += int(st1.dispatches)
    return r, stats
