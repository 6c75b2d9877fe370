"""Convergence-compacting chunked-phase batch driver, generic over a
ProblemSpec (``core/problem.py``).

Port of ``repro.core.compaction``. A lockstep batch burns phases on every
lane until the slowest converges; this driver retires converged lanes:

  1. run ``k`` phases on the whole batch bucket (``spec.run_phases``);
  2. fetch the (B,) converged mask with the per-lane phase counters: ONE
     device->host read per chunk;
  3. once occupancy has halved, write the bucket's states into a full-B
     result buffer and gather the survivors into the next power-of-two
     bucket (padded with a converged lane, which takes no phase);
  4. when every lane has terminated, run the epilogue once over the
     full-B buffer.

Per-lane trajectories equal the lockstep path's and the unbatched
solver's: lanes never interact, and the hash keys depend only on the
within-instance (row, col, phase, round). ``eps`` may be per instance.

``deadline`` (an absolute time on ``repro_torch.obs.now``, the clock the
serving layers' spans and budgets use) cuts the loop when the next chunk
would overrun it; the lanes still live at the cut come back best-so-far
(``stats.unconverged``, ``Solution.degraded``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

# the serving stack's one monotonic clock: chunk timing and deadline
# checks share a time base with the scheduler's spans and budgets
from ..obs.metrics import now as _now
from .device import host_numpy
from .problem import ASSIGNMENT, OT, pow2_at_least, tree_map

DEFAULT_CHUNK = 8


@dataclass
class CompactionStats:
    """Occupancy/waste accounting for one compacted solve."""
    batch: int                 # real instances
    dispatched_batch: int      # power-of-two padded batch the driver ran
    chunk: int                 # k, phases per dispatch
    dispatches: int = 0
    # (batch bucket, live instances) after each k-phase dispatch
    occupancy: List[Tuple[int, int]] = field(default_factory=list)
    slot_phases: int = 0       # phase-slots executed (all lanes)
    phases_needed: int = 0     # sum of per-instance converged phase counts
    lockstep_slot_phases: int = 0  # batch * max(phases): what lockstep burns
    # final integer state (trimmed to the real batch), kept only with
    # keep_state=True for the feasibility certificates
    final_state: Optional[Any] = None
    # set by api.dispatch: dispatch wall seconds, the solver that ran and
    # the cost model's prediction for it
    solve_s: Optional[float] = None
    solver: str = "pushrelabel"
    predicted_s: Optional[float] = None
    # deadline cut: ``deadline_hit`` records that the loop stopped because
    # its next chunk would overrun the budget; ``unconverged`` is the
    # (dispatched_batch,) bool mask (original batch order) of the lanes
    # whose termination predicate had not fired at the cut
    deadline_hit: bool = False
    unconverged: Optional[np.ndarray] = None

    def as_dict(self) -> dict:
        return {
            "batch": self.batch,
            "dispatched_batch": self.dispatched_batch,
            "chunk": self.chunk,
            "dispatches": self.dispatches,
            "occupancy": [list(o) for o in self.occupancy],
            "slot_phases": self.slot_phases,
            "phases_needed": self.phases_needed,
            "lockstep_slot_phases": self.lockstep_slot_phases,
            "deadline_hit": self.deadline_hit,
        }


def _gather(tree, idx: torch.Tensor):
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _scatter(buf, tree, idx: torch.Tensor):
    return type(buf)(*(b.index_copy(0, idx, a) for b, a in zip(buf, tree)))


def _flush(buf, cur_s, idx: np.ndarray):
    if buf is None:
        return cur_s
    return _scatter(buf, cur_s, torch.as_tensor(idx, device=cur_s[0].device))


def _drive(data, state, run_fn, conv_fn, max_chunks: int,
           stats: CompactionStats, deadline: Optional[float] = None,
           obs=None):
    """The compacting loop over a per-lane ``data`` dict and a state
    NamedTuple. ``run_fn(data, state)`` advances every lane by at most
    ``stats.chunk`` phases; ``conv_fn(data, state)`` gives ((B,) bool
    converged, (B,) int32 phases). The fetch of both, stacked, is the
    loop's one device->host read per chunk. Returns the full-size state
    with every lane terminated (or cut), in original batch order.

    ``deadline`` is an absolute ``_now()`` instant: after each chunk the
    host clock (read after the chunk's fetch, which already waited on the
    device) plus that chunk's duration is held against it, and the loop
    stops when the NEXT chunk would overrun, flushing best-so-far state
    and recording the still-live lanes on ``stats``. At least one chunk
    always runs.

    ``obs`` (any object with ``event(name, **fields)``) gets one
    ``"chunk"`` event per dispatch and a ``"deadline-cut"`` event when the
    budget stops the loop."""
    idx = np.arange(stats.dispatched_batch)
    # the result buffer is born at the first flush, where idx is still the
    # identity, so it never aliases a state a later chunk updates
    buf = None
    cur_d, cur_s = data, state
    ph_prev = np.zeros((stats.dispatched_batch,), np.int64)
    for _ in range(max_chunks):
        t_chunk = _now()
        cur_s = run_fn(cur_d, cur_s)
        stats.dispatches += 1
        conv_t, ph_t = conv_fn(cur_d, cur_s)
        both = host_numpy("chunk", torch.stack([conv_t.to(torch.int32),
                                                ph_t.to(torch.int32)]))
        conv, ph = both[0].astype(bool), both[1].astype(np.int64)
        t_chunk = _now() - t_chunk
        bb = int(conv.shape[0])
        # the chunk runs every lane for the max phase delta
        dph = int((ph - ph_prev).max(initial=0))
        stats.slot_phases += bb * dph
        ph_prev = ph
        live = int((~conv).sum())
        stats.occupancy.append((bb, live))
        if obs is not None:
            obs.event("chunk", bucket=bb, live=live, chunk_s=t_chunk,
                      phases=dph)
        if live == 0:
            buf = _flush(buf, cur_s, idx)
            break
        if deadline is not None and _now() + t_chunk >= deadline:
            # another chunk (estimated by the one that just ran) would
            # overrun the budget: flush best-so-far state and mark the
            # lanes that had not terminated. The epilogue is defined on
            # any phase boundary (the phase cap already ends lanes
            # unconverged), so the answer is primal-feasible and its
            # certificate reports the true, larger gap.
            stats.deadline_hit = True
            un = np.zeros((stats.dispatched_batch,), bool)
            un[idx[~conv]] = True
            stats.unconverged = un
            if obs is not None:
                obs.event("deadline-cut", bucket=bb, live=live)
            buf = _flush(buf, cur_s, idx)
            break
        nb = pow2_at_least(live)
        if nb <= bb // 2:
            # retire: flush all current lanes to the result buffer, then
            # gather the survivors (padded with one converged lane, whose
            # predicate is already false) into the next bucket
            buf = _flush(buf, cur_s, idx)
            surv = np.flatnonzero(~conv)
            fill = np.flatnonzero(conv)[:1]
            sel = np.concatenate([surv, np.repeat(fill, nb - live)])
            sel_t = torch.as_tensor(sel, device=cur_s[0].device)
            cur_d = _gather(cur_d, sel_t)
            cur_s = _gather(cur_s, sel_t)
            idx = idx[sel]
            ph_prev = ph[sel]
    else:
        # phase caps bound every lane, so the loop always breaks
        buf = _flush(buf, cur_s, idx)
    return buf


def max_chunk_dispatches(phase_cap: np.ndarray, k: int) -> int:
    """Upper bound on k-phase dispatches (phase caps bound every lane)."""
    return -(-int(phase_cap.max(initial=1)) // max(k, 1)) + 2


def solve_compacting(spec, inputs, eps, *, sizes=None, k: int = DEFAULT_CHUNK,
                     guaranteed: bool = False, keep_state: bool = False,
                     deadline: Optional[float] = None, obs=None,
                     device=None, **prep_kw):
    """Solve a (B, M, N) batch of ``spec`` instances with convergence
    compaction.

    Args:
      spec: ``ASSIGNMENT`` or ``OT``.
      inputs: dict of batched operands (``{"c"}`` or ``{"c", "nu", "mu"}``),
        tensors or arrays; they are moved to ``device``.
      eps: scalar, or (B,) per-instance array.
      k: phases per chunk; any value gives identical results.
      keep_state: keep the final pre-completion integer state on
        ``stats.final_state``.
      deadline: absolute ``repro_torch.obs.now()`` budget; the loop stops
        when the next chunk would overrun it and returns best-so-far
        answers (``stats.deadline_hit`` / ``unconverged``).
      obs: see :func:`_drive`.
      device: where the solve runs; None means CUDA (raising without it).
      prep_kw: spec-specific prep options (OT: ``theta``).

    Returns ``(result, CompactionStats)``.
    """
    inputs = spec.canonicalize(inputs, device)
    b, m, n = spec.batch_shape(inputs)
    if b == 0:
        return (spec.empty_result(m, n, inputs["c"].device),
                CompactionStats(batch=0, dispatched_batch=0, chunk=k))
    p = spec.prepare(inputs, eps, sizes=sizes, guaranteed=guaranteed,
                     **prep_kw)
    ops = p.ops
    data, ctx = spec.prologue(ops)
    ctx = {**ctx, **{kk: ops[kk] for kk in spec.ctx_ops}}
    state0 = spec.init_state(data, ctx)
    stats = CompactionStats(batch=b, dispatched_batch=p.bp, chunk=k)
    final = _drive(
        data, state0, lambda d, s: spec.run_phases(d, s, k),
        lambda d, s: (spec.converged(d, s), s.phases),
        max_chunk_dispatches(p.phase_cap, k), stats, deadline=deadline,
        obs=obs)
    r = spec.epilogue(ctx, final)
    phases = np.asarray(final.phases[:b].cpu(), np.int64)
    stats.phases_needed = int(phases.sum())
    stats.lockstep_slot_phases = b * int(phases.max(initial=0))
    if keep_state:
        stats.final_state = tree_map(lambda a: a[:b], final)
    return spec.trim(r, b), stats


def solve_assignment_batched_compacting(c, eps, *, sizes=None,
                                        k: int = DEFAULT_CHUNK,
                                        guaranteed: bool = False,
                                        keep_state: bool = False,
                                        device=None):
    """Compacting solve of a (B, M, N) assignment batch on ``device``
    (None: CUDA); returns ``(BatchedAssignmentResult, CompactionStats)``."""
    return solve_compacting(ASSIGNMENT, {"c": c}, eps, sizes=sizes, k=k,
                            guaranteed=guaranteed, keep_state=keep_state,
                            device=device)


def solve_ot_batched_compacting(c, nu, mu, eps, *, sizes=None, theta=None,
                                k: int = DEFAULT_CHUNK,
                                guaranteed: bool = False,
                                keep_state: bool = False, device=None):
    """Compacting solve of a (B, M, N) OT batch on ``device`` (None:
    CUDA); returns ``(OTResult with leading batch axes,
    CompactionStats)``."""
    return solve_compacting(OT, {"c": c, "nu": nu, "mu": mu}, eps,
                            sizes=sizes, k=k, guaranteed=guaranteed,
                            keep_state=keep_state, device=device,
                            theta=theta)
