"""Convergence-compacting chunked-phase batch driver, generic over a
ProblemSpec (``core/problem.py``): the port's one chunk loop.

Port of ``repro.core.compaction``. A lockstep batch burns phases on every
lane until the slowest converges; this driver retires converged lanes:

  1. run ``k`` phases on the whole batch bucket (``spec.run_phases``;
     ``k`` as :func:`chunk_for` resolves it);
  2. fetch the (B,) converged mask with the per-lane phase counters: ONE
     device->host read per chunk;
  3. once occupancy has halved, write the bucket's states into a full-B
     result buffer and gather the survivors into the next power-of-two
     bucket (padded with a converged lane, which takes no phase);
  4. when every lane has terminated, run the epilogue once over the
     full-B buffer.

Every solve of a bucket runs through :func:`solve_compacting` and its
loop :func:`_drive`. Where the lanes live is the runner's business: one
device (:class:`OneDevice`), or a mesh's devices
(``core.distributed``'s batch placement, whose runner splits each chunk
over them). ``mode="lockstep"`` is the same loop asked for one chunk
above every lane's phase cap (``lockstep=True``), so no lane retires
early.

Per-lane trajectories equal the unbatched solver's for any k and any
runner: lanes never interact, and the hash keys depend only on the
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
from ..analysis import debug_checks_enabled
from ..obs import tracing as _tracing
from ..obs.metrics import now as _now
from .device import host_numpy
from .problem import (
    ASSIGNMENT,
    OT,
    FusedAssignmentSpec,
    FusedOTSpec,
    pow2_at_least,
    tree_map,
)

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


def _chunk(run_fn, conv_fn, data, state):
    """One chunk over the lanes of ``data`` / ``state``: the new state and
    the stacked ((b,) converged, (b,) phases) as int32, which the driver
    reads in its one fetch."""
    state = run_fn(data, state)
    conv, ph = conv_fn(data, state)
    return state, torch.stack([conv.to(torch.int32), ph.to(torch.int32)])


class OneDevice:
    """The runner of :func:`_drive` for a bucket on one device: where the
    lanes live and how a chunk runs over them. ``core.distributed``'s
    mesh runner splits them over its devices. ``shards`` is how many
    shards the next chunk runs on; ``run()`` gives the chunk's stacked
    (2, bb) read (:func:`_chunk`) on the first device; ``retire(sel)``
    goes on with the lanes ``sel`` of the state ``state()`` last gave;
    ``fields()`` is what the runner adds to each chunk's span and event;
    ``close()`` runs once, also on error."""

    shards = 1

    def stats(self, **kw) -> CompactionStats:
        return CompactionStats(**kw)

    def load(self, data, state, run_fn, conv_fn, stats) -> None:
        self.data, self.full = data, state
        self.run_fn, self.conv_fn = run_fn, conv_fn

    def run(self) -> torch.Tensor:
        self.full, both = _chunk(self.run_fn, self.conv_fn, self.data,
                                 self.full)
        return both

    def state(self):
        return self.full

    def retire(self, sel: np.ndarray) -> None:
        sel_t = torch.as_tensor(sel, device=self.full[0].device)
        self.data = _gather(self.data, sel_t)
        self.full = _gather(self.full, sel_t)

    def fields(self) -> dict:
        return {}

    def close(self) -> None:
        pass


def _drive(runner, max_chunks: int, stats: CompactionStats,
           deadline: Optional[float] = None, obs=None):
    """The compacting loop over the bucket ``runner`` holds
    (:class:`OneDevice`, or the mesh's runner). Each chunk advances
    every lane by at most ``stats.chunk`` phases; the fetch of its
    stacked (converged, phases) is the loop's one device->host read per
    chunk. Returns the full-size state with every lane terminated (or
    cut), in original batch order, on the runner's first device.

    ``deadline`` is an absolute ``_now()`` instant: after each chunk the
    host clock (read after the chunk's fetch, which already waited on the
    device) plus that chunk's duration is held against it, and the loop
    stops when the NEXT chunk would overrun, flushing best-so-far state
    and recording the still-live lanes on ``stats``. At least one chunk
    always runs.

    ``obs`` (any object with ``event(name, **fields)``) gets one
    ``"chunk"`` event per dispatch and a ``"deadline-cut"`` event when the
    budget stops the loop. Each dispatch, its read and its retirement run
    under a ``driver.chunk`` span (``obs.tracing``).

    ``slot_phases`` counts per-shard lockstep slots: each shard runs its
    lanes for its own max phase delta. Each lane's phase count at its
    last read is its final one (a converged lane takes no more phases),
    so the loop also sets ``stats.phases_needed`` /
    ``lockstep_slot_phases`` from its reads."""
    idx = np.arange(stats.dispatched_batch)
    # the result buffer is born at the first flush, where idx is still the
    # identity, so it never aliases a state a later chunk updates
    buf = None
    ph_prev = np.zeros((stats.dispatched_batch,), np.int64)
    ph_last = np.zeros((stats.dispatched_batch,), np.int64)
    for _ in range(max_chunks):
        with _tracing.span("driver.chunk") as sp:
            t_chunk = _now()
            shards = runner.shards
            both = host_numpy("chunk", runner.run())
            stats.dispatches += 1
            conv, ph = both[0].astype(bool), both[1].astype(np.int64)
            t_chunk = _now() - t_chunk
            bb = int(conv.shape[0])
            per_shard = (ph - ph_prev).reshape(shards, bb // shards)
            stats.slot_phases += int(per_shard.max(axis=1).sum()
                                     * (bb // shards))
            dph = int(per_shard.max(initial=0))
            ph_prev = ph
            ph_last[idx] = ph
            live = int((~conv).sum())
            stats.occupancy.append((bb, live))
            extra = runner.fields()
            if sp is not None:
                sp.attrs.update(bucket=bb, live=live, phases=dph,
                                k=stats.chunk, **extra)
                _tracing.add("chunks")
            if obs is not None:
                obs.event("chunk", bucket=bb, live=live, chunk_s=t_chunk,
                          phases=dph, **extra)
            if live == 0:
                buf = _flush(buf, runner.state(), idx)
                break
            if deadline is not None and _now() + t_chunk >= deadline:
                # another chunk (estimated by the one that just ran) would
                # overrun the budget: flush best-so-far state and mark the
                # lanes that had not terminated. The epilogue is defined
                # on any phase boundary (the phase cap already ends lanes
                # unconverged), so the answer is primal-feasible and its
                # certificate reports the true, larger gap.
                stats.deadline_hit = True
                un = np.zeros((stats.dispatched_batch,), bool)
                un[idx[~conv]] = True
                stats.unconverged = un
                if obs is not None:
                    obs.event("deadline-cut", bucket=bb, live=live)
                buf = _flush(buf, runner.state(), idx)
                break
            nb = pow2_at_least(live)
            if nb <= bb // 2:
                # retire: flush all current lanes to the result buffer,
                # then go on with the survivors (padded with one converged
                # lane, whose predicate is already false) in the next
                # bucket
                buf = _flush(buf, runner.state(), idx)
                surv = np.flatnonzero(~conv)
                fill = np.flatnonzero(conv)[:1]
                sel = np.concatenate([surv, np.repeat(fill, nb - live)])
                runner.retire(sel)
                idx = idx[sel]
                ph_prev = ph[sel]
    else:
        # phase caps bound every lane, so the loop always breaks
        buf = _flush(buf, runner.state(), idx)
    record_phases(stats, ph_last)
    return buf


def record_phases(stats, phases: np.ndarray) -> None:
    """``phases_needed`` and ``lockstep_slot_phases`` of ``stats`` from
    the final per-lane phase counts (original order, padded lanes
    after the real ones)."""
    real = phases[:stats.batch]
    stats.phases_needed = int(real.sum())
    stats.lockstep_slot_phases = stats.batch * int(real.max(initial=0))


def spec_fns(spec, k: int):
    """``(prologue, init, chunk, conv, epilogue)``: the spec's batched
    functions as the driver calls them. ``chunk(data, state)`` runs at
    most ``k`` phases; ``conv(data, state)`` gives ((B,) converged, (B,)
    phases), which the driver stacks into its one read per chunk.
    ``analysis.checked.checked_spec_fns`` gives the same family with the
    sanitizer's checks."""
    return (spec.prologue, spec.init_state,
            lambda data, state: spec.run_phases(data, state, k),
            lambda data, state: (spec.converged(data, state), state.phases),
            spec.epilogue)


def chunk_for(spec, k: Optional[int], deadline: Optional[float],
              phase_cap: Optional[np.ndarray] = None,
              lockstep: bool = False) -> Tuple[int, bool]:
    """``(k, runout)``: the phases a chunk of ``spec``'s bucket runs, and
    whether the driver chose to run the bucket out in that one chunk.
    An explicit ``k`` is used as given. None is the driver's choice: one
    chunk above every lane's phase cap (``phase_cap.max() + 1``) where
    the chunk is one fused push-relabel launch that stops itself lane by
    lane, no ``deadline`` is set and the debug checks are off (their
    checked chunk runs stepped); so the bucket runs to termination in
    one launch and the driver reads once. ``lockstep`` asks for that
    run-out for any spec (``mode="lockstep"``). Otherwise, and with no
    ``phase_cap`` (an empty batch, matrix placement), ``DEFAULT_CHUNK``:
    a deadline cuts between chunks, and a stepped chunk reads a flag
    every round anyway. Results are the same for any k."""
    if k is not None:
        return int(k), False
    if phase_cap is not None and (
            lockstep or (deadline is None and not debug_checks_enabled()
                         and isinstance(spec, (FusedAssignmentSpec,
                                               FusedOTSpec)))):
        return int(phase_cap.max(initial=0)) + 1, True
    return DEFAULT_CHUNK, False


def solve_compacting(spec, inputs, eps, *, sizes=None,
                     k: Optional[int] = None,
                     guaranteed: bool = False, keep_state: bool = False,
                     deadline: Optional[float] = None, obs=None,
                     device=None, lockstep: bool = False, runner=None,
                     **prep_kw):
    """Solve a (B, M, N) batch of ``spec`` instances with convergence
    compaction.

    Args:
      spec: ``ASSIGNMENT`` or ``OT``.
      inputs: dict of batched operands (``{"c"}`` or ``{"c", "nu", "mu"}``),
        tensors or arrays; they are moved to ``device``.
      eps: scalar, or (B,) per-instance array.
      k: phases per chunk; any value gives identical results. None
        lets :func:`chunk_for` choose: on a fused push-relabel spec with
        no ``deadline``, one chunk that runs the bucket to termination;
        else ``DEFAULT_CHUNK`` (8).
      keep_state: keep the final pre-completion integer state on
        ``stats.final_state``.
      deadline: absolute ``repro_torch.obs.now()`` budget; the loop stops
        when the next chunk would overrun it and returns best-so-far
        answers (``stats.deadline_hit`` / ``unconverged``).
      obs: see :func:`_drive`.
      device: where the solve runs; None means CUDA (raising without it).
      lockstep: with ``k`` None, run every lane to termination in one
        chunk whatever the spec (``api``'s ``mode="lockstep"``).
      runner: where the lanes run (:class:`OneDevice` when None;
        ``core.distributed`` passes the mesh's). The sanitizer's checked
        functions run a bucket that starts on one shard.
      prep_kw: spec-specific prep options (OT: ``theta``; the mesh:
        ``min_batch``).

    Returns ``(result, stats)``: ``CompactionStats``, or what the
    runner's ``stats`` makes.
    """
    runner = runner or OneDevice()
    inputs = spec.canonicalize(inputs, device)
    b, m, n = spec.batch_shape(inputs)
    if b == 0:
        return (spec.empty_result(m, n, inputs["c"].device),
                runner.stats(batch=0, dispatched_batch=0,
                             chunk=chunk_for(spec, k, deadline)[0]))
    with _tracing.span("solve.prepare"):
        p = spec.prepare(inputs, eps, sizes=sizes, guaranteed=guaranteed,
                         **prep_kw)
    k, runout = chunk_for(spec, k, deadline, p.phase_cap, lockstep)
    if runout:
        _tracing.add("runouts")
    if debug_checks_enabled() and runner.shards == 1:
        # the sanitizer: checked prologue, chunk and epilogue, on the
        # stepped route (analysis/checked.py); one more read a chunk
        from ..analysis.checked import checked_spec_fns
        prologue, init, chunk, conv, epilogue = checked_spec_fns(spec, k)
        _tracing.note("route", "stepped")
    else:
        prologue, init, chunk, conv, epilogue = spec_fns(spec, k)
        _tracing.note("route", "fused" if getattr(spec, "fused", False)
                      else "stepped")
    ops = p.ops
    with _tracing.span("solve.prologue"):
        data, ctx = prologue(ops)
        ctx = {**ctx, **{kk: ops[kk] for kk in spec.ctx_ops}}
        state0 = init(data, ctx)
    stats = runner.stats(batch=b, dispatched_batch=p.bp, chunk=k)
    # phase caps bound every lane, so this many chunks end every bucket
    max_chunks = -(-int(p.phase_cap.max(initial=1)) // max(k, 1)) + 2
    try:
        runner.load(data, state0, chunk, conv, stats)
        final = _drive(runner, max_chunks, stats, deadline=deadline,
                       obs=obs)
    finally:
        runner.close()
    with _tracing.span("solve.epilogue"):
        r = epilogue(ctx, final)
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


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the chunk and converged-mask
# functions are what the compacting loop re-issues per bucket, so they
# are what the donation-safety and dtype-drift rules must see.
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _tiny_batch(spec_name: str, k: int = 2):
    """A deterministic (2, 4, 4) prepared batch on the CPU: ``(chunk,
    conv, data, state)`` for recording dispatches."""
    spec = ASSIGNMENT if spec_name == "assignment" else OT
    b, mn = 2, 4
    c = np.linspace(0.0, 1.0, b * mn * mn, dtype=np.float32)
    inputs = {"c": c.reshape(b, mn, mn)}
    if spec_name == "ot":
        inputs["nu"] = np.full((b, mn), 1.0 / mn, np.float32)
        inputs["mu"] = np.full((b, mn), 1.0 / mn, np.float32)
    p = spec.prepare(spec.canonicalize(inputs, "cpu"), 0.25)
    prologue, init, chunk, conv, _ = spec_fns(spec, k)
    data, ctx = prologue(p.ops)
    state = init(data, ctx)
    return chunk, conv, data, state


def _trace_chunk(spec_name: str):
    chunk, _, data, state = _tiny_batch(spec_name)
    return _audit.trace_entry(
        name=f"core.compaction.chunk[{spec_name}]",
        fn=chunk,
        args={"data": data, "state": state},
        donated={"state"},
        tags={"chunk-dispatch", spec_name},
        source=__name__,
    )


def _trace_conv(spec_name: str):
    _, conv, data, state = _tiny_batch(spec_name)
    return _audit.trace_entry(
        name=f"core.compaction.conv[{spec_name}]",
        fn=conv,
        args={"data": data, "state": state},
        tags={"conv-dispatch", spec_name},
        source=__name__,
    )


_audit.register("core.compaction.chunk[assignment]",
                lambda: _trace_chunk("assignment"), source=__name__)
_audit.register("core.compaction.chunk[ot]",
                lambda: _trace_chunk("ot"), source=__name__)
_audit.register("core.compaction.conv[assignment]",
                lambda: _trace_conv("assignment"), source=__name__)
_audit.register("core.compaction.conv[ot]",
                lambda: _trace_conv("ot"), source=__name__)
