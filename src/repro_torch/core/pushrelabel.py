"""Push-relabel additive epsilon-approximation for the assignment problem.

Section 2.2 of Lahn-Raghvendra-Zhang (2022), in integer units of eps so
that feasibility and admissibility are exact:

    c_int      = floor(c / eps)            (costs scaled to [0, 1] first)
    admissible = y_b + y_a == c_int + 1
    matched    = y_b + y_a == c_int

Each phase: (I) greedy maximal matching M' on the admissible subgraph
touching the free rows B'; (II) push: add M' to M, displacing old
partners; (III) relabel: y_a -= 1 on columns matched in M', y_b += 1 on
rows of B' still free. The solve stops when |B'| <= eps * m and completes
the matching arbitrarily.

Port of ``repro.core.pushrelabel`` as a resumable stepped core over a
(B, m, n) batch: ``init_assignment_state`` / ``run_assignment_phases`` /
``assignment_converged`` plus ``assignment_prologue`` /
``assignment_epilogue``. Per lane, the state trajectory equals the
reference's for every chunk size k: a lane whose predicate is false takes
no phase (its rows leave B' and its round counter does not move) while
the other lanes go on.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .matching import greedy_maximal_matching


class PushRelabelState(NamedTuple):
    match_ba: torch.Tensor  # (B, m) int32 partner col of each row, -1 if free
    match_ab: torch.Tensor  # (B, n) int32 partner row of each col, -1 if free
    y_b: torch.Tensor       # (B, m) int32 supply duals (units of eps)
    y_a: torch.Tensor       # (B, n) int32 demand duals (units of eps)
    phases: torch.Tensor    # (B,) int32
    rounds: torch.Tensor    # (B,) int32 cumulative propose/accept rounds
    sum_ni: torch.Tensor    # (B,) int32 sum of |B'| over phases


class AssignmentResult(NamedTuple):
    matching: torch.Tensor   # (B, m) int32 col assigned to each row
    cost: torch.Tensor       # (B,) float32 cost under the original costs
    y_b: torch.Tensor        # (B, m) float32 scaled duals
    y_a: torch.Tensor        # (B, n) float32 scaled duals
    phases: torch.Tensor
    rounds: torch.Tensor
    sum_ni: torch.Tensor
    matched_before_completion: torch.Tensor  # (B,) int32


# Sentinel cost for padded rows/columns of a bucketed instance. Duals stay
# far below 2**26, so y_b + y_a == c + 1 never holds on a padded edge.
PAD_COST = 1 << 26


def _max_phases(eps: float, m: int) -> int:
    """Upper bound on the phase count: (1+2e)/e^2 when e*m >= 1, else
    m*(1+2e)/e (each phase matches at least one row)."""
    if eps * m >= 1.0:
        return int((1.0 + 2.0 * eps) / (eps * eps)) + 4
    return int(m * (1.0 + 2.0 * eps) / eps) + 4


def round_costs(c: torch.Tensor, eps) -> torch.Tensor:
    """``floor(c / eps)`` on costs pre-scaled to [0, 1], as int32. ``eps``
    goes in as an f32 tensor of ``c``'s rank, so the quotient is one
    correctly rounded f32 division (a Python scalar divisor may be turned
    into a multiplication by its reciprocal)."""
    eps_t = torch.full((1,) * c.dim(), float(eps), dtype=torch.float32,
                       device=c.device)
    return torch.floor(c / eps_t).to(torch.int32)


def init_assignment_state(b: int, m: int, n: int,
                          device=None) -> PushRelabelState:
    """Paper initialization: all free, y(b) = eps (1 unit), y(a) = 0."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=device)
    return PushRelabelState(
        match_ba=full((b, m), -1), match_ab=full((b, n), -1),
        y_b=full((b, m), 1), y_a=full((b, n), 0),
        phases=full((b,), 0), rounds=full((b,), 0), sum_ni=full((b,), 0))


def _row_mask(b: int, m: int, m_valid, device) -> torch.Tensor:
    rows = torch.arange(m, dtype=torch.int32, device=device)
    if m_valid is None:
        return torch.ones((b, m), dtype=torch.bool, device=device)
    return rows[None, :] < m_valid[:, None]


def assignment_phase(c_int, s: PushRelabelState, row_ok, lanes,
                     propose_fn=None) -> Tuple[PushRelabelState, bool]:
    """One phase on every lane in ``lanes`` ((B,) bool); other lanes come
    back unchanged. (I) maximal matching, (II) push, (III) relabel.
    Returns the state and whether any lane ran (read from the device with
    the first round's flag)."""
    b, m, n = c_int.shape
    dev = c_int.device
    in_bprime = (s.match_ba < 0) & row_ok & lanes[:, None]
    mm = greedy_maximal_matching(c_int, s.y_b, s.y_a, in_bprime, s.phases,
                                 lanes=lanes, propose_fn=propose_fn)
    if not mm.ran:
        return s, False
    rows = torch.arange(m, dtype=torch.int32, device=dev).expand(b, m)
    won = mm.mprime_b >= 0
    tgt = torch.where(won, mm.mprime_b, 0).to(torch.int64)
    # (II) push: displace the old partner of each column matched in M'
    old_partner = torch.where(won, s.match_ab.gather(1, tgt), -1)
    displaced = torch.where(old_partner >= 0, old_partner, m).to(torch.int64)
    match_ba = torch.cat([s.match_ba, s.match_ba.new_full((b, 1), -1)], 1)
    match_ba = match_ba.scatter(1, displaced, -1)[:, :m]
    match_ba = torch.where(won, mm.mprime_b, match_ba)
    won_col = torch.where(won, mm.mprime_b, n).to(torch.int64)
    match_ab = torch.cat([s.match_ab, s.match_ab.new_full((b, 1), -1)], 1)
    match_ab = match_ab.scatter(1, won_col, rows)[:, :n]
    # (III) relabel
    y_a = s.y_a.scatter_add(1, tgt, -won.to(torch.int32))
    still_free = in_bprime & ~won
    y_b = s.y_b + still_free.to(torch.int32)
    return PushRelabelState(
        match_ba=match_ba, match_ab=match_ab, y_b=y_b, y_a=y_a,
        phases=s.phases + lanes.to(torch.int32),
        rounds=s.rounds + mm.rounds,
        sum_ni=s.sum_ni + in_bprime.sum(dim=1, dtype=torch.int32)), True


def _running(state: PushRelabelState, row_ok, threshold, phase_cap):
    free = ((state.match_ba < 0) & row_ok).sum(dim=1, dtype=torch.int32)
    return (free > threshold) & (state.phases < phase_cap)


def run_assignment_phases(
    c_int: torch.Tensor,
    state: PushRelabelState,
    threshold: torch.Tensor,
    phase_cap: torch.Tensor,
    k: int,
    m_valid: Optional[torch.Tensor] = None,
    propose_fn=None,
) -> PushRelabelState:
    """Advance every lane by at most ``k`` phases (fewer where it
    terminates). ``threshold``/``phase_cap``/``m_valid`` are (B,) int32
    per lane. Chaining calls reproduces the one-shot trajectory for any k,
    lane by lane. The loop ends at the first phase in which no lane ran,
    as the phase's first round read reports."""
    b, m, _ = c_int.shape
    row_ok = _row_mask(b, m, m_valid, c_int.device)
    start = state.phases
    for _ in range(k):
        lanes = (_running(state, row_ok, threshold, phase_cap)
                 & (state.phases - start < k))
        state, ran = assignment_phase(c_int, state, row_ok, lanes,
                                      propose_fn)
        if not ran:
            break
    return state


def solve_assignment_int(c_int: torch.Tensor, eps: float, propose_fn=None,
                         m_valid=None, threshold=None) -> PushRelabelState:
    """Run phases on one (m, n) integer cost matrix until |B'| <= eps * m.
    No completion. Returns the state with a leading batch axis of 1.
    ``c_int`` must be contiguous for the kernel; with a ``propose_fn``
    of its own (the block schedule of ``core/sharded.py``) only its
    shape and device are read.

    ``m_valid`` restricts B' and the termination count to the first
    ``m_valid`` rows (an instance padded to a bucket; padded columns get
    a cost no dual sum reaches). ``threshold`` must accompany it: the
    caller computes ``int(eps * m_valid)`` on the host in float64, as the
    default below does for the full m."""
    m, n = c_int.shape
    dev = c_int.device
    if m_valid is None:
        threshold = int(eps * m)
    elif threshold is None:
        raise ValueError("m_valid requires a host-computed threshold")
    cap = _max_phases(eps, m)

    def vec(v):
        return torch.tensor([int(v)], dtype=torch.int32, device=dev)
    return run_assignment_phases(
        c_int[None], init_assignment_state(1, m, n, dev),
        vec(threshold), vec(cap), cap + 1,
        m_valid=None if m_valid is None else vec(m_valid),
        propose_fn=propose_fn)


def assignment_converged(state: PushRelabelState, threshold, phase_cap,
                         m_valid=None) -> torch.Tensor:
    """(B,) bool: the loop would take no further phase on the lane."""
    b, m = state.match_ba.shape
    row_ok = _row_mask(b, m, m_valid, state.match_ba.device)
    return ~_running(state, row_ok, threshold, phase_cap)


def complete_matching(match_ba, match_ab, valid_b=None, valid_a=None):
    """Match the remaining free rows to free columns by rank, lane by lane.
    Rows beyond the number of free columns stay -1; ``valid_b``/``valid_a``
    ((B, m)/(B, n) bool) keep padding out of the completion."""
    b, m = match_ba.shape
    n = match_ab.shape[1]
    free_b = match_ba < 0
    free_a = match_ab < 0
    if valid_b is not None:
        free_b = free_b & valid_b
    if valid_a is not None:
        free_a = free_a & valid_a
    # torch.cumsum of int32 returns int64; cast back as the int32 reference
    rank_b = (free_b.to(torch.int32).cumsum(1) - 1).to(torch.int32)
    rank_a = (free_a.to(torch.int32).cumsum(1) - 1).to(torch.int32)
    n_free_a = free_a.sum(dim=1, dtype=torch.int32)
    cols = torch.arange(n, dtype=torch.int32, device=match_ba.device)
    free_cols = torch.full((b, n + 1), -1, dtype=torch.int32,
                           device=match_ba.device)
    free_cols.scatter_(1, torch.where(free_a, rank_a, n).to(torch.int64),
                       cols.expand(b, n))
    take = free_b & (rank_b < n_free_a[:, None])
    fill = torch.where(
        take, free_cols.gather(1, rank_b.clamp(0, n - 1).to(torch.int64)),
        -1)
    return torch.where(free_b, fill, match_ba)


def assignment_prologue(c: torch.Tensor, eps: torch.Tensor, m_valid=None,
                        n_valid=None):
    """Scaling + rounding over a (B, m, n) float32 batch. ``eps`` is (B,)
    float32. Returns ``(cm, c_int, scale, row_ok, col_ok)``.

    The reference writes ``floor((cm / scale) / eps)``, but in every
    batched program (the ``solve`` path) XLA's algebraic simplifier turns
    ``(a / b) / c`` with broadcast b, c into ``a / (b * c)``, which rounds
    differently: at eps = 0.2/3 the largest cost gives 1/eps = 14.999999
    (floor 14) one way and 15.0 the other. The port computes what the
    reference's batched programs compute, ``floor(cm / (scale * eps))``
    in f32."""
    b, m, n = c.shape
    dev = c.device
    if m_valid is None:
        row_ok = col_ok = None
        cm = c
    else:
        row_ok = _row_mask(b, m, m_valid, dev)
        col_ok = _row_mask(b, n, n_valid, dev)
        mask = row_ok[:, :, None] & col_ok[:, None, :]
        cm = torch.where(mask, c, 0.0)
    scale = cm.amax(dim=(1, 2)).clamp_min(1e-30)
    c_int = torch.floor(cm / (scale * eps)[:, None, None]).to(torch.int32)
    if m_valid is not None:
        c_int = torch.where(mask, c_int, PAD_COST)
    return cm, c_int.contiguous(), scale, row_ok, col_ok


def assignment_epilogue(cm, scale, state: PushRelabelState, eps,
                        row_ok=None, col_ok=None) -> AssignmentResult:
    """Completion + cost/duals over a batch of terminated states."""
    b, m, n = cm.shape
    matched_before = (state.match_ba >= 0).sum(dim=1, dtype=torch.int32)
    matching = complete_matching(state.match_ba, state.match_ab, row_ok,
                                 col_ok)
    valid = matching >= 0
    picked = cm.gather(2, matching.clamp(0, n - 1).to(torch.int64)[:, :, None])
    cost = torch.where(valid, picked[:, :, 0], 0.0).sum(dim=1)
    return AssignmentResult(
        matching=matching, cost=cost,
        y_b=state.y_b.to(torch.float32) * eps[:, None] * scale[:, None],
        y_a=state.y_a.to(torch.float32) * eps[:, None] * scale[:, None],
        phases=state.phases, rounds=state.rounds, sum_ni=state.sum_ni,
        matched_before_completion=matched_before)


def solve_assignment(c, eps: float, *, guaranteed: bool = False,
                     device=None) -> AssignmentResult:
    """One (m, n) instance, m <= n: cost <= OPT + 3*eps*m after rescaling
    costs to [0, 1]; ``guaranteed=True`` runs at eps/3 for <= OPT + eps*m.
    Returns an AssignmentResult with a leading batch axis of 1."""
    from .device import resolve_device

    dev = resolve_device(device)
    if guaranteed:
        eps = eps / 3.0
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)[None]
    _, m, n = c.shape
    eps_t = torch.tensor([eps], dtype=torch.float32, device=dev)
    cm, c_int, scale, _, _ = assignment_prologue(c, eps_t)
    cap = _max_phases(eps, m)
    state = run_assignment_phases(
        c_int, init_assignment_state(1, m, n, dev),
        torch.tensor([int(eps * m)], dtype=torch.int32, device=dev),
        torch.tensor([cap], dtype=torch.int32, device=dev), cap + 1)
    return assignment_epilogue(cm, scale, state, eps_t)


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the stepped core is a solver entry
# point in its own right (lockstep and the sharded solve call it
# directly); its per-lane schedule operands must arrive as tensors.
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _trace_assignment_chunk():
    m = n = 8

    def vec(v):
        return torch.tensor([v], dtype=torch.int32)
    return _audit.trace_entry(
        name="core.pushrelabel.run_assignment_phases",
        fn=lambda c_int, state, threshold, phase_cap, m_valid:
            run_assignment_phases(c_int, state, threshold, phase_cap, 4,
                                  m_valid=m_valid),
        args={
            "c_int": torch.zeros((1, m, n), dtype=torch.int32),
            "state": init_assignment_state(1, m, n, "cpu"),
            "threshold": vec(0),
            "phase_cap": vec(8),
            "m_valid": vec(m),
        },
        donated={"state"},
        must_trace={"threshold", "phase_cap", "m_valid"},
        tags={"stepped-core", "assignment"},
        source=__name__,
    )


_audit.register("core.pushrelabel.run_assignment_phases",
                _trace_assignment_chunk, source=__name__)
