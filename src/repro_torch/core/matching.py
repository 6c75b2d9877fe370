"""Parallel greedy maximal matching via randomized propose/accept rounds.

Step (I) of each push-relabel phase. Every free supply row proposes to one
admissible column chosen by a per-(row, col, round) hash key (Israeli-Itai
style randomization, expected O(log n) rounds); every column accepts its
lowest-index proposer. Accepted pairs leave the pool; rounds repeat until
no row proposes, so M' is maximal on the admissible subgraph.

Port of ``repro.core.matching`` with the batch axis written out: every
array carries a leading lane axis B. JAX runs the batch as ``vmap`` over a
``while_loop``, which freezes a lane whose predicate is false while other
lanes go on; here a per-lane ``done`` mask does the same, so each lane's
result and round count equal an unbatched solve. The loop reads one flag
from the device per round; the first round's read also says whether any
lane ran, which ends the caller's phase loop without a read of its own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..kernels.slack_propose import _mix, proposal_keys, slack_propose_ref
from ..obs import tracing as _tracing
from .device import host_flags

__all__ = ["_mix", "proposal_keys", "MaximalMatchingState",
           "greedy_maximal_matching", "_propose_dense"]


class MaximalMatchingState(NamedTuple):
    mprime_b: torch.Tensor   # (B, m) int32: M' partner col per row, -1 if none
    mprime_a: torch.Tensor   # (B, n) int32: M' partner row per col, -1 if none
    avail_a: torch.Tensor    # (B, n) bool: col not yet matched in M'
    active_b: torch.Tensor   # (B, m) bool: row in B' not yet matched in M'
    rounds: torch.Tensor     # (B,) int32
    done: torch.Tensor       # (B,) bool
    ran: bool = True         # host: some lane took a round


def _propose_dense(c_int, y_b, y_a, active_b, avail_a, salt_round):
    """Plain proposal step (the reference's ``_propose_dense``): dense
    masked hash-argmin over columns. (B, m) int32 column or -1."""
    return slack_propose_ref(c_int, y_b, y_a, avail_a, salt_round,
                             active_b)[0]


def _propose_kernel(c_int, y_b, y_a, active_b, avail_a, salt_round):
    """The default proposal step: the ``slack_propose`` kernel on CUDA
    tensors, its plain version on CPU tensors (same results)."""
    return ops.slack_propose_batched(c_int, y_b, y_a, avail_a, salt_round,
                                     active_b=active_b)[0]


def greedy_maximal_matching(
    c_int: torch.Tensor,
    y_b: torch.Tensor,
    y_a: torch.Tensor,
    in_bprime: torch.Tensor,
    salt: torch.Tensor,
    *,
    lanes: Optional[torch.Tensor] = None,
    propose_fn=None,
) -> MaximalMatchingState:
    """Maximal matching M' on the admissible subgraph touching B'.

    Args:
      c_int: (B, m, n) int32 costs in units of eps.
      y_b: (B, m) int32 supply duals; y_a: (B, n) int32 demand duals.
      in_bprime: (B, m) bool, rows free in M (the set B').
      salt: (B,) int32 folded into the per-round hash (the phase index).
      lanes: (B,) bool lanes that run; a lane outside it takes no round
        and keeps rounds == 0 (a lane whose outer loop has stopped).
      propose_fn: override of the proposal step, signature
        (c_int, y_b, y_a, active_b, avail_a, salt_round) -> (B, m) int32.
    """
    b, m, n = c_int.shape
    dev = c_int.device
    if propose_fn is None:
        propose_fn = _propose_kernel
    if lanes is None:
        lanes = torch.ones((b,), dtype=torch.bool, device=dev)
    mprime_b = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    # one extra sentinel slot per lane stands in for scatter mode="drop"
    mprime_a = torch.full((b, n + 1), -1, dtype=torch.int32, device=dev)
    avail_a = torch.ones((b, n + 1), dtype=torch.bool, device=dev)
    active_b = in_bprime & lanes[:, None]
    rounds = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = ~lanes
    rows = torch.arange(m, dtype=torch.int32, device=dev).expand(b, m)
    salt7919 = salt.to(torch.int32) * 7919
    ran = True
    with _tracing.span("core.rounds") as sp:
        for r in range(min(m, n) + 1):
            run = ~done
            salt_round = (salt7919 + rounds).contiguous()
            prop = propose_fn(c_int, y_b, y_a, active_b & run[:, None],
                              avail_a[:, :n].contiguous(), salt_round)
            has_prop = prop >= 0
            # accept: per column, the lowest-index proposing row wins
            tgt = torch.where(has_prop, prop, n).to(torch.int64)
            winners = torch.full((b, n + 1), m, dtype=torch.int32, device=dev)
            winners.scatter_reduce_(1, tgt, torch.where(has_prop, rows, m),
                                    reduce="amin")
            won = has_prop & (winners.gather(1, tgt) == rows)
            mprime_b = torch.where(won, prop, mprime_b)
            won_col = torch.where(won, prop, n).to(torch.int64)
            mprime_a.scatter_(1, won_col, rows)
            avail_a.scatter_(1, won_col, False)
            active_b = active_b & ~won
            rounds = rounds + run.to(torch.int32)
            done = done | ~has_prop.any(dim=1)
            if r == 0:
                stop, ran = host_flags("round", done.all(), lanes.any())
            else:
                stop, = host_flags("round", done.all())
            if stop:
                break
        if sp is not None:
            n_rounds = r + 1 if ran else 0
            sp.attrs["rounds"] = n_rounds
            _tracing.add("rounds", n_rounds)
    return MaximalMatchingState(
        mprime_b=mprime_b, mprime_a=mprime_a[:, :n], avail_a=avail_a[:, :n],
        active_b=active_b, rounds=rounds, done=done, ran=ran)
