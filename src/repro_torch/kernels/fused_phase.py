"""``fused_assignment_phases`` / ``fused_ot_phases``: a whole k-phase
chunk of either solver in one launch.

Replaces the Pallas kernels ``fused_assignment_phases``
(``src/repro/kernels/fused_phase.py:181``, body ``_assignment_kernel``
at :87) and ``fused_ot_phases`` (:334, body ``_ot_kernel`` at :230). The
stepped cores (``core/pushrelabel.run_assignment_phases``,
``core/transport.run_ot_phases``) launch ``slack_propose`` and a dozen
small updates per propose round and read one flag per round back to the
host; the fused kernels run the phase loop and the round loop on the card
and return once per chunk.

This module holds the plain PyTorch versions (used on CPU tensors and as
the oracle of the kernels on the card). They are written as the Pallas
kernels' dense formulation, not as calls into the stepped cores, so that
comparing the two is a real check: one-hot proposals, the per-column
winner as a masked row-iota minimum, the OT grant base as a one-hot
masked minimum of the exclusive row cumsum, and the OT strip through
suffix-exclusive column sums. Every tensor carries a leading lane axis B;
each lane runs its own phase loop and round loop and freezes when done,
as JAX's ``vmap`` of the Pallas call does.

Bit parity with the stepped cores is the contract: ``salt_round =
phases*7919 + round`` per lane, the first-minimum column over (key, col)
with "none" meaning no admissible column, the lowest-index proposing row
wins a column, and the round caps come from the bucket's shape
(``min(m, n) + 1``, ``nb + na + 2``), not from ``m_valid``.

The CUDA kernels are ``csrc/fused_assignment.cu`` and ``csrc/fused_ot.cu``
(``kernels/ops.py`` launches them). What bounds them on an H100: the
propose scan reads ``c_int`` once per round for every row that still
proposes (4 bytes per element), so a chunk is bound by those bytes at the
HBM rate; the OT kernel also copies the two flow matrices in and out once
per launch, and per phase touches them only in the row tiles of the
columns that granted. They wait at grid-wide barriers (the assignment
kernel at one per propose round, the OT kernel at two), whose cost grows
with the rounds, not with the bytes.
"""
from __future__ import annotations

import torch

from .slack_propose import UMAX, proposal_keys

_I32_MAX = 2**31 - 1


def _first_min_col(keys: torch.Tensor) -> torch.Tensor:
    """(B, m) first column of the row-minimum key of (B, m, n) keys."""
    n = keys.shape[-1]
    cols = torch.arange(n, dtype=torch.int64, device=keys.device)
    rowmin = keys.amin(dim=2, keepdim=True)
    return torch.where(keys == rowmin, cols, n).amin(dim=2)


def _salt(phases: torch.Tensor, r: int) -> torch.Tensor:
    # int32 arithmetic, wrapping as the reference's does
    return phases * 7919 + r


def fused_assignment_phases_ref(c_int, match_ba, match_ab, y_b, y_a, phases,
                                rounds, sum_ni, threshold, phase_cap,
                                m_valid, *, k: int):
    """At most ``k`` assignment phases per lane.

    Args: ``c_int`` (B, m, n) int32; ``match_ba``, ``y_b`` (B, m) int32;
    ``match_ab``, ``y_a`` (B, n) int32; ``phases``, ``rounds``,
    ``sum_ni``, ``threshold``, ``phase_cap``, ``m_valid`` (B,) int32.

    Returns the new ``(match_ba, match_ab, y_b, y_a, phases, rounds,
    sum_ni)``; the inputs are not modified.
    """
    b, m, n = c_int.shape
    dev = c_int.device
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    cols = torch.arange(n, dtype=torch.int64, device=dev)
    row_ok = rows[None, :] < m_valid[:, None]
    mm_cap = min(m, n) + 1
    mba, mab, yb, ya = match_ba, match_ab, y_b, y_a
    ph, rd, sni = phases, rounds, sum_ni
    start = phases
    for _ in range(k):
        free = ((mba < 0) & row_ok).sum(dim=1, dtype=torch.int32)
        lanes = (free > threshold) & (ph < phase_cap) & (ph - start < k)
        if not bool(lanes.any()):
            break
        in_bp = (mba < 0) & row_ok & lanes[:, None]

        # (I) greedy maximal matching by propose/accept rounds
        mpb = torch.full((b, m), -1, dtype=torch.int64, device=dev)
        avail = torch.ones((b, n), dtype=torch.bool, device=dev)
        active = in_bp
        done = ~lanes
        mm_rounds = torch.zeros((b,), dtype=torch.int32, device=dev)
        for r in range(mm_cap):
            if bool(done.all()):
                break
            run = ~done
            adm = ((yb[:, :, None] + ya[:, None, :] == c_int + 1)
                   & avail[:, None, :])
            keys = torch.where(adm, proposal_keys(m, n, _salt(ph, r)), UMAX)
            best = _first_min_col(keys)
            has_prop = adm.any(dim=2) & active & run[:, None]
            prop = has_prop[:, :, None] & (best[:, :, None] == cols)
            # accept: per column, the lowest-index proposing row wins
            winners = torch.where(prop, rows[None, :, None], m).amin(dim=1)
            won_edge = prop & (winners[:, None, :] == rows[None, :, None])
            won = won_edge.any(dim=2)
            mpb = torch.where(won, best, mpb)
            avail = avail & ~won_edge.any(dim=1)
            active = active & ~won
            mm_rounds = mm_rounds + run.to(torch.int32)
            done = done | ~has_prop.any(dim=1)

        # (II) push: add M' to M, displacing old partners of M' columns
        won = mpb >= 0
        newmat = won[:, :, None] & (mpb[:, :, None] == cols)
        col_new = newmat.any(dim=1)
        displaced = (mba >= 0) & ((mba[:, :, None] == cols)
                                  & col_new[:, None, :]).any(dim=2)
        mba = torch.where(won, mpb.to(torch.int32),
                          torch.where(displaced, -1, mba))
        new_row = torch.where(newmat, rows[None, :, None], m).amin(dim=1)
        mab = torch.where(col_new, new_row, mab)
        # (III) relabel
        ya = ya - col_new.to(torch.int32)
        yb = yb + (in_bp & ~won).to(torch.int32)
        ph = ph + lanes.to(torch.int32)
        rd = rd + mm_rounds
        sni = sni + in_bp.sum(dim=1, dtype=torch.int32)
    return mba, mab, yb, ya, ph, rd, sni


def fused_ot_phases_ref(c_int, y_b, ya_hi, free_b, free_a, f_hi, f_lo,
                        phases, rounds, threshold, phase_cap, *, k: int,
                        max_rounds: int):
    """At most ``k`` OT phases per lane.

    Args: ``c_int`` (B, nb, na) int32; ``y_b``, ``free_b`` (B, nb) int32;
    ``ya_hi``, ``free_a`` (B, na) int32; ``f_hi``, ``f_lo`` (B, nb, na)
    int32; ``phases``, ``rounds``, ``threshold``, ``phase_cap`` (B,)
    int32; ``max_rounds`` the round cap of a phase.

    Returns the new ``(y_b, ya_hi, free_b, free_a, f_hi, f_lo, phases,
    rounds)``; the inputs are not modified.
    """
    b, nb, na = c_int.shape
    dev = c_int.device
    cols = torch.arange(na, dtype=torch.int64, device=dev)
    yb, yahi, fb, fa, fhi, flo = y_b, ya_hi, free_b, free_a, f_hi, f_lo
    ph, rd = phases, rounds
    start = phases
    for _ in range(k):
        lanes = ((fb.sum(dim=1, dtype=torch.int32) > threshold)
                 & (ph < phase_cap) & (ph - start < k))
        if not bool(lanes.any()):
            break
        # hi-cluster capacity available to M'
        hi_free = torch.where(yahi == 0, fa, 0)
        cap = hi_free + fhi.sum(dim=1, dtype=torch.int32)
        rem = fb
        granted = torch.zeros((b, nb, na), dtype=torch.int32, device=dev)
        done = ~lanes
        g_rounds = torch.zeros((b,), dtype=torch.int32, device=dev)
        for r in range(max_rounds):
            if bool(done.all()):
                break
            run = ~done
            adm = ((yb[:, :, None] + yahi[:, None, :] == c_int + 1)
                   & (cap > 0)[:, None, :])
            keys = torch.where(adm, proposal_keys(nb, na, _salt(ph, r)),
                               UMAX)
            best = _first_min_col(keys)
            can = adm.any(dim=2) & (rem > 0) & run[:, None]
            prop = can[:, :, None] & (best[:, :, None] == cols)
            # FIFO grants by row order: exclusive prefix of the proposal
            # amounts, one-hot reduced (int32, as the reference's cumsum)
            amt = torch.where(can, rem, 0)
            excl = amt.cumsum(dim=1).to(torch.int32) - amt
            base = torch.where(prop, excl[:, :, None], _I32_MAX).amin(dim=1)
            base_t = torch.where(prop, base[:, None, :], _I32_MAX).amin(dim=2)
            cap_t = torch.where(prop, cap[:, None, :], _I32_MAX).amin(dim=2)
            prefix = excl - torch.where(can, base_t, 0)
            grant = torch.where(
                can, torch.minimum((cap_t - prefix).clamp_min(0), amt), 0)
            g_edge = torch.where(prop, grant[:, :, None], 0)
            rem = rem - grant
            cap = cap - g_edge.sum(dim=1, dtype=torch.int32)
            granted = granted + g_edge
            g_rounds = g_rounds + run.to(torch.int32)
            done = done | ~can.any(dim=1)

        # push: displaced hi flow stripped bottom rows first
        g_a = granted.sum(dim=1, dtype=torch.int32)
        use_free = torch.minimum(g_a, hi_free)
        disp = g_a - use_free
        suffix_excl = (fhi.sum(dim=1, keepdim=True, dtype=torch.int32)
                       - fhi.cumsum(dim=1).to(torch.int32))
        take = torch.minimum((disp[:, None, :] - suffix_excl).clamp_min(0),
                             fhi)
        fhi2 = fhi - take
        freed = take.sum(dim=2, dtype=torch.int32)
        # relabel: granted units drop one level; empty hi clusters collapse
        fa2 = fa - use_free
        hi_left = (torch.where(yahi == 0, fa2, 0)
                   + fhi2.sum(dim=1, dtype=torch.int32))
        collapse = (hi_left == 0) & (g_a > 0)
        lo = flo + granted
        on = lanes[:, None]
        on3 = lanes[:, None, None]
        yb = torch.where(on, yb + ((fb > 0) & (rem > 0)).to(torch.int32), yb)
        yahi = torch.where(on & collapse, yahi - 1, yahi)
        fhi = torch.where(on3, torch.where(collapse[:, None, :], lo, fhi2),
                          fhi)
        flo = torch.where(on3, torch.where(collapse[:, None, :], 0, lo), flo)
        fb = torch.where(on, rem + freed, fb)
        fa = torch.where(on, fa2, fa)
        ph = ph + lanes.to(torch.int32)
        rd = rd + g_rounds
    return yb, yahi, fb, fa, fhi, flo, ph, rd
