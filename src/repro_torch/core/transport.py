"""Optimal transport via the push-relabel framework (paper Section 4).

Masses are scaled by theta = 4n/eps and rounded (supplies down, demands
up) to integer units; Lemma 4.1 lets each vertex's unit copies carry at
most two dual values, so copies are never materialized:

  per supply b : ``y_b`` dual of b's free copies, ``free_b`` free units;
  per demand a : ``ya_hi`` the larger of a's two dual values (<= 0),
                 ``free_a`` unmatched units (at dual 0);
  flows        : ``f_hi[b, a]`` / ``f_lo[b, a]`` units matched to copies of
                 a at ``ya_hi[a]`` / ``ya_hi[a] - 1``.

Each phase is a capacity-respecting greedy maximal matching from free
supply onto hi-cluster capacity (FIFO grants in row order), then push
(strip displaced hi flow, bottom rows first) and relabel; a column whose
hi cluster empties collapses one step down.

Port of ``repro.core.transport`` as a resumable stepped core over a
(B, nb, na) batch. The propose step of each grant round is the same
computation as the assignment solver's, with ``avail = cap_a > 0``, so it
runs through the same ``slack_propose`` kernel. The two (B, nb, na) flow
matrices dominate the state; updates that would otherwise copy them are
done in place and say so.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..obs import tracing as _tracing
from .device import host_flags


class OTState(NamedTuple):
    y_b: torch.Tensor      # (B, nb) int32 dual of free supply copies
    ya_hi: torch.Tensor    # (B, na) int32 max dual among demand copies
    free_b: torch.Tensor   # (B, nb) int32 unmatched supply units
    free_a: torch.Tensor   # (B, na) int32 unmatched demand units
    f_hi: torch.Tensor     # (B, nb, na) int32 flow matched at ya_hi
    f_lo: torch.Tensor     # (B, nb, na) int32 flow matched at ya_hi - 1
    phases: torch.Tensor   # (B,) int32
    rounds: torch.Tensor   # (B,) int32


class OTResult(NamedTuple):
    plan: torch.Tensor     # (B, nb, na) float32, marginals (nu rows, mu cols)
    cost: torch.Tensor     # (B,) <plan, C> under the original costs
    y_b: torch.Tensor      # (B, nb) scaled duals (supply side)
    y_a: torch.Tensor      # (B, na) scaled duals (demand side)
    phases: torch.Tensor
    rounds: torch.Tensor
    state: OTState         # raw integer state (for invariant checks)
    theta: torch.Tensor    # (B,) float32
    s_int: torch.Tensor    # (B, nb) int32 supplies after rounding
    d_int: torch.Tensor    # (B, na) int32 demands after rounding


_I32_MAX = int(np.iinfo(np.int32).max)


def _cumsum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    # torch.cumsum of int32 returns int64; the reference accumulates int32
    return x.cumsum(dim).to(torch.int32)


def _grant_round(c_int, y_b, ya_hi, rem_b, cap_a, salt, propose=None):
    """One propose/accept round on every lane. Every row with free supply
    left proposes all of it to one hash-random admissible column with
    capacity left; columns grant FIFO by row order through a segmented
    exclusive prefix sum. Returns ``(tgt (B, nb) int64, grant (B, nb)
    int32, any_prop (B,) bool)``; ``tgt`` is ``na`` where a row did not
    propose. ``propose`` replaces the propose step (the signature of
    ``ops.slack_propose_batched``; ``core/sharded.py`` passes its block
    schedule)."""
    b, nb, na = c_int.shape
    propose = ops.slack_propose_batched if propose is None else propose
    col, _ = propose(c_int, y_b, ya_hi, cap_a > 0, salt, active_b=rem_b > 0)
    can = col >= 0
    amt = torch.where(can, rem_b, 0)
    excl = _cumsum32(amt, 1) - amt
    tgt = torch.where(can, col, na).to(torch.int64)
    base = torch.full((b, na + 1), _I32_MAX, dtype=torch.int32,
                      device=c_int.device)
    base.scatter_reduce_(1, tgt, torch.where(can, excl, _I32_MAX),
                         reduce="amin")
    tgt_c = tgt.clamp(max=na - 1)
    prefix = excl - torch.where(can, base.gather(1, tgt_c), 0)
    grant = torch.minimum((cap_a.gather(1, tgt_c) - prefix).clamp_min(0),
                          amt)
    grant = torch.where(can, grant, 0)
    return tgt, grant, can.any(dim=1)


def _phase(c_int, s: OTState, max_rounds: int, lanes
           ) -> Tuple[OTState, bool]:
    """One phase on every lane in ``lanes`` ((B,) bool); other lanes come
    back unchanged (no free supply proposes, no round is counted).
    Returns the state and whether any lane ran (read from the device with
    the first round's flag)."""
    b, nb, na = c_int.shape
    dev = c_int.device
    free_b0 = torch.where(lanes[:, None], s.free_b, 0)
    free_a0 = s.free_a
    hi_free = torch.where(s.ya_hi == 0, free_a0, 0)
    cap_a = hi_free + s.f_hi.sum(dim=1, dtype=torch.int32)
    rem_b = free_b0
    granted = torch.zeros((b, nb, na), dtype=torch.int32, device=dev)
    granted_rows = granted.view(b * nb, na)
    rounds = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = ~lanes
    ran = True
    with _tracing.span("core.rounds") as sp:
        for r in range(max_rounds):
            run = ~done
            salt = (s.phases * 7919 + rounds).contiguous()
            tgt, grant, any_prop = _grant_round(
                c_int, s.y_b, s.ya_hi, torch.where(run[:, None], rem_b, 0),
                cap_a, salt)
            # accumulate this round's grants in place: granted is (B, nb, na);
            # a row that did not propose adds its zero grant to column na - 1
            tgt_c = tgt.clamp(max=na - 1)
            granted_rows.scatter_add_(1, tgt_c.view(b * nb, 1),
                                      grant.view(b * nb, 1))
            cap_a = cap_a.scatter_add(1, tgt_c, -grant)
            rem_b = rem_b - grant
            rounds = rounds + run.to(torch.int32)
            done = done | ~any_prop
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
    if not ran:
        return s, False

    g_a = granted.sum(dim=1, dtype=torch.int32)          # units matched in M'
    use_free = torch.minimum(g_a, hi_free)
    disp = g_a - use_free                                # displaced hi flow
    # victims: strip disp units off each column of f_hi, bottom rows first
    suffix_excl = _cumsum32(s.f_hi.flip(1), 1).flip(1)
    suffix_excl.sub_(s.f_hi)         # in place: saves a (B, nb, na) copy
    take = torch.minimum((disp[:, None, :] - suffix_excl).clamp_min(0),
                         s.f_hi)
    del suffix_excl
    freed_b = take.sum(dim=2, dtype=torch.int32)
    f_hi = take.neg_().add_(s.f_hi)  # in place: f_hi - take in take's buffer

    # relabel III(a): granted units land at ya_hi - 1; an emptied hi
    # cluster collapses one step down
    free_a = free_a0 - use_free
    hi_left = (torch.where(s.ya_hi == 0, free_a, 0)
               + f_hi.sum(dim=1, dtype=torch.int32))
    collapse = (hi_left == 0) & (g_a > 0)
    ya_hi = torch.where(collapse, s.ya_hi - 1, s.ya_hi)
    lo = granted.add_(s.f_lo)        # in place: f_lo + granted in granted
    f_hi_new = torch.where(collapse[:, None, :], lo, f_hi)
    f_lo_new = torch.where(collapse[:, None, :], 0, lo)

    # relabel III(b): rows of B' with free supply left rise by one
    y_b = s.y_b + ((free_b0 > 0) & (rem_b > 0)).to(torch.int32)
    free_b = torch.where(lanes[:, None], rem_b + freed_b, s.free_b)
    return OTState(y_b=y_b, ya_hi=ya_hi, free_b=free_b, free_a=free_a,
                   f_hi=f_hi_new, f_lo=f_lo_new,
                   phases=s.phases + lanes.to(torch.int32),
                   rounds=s.rounds + rounds), True


def init_ot_state(s_int: torch.Tensor, d_int: torch.Tensor) -> OTState:
    """Paper initialization over a batch: all mass free, y(b) = 1 unit,
    y(a) = 0. ``free_b``/``free_a`` are fresh copies of the masses."""
    b, nb = s_int.shape
    na = d_int.shape[1]
    dev = s_int.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    return OTState(
        y_b=torch.ones((b, nb), dtype=torch.int32, device=dev),
        ya_hi=zeros(b, na),
        free_b=s_int.to(torch.int32, copy=True),
        free_a=d_int.to(torch.int32, copy=True),
        f_hi=zeros(b, nb, na), f_lo=zeros(b, nb, na),
        phases=zeros(b), rounds=zeros(b))


def ot_termination_threshold(nu, theta, eps: float) -> int:
    """Host-side float64 threshold ``int(eps * sum(s_int))`` with
    ``s_int = floor(f32(nu) * f32(theta))`` as the device rounds it. The
    device f32 product ``f32(eps) * f32(total)`` rounds the wrong way for
    some (eps, total) pairs, e.g. eps = 0.1, total = 10."""
    s_int = np.floor(np.asarray(nu, np.float32) * np.float32(theta))
    return int(float(eps) * int(s_int.sum(dtype=np.float64)))


def solve_ot_int(c_int, s_int, d_int, eps: float, max_phases: int,
                 max_rounds: int, threshold=None) -> OTState:
    """Run phases on one (nb, na) integer instance until the free supply
    is <= ``threshold``. Returns the state with a leading batch axis of
    1. ``threshold`` should be the host's ``ot_termination_threshold``;
    None falls back to the device f32 product ``f32(eps) * f32(total)``,
    as the reference does, which rounds differently for some (eps,
    total) pairs."""
    dev = c_int.device
    if threshold is None:
        total = s_int.sum(dtype=torch.int32).to(torch.float32)
        thr = (torch.tensor(eps, dtype=torch.float32, device=dev)
               * total).to(torch.int32).reshape(1)
    else:
        thr = torch.tensor([int(threshold)], dtype=torch.int32, device=dev)
    return run_ot_phases(
        c_int[None].contiguous(), init_ot_state(s_int[None], d_int[None]),
        thr, torch.tensor([int(max_phases)], dtype=torch.int32, device=dev),
        int(max_phases) + 1, int(max_rounds))


def _running(state: OTState, threshold, phase_cap):
    return ((state.free_b.sum(dim=1, dtype=torch.int32) > threshold)
            & (state.phases < phase_cap))


def run_ot_phases(c_int, state: OTState, threshold, phase_cap, k: int,
                  max_rounds: int) -> OTState:
    """Advance every lane by at most ``k`` phases (fewer where it
    terminates); ``threshold``/``phase_cap`` are (B,) int32. Chaining
    calls reproduces the one-shot trajectory for any k, lane by lane. The
    loop ends at the first phase in which no lane ran, as the phase's
    first round read reports."""
    start = state.phases
    for _ in range(k):
        lanes = (_running(state, threshold, phase_cap)
                 & (state.phases - start < k))
        state, ran = _phase(c_int, state, max_rounds, lanes)
        if not ran:
            break
    return state


def ot_converged(state: OTState, threshold, phase_cap) -> torch.Tensor:
    """(B,) bool: the loop would take no further phase on the lane."""
    return ~_running(state, threshold, phase_cap)


def northwest_corner(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Closed-form NW-corner plans over a batch: (B, m), (B, n) ->
    (B, m, n), P[i,j] = (min(R_i, C_j) - max(R_{i-1}, C_{j-1}))+."""
    cr = r.cumsum(1)
    cc = c.cumsum(1)
    cr0 = cr - r
    cc0 = cc - c
    return (torch.minimum(cr[:, :, None], cc[:, None, :])
            - torch.maximum(cr0[:, :, None], cc0[:, None, :])).clamp_min(0.0)


def ot_phase_cap(eps: float) -> int:
    """Safety bound on the phase count (paper Lemma 4.2 analogue)."""
    return int((1.0 + 2.0 * eps) / (eps * eps)) + 8


def ot_prologue(c, nu, mu, theta, eps):
    """Rounding over a batch: float costs/masses -> integer instance.
    ``theta``/``eps`` are (B,) float32. Returns ``(c_int, s_int, d_int,
    scale)``. ``c_int = floor(c / (scale * eps))`` as the reference's
    batched programs compute it (see ``assignment_prologue``)."""
    scale = c.amax(dim=(1, 2)).clamp_min(1e-30)
    c_int = torch.floor(c / (scale * eps)[:, None, None]).to(
        torch.int32).contiguous()
    s_int = torch.floor(nu * theta[:, None]).to(torch.int32)   # round down
    d_int = torch.ceil(mu * theta[:, None]).to(torch.int32)    # round up
    return c_int, s_int, d_int, scale


def ot_epilogue(c, nu, mu, theta, eps, scale, s_int, d_int,
                state: OTState) -> OTResult:
    """Completion + marginal repair over a batch of terminated states."""
    flow = (state.f_hi + state.f_lo).to(torch.float32)
    comp = northwest_corner(state.free_b.to(torch.float32),
                            state.free_a.to(torch.float32))
    plan = (flow + comp) / theta[:, None, None]
    # repair marginals to the original (nu, mu): rescale overfull columns,
    # then NW-fill the residuals
    colsum = plan.sum(dim=1)
    col_scale = torch.where(colsum > mu, mu / colsum.clamp_min(1e-30), 1.0)
    plan = plan * col_scale[:, None, :]
    r = (nu - plan.sum(dim=2)).clamp_min(0.0)
    cc = (mu - plan.sum(dim=1)).clamp_min(0.0)
    sr, sc = r.sum(dim=1), cc.sum(dim=1)
    tot = torch.minimum(sr, sc)
    r = r * torch.where(sr > 0, tot / sr.clamp_min(1e-30), 0.0)[:, None]
    cc = cc * torch.where(sc > 0, tot / sc.clamp_min(1e-30), 0.0)[:, None]
    plan = plan + northwest_corner(r, cc)
    cost = (plan * c).sum(dim=(1, 2))
    return OTResult(
        plan=plan, cost=cost,
        y_b=state.y_b.to(torch.float32) * eps[:, None] * scale[:, None],
        y_a=state.ya_hi.to(torch.float32) * eps[:, None] * scale[:, None],
        phases=state.phases, rounds=state.rounds, state=state, theta=theta,
        s_int=s_int, d_int=d_int)


def solve_ot(c, nu, mu, eps: float, *, theta=None, guaranteed: bool = False,
             device=None) -> OTResult:
    """eps-additive approximate OT of one instance (rows = supplies nu,
    cols = demands mu). ``guaranteed=True`` runs at eps/3. Returns an
    OTResult with a leading batch axis of 1."""
    from .device import resolve_device

    dev = resolve_device(device)
    if guaranteed:
        eps = eps / 3.0
    nu_h = np.asarray(nu, np.float32)
    c = torch.as_tensor(np.asarray(c, np.float32), device=dev)[None]
    nu = torch.as_tensor(nu_h, device=dev)[None]
    mu = torch.as_tensor(np.asarray(mu, np.float32), device=dev)[None]
    _, nb, na = c.shape
    if theta is None:
        theta = 4.0 * max(nb, na) / eps
    theta_t = torch.tensor([theta], dtype=torch.float32, device=dev)
    eps_t = torch.tensor([eps], dtype=torch.float32, device=dev)
    c_int, s_int, d_int, scale = ot_prologue(c, nu, mu, theta_t, eps_t)
    cap = ot_phase_cap(eps)
    thr = ot_termination_threshold(nu_h, np.float32(theta), eps)
    state = run_ot_phases(
        c_int, init_ot_state(s_int, d_int),
        torch.tensor([thr], dtype=torch.int32, device=dev),
        torch.tensor([cap], dtype=torch.int32, device=dev), cap + 1,
        nb + na + 2)
    return ot_epilogue(c, nu, mu, theta_t, eps_t, scale, s_int, d_int, state)


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the OT stepped core (its init chain,
# where the shared-buffer bug lived, is registered from core/problem.py),
# and the one-shot solve's threshold=None fallback, the on-device f32
# threshold, under the "threshold" tag so the dtype-drift rule keeps it
# visible as an explicit baseline entry.
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _trace_ot_chunk():
    m = n = 8

    def vec(v):
        return torch.tensor([v], dtype=torch.int32)
    return _audit.trace_entry(
        name="core.transport.run_ot_phases",
        fn=lambda c_int, state, threshold, phase_cap:
            run_ot_phases(c_int, state, threshold, phase_cap, 4,
                          max_rounds=int(m + n + 2)),
        args={
            "c_int": torch.zeros((1, m, n), dtype=torch.int32),
            "state": init_ot_state(torch.ones((1, m), dtype=torch.int32),
                                   torch.ones((1, n), dtype=torch.int32)),
            "threshold": vec(0),
            "phase_cap": vec(8),
        },
        donated={"state"},
        must_trace={"threshold", "phase_cap"},
        tags={"stepped-core", "ot"},
        source=__name__,
    )


def _trace_solve_ot_int_fallback():
    m = n = 8
    return _audit.trace_entry(
        name="core.transport.solve_ot_int[threshold=None]",
        fn=lambda c_int, s_int, d_int:
            solve_ot_int(c_int, s_int, d_int, 0.25, 8, max_rounds=18,
                         threshold=None),
        args={
            "c_int": torch.zeros((m, n), dtype=torch.int32),
            "s_int": torch.ones((m,), dtype=torch.int32),
            "d_int": torch.ones((n,), dtype=torch.int32),
        },
        tags={"threshold", "ot"},
        source=__name__,
    )


_audit.register("core.transport.run_ot_phases", _trace_ot_chunk,
                source=__name__)
_audit.register("core.transport.solve_ot_int[threshold=None]",
                _trace_solve_ot_int_fallback, source=__name__)
