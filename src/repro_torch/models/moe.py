"""Mixture-of-Experts layer with three interchangeable routers:

  - ``topk``        : standard softmax-top-k gating (baseline).
  - ``sinkhorn``    : Sinkhorn-normalized balanced gating (baseline).
  - ``pushrelabel`` : the paper's router. Token->expert assignment is an
                      unbalanced optimal-transport instance (tokens supply
                      k units each, experts demand capacity), solved by a
                      fixed budget of integer push-relabel phases.

Port of ``repro.models.moe``. ``moe_forward`` is the no-mesh path;
``moe_forward_ep`` is the body of the reference's ``shard_map`` over a
mesh for one batch shard (experts split along 'tp', partial outputs
summed where the reference ``psum``s), driven by
``transformer.apply_moe``. ``pushrelabel_assign`` is one call of
``kernels.ops.fused_run_ot_phases``: on the card one launch of the
``fused_ot_phases`` kernel runs every phase with no read back to the
host; on the CPU the same wrapper runs the kernel's plain version. The
reference runs ``transport._phase`` in a ``fori_loop``; with a threshold
of -1 (the kernel's live-lane test is signed) and ``phase_cap = phases``
the kernel runs exactly ``phases`` phases, which is that loop.

Every shape in the layer follows from the input's shape (the counts are
scatter-adds into fixed lengths, not ``bincount``), so the layer runs
under ``FakeTensorMode``, which the dry-run's plans use: there
``pushrelabel_assign`` launches nothing and records its launch instead.

``norm_topk_prob`` (a port-only config field, DeepSeek-V2's; True when
a config lacks it): with it False the gates are the softmax
probabilities at the chosen experts as they are, not renormalised over
the k. ``tap(RouterTap())`` installs a hook, off by default (one ``is
None`` test a call when off), that counts the routers' launches and
units, the units the phase budget left to the fallback and the entries
the dispatch dropped past capacity, as device tensors summed only when
read; with ``capture=True`` it also keeps each push-relabel call's
``c_int``, flow and ``sel``.

Dispatch is sort-based (stable argsort by expert id -> rank within expert
-> capacity-bounded scatter into a buffer with one sink row that takes
the dropped entries), no (T, E, C) one-hot tensors. The return of the
expert outputs sums each token's entries in slot order, as the
reference's scatter-add does, by a gather and a fixed sequence of adds,
so it is deterministic on the card (an atomic ``index_add_`` is not).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from torch._subclasses.fake_tensor import FakeTensor

from ..core.transport import OTState
from ..kernels import ops
from ..obs import tracing
from ..roofline.plan import record_custom_call
from .layers import _init, glu_mlp, glu_mlp_init


def moe_init(gen, cfg, dtype=torch.float32, router_dtype=torch.float32):
    d, e, ffe = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    p = {
        # the reference keeps a float32 router whatever the parameters'
        # dtype and casts it to bf16 on every call; a model built in bf16
        # for serving (router_dtype bf16) holds those bf16 values
        "router": _init(gen, (d, e), scale=0.02, dtype=router_dtype),
        "w_gate": _init(gen, (e, d, ffe), dtype=dtype),
        "w_up": _init(gen, (e, d, ffe), dtype=dtype),
        "w_down": _init(gen, (e, ffe, d), dtype=dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = glu_mlp_init(gen, d, cfg.num_shared_experts * ffe,
                                   dtype=dtype)
    return p


# --------------------------------------------------------------------------
# Routers: all return (sel (T, k) int32, gates (T, k) float32).
# --------------------------------------------------------------------------

def _top_k(x, k):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _normalize(gates):
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def route_topk(logits, k, norm: bool = True):
    probs = torch.softmax(logits.float(), dim=-1)
    gates, sel = _top_k(probs, k)
    return sel.to(torch.int32), _normalize(gates) if norm else gates


def route_sinkhorn(logits, k, iters: int = 8, norm: bool = True):
    """Balanced gating via Sinkhorn normalization of the prob matrix
    (S-BASE style). Selection through the balanced matrix, gate values from
    the raw softmax."""
    t, e = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    f = torch.zeros((t,), device=logits.device)
    g = torch.zeros((e,), device=logits.device)
    log_cap = math.log(1.0 / e)
    for _ in range(iters):
        g = log_cap - torch.logsumexp(logp + f[:, None], dim=0)
        f = -math.log(t) * 0 - torch.logsumexp(logp + g[None, :], dim=1)
    balanced = logp + f[:, None] + g[None, :]
    _, sel = _top_k(balanced.detach(), k)
    probs = torch.softmax(logits.float(), dim=-1)
    gates = torch.gather(probs, 1, sel)
    return sel.to(torch.int32), _normalize(gates) if norm else gates


def router_costs(affinity, levels: int = 16):
    """The router's integer cost matrix: ``-affinity`` scaled to [0, 1]
    and quantized to ``levels`` steps (int32, in [0, levels])."""
    aff = affinity.float()
    lo = aff.min()
    hi = aff.max()
    cost = (hi - aff) / torch.clamp(hi - lo, min=1e-9)       # in [0, 1]
    return torch.clamp(torch.floor(cost * levels).to(torch.int32), 0, levels)


def router_state(t: int, e: int, k: int, capacity: int, device) -> OTState:
    """The router's start state (B = 1), not ``init_ot_state``'s: every
    token's dual at 1, k free units a token, ``capacity`` an expert."""
    i32 = torch.int32

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=device)
    return OTState(y_b=full((1, t), 1), ya_hi=full((1, e), 0),
                   free_b=full((1, t), k), free_a=full((1, e), capacity),
                   f_hi=full((1, t, e), 0), f_lo=full((1, t, e), 0),
                   phases=full((1,), 0), rounds=full((1,), 0))


def _abstract(t: torch.Tensor) -> bool:
    """A tensor without data: a fake tensor (``FakeTensorMode``) or one
    on the meta device."""
    return isinstance(t, FakeTensor) or t.is_meta


def pushrelabel_assign(
    affinity: torch.Tensor,
    k: int,
    capacity: int,
    *,
    levels: int = 16,
    phases: int = 12,
    max_rounds: int = 8,
) -> torch.Tensor:
    """Balanced token->expert flows via a fixed budget of push-relabel
    phases on the integer OT instance (supplies = k per token, demands =
    capacity per expert, cost = quantized -affinity). Returns (T, E)
    int32 flow. One ``fused_run_ot_phases`` call: exactly ``phases``
    phases of at most ``max_rounds`` rounds each. A fake or meta
    ``affinity`` (a dry-run's plan) launches nothing: the flow is zeros of
    the right shape, and the launch is recorded in the active plan."""
    t, e = affinity.shape
    dev = affinity.device
    if _abstract(affinity):
        # a plan (``roofline/plan.py``) records the launch it would make
        record_custom_call("fused_ot_phases", shape=(t, e), phases=phases,
                           max_rounds=max_rounds)
        return torch.zeros((t, e), dtype=torch.int32, device=dev)
    c_int = router_costs(affinity, levels)
    state = router_state(t, e, k, capacity, dev)
    never = torch.full((1,), -1, dtype=torch.int32, device=dev)
    cap = torch.full((1,), phases, dtype=torch.int32, device=dev)
    state = ops.fused_run_ot_phases(c_int[None].contiguous(), state, never,
                                    cap, phases, max_rounds)
    return (state.f_hi + state.f_lo)[0]


def route_pushrelabel(logits, k, *, phases: int = 24, norm: bool = True):
    t, e = logits.shape
    capacity = -(-t * k // e)  # ceil: perfectly balanced demand
    flow = pushrelabel_assign(logits.detach(), k, capacity, phases=phases)
    probs = torch.softmax(logits.float(), dim=-1)
    # Expand the flow MULTISET into k slots (flow[t,e] units can exceed 1).
    # Unmatched units fall back to the best expert with residual capacity.
    residual = torch.clamp(capacity - flow.sum(dim=0, dtype=torch.int32),
                           min=0)
    base = probs.detach() + (residual[None, :] > 0).float() * 2.0
    score = flow.float() * 10.0 + base
    rows = torch.arange(t, device=logits.device)
    sels = []
    for _ in range(k):
        pick = torch.argmax(score, dim=1)       # the first maximum
        sels.append(pick.to(torch.int32))
        # consume one flow unit (or burn the fallback bonus) at the pick
        score[rows, pick] -= 10.0
    sel = torch.stack(sels, dim=1)
    # a token may pick one expert several times; the backward of this
    # gather sums those slots by an accumulating index_put_, which sorts
    # on the card and is deterministic (torch.gather's scatter_add is not)
    gates = probs[rows[:, None], sel.long()]
    if _TAP is not None and not _abstract(logits):
        _TAP.routed(logits, flow, sel, k)
    return sel, _normalize(gates) if norm else gates


ROUTERS = {
    "topk": lambda logits, k, norm=True: route_topk(logits, k, norm),
    "sinkhorn": lambda logits, k, norm=True: route_sinkhorn(logits, k,
                                                            norm=norm),
    "pushrelabel": lambda logits, k, norm=True: route_pushrelabel(
        logits, k, norm=norm),
}


def route(cfg, logits):
    """(sel, gates) of ``cfg``'s router over (T, E) float32 logits; the
    gates renormalised over the k unless ``cfg.norm_topk_prob`` is False."""
    with tracing.span("moe.route"):
        return ROUTERS[cfg.router](logits, cfg.top_k,
                                   getattr(cfg, "norm_topk_prob", True))


# --------------------------------------------------------------------------
# The router's hook: counts for the step's root span, captures for checks
# --------------------------------------------------------------------------

class RouterTap:
    """What the MoE layers did while the tap was installed (``tap``), on
    any thread (the remat recompute runs on autograd's): ``launches`` and
    ``units`` (k T a call) of the push-relabel router, and the device
    tensors of the units its phase budget left to the ``argmax``
    fallback and of the dispatch's entries past capacity (into the sink
    row), summed on the device only by ``device_counts``. With
    ``capture``, ``calls`` keeps each push-relabel call's ``c_int`` (T,
    E) int32, ``flow`` (T, E) int32 and ``sel`` (T, k) int32, in call
    order."""

    def __init__(self, capture: bool = False):
        self.capture = capture
        self.launches = 0
        self.units = 0
        self.calls = []
        self._unmatched = []
        self._dropped = []

    def routed(self, logits, flow, sel, k: int) -> None:
        t = logits.shape[0]
        self.launches += 1
        self.units += k * t
        self._unmatched.append(k * t - flow.sum(dtype=torch.int64))
        if self.capture:
            self.calls.append({"c_int": router_costs(logits.detach()),
                               "flow": flow, "sel": sel})

    def dropped(self, n: torch.Tensor) -> None:
        self._dropped.append(n)

    def device_counts(self):
        """(2,) float64 on the device: unmatched units and dropped entries
        summed, or None when nothing was counted."""
        parts = [torch.stack(xs).sum() if xs else None
                 for xs in (self._unmatched, self._dropped)]
        ref = next((p_ for p_ in parts if p_ is not None), None)
        if ref is None:
            return None
        return torch.stack([(p_ if p_ is not None else torch.zeros_like(ref))
                            .to(torch.float64) for p_ in parts])


_TAP = None


@contextmanager
def tap(hook: "RouterTap"):
    """Install ``hook`` for the body (the previous one restored after)."""
    global _TAP
    prev, _TAP = _TAP, hook
    try:
        yield hook
    finally:
        _TAP = prev


# --------------------------------------------------------------------------
# Sort-based capacity dispatch (local experts [e0, e0 + e_loc)).
# --------------------------------------------------------------------------

def _dispatch_local(tokens, sel, gates, e0, e_loc, cap):
    """tokens (T,d); sel/gates (T,k). Returns (buffer (e_loc*cap, d),
    buf_gate (e_loc*cap,), src_token (e_loc*cap,) int32 with -1 holes)."""
    t, d = tokens.shape
    k = sel.shape[1]
    dev = tokens.device
    n_slots = e_loc * cap
    flat_e = (sel.to(torch.int32) - e0).reshape(-1)
    flat_tok = torch.arange(t, dtype=torch.int32,
                            device=dev).repeat_interleave(k)
    flat_gate = gates.reshape(-1)
    local = (flat_e >= 0) & (flat_e < e_loc)
    key = torch.where(local, flat_e, e_loc)
    order = torch.argsort(key, stable=True)
    e_sorted = key[order]
    # rank within expert segment
    idx = torch.arange(t * k, dtype=torch.int32, device=dev)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          e_sorted[1:] != e_sorted[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - seg_start
    ok = (e_sorted < e_loc) & (rank < cap)
    if _TAP is not None and not _abstract(tokens):
        _TAP.dropped(((e_sorted < e_loc) & ~ok).sum(dtype=torch.int64))
    # entries that do not fit land in the sink row n_slots, dropped below
    slot = torch.where(ok, e_sorted * cap + rank, n_slots).long()
    tok_sorted = flat_tok[order]
    buffer = torch.zeros((n_slots + 1, d), dtype=tokens.dtype, device=dev)
    buffer[slot] = tokens[tok_sorted.long()]
    buf_gate = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev)
    buf_gate[slot] = flat_gate[order].float()
    src = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    src[slot] = tok_sorted
    return buffer[:n_slots], buf_gate[:n_slots], src[:n_slots]


def _combine(y_flat, src, t: int, k: int):
    """``out[src[i]] += y_flat[i]`` over the slots in index order, the
    sum the reference's scatter-add makes: each token's (at most k)
    slots, gathered in ascending order and added one by one."""
    n_slots, d = y_flat.shape
    dev = y_flat.device
    held = src >= 0
    owner = torch.where(held, src, t).long()
    # slots grouped by token, ascending within a token (stable sort)
    by_tok = torch.argsort(owner, stable=True)
    # a static-shape count (bincount's length depends on the data)
    counts = torch.zeros(t + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, owner, torch.ones_like(owner))[:t]
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(k, device=dev)
    pick = first[:, None] + j[None, :]
    has = j[None, :] < counts[:, None]
    slot_of = torch.where(has, by_tok[pick.clamp(max=n_slots - 1)], n_slots)
    y_pad = torch.cat([y_flat, y_flat.new_zeros((1, d))])
    parts = y_pad[slot_of]                                  # (T, k, d)
    out = torch.zeros((t, d), dtype=y_flat.dtype, device=dev)
    for i in range(k):
        out = out + parts[:, i]
    return out


def moe_local_forward(p_experts, cfg, tokens, sel, gates, e0, e_loc):
    """Per-shard expert compute: dispatch -> GLU experts -> weighted return.
    tokens: (T, d). Returns partial (T, d) covering local experts only."""
    t, d = tokens.shape
    cap = int(t * cfg.top_k / cfg.num_experts * cfg.capacity_factor) + 1
    buffer, buf_gate, src = _dispatch_local(tokens, sel, gates, e0, e_loc, cap)
    xb = buffer.reshape(e_loc, cap, d)
    h = F.silu(torch.bmm(xb, p_experts["w_gate"])) \
        * torch.bmm(xb, p_experts["w_up"])
    yb = torch.bmm(h, p_experts["w_down"])
    y_flat = yb.reshape(e_loc * cap, d) * buf_gate[:, None].to(yb.dtype)
    return _combine(y_flat, src, t, sel.shape[1])


def moe_forward(p, cfg, x):
    """x: (B, S, d). The reference's single-device path: every expert is
    local (e0 = 0)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    # the reference's f32 @ bf16 promotes to f32: the router in f32
    logits = tokens.float() @ p["router"].float()
    sel, gates = route(cfg, logits)
    e_loc = p["w_gate"].shape[0]
    experts = {k_: p[k_] for k_ in ("w_gate", "w_up", "w_down")}
    out = moe_local_forward(experts, cfg, tokens, sel, gates, 0, e_loc)
    out = out.reshape(b, s, d).to(x.dtype)
    if cfg.num_shared_experts:
        out = out + glu_mlp(p["shared"], x)
    return out


def moe_forward_ep(p, cfg, x, devices, experts):
    """One batch shard of the expert-parallel branch: x (B, S, d) the
    shard's tokens; ``devices[t]`` the device of expert block t (the
    shard's row of the mesh along 'tp'); ``experts[name][t]`` block t of
    each expert weight ((E / tp, ...), on ``devices[t]``). The router runs
    once, on ``devices[0]``; each block's ``moe_local_forward`` runs on
    its device with its expert range [t * E_loc, (t + 1) * E_loc); the
    partial outputs are summed in t order on ``devices[0]`` (the
    reference's ``psum``, which recomputes the same routing on every
    device of the shard: the router is deterministic). Returns (B, S, d)
    in x's dtype on ``devices[0]``. No shared experts (the caller adds
    them, as the reference's ``apply_moe`` does)."""
    b, s, d = x.shape
    home = devices[0]
    tokens = x.reshape(b * s, d).to(home)
    logits = tokens.float() @ p["router"].to(home).float()
    sel, gates = route(cfg, logits)
    e_loc = experts["w_gate"][0].shape[0]
    out = None
    for t, dev in enumerate(devices):
        block = {k_: experts[k_][t] for k_ in ("w_gate", "w_up", "w_down")}
        part = moe_local_forward(block, cfg, tokens.to(dev), sel.to(dev),
                                 gates.to(dev), t * e_loc, e_loc).to(home)
        out = part if out is None else out + part
    return out.reshape(b, s, d).to(x.dtype)


def load_balance_stats(logits, sel, num_experts):
    """Aux metrics: expert load entropy + max/mean load ratio."""
    flat = sel.reshape(-1).long()
    counts = torch.zeros(num_experts, dtype=torch.int64,
                         device=sel.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float()
    load = counts / torch.clamp(counts.sum(), min=1.0)
    entropy = -torch.sum(load * torch.log(load + 1e-9))
    imbalance = counts.max() / torch.clamp(counts.mean(), min=1e-9)
    return {"load_entropy": entropy, "load_imbalance": imbalance}
