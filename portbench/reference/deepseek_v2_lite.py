"""The plain reference of the ``deepseek_v2_lite`` configuration: one
training step's loss, gradients and AdamW update, and the push-relabel
router's flows, worked out again in plain torch from DeepSeek-V2's published equations
(arXiv:2405.04434; the ``modeling_deepseek.py`` beside the model's
``config.json``) and from the inputs the entry made.

Plain torch in float32 with TF32 off (``torch.backends.cuda.matmul
.allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` False while a
check runs). It imports nothing of the program, of JAX, or of the
benchmark's ``entries`` and ``lib``. It runs on the device of the
weights it is given, in blocks so that it fits beside them on the card:
each layer under ``torch.utils.checkpoint`` (its activations recomputed
in the backward pass), the attention one query block at a time (each
block checkpointed too), the loss a chunk of positions at a time.

The instance (``entries/train.py``'s ``TrainInstance``): ``tokens`` (B,
S + 1) int; ``params``, the weights the step ran on, in this file's
layout (``LAYOUT``); ``moments`` ({name: (m, v)}), AdamW's moments
before the step of the leaves ``grad_names`` gives; ``step``, AdamW's
step count before the step; ``optim``, the optimizer's settings (``lr``,
``warmup``, ``total_steps``, ``max_grad_norm``, ``beta1``, ``beta2``,
``eps``, ``weight_decay``). The answer: the program's ``loss`` and
``grad_norm`` (floats), ``grads`` and ``update`` ({name: tensor}, names
as ``grad_names`` gives them: each leaf's gradient before the clip, and
its weights after the step less before) and ``routes``, one per MoE
layer in order: ``c_int`` (T, E) int32 (the router's integer costs),
``sel`` (T, k) int32, ``flow`` (T, E) int32, and ``flow_recompute``, the
same layer's flow from the backward pass's recompute; ``attn_core``, the
first layer's attention core in the forward: its ``q``, ``k`` (B, S, H,
192), ``v`` and answer ``out`` (B, S, H, 128).

What follows the published code, and where it departs:

- MLA without a query latent: q = x W_q (16 heads of 128 nope + 64
  rope); [c | k_pe] = x W_kv_a; c normalised by its own RMSNorm;
  [k_nope | v] = c W_kv_b per head; the rope key k_pe shared by every
  head; scores (q . k) 192^-0.5 m^2 with m = 0.1 mscale_all_dim ln(factor)
  + 1; causal softmax; o = (softmax v) W_o.
- YaRN on the 64 rope dims: ``inv_freq = inter (1 - mask) + extra
  mask`` (extra = theta^(-2i/64), inter = extra / factor, mask = 1 -
  ramp(low, high), low and high from ``yarn_find_correction_range``),
  cos and sin scaled by mscale / mscale_all_dim (1 here), applied after
  the published de-interleave (pairs (2i, 2i + 1), then rotate-half).
- The MoE layer: softmax gate over the 64 experts in float32, the gates
  the probabilities at the chosen experts (renormalised only when
  ``norm_topk_prob``), times ``routed_scaling_factor``; the 2 shared
  experts one SiLU-GLU MLP of width 2 x 1408 on every token.
  Departures, as the configuration states them (``assumed``): the
  experts are chosen by the program's ``sel`` (the paper's push-relabel
  router, not greedy top-6; a discrete pick flips on a rounding, so the
  reference follows the program's picks and computes the gates itself),
  each expert takes at most ``capacity`` = int(T k / E x
  capacity_factor) + 1 entries, in token-then-slot order (the rest are
  dropped, as the program's dispatch drops them), and the sequence
  auxiliary loss is left out.
- The optimizer (DeepSeek-V2's: AdamW with beta1 0.9, beta2 0.95,
  weight decay 0.1, the gradient clipped to a global norm of 1.0): the
  reference's own gradients scaled to at most ``max_grad_norm`` by its
  own global norm, then AdamW from the instance's moments at step count
  ``step`` + 1 (bias-corrected, decoupled weight decay), at the learning
  rate of a linear warm-up over ``warmup`` steps then a cosine over
  ``total_steps``, in float32 (``adamw_after``).
- The router: ``pushrelabel_flow`` transcribes the integer push-relabel
  phases as the router runs them (duals start at 1, k free units a token,
  ceil(T k / E) an expert, exactly ``phases`` phases of at most
  ``max_rounds`` propose rounds) and is run on the program's ``c_int``.

Numbers:

  router_flow_mismatch  flow entries (forward and recompute) that differ
                        from the transcription's on the program's c_int
  router_infeasible     units over k in a token's flow, over capacity in
                        an expert's, and flow units missing from ``sel``
  grad_rel_err          the worst ||g - g_ref|| / ||g_ref|| over the
                        leaves the answer carries
  grad_norm_rel_err     |grad_norm - ||g_ref|| | / ||g_ref||, the norm
                        over every leaf
  param_update_rel_err  the worst ||d - d_ref|| / ||d_ref|| over the
                        leaves the answer updates: d its weights after
                        less before, d_ref the same of ``adamw_after``
                        (1 for an update that leaves the weights as they
                        were)
  attn_core_rel_err     ||o - o_ref|| / ||o_ref|| of the first layer's
                        attention core: o the program's answer, o_ref
                        the causal softmax(q k^T 192^-0.5 m^2) v in
                        float32 from the program's own q, k and v (the
                        configuration states the core in float32)

and, as a breakdown that no limit holds, ``loss_rel_err`` (|loss -
loss_ref| / |loss_ref|: the precision hardly moves it) and each leaf's
own errors under ``grad_rel_err.<name>`` and
``param_update_rel_err.<name>``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NUMBERS = ("router_flow_mismatch", "router_infeasible", "grad_rel_err",
           "grad_norm_rel_err", "param_update_rel_err", "attn_core_rel_err")

# the weights' layout: names of the top level and of one layer; a dense
# layer has the mlp_* weights, an MoE layer the router, the routed
# experts' stacked (E, ...) weights and the shared experts' shared_*
LAYOUT = {
    "top": ("embed", "final_norm", "lm_head"),
    "attn": ("ln1", "wq", "wkv_a", "kv_norm", "wkv_b", "wo", "ln2"),
    "dense": ("mlp_gate", "mlp_up", "mlp_down"),
    "moe": ("router", "w_gate", "w_up", "w_down", "shared_gate",
            "shared_up", "shared_down"),
}
Q_BLOCK = 1024
LOSS_CHUNK = 1024


class no_tf32:
    """float32 matmuls in float32: TF32 off for the body."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def grad_names(config: dict) -> list:
    """The leaves whose gradients and updates ``check`` compares: the
    embedding; every leaf of the dense layers; of the first MoE layer
    the MLA, norms, router, shared experts and routed ``w_down``; every
    leaf of the last MoE layer; the final norm and the head."""
    fd = config["first_k_dense_replace"]
    last = config["num_hidden_layers"] - 1
    dense = [f"layers.{i}.{n}" for i in range(fd)
             for n in LAYOUT["attn"] + LAYOUT["dense"]]
    first = [f"layers.{fd}.{n}" for n in LAYOUT["attn"] + (
        "router", "w_down", "shared_gate", "shared_up", "shared_down")]
    final = [f"layers.{last}.{n}" for n in LAYOUT["attn"] + LAYOUT["moe"]]
    names = ["embed"] + dense + first + final + ["final_norm", "lm_head"]
    return list(dict.fromkeys(names))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(config: dict, device):
    """(inv_freq (dim/2,), the cos/sin factor) of the rope dims."""
    dim = config["qk_rope_head_dim"]
    base = config["rope_theta"]
    rs = config["rope_scaling"]
    factor = rs["factor"]
    orig = rs["original_max_position_embeddings"]

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) \
            / (2 * math.log(base))

    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i2 = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** i2)
    inter = 1.0 / (factor * base ** i2)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv_freq = inter * (1 - mask) + extra * mask
    scale = (yarn_get_mscale(factor, rs["mscale"])
             / yarn_get_mscale(factor, rs["mscale_all_dim"]))
    return inv_freq, scale


def softmax_scale(config: dict) -> float:
    q_dim = config["qk_nope_head_dim"] + config["qk_rope_head_dim"]
    scale = q_dim ** -0.5
    rs = config["rope_scaling"]
    if rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def apply_rope(x, cos, sin):
    """x (B, S, H, D): the published de-interleave, then rotate-half."""
    b, s, h, d = x.shape
    x = x.view(b, s, h, d // 2, 2).transpose(4, 3).reshape(b, s, h, d)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attend_block(q, k, v, q0: int, scale: float):
    """Causal softmax attention of the queries at positions q0 + i over
    the keys at 0 .. q0 + len(q) - 1. q (B, qb, H, Dq), k (B, S', H, Dq),
    v (B, S', H, Dv) -> (B, qb, H, Dv)."""
    qb, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    allowed = (torch.arange(sk, device=q.device)[None, :]
               <= q0 + torch.arange(qb, device=q.device)[:, None])
    s = s.masked_fill(~allowed, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def mla(p, config, x, cos, sin):
    b, s, _ = x.shape
    h = config["num_attention_heads"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, r = config["v_head_dim"], config["kv_lora_rank"]
    q = (x @ p["wq"]).view(b, s, h, dn + dr)
    ckv = x @ p["wkv_a"]
    c = rms_norm(ckv[..., :r], p["kv_norm"], config["rms_norm_eps"])
    k_pe = apply_rope(ckv[..., r:].reshape(b, s, 1, dr), cos, sin)
    kv = (c @ p["wkv_b"]).view(b, s, h, dn + dv)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], -1)
    v = kv[..., dn:]
    o = attention_core(q, k, v, softmax_scale(config))
    return o.reshape(b, s, h * dv) @ p["wo"]


def attention_core(q, k, v, scale: float):
    """Causal softmax attention, one block of ``Q_BLOCK`` queries at a
    time (each checkpointed under autograd): q, k (B, S, H, Dq), v (B,
    S, H, Dv) -> (B, S, H, Dv)."""
    s = q.shape[1]
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, s)
        args = (q[:, q0:q1], k[:, :q1], v[:, :q1], q0, scale)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend_block(*args))
    return torch.cat(outs, dim=1)


def glu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def capacity_of(config: dict, t: int) -> int:
    """Entries an expert takes: int(T k / E x capacity_factor) + 1."""
    return int(t * config["num_experts_per_tok"] / config["n_routed_experts"]
               * config["capacity_factor"]) + 1


def moe(p, config, x, sel):
    """The MoE layer on tokens routed by ``sel`` (T, k)."""
    b, s, d = x.shape
    t, k = sel.shape
    xt = x.reshape(t, d)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    gates = torch.gather(probs, 1, sel.long())
    if config["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * config["routed_scaling_factor"]
    cap = capacity_of(config, t)
    flat = sel.reshape(-1).long()
    out = torch.zeros_like(xt)
    for e in range(config["n_routed_experts"]):
        entries = torch.nonzero(flat == e).reshape(-1)[:cap]
        if entries.numel() == 0:
            continue
        tok = entries // k
        y = glu(xt[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
        out = out.index_add(0, tok, y * gates.reshape(-1)[entries][:, None])
    shared = glu(xt, p["shared_gate"], p["shared_up"], p["shared_down"])
    return (out + shared).reshape(b, s, d)


def _layer(p, config, x, cos, sin, sel):
    eps = config["rms_norm_eps"]
    x = x + mla(p, config, rms_norm(x, p["ln1"], eps), cos, sin)
    hn = rms_norm(x, p["ln2"], eps)
    if sel is None:
        return x + glu(hn, p["mlp_gate"], p["mlp_up"], p["mlp_down"])
    return x + moe(p, config, hn, sel)


def _chunk_nll(x, head, labels):
    logits = x @ head
    return (torch.logsumexp(logits, -1)
            - torch.gather(logits, -1, labels[..., None])[..., 0]).sum()


def forward_loss(params, config, tokens, sels):
    """The mean next-token cross-entropy of ``tokens`` (B, S + 1), the MoE
    layers routed by ``sels`` (one (T, k) tensor a MoE layer)."""
    inp, labels = tokens[:, :-1].long(), tokens[:, 1:].long()
    b, s = inp.shape
    x = params["embed"][inp]
    inv_freq, msc = yarn_inv_freq(config, x.device)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv_freq[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    cos = (emb.cos() * msc)[None, :, None, :]
    sin = (emb.sin() * msc)[None, :, None, :]
    fd = config["first_k_dense_replace"]
    for i, lp in enumerate(params["layers"]):
        sel = None if i < fd else sels[i - fd]
        x = checkpoint(_layer, lp, config, x, cos, sin, sel,
                       use_reentrant=False)
    x = rms_norm(x, params["final_norm"], config["rms_norm_eps"])
    total = x.new_zeros(())
    for s0 in range(0, s, LOSS_CHUNK):
        total = total + checkpoint(
            _chunk_nll, x[:, s0:s0 + LOSS_CHUNK], params["lm_head"],
            labels[:, s0:s0 + LOSS_CHUNK], use_reentrant=False)
    return total / (b * s)


def flat_params(params):
    """[(name, tensor)] of every weight, names as ``grad_names`` uses."""
    out = [(n, params[n]) for n in LAYOUT["top"]]
    for i, lp in enumerate(params["layers"]):
        out += [(f"layers.{i}.{n}", w) for n, w in lp.items()]
    return out


def loss_and_grads(params, config, tokens, sels):
    """(loss, {name: gradient}) of every weight, in float32."""
    named = flat_params(params)
    views = {n: w.detach().float().requires_grad_(True) for n, w in named}
    tree = {n: views[n] for n in LAYOUT["top"]}
    tree["layers"] = [{n: views[f"layers.{i}.{n}"] for n in lp}
                      for i, lp in enumerate(params["layers"])]
    with torch.enable_grad():
        loss = forward_loss(tree, config, tokens, sels)
        grads = torch.autograd.grad(loss, [views[n] for n, _ in named])
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

def learning_rate(optim: dict, step: int) -> float:
    """The rate at AdamW's step count ``step`` (before the step): a
    linear warm-up to ``lr`` over ``warmup`` steps, then a cosine to 0 at
    ``total_steps``."""
    lr, warm, total = optim["lr"], optim["warmup"], optim["total_steps"]
    if step < warm:
        return lr * (step + 1) / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t))


def adamw_after(p, g, m, v, step: int, optim: dict):
    """The weights ``p`` after one AdamW step (float32) on the clipped
    gradient ``g`` from the moments ``m``, ``v`` at step count ``step``:
    m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2) g^2, u = (m' / (1 -
    b1^t)) / (sqrt(v' / (1 - b2^t)) + eps) with t = step + 1, and p - lr
    (u + wd p)."""
    b1, b2, t = optim["beta1"], optim["beta2"], step + 1
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    u = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + optim["eps"])
    return p - learning_rate(optim, step) * (u + optim["weight_decay"] * p)


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------

_H1, _H2, _H3 = 2654435761, 2246822519, 3266489917
_M32 = 0xFFFFFFFF
_I32_MAX = 2 ** 31 - 1


def _mul32(a, c: int):
    """(a c) mod 2^32 for int64 a in [0, 2^32), in 16-bit halves of c."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(h):
    h = h ^ (h >> 15)
    h = _mul32(h, _H2)
    h = h ^ (h >> 13)
    h = _mul32(h, _H3)
    return h ^ (h >> 16)


def proposal_keys(t: int, e: int, salt: int, device):
    """The uint32 hash key of every (token, expert) for one round's salt,
    as int64: mix(i H1 + j H2 + salt H3)."""
    i = torch.arange(t, dtype=torch.int64, device=device)
    j = torch.arange(e, dtype=torch.int64, device=device)
    h = (_mul32(i, _H1)[:, None] + _mul32(j, _H2)[None, :]) & _M32
    return _mix((h + _mul32(torch.tensor(salt & _M32, device=device), _H3))
                & _M32)


def pushrelabel_flow(c_int, k: int, capacity: int, phases: int = 24,
                     max_rounds: int = 8):
    """The (T, E) int32 flow of the router's integer push-relabel on costs
    ``c_int``: token duals start at 1, expert duals at 0, k free units a
    token, ``capacity`` an expert; each phase proposes along admissible
    edges (y_t + y_e == c + 1) to the column of least hash key, grants
    each column's remaining capacity to its proposers in token order,
    pushes (displacing the expert's higher-level flow, last tokens
    first), and relabels (a token with units left up one, an expert
    whose higher level emptied down one)."""
    t, e = c_int.shape
    dev = c_int.device
    i32 = torch.int32
    cols = torch.arange(e, dtype=torch.int64, device=dev)
    yb = torch.ones(t, dtype=i32, device=dev)
    yahi = torch.zeros(e, dtype=i32, device=dev)
    fb = torch.full((t,), k, dtype=i32, device=dev)
    fa = torch.full((e,), capacity, dtype=i32, device=dev)
    fhi = torch.zeros((t, e), dtype=i32, device=dev)
    flo = torch.zeros((t, e), dtype=i32, device=dev)
    for ph in range(phases):
        hi_free = torch.where(yahi == 0, fa, 0)
        cap = hi_free + fhi.sum(0, dtype=i32)
        rem = fb
        granted = torch.zeros((t, e), dtype=i32, device=dev)
        for r in range(max_rounds):
            adm = (yb[:, None] + yahi[None, :] == c_int + 1) & (cap > 0)
            can = adm.any(1) & (rem > 0)
            if not bool(can.any()):
                break
            keys = torch.where(adm, proposal_keys(t, e, ph * 7919 + r, dev),
                               _M32)
            best = (keys * e + cols).amin(1) % e
            prop = can[:, None] & (best[:, None] == cols)
            amt = torch.where(can, rem, 0)
            excl = amt.cumsum(0).to(i32) - amt
            base = torch.where(prop, excl[:, None], _I32_MAX).amin(0)
            base_t = torch.where(prop, base[None, :], _I32_MAX).amin(1)
            cap_t = torch.where(prop, cap[None, :], _I32_MAX).amin(1)
            prefix = excl - torch.where(can, base_t, 0)
            grant = torch.where(
                can, torch.minimum((cap_t - prefix).clamp_min(0), amt), 0)
            g_edge = torch.where(prop, grant[:, None], 0)
            rem = rem - grant
            cap = cap - g_edge.sum(0, dtype=i32)
            granted = granted + g_edge
        g_a = granted.sum(0, dtype=i32)
        use_free = torch.minimum(g_a, hi_free)
        disp = g_a - use_free
        suffix_excl = fhi.sum(0, keepdim=True, dtype=i32) \
            - fhi.cumsum(0).to(i32)
        take = torch.minimum((disp[None, :] - suffix_excl).clamp_min(0), fhi)
        fhi2 = fhi - take
        fa2 = fa - use_free
        hi_left = torch.where(yahi == 0, fa2, 0) + fhi2.sum(0, dtype=i32)
        collapse = (hi_left == 0) & (g_a > 0)
        lo = flo + granted
        yb = yb + ((fb > 0) & (rem > 0)).to(i32)
        yahi = torch.where(collapse, yahi - 1, yahi)
        fhi = torch.where(collapse[None, :], lo, fhi2)
        flo = torch.where(collapse[None, :], 0, lo)
        fb = rem + take.sum(1, dtype=i32)
        fa = fa2
    return fhi + flo


def router_numbers(route: dict, config: dict):
    """(flow entries that differ from the transcription's, infeasible
    units) of one MoE layer's route."""
    c_int, sel = route["c_int"], route["sel"].long()
    t, k = sel.shape
    e = config["n_routed_experts"]
    capacity = -(-t * k // e)
    want = pushrelabel_flow(c_int, k, capacity,
                            config["router_phases"], config["router_rounds"])
    mismatch = sum(int((route[f] != want).sum())
                   for f in ("flow", "flow_recompute") if f in route)
    flow = route["flow"].long()
    picked = torch.zeros((t, e), dtype=torch.int64, device=sel.device)
    picked.scatter_add_(1, sel, torch.ones_like(sel))
    bad = (int((flow.sum(1) - k).clamp_min(0).sum())
           + int((flow.sum(0) - capacity).clamp_min(0).sum())
           + int((flow - picked).clamp_min(0).sum()))
    return mismatch, bad


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a.double() - b.double()))
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-300))


def check(instance, answer: dict, config: dict) -> dict:
    with no_tf32():
        mismatch, bad = 0, 0
        for route in answer["routes"]:
            m, b_ = router_numbers(route, config)
            mismatch, bad = mismatch + m, bad + b_
        sels = [r["sel"] for r in answer["routes"]]
        loss, grads = loss_and_grads(instance.params, config,
                                     instance.tokens, sels)
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        leaf = {f"grad_rel_err.{n}": _rel(g, grads[n])
                for n, g in answer["grads"].items()}
        core = answer["attn_core"]
        with torch.no_grad():
            want = attention_core(core["q"].float(), core["k"].float(),
                                  core["v"].float(), softmax_scale(config))
        core_err = _rel(core["out"], want)
        del want
        optim = instance.optim
        clip = min(1.0, optim["max_grad_norm"] / max(norm, 1e-9))
        weights = dict(flat_params(instance.params))
        upd = {}
        for n, d in answer["update"].items():
            p = weights[n].float()
            m, v = (x.to(p.device) for x in instance.moments[n])
            want = adamw_after(p, grads[n] * clip, m, v, instance.step,
                               optim) - p
            upd[f"param_update_rel_err.{n}"] = _rel(d, want)
            del p, m, v, want
    loss = float(loss)
    return {"router_flow_mismatch": float(mismatch),
            "router_infeasible": float(bad),
            "grad_rel_err": max(leaf.values()),
            "grad_norm_rel_err": abs(answer["grad_norm"] - norm) / norm,
            "param_update_rel_err": max(upd.values()),
            "attn_core_rel_err": core_err,
            "loss_rel_err": abs(answer["loss"] - loss) / abs(loss),
            **leaf, **upd}
