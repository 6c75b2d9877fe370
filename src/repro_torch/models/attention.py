"""GQA attention: blocked online-softmax attention for prefill, plain
KV-cache attention for decode; and DeepSeek-V2's multi-head latent
attention (MLA) for training.

Port of ``repro.models.attention``. ``flash_attention`` is the
reference's blocked formulation in float32 (a list of the (q-block,
kv-block) pairs that intersect causally, GQA by head groups, padding of
``sq`` / ``sk`` to block multiples), run as a Python loop over the pairs
where the reference scans; it is plain tensor code in both packages, no
kernel. ``attn_decode`` writes the new token's K/V into the cache it is
given, in place, and returns it.

MLA (``mla_init`` / ``mla_forward``, port-only: the JAX package has
none) follows DeepSeek-V2's published modeling code without a query
latent (``q_lora_rank`` null): q = x W_q per head, (128 nope | 64 rope);
c = RMSNorm(x W_kv_a[:, :512]); one rope key k_pe = x W_kv_a[:, 512:]
shared by every head; (k_nope | v) = c W_kv_b per head; YaRN RoPE on the
de-interleaved rope dims of q and k_pe (``layers.deinterleave``); the
softmax scale 192^-0.5 m^2 (``mla_softmax_scale``); a value width (128)
of its own. Serving it needs a latent KV cache, which the port does not
have: the prefill and decode of an MLA layer raise
(``no_latent_cache``).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ..obs import tracing
from .layers import (_init, apply_rope, deinterleave, rmsnorm, rope_rotate,
                     yarn_inv_freq, yarn_mscale)

NEG_INF = -1e30


def attn_init(gen, cfg, dtype=torch.float32):
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": _init(gen, (d, h * dh), dtype=dtype),
        "wk": _init(gen, (d, kvh * dh), dtype=dtype),
        "wv": _init(gen, (d, kvh * dh), dtype=dtype),
        "wo": _init(gen, (h * dh, d), dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kvh * dh,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kvh * dh,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=dev)
    return p


def _project_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kvh, dh)
    v = v.reshape(b, s, kvh, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q, k, v, *, causal: bool, q_block: int = 512,
                    kv_block: int = 1024, scale=None):
    """Online-softmax attention. q/k: (B, Sq|Sk, H|KvH, Dh); v: (B, Sk,
    KvH, Dv), Dv by default Dh. Scores are scaled by ``scale``, by default
    Dh^-0.5; the defaults compute exactly what they did before either
    argument existed.

    Only the (q-block, kv-block) pairs that intersect causally are
    visited, and the (Sq, Sk) score matrix is never materialized. GQA via
    head-group reshape. Peak intermediate: (B, KvH, g, q_block, kv_block).
    """
    in_dtype = q.dtype
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    dv = v.shape[-1]
    g = h // kvh
    if scale is None:
        scale = dh ** -0.5
    q = (q * scale).float()
    k = k.float()
    v = v.float()

    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    pq = (-sq) % q_block
    pk = (-sk) % kv_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq = q.shape[1] // q_block
    nk = k.shape[1] // kv_block
    # qr: (nq, B, KvH, g, qb, Dh)
    qr = q.reshape(b, nq, q_block, kvh, g, dh).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, nk, kv_block, kvh, dh)
    vr = v.reshape(b, nk, kv_block, kvh, dv)

    if causal:
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nk)
                 if ki * kv_block < (qi + 1) * q_block]
    else:
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nk)]

    dev = q.device
    m = [torch.full((b, kvh, g, q_block), NEG_INF, device=dev)
         for _ in range(nq)]
    l_ = [torch.zeros((b, kvh, g, q_block), device=dev) for _ in range(nq)]
    acc = [torch.zeros((b, kvh, g, q_block, dv), device=dev)
           for _ in range(nq)]
    for qi, ki in pairs:
        s_ = torch.einsum("bhgqd,bkhd->bhgqk", qr[qi], kr[:, ki])
        k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
        valid = k_pos[None, :] < sk
        if causal:
            q_pos = qi * q_block + torch.arange(q_block, device=dev)
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        s_ = torch.where(valid[None, None, None], s_, NEG_INF)
        m_new = torch.maximum(m[qi], s_.amax(dim=-1))
        p_ = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(m[qi] - m_new)
        l_[qi] = l_[qi] * corr + p_.sum(dim=-1)
        acc[qi] = acc[qi] * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p_, vr[:, ki])
        m[qi] = m_new
    out = torch.stack(acc) / torch.clamp(torch.stack(l_)[..., None],
                                         min=1e-30)
    # (nq, B, KvH, g, qb, Dv) -> (B, S, H, Dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * q_block, h, dv)
    return out[:, :sq].to(in_dtype)


def attn_forward(p, cfg, x, positions, *, causal=True):
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ p["wo"]


def cross_attn_forward(p, cfg, x, memory):
    """Decoder cross-attention onto encoder memory (no RoPE, not causal)."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (memory @ p["wk"]).reshape(b, memory.shape[1], kvh, dh)
    v = (memory @ p["wv"]).reshape(b, memory.shape[1], kvh, dh)
    out = flash_attention(q, k, v, causal=False)
    return out.reshape(b, s, -1) @ p["wo"]


def attn_prefill(p, cfg, x, positions):
    """Returns (out, (k_cache, v_cache)) for serving."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, causal=True)
    return out.reshape(b, s, -1) @ p["wo"], (k, v)


def attn_decode(p, cfg, x, cache, pos: int):
    """One-token decode. cache: (k, v) each (B, S_max, KvH, Dh); ``pos``
    a Python int. Slot ``pos`` of both caches is overwritten in place
    (clamped into the cache, as ``dynamic_update_slice`` clamps)."""
    b, s, _ = x.shape  # s == 1
    k_cache, v_cache = cache
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    s_max = k_cache.shape[1]
    at = min(max(int(pos), 0), s_max - 1)
    k_cache[:, at:at + 1] = k_new.to(k_cache.dtype)
    v_cache[:, at:at + 1] = v_new.to(v_cache.dtype)
    valid = torch.arange(s_max, device=x.device)[None, None, None, None, :] \
        <= pos
    qg = (q * dh ** -0.5).reshape(b, 1, kvh, g, dh)
    # fast_decode_math: the reference reads the cache in its storage
    # dtype with float32 accumulation (preferred_element_type), the
    # softmax weights cast to that dtype too; bf16 products are exact in
    # float32, so the float32 einsum of the same values computes that
    fast = cfg.fast_decode_math
    if fast:
        qg = qg.to(k_cache.dtype)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float())
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if fast:
        w = w.to(k_cache.dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache.float())
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return out @ p["wo"], (k_cache, v_cache)


# --------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2), training only
# --------------------------------------------------------------------------

def is_mla(cfg) -> bool:
    """Whether ``cfg``'s attention layers are latent attention."""
    return getattr(cfg, "kv_lora_rank", 0) > 0


def mla_softmax_scale(cfg) -> float:
    """q_head_dim^-0.5, times m^2 with m = ``yarn_mscale(factor,
    mscale_all_dim)`` when the config scales RoPE by YaRN (1.2608... for
    DeepSeek-V2-Lite, so 192^-0.5 x 1.5896...)."""
    scale = cfg.q_head_dim ** -0.5
    if cfg.mscale_all_dim:
        m = yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
        scale = scale * m * m
    return scale


def mla_rope(cfg, device):
    """(YaRN's inverse frequencies of the rope dims, the cos/sin factor
    mscale / mscale_all_dim as their m's)."""
    freqs = yarn_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta,
                          cfg.rope_factor, cfg.rope_orig_len, cfg.beta_fast,
                          cfg.beta_slow, device)
    return freqs, (yarn_mscale(cfg.rope_factor, cfg.mscale)
                   / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))


def mla_init(gen, cfg, dtype=torch.float32):
    d, h = cfg.d_model, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return {
        "wq": _init(gen, (d, h * cfg.q_head_dim), dtype=dtype),
        "wkv_a": _init(gen, (d, r + dr), dtype=dtype),
        "kv_norm": torch.ones((r,), dtype=dtype, device=gen.device),
        "wkv_b": _init(gen, (r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                       dtype=dtype),
        "wo": _init(gen, (h * cfg.v_head_dim, d), dtype=dtype),
    }


def _mla_qkv(p, cfg, x, positions):
    """q, k (B, S, H, 192) and v (B, S, H, 128), in x's dtype."""
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dn + dr)
    kv_a = x @ p["wkv_a"]
    c = rmsnorm(p["kv_norm"], kv_a[..., :r], cfg.norm_eps)
    kv = (c @ p["wkv_b"]).reshape(b, s, h, dn + dv)
    freqs, ms = mla_rope(cfg, x.device)
    q_pe = rope_rotate(deinterleave(q[..., dn:]), positions, freqs, ms)
    k_pe = rope_rotate(deinterleave(kv_a[..., r:].reshape(b, s, 1, dr)),
                       positions, freqs, ms)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], dim=-1)
    return q, k, kv[..., dn:]


_CORE_WATCH = None


@contextmanager
def watch_core(fn):
    """Call ``fn(q, k, v, out)`` in the body with each latent attention
    core's inputs and answer as ``mla_forward`` computes them (q, k (B,
    S, H, 192), v and out (B, S, H, 128); the remat recompute calls it
    too, on autograd's thread); ``fn`` copies what it keeps. Off, the
    default, a call pays one test."""
    global _CORE_WATCH
    prev, _CORE_WATCH = _CORE_WATCH, fn
    try:
        yield fn
    finally:
        _CORE_WATCH = prev


def mla_forward(p, cfg, x, positions, *, causal=True):
    """Latent attention over x (B, S, d): ``flash_attention`` with the
    query width 192, the value width 128 and ``mla_softmax_scale``."""
    b, s, _ = x.shape
    with tracing.span("attn.mla"):
        q, k, v = _mla_qkv(p, cfg, x, positions)
        out = flash_attention(q, k, v, causal=causal,
                              scale=mla_softmax_scale(cfg))
        if _CORE_WATCH is not None:
            _CORE_WATCH(q, k, v, out)
        return out.reshape(b, s, -1) @ p["wo"]


def no_latent_cache():
    """Serving MLA (prefill and decode) is not ported: raises."""
    raise NotImplementedError(
        "serving latent attention (MLA) needs a latent KV cache of (c, "
        "k_pe) per token in serve/engine.py, which the port does not have "
        "yet; MLA configs train (models.model.loss_fn) only")
