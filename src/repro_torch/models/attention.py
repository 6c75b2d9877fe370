"""GQA attention: blocked online-softmax attention for prefill, plain
KV-cache attention for decode.

Port of ``repro.models.attention``. ``flash_attention`` is the
reference's blocked formulation in float32 (a list of the (q-block,
kv-block) pairs that intersect causally, GQA by head groups, padding of
``sq`` / ``sk`` to block multiples), run as a Python loop over the pairs
where the reference scans; it is plain tensor code in both packages, no
kernel. ``attn_decode`` writes the new token's K/V into the cache it is
given, in place, and returns it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _init, apply_rope, rmsnorm

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
                    kv_block: int = 1024):
    """Online-softmax attention. q: (B, Sq, H, Dh); k/v: (B, Sk, KvH, Dh).

    Only the (q-block, kv-block) pairs that intersect causally are
    visited, and the (Sq, Sk) score matrix is never materialized. GQA via
    head-group reshape. Peak intermediate: (B, KvH, g, q_block, kv_block).
    """
    in_dtype = q.dtype
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
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
    vr = v.reshape(b, nk, kv_block, kvh, dh)

    if causal:
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nk)
                 if ki * kv_block < (qi + 1) * q_block]
    else:
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nk)]

    dev = q.device
    m = [torch.full((b, kvh, g, q_block), NEG_INF, device=dev)
         for _ in range(nq)]
    l_ = [torch.zeros((b, kvh, g, q_block), device=dev) for _ in range(nq)]
    acc = [torch.zeros((b, kvh, g, q_block, dh), device=dev)
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
    # (nq, B, KvH, g, qb, Dh) -> (B, S, H, Dh)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * q_block, h, dh)
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
