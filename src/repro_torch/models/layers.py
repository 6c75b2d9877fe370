"""Shared neural building blocks: norms, RoPE (and YaRN's frequencies),
GLU MLP, embeddings, chunked cross-entropy.

Port of ``repro.models.layers``. Parameters are plain dicts of tensors;
every apply function is functional. Initialisers draw from an explicit
``torch.Generator`` on the parameters' device, in float32, and cast at
once to the asked dtype (so building a bf16 model holds one tensor's
float32 copy at a time).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32):
    """Normal(0, 1) * scale, scale = 1/sqrt(fan_in) by default (fan_in the
    second-to-last axis, as in the reference)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / (fan_in ** 0.5)
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(dtype)


def rmsnorm_init(d, dtype=torch.float32, device=None):
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(w, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, Dh); positions: (..., S)."""
    return rope_rotate(x, positions, rope_freqs(x.shape[-1], theta, x.device))


def rope_rotate(x, positions, freqs, mscale: float = 1.0):
    """Rotate-half RoPE of x (..., S, H, Dh) at ``positions`` (..., S) by
    the inverse frequencies ``freqs`` (Dh/2,): dim i pairs with dim
    i + Dh/2; cos and sin are scaled by ``mscale`` (YaRN's) unless 1."""
    angles = positions[..., :, None].float() * freqs           # (...,S,Dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def deinterleave(x):
    """(..., D) -> (..., D): the even dims, then the odd ones. DeepSeek-V2's
    ``apply_rotary_pos_emb`` views the rope dims as D/2 pairs (2i, 2i+1)
    and transposes them this way before rotate-half, so pair i is rotated
    by frequency i; queries and keys get the same permutation, so their
    dot products are those of the interleaved layout."""
    d = x.shape[-1]
    return x.reshape(x.shape[:-1] + (d // 2, 2)).transpose(-1, -2) \
        .reshape(x.shape)


# --------------------------------------------------------------------------
# YaRN (DeepSeek-V2's DeepseekV2YarnRotaryEmbedding, rope_scaling "yarn")
# --------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """``yarn_get_mscale``: 0.1 mscale ln(factor) + 1, or 1 for factor <= 1."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def _yarn_correction_dim(rotations, dim, theta, orig_len):
    return (dim * math.log(orig_len / (rotations * 2 * math.pi))) \
        / (2 * math.log(theta))


def yarn_ramp_bounds(dim: int, theta: float, orig_len: int,
                     beta_fast: float, beta_slow: float):
    """``yarn_find_correction_range``: the (low, high) pair indices between
    which the ramp runs (10 and 23 for DeepSeek-V2-Lite's 64 rope dims)."""
    low = math.floor(_yarn_correction_dim(beta_fast, dim, theta, orig_len))
    high = math.ceil(_yarn_correction_dim(beta_slow, dim, theta, orig_len))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(dim: int, theta: float, factor: float, orig_len: int,
                  beta_fast: float, beta_slow: float, device=None):
    """YaRN's inverse frequencies of ``dim`` rope dims, as the published
    code computes them in float32: ``inter (1 - mask) + extra mask`` with
    ``extra = theta^(-2i/dim)``, ``inter = 1 / (factor theta^(2i/dim))``
    and ``mask = 1 - ramp(low, high)`` over the dim/2 pairs (the
    high-frequency pairs keep ``extra``, the low ones are interpolated)."""
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** pos)
    inter = 1.0 / (factor * theta ** pos)
    low, high = yarn_ramp_bounds(dim, theta, orig_len, beta_fast, beta_slow)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def glu_mlp_init(gen, d, ff, dtype=torch.float32):
    return {
        "w_gate": _init(gen, (d, ff), dtype=dtype),
        "w_up": _init(gen, (d, ff), dtype=dtype),
        "w_down": _init(gen, (ff, d), dtype=dtype),
    }


def glu_mlp(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def embed_init(gen, vocab, d, dtype=torch.float32):
    return _init(gen, (vocab, d), scale=0.02, dtype=dtype)


def embed_lookup(table, ids):
    return table[ids.long()]


def _chunk_nll(logits_fn, xs, ls, ms):
    """Summed masked negative log-likelihood of one chunk."""
    logits = logits_fn(xs).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
    return torch.sum((lse - gold) * ms)


def cross_entropy_chunked(logits_fn, x, labels, mask, chunk: int = 512):
    """Streaming CE over sequence chunks so the (B, S, V) logits tensor is
    never materialized in full. ``logits_fn(x_chunk) -> (B, c, V)``.

    The reference scans over the chunks. Here a Python loop does, and
    while grad is enabled each chunk runs under ``torch.utils.checkpoint``,
    so backward keeps the chunk's input alone and recomputes its float32
    logits: without it autograd would hold every chunk's logits at once.
    S is padded to a multiple of the chunk with masked positions; the
    result is the masked mean ``tot / max(cnt, 1)``."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(x.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (logits_fn, x[:, sl], labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            nll = checkpoint(_chunk_nll, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            nll = _chunk_nll(*args)
        tot = tot + nll
        cnt = cnt + torch.sum(mask[:, sl])
    return tot / torch.clamp(cnt, min=1.0)
