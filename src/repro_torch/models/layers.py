"""Shared neural building blocks: norms, RoPE, GLU MLP, embeddings,
chunked cross-entropy.

Port of ``repro.models.layers``. Parameters are plain dicts of tensors;
every apply function is functional. Initialisers draw from an explicit
``torch.Generator`` on the parameters' device, in float32, and cast at
once to the asked dtype (so building a bf16 model holds one tensor's
float32 copy at a time).
"""
from __future__ import annotations

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
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                    # (Dh/2,)
    angles = positions[..., :, None].float() * freqs           # (...,S,Dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
