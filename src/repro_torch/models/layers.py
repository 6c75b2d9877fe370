"""Shared neural building blocks: norms, RoPE, GLU MLP, embeddings.

Port of ``repro.models.layers``. Parameters are plain dicts of tensors;
every apply function is functional. Initialisers draw from an explicit
``torch.Generator`` on the parameters' device, in float32, and cast at
once to the asked dtype (so building a bf16 model holds one tensor's
float32 copy at a time). The reference's ``cross_entropy_chunked``
belongs to training and is not ported here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
