"""Mamba-2 (SSD, state-space duality) block: the chunked quadratic-intra /
recurrent-inter algorithm (arXiv:2405.21060), plus O(1)-state
single-token decode.

Port of ``repro.models.mamba``: separate z / x / B / C / dt projections
(the reference's split of the fused ``in_proj``), depthwise causal
convolutions of width 4, and the chunk loop as a Python loop over chunks
where the reference scans, so prefill memory stays O(chunk^2 + state) per
layer."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _init, rmsnorm


def mamba_dims(cfg):
    d_inner = 2 * cfg.d_model
    headdim = cfg.ssm_headdim
    nheads = d_inner // headdim
    d_state = cfg.ssm_state
    return d_inner, headdim, nheads, d_state


def mamba_init(gen, cfg, dtype=torch.float32):
    d = cfg.d_model
    d_inner, headdim, nheads, d_state = mamba_dims(cfg)
    dev = gen.device

    def const(n, v):
        return torch.full((n,), v, dtype=dtype, device=dev)
    return {
        "in_z": _init(gen, (d, d_inner), dtype=dtype),
        "in_x": _init(gen, (d, d_inner), dtype=dtype),
        "in_b": _init(gen, (d, d_state), dtype=dtype),
        "in_c": _init(gen, (d, d_state), dtype=dtype),
        "in_dt": _init(gen, (d, nheads), dtype=dtype),
        "conv_x": _init(gen, (4, d_inner), scale=0.5, dtype=dtype),
        "conv_b": _init(gen, (4, d_state), scale=0.5, dtype=dtype),
        "conv_c": _init(gen, (4, d_state), scale=0.5, dtype=dtype),
        "conv_bias_x": const(d_inner, 0.0),
        "conv_bias_b": const(d_state, 0.0),
        "conv_bias_c": const(d_state, 0.0),
        "a_log": const(nheads, 0.0),
        "d_skip": const(nheads, 1.0),
        "dt_bias": const(nheads, 0.0),
        "norm_w": const(d_inner, 1.0),
        "out_proj": _init(gen, (d_inner, d), dtype=dtype),
    }


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), with no linear cut-off
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, bias):
    """Depthwise causal conv, kernel 4, over (B, L, C)."""
    pad = F.pad(x, (0, 0, 3, 0))
    out = (
        pad[:, 0:-3] * w[0] + pad[:, 1:-2] * w[1]
        + pad[:, 2:-1] * w[2] + pad[:, 3:] * w[3]
    )
    return F.silu(out + bias)


def ssd_scan(x, dt, a, b_mat, c_mat, chunk: int = 256, init_state=None):
    """Chunked SSD. x: (B,L,H,P); dt: (B,L,H); a: (H,) (negative);
    b_mat/c_mat: (B,L,N). Returns (y (B,L,H,P), final_state (B,H,P,N))."""
    bsz, l, h, p_ = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, l)
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    state = init_state
    if state is None:
        state = torch.zeros((bsz, h, p_, n), dtype=torch.float32,
                            device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xk, dtk, bk, ck = x[:, sl], dt[:, sl], b_mat[:, sl], c_mat[:, sl]
        da = dtk * a                                      # (B,Q,H)
        cums = torch.cumsum(da, dim=1)        # inclusive cumsum over chunk
        seg = cums[:, :, None, :] - cums[:, None, :, :]   # (B,Qi,Qj,H)
        # mask BEFORE exp: the upper triangle of seg is positive
        seg = torch.where(tri[None, :, :, None], seg, -1e30)
        decay = torch.exp(seg)
        cb = torch.einsum("bin,bjn->bij", ck, bk)         # (B,Qi,Qj)
        xdt = xk * dtk[..., None]                         # (B,Q,H,P)
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", cb, decay, xdt)
        # inter-chunk: contribution of the incoming state
        state_decay = torch.exp(cums)                     # (B,Q,H)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", ck, state, state_decay)
        # S' = S*exp(sum da) + sum_i exp(cum_end - cum_i) xdt_i b_i
        total = cums[:, -1]                               # (B,H)
        rem = torch.exp(total[:, None, :] - cums)         # (B,Q,H)
        s_local = torch.einsum("bqhp,bqn,bqh->bhpn", xdt, bk, rem)
        state = state * torch.exp(total)[:, :, None, None] + s_local
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y[:, :l], state


def _project(p, u):
    z = u @ p["in_z"]
    x = u @ p["in_x"]
    b_raw = u @ p["in_b"]
    c_raw = u @ p["in_c"]
    dt = u @ p["in_dt"]
    return z, x, b_raw, c_raw, dt


def mamba_forward(p, cfg, u):
    """Full-sequence forward. Returns (out, cache); cache = (conv_x_state
    (B,3,d_inner), conv_b_state, conv_c_state, ssm_state (B,H,P,N))."""
    d_inner, headdim, nheads, d_state = mamba_dims(cfg)
    bsz, l, _ = u.shape
    z, x_raw, b_raw, c_raw, dt = _project(p, u)

    def tail(t):
        return t[:, -3:, :] if l >= 3 else F.pad(t, (0, 0, 3 - l, 0))

    conv_state = (tail(x_raw), tail(b_raw), tail(c_raw))
    x = _causal_conv(x_raw, p["conv_x"], p["conv_bias_x"])
    b_mat = _causal_conv(b_raw, p["conv_b"], p["conv_bias_b"])
    c_mat = _causal_conv(c_raw, p["conv_c"], p["conv_bias_c"])
    x = x.reshape(bsz, l, nheads, headdim)
    dt = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    y, state = ssd_scan(x.float(), dt, a, b_mat.float(), c_mat.float())
    y = y + x.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, l, d_inner).to(u.dtype)
    y = rmsnorm(p["norm_w"], y * F.silu(z))
    return y @ p["out_proj"], conv_state + (state,)


def mamba_decode(p, cfg, u, cache):
    """Single-token decode. u: (B, 1, d)."""
    d_inner, headdim, nheads, d_state = mamba_dims(cfg)
    bsz = u.shape[0]
    cx, cb, cc, ssm_state = cache
    z, x_raw, b_raw, c_raw, dt = _project(p, u)

    def step_conv(state, new, w, bias):
        new = new[:, 0]
        out = (state[:, 0] * w[0] + state[:, 1] * w[1]
               + state[:, 2] * w[2] + new * w[3])
        out = F.silu(out + bias)
        state = torch.cat([state[:, 1:], new[:, None, :]], dim=1)
        return out, state

    x, cx = step_conv(cx, x_raw, p["conv_x"], p["conv_bias_x"])
    b_mat, cb = step_conv(cb, b_raw, p["conv_b"], p["conv_bias_b"])
    c_mat, cc = step_conv(cc, c_raw, p["conv_c"], p["conv_bias_c"])

    x = x.reshape(bsz, nheads, headdim).float()
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])                 # (B,H)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)
    xdt = x * dt[..., None]
    ssm_state = (ssm_state * da[:, :, None, None]
                 + torch.einsum("bhp,bn->bhpn", xdt, b_mat.float()))
    y = torch.einsum("bhpn,bn->bhp", ssm_state, c_mat.float())
    y = y + x * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = rmsnorm(p["norm_w"], y * F.silu(z))
    return y @ p["out_proj"], (cx, cb, cc, ssm_state)


def mamba_cache_init(cfg, batch, dtype=torch.float32, device=None):
    d_inner, headdim, nheads, d_state = mamba_dims(cfg)
    return (
        torch.zeros((batch, 3, d_inner), dtype=dtype, device=device),
        torch.zeros((batch, 3, d_state), dtype=dtype, device=device),
        torch.zeros((batch, 3, d_state), dtype=dtype, device=device),
        torch.zeros((batch, nheads, headdim, d_state), dtype=torch.float32,
                    device=device),
    )
