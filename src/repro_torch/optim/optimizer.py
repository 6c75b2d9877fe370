"""Optimizers (no torch.optim): AdamW and Adafactor (factored second
moment, for the >100B configs where full Adam state does not fit), cosine
LR schedule with warmup, global-norm clipping, and an int8 error-feedback
gradient compressor for bandwidth-limited cross-pod reductions.

Port of ``repro.optim.optimizer``. The reference is functional and XLA
reuses the donated buffers; here the updates write the parameters and the
moments in place, under ``torch.no_grad()``, and return the same tensors:
a functional copy of a 2.27 B-parameter tree would not fit beside the
state on one card. The step counter, the bias corrections and the
learning rate are float32 tensors computed from the int32 step, as in the
reference (Python floats would move their last bits).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..models.model import leaves, map_params


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any          # first moment (AdamW) or None (Adafactor)
    v: Any          # second moment / factored tuple
    comp_err: Any   # error-feedback residual (only when compression on)


def _up_to(tree, other):
    """``other``'s subtrees at the places of ``tree``'s tensors, in
    ``leaves(tree)`` order (JAX's ``flatten_up_to``)."""
    if isinstance(tree, dict):
        return [o for k in tree for o in _up_to(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [o for t, ot in zip(tree, other) for o in _up_to(t, ot)]
    return [other]


def _device(params) -> torch.device:
    return leaves(params)[0].device


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * (step + 1) / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return lr


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before). The reference returns float32 copies; here a float32 grad is
    scaled in place (the same numbers) and any other is copied to
    float32 first."""
    gs = [g.float() for g in leaves(grads)]
    sq = sum(torch.sum(torch.square(g)) for g in gs)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in gs:
        g.mul_(scale)
    it = iter(gs)
    return map_params(lambda _: next(it), grads), norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        m=map_params(zeros, params), v=map_params(zeros, params),
        comp_err=None)


@torch.no_grad()
def adamw_update(params, grads, state: OptState, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, wd=0.1):
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float()
        # the reference's b1 * m + (1 - b1) * g, rounded op by op
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        p.copy_(pf - lr * (u + wd * pf))
    return params, OptState(step=step, m=state.m, v=state.v,
                            comp_err=state.comp_err)


# --------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018) - factored v, no m by default
# --------------------------------------------------------------------------

def _factored(shape):
    return len(shape) >= 2


def adafactor_init(params):
    def one(p):
        f32, dev = torch.float32, p.device
        if _factored(p.shape):
            return (
                torch.zeros(p.shape[:-1], dtype=f32, device=dev),  # rows
                torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                            device=dev),
            )
        return (torch.zeros(p.shape, dtype=f32, device=dev),)

    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        m=None,
        v=map_params(one, params),
        comp_err=None,
    )


@torch.no_grad()
def adafactor_update(params, grads, state: OptState, lr, *, d2=0.999,
                     eps=1e-30, clip_thresh=1.0, wd=0.0):
    step = state.step + 1
    for p, g, v in zip(leaves(params), leaves(grads),
                       _up_to(params, state.v)):
        g = g.float()
        g2 = g * g + eps
        if _factored(p.shape):
            vr, vc = v
            vr.mul_(d2).add_((1 - d2) * torch.mean(g2, dim=-1))
            vc.mul_(d2).add_((1 - d2) * torch.mean(g2, dim=-2))
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=eps)
            u = g * torch.rsqrt(r[..., None] * vc[..., None, :] + eps)
        else:
            (v0,) = v
            v0.mul_(d2).add_((1 - d2) * g2)
            u = g * torch.rsqrt(v0 + eps)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms_u / clip_thresh, min=1.0)
        pf = p.float()
        p.copy_(pf - lr * (u + wd * pf))
    return params, OptState(step=step, m=None, v=state.v,
                            comp_err=state.comp_err)


# --------------------------------------------------------------------------
# int8 error-feedback gradient compression (cross-pod bandwidth trick)
# --------------------------------------------------------------------------

def compress_int8(g, err):
    """Quantize g+err to int8 with per-tensor scale; return (q, scale, new_err).
    Error feedback keeps the quantization bias out of the optimizer path."""
    g = g.float() + (err if err is not None else 0.0)
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g - deq


def decompress_int8(q, scale):
    return q.float() * scale


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}


def make_optimizer(name: str, lr_fn):
    init, update = OPTIMIZERS[name]

    def step(params, grads, state):
        lr = lr_fn(state.step)
        return update(params, grads, state, lr)

    return init, step
