"""Layer-stack machinery for all families.

Port of ``repro.models.transformer``. A model is a list of *stages*; a
stage is (period_spec, n_periods) where period_spec is a tuple of
(layer_type, ffn_kind) entries. Jamba's 1:7 hybrid is an 8-layer period
repeated 9 times. A stage's parameters are a list of n period dicts
(``{"l0": layer, "l1": ...}``) and its caches likewise; the forward,
prefill and decode run a Python loop over them where the reference scans
over a stacked period axis. ``apply_moe`` is the reference's
single-device branch (no mesh); the reference's sharding constraints are
the identity on one device and are left out.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (
    attn_init, attn_forward, attn_prefill, attn_decode, cross_attn_forward,
    flash_attention,
)
from .layers import glu_mlp, glu_mlp_init, rmsnorm, rmsnorm_init
from .mamba import mamba_init, mamba_forward, mamba_decode
from .moe import moe_init, moe_forward

Spec = Tuple[Tuple[str, Optional[str]], ...]


def build_stages(cfg) -> List[Tuple[Spec, int]]:
    if cfg.family in ("dense", "vlm"):
        return [((("attn", "mlp"),), cfg.num_layers)]
    if cfg.family == "moe":
        stages = []
        fd = cfg.first_dense_layers
        if fd:
            stages.append(((("attn", "mlp"),), fd))
        stages.append(((("attn", "moe"),), cfg.num_layers - fd))
        return stages
    if cfg.family == "ssm":
        return [((("mamba", None),), cfg.num_layers)]
    if cfg.family == "hybrid":
        period = [("attn", "mlp")]
        for i in range(1, cfg.attn_period):
            period.append(("mamba", "moe" if i % 2 == 1 else "mlp"))
        assert cfg.num_layers % cfg.attn_period == 0
        return [(tuple(period), cfg.num_layers // cfg.attn_period)]
    if cfg.family == "audio":
        # decoder stack (encoder built separately)
        return [((("attn_cross", "mlp"),), cfg.num_layers)]
    raise ValueError(cfg.family)


def encoder_stages(cfg) -> List[Tuple[Spec, int]]:
    return [((("attn", "mlp"),), cfg.encoder_layers)]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def layer_init(gen, cfg, ltype, ffn, dtype):
    p: Dict[str, Any] = {}
    d = cfg.d_model
    dev = gen.device
    if ltype in ("attn", "attn_cross"):
        p["ln1"] = rmsnorm_init(d, dtype, dev)
        p["attn"] = attn_init(gen, cfg, dtype)
        if ltype == "attn_cross":
            p["ln_x"] = rmsnorm_init(d, dtype, dev)
            p["xattn"] = attn_init(gen, cfg.with_(qk_norm=False), dtype)
    elif ltype == "mamba":
        p["ln1"] = rmsnorm_init(d, dtype, dev)
        p["mamba"] = mamba_init(gen, cfg, dtype)
    if ffn == "mlp":
        p["ln2"] = rmsnorm_init(d, dtype, dev)
        p["mlp"] = glu_mlp_init(gen, d, cfg.d_ff, dtype)
    elif ffn == "moe":
        p["ln2"] = rmsnorm_init(d, dtype, dev)
        p["moe"] = moe_init(gen, cfg, dtype)
    return p


def stage_init(gen, cfg, spec: Spec, n: int, dtype) -> List[Dict[str, Any]]:
    return [{f"l{i}": layer_init(gen, cfg, lt, ffn, dtype)
             for i, (lt, ffn) in enumerate(spec)} for _ in range(n)]


# --------------------------------------------------------------------------
# MoE (the reference's branch without a mesh)
# --------------------------------------------------------------------------

_ROUTED = ("router", "w_gate", "w_up", "w_down")


def apply_moe(p, cfg, x):
    routed = {k: p[k] for k in _ROUTED}
    out = moe_forward(routed, cfg.with_(num_shared_experts=0), x)
    if cfg.num_shared_experts:
        out = out + glu_mlp(p["shared"], x)
    return out


# --------------------------------------------------------------------------
# forward (no cache)
# --------------------------------------------------------------------------

def apply_layer(lp, cfg, lt, ffn, x, positions, memory=None, causal=True):
    if cfg.parallel_block and lt == "attn" and ffn == "mlp":
        # parallel residual: attention and MLP both read x
        h = attn_forward(lp["attn"], cfg, rmsnorm(lp["ln1"], x), positions,
                         causal=causal)
        h = h + glu_mlp(lp["mlp"], rmsnorm(lp["ln2"], x))
        return x + h
    if lt in ("attn", "attn_cross"):
        x = x + attn_forward(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                             positions, causal=causal)
        if lt == "attn_cross":
            x = x + cross_attn_forward(
                lp["xattn"], cfg, rmsnorm(lp["ln_x"], x), memory
            )
    elif lt == "mamba":
        x = x + mamba_forward(lp["mamba"], cfg, rmsnorm(lp["ln1"], x))[0]
    if ffn == "mlp":
        x = x + glu_mlp(lp["mlp"], rmsnorm(lp["ln2"], x))
    elif ffn == "moe":
        x = x + apply_moe(lp["moe"], cfg, rmsnorm(lp["ln2"], x))
    return x


def _period_forward(lp, cfg, spec, x, positions, memory, causal):
    for i, (lt, ffn) in enumerate(spec):
        x = apply_layer(lp[f"l{i}"], cfg, lt, ffn, x, positions,
                        memory=memory, causal=causal)
    return x


def stages_forward(stage_params, cfg, stages, x, positions, memory=None,
                   causal=True, remat=True):
    """The layers without caches. With ``remat`` and ``cfg.remat``, while
    grad is enabled, each period runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint`` of the period body): backward
    keeps the period's input and runs the period again, the MoE router
    included (its kernel is deterministic, so it routes as the forward
    did). Under ``no_grad`` / ``inference_mode`` nothing changes."""
    ckpt = remat and cfg.remat and torch.is_grad_enabled()
    for (spec, _n), periods in zip(stages, stage_params):
        for lp in periods:
            args = (lp, cfg, spec, x, positions, memory, causal)
            if ckpt:
                x = checkpoint(_period_forward, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _period_forward(*args)
    return x


# --------------------------------------------------------------------------
# prefill / decode (KV + state caches)
# --------------------------------------------------------------------------

def layer_prefill(lp, cfg, lt, ffn, x, positions, memory=None):
    cache = {}
    if cfg.parallel_block and lt == "attn" and ffn == "mlp":
        h, (k, v) = attn_prefill(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                                 positions)
        cache["self_k"], cache["self_v"] = k, v
        h = h + glu_mlp(lp["mlp"], rmsnorm(lp["ln2"], x))
        return x + h, cache
    if lt in ("attn", "attn_cross"):
        h, (k, v) = attn_prefill(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                                 positions)
        x = x + h
        cache["self_k"], cache["self_v"] = k, v
        if lt == "attn_cross":
            b = memory.shape[0]
            kvh, dh = cfg.num_kv_heads, cfg.head_dim
            ck = (memory @ lp["xattn"]["wk"]).reshape(b, -1, kvh, dh)
            cv = (memory @ lp["xattn"]["wv"]).reshape(b, -1, kvh, dh)
            cache["cross_k"], cache["cross_v"] = ck, cv
            xq = rmsnorm(lp["ln_x"], x)
            x = x + cross_attn_forward(lp["xattn"], cfg, xq, memory)
    elif lt == "mamba":
        h, mcache = mamba_forward(lp["mamba"], cfg, rmsnorm(lp["ln1"], x))
        x = x + h
        cache["mamba"] = mcache
    if ffn == "mlp":
        x = x + glu_mlp(lp["mlp"], rmsnorm(lp["ln2"], x))
    elif ffn == "moe":
        x = x + apply_moe(lp["moe"], cfg, rmsnorm(lp["ln2"], x))
    return x, cache


def _cross_decode(p, cfg, x, ck, cv):
    b = x.shape[0]
    h, dh = cfg.num_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, 1, h, dh)
    out = flash_attention(q, ck, cv, causal=False)
    return out.reshape(b, 1, h * dh) @ p["wo"]


def layer_decode(lp, cfg, lt, ffn, x, cache, pos):
    new_cache = {}
    if lt in ("attn", "attn_cross"):
        h, (k, v) = attn_decode(
            lp["attn"], cfg, rmsnorm(lp["ln1"], x),
            (cache["self_k"], cache["self_v"]), pos,
        )
        x = x + h
        new_cache["self_k"], new_cache["self_v"] = k, v
        if lt == "attn_cross":
            xq = rmsnorm(lp["ln_x"], x)
            x = x + _cross_decode(lp["xattn"], cfg, xq,
                                  cache["cross_k"], cache["cross_v"])
            new_cache["cross_k"] = cache["cross_k"]
            new_cache["cross_v"] = cache["cross_v"]
    elif lt == "mamba":
        h, mcache = mamba_decode(lp["mamba"], cfg, rmsnorm(lp["ln1"], x),
                                 cache["mamba"])
        x = x + h
        new_cache["mamba"] = mcache
    if ffn == "mlp":
        x = x + glu_mlp(lp["mlp"], rmsnorm(lp["ln2"], x))
    elif ffn == "moe":
        x = x + apply_moe(lp["moe"], cfg, rmsnorm(lp["ln2"], x))
    return x, new_cache


def stages_prefill(stage_params, cfg, stages, x, positions, memory=None):
    """Returns (x, caches): caches[stage][period][f"l{i}"] is a layer's."""
    caches = []
    for (spec, _n), periods in zip(stages, stage_params):
        stage_cache = []
        for lp in periods:
            pc = {}
            for i, (lt, ffn) in enumerate(spec):
                x, pc[f"l{i}"] = layer_prefill(lp[f"l{i}"], cfg, lt, ffn, x,
                                               positions, memory)
            stage_cache.append(pc)
        caches.append(stage_cache)
    return x, caches


def stages_decode(stage_params, cfg, stages, x, caches, pos):
    new_caches = []
    for (spec, _n), periods, stage_cache in zip(stages, stage_params, caches):
        new_stage = []
        for lp, cl in zip(periods, stage_cache):
            pc = {}
            for i, (lt, ffn) in enumerate(spec):
                x, pc[f"l{i}"] = layer_decode(lp[f"l{i}"], cfg, lt, ffn, x,
                                              cl[f"l{i}"], pos)
            new_stage.append(pc)
        new_caches.append(new_stage)
    return x, new_caches
