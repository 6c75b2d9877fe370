"""Layer-stack machinery for all families.

Port of ``repro.models.transformer``. A model is a list of *stages*; a
stage is (period_spec, n_periods) where period_spec is a tuple of
(layer_type, ffn_kind) entries. Jamba's 1:7 hybrid is an 8-layer period
repeated 9 times. A stage's parameters are a list of n period dicts
(``{"l0": layer, "l1": ...}``) and its caches likewise; the forward,
prefill and decode run a Python loop over them where the reference scans
over a stacked period axis. ``apply_moe`` has the reference's two
branches: without a mesh (or without a 'tp' axis, or with experts that
do not divide over it) every expert is local; under
``sharding.set_mesh`` the experts split over 'tp' and the batch over
'dp' (``moe.moe_forward_ep``), as the reference's ``shard_map`` does.
The reference's other sharding constraints change no value and are left
out (``sharding.constrain`` is the identity). FSDP and tensor
parallelism of the dense layers are planned (``launch/dryrun.py``), not
executed: ``Trainer(shardings=)`` restores sharded leaves and trains on
them assembled whole.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (
    attn_init, attn_forward, attn_prefill, attn_decode, cross_attn_forward,
    flash_attention, is_mla, mla_forward, mla_init, no_latent_cache,
)
from .layers import glu_mlp, glu_mlp_init, rmsnorm, rmsnorm_init
from .mamba import mamba_init, mamba_forward, mamba_decode
from . import sharding
from .moe import moe_init, moe_forward, moe_forward_ep

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

def layer_init(gen, cfg, ltype, ffn, dtype, router_dtype=torch.float32):
    p: Dict[str, Any] = {}
    d = cfg.d_model
    dev = gen.device
    if ltype in ("attn", "attn_cross"):
        p["ln1"] = rmsnorm_init(d, dtype, dev)
        p["attn"] = (mla_init if is_mla(cfg) else attn_init)(gen, cfg, dtype)
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
        p["moe"] = moe_init(gen, cfg, dtype, router_dtype)
    return p


def stage_init(gen, cfg, spec: Spec, n: int, dtype,
               router_dtype=torch.float32) -> List[Dict[str, Any]]:
    return [{f"l{i}": layer_init(gen, cfg, lt, ffn, dtype, router_dtype)
             for i, (lt, ffn) in enumerate(spec)} for _ in range(n)]


# --------------------------------------------------------------------------
# MoE dispatch wrapper (expert parallel when a mesh is configured)
# --------------------------------------------------------------------------

_ROUTED = ("router", "w_gate", "w_up", "w_down")
_EXPERTS = ("w_gate", "w_up", "w_down")
# (id(weight), mesh, tp) -> (weakref to the weight, its version, placed)
_PLACED: Dict[tuple, tuple] = {}


def _expert_blocks(w, mesh, tp) -> sharding.ShardedTensor:
    """``w`` placed by P(tp, None, None) on ``mesh``. Blocks on ``w``'s
    own device are views. A weight with blocks bound for other devices is
    placed once and kept while it lives and is not written in place
    (``_version``); under autograd (a weight that requires grad) it is
    placed on every call, so the copies carry gradients back."""
    placed_by = sharding.NamedSharding(mesh, sharding.P(tp, None, None))
    if all(d == w.device for d in mesh.flat_devices) or (
            w.requires_grad and torch.is_grad_enabled()):
        return sharding.device_put(w, placed_by)
    key = (id(w), mesh, tp)
    hit = _PLACED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    placed = sharding.device_put(w.detach(), placed_by)
    _PLACED[key] = (weakref.ref(w, lambda _, k=key: _PLACED.pop(k, None)),
                    w._version, placed)
    return placed


def _moe_expert_parallel(routed, cfg, x, mesh, tp):
    """The reference's ``shard_map`` branch: x split along B into the
    'dp' shards when B divides, else one shard holding the whole batch
    (the reference replicates it: the decode case); each shard through
    ``moe_forward_ep`` on its row of the mesh; the outputs concatenated
    along B on x's device."""
    grid = sharding.expert_grid(mesh, tp)
    placed = {k: _expert_blocks(routed[k], mesh, tp) for k in _EXPERTS}
    at = placed["w_gate"].sharding.device_at
    split = x.shape[0] % len(grid) == 0
    shards = torch.chunk(x, len(grid)) if split else (x,)
    outs = []
    for row, xs in zip(grid, shards):
        experts = {k: [placed[k].block(pos) for pos in row]
                   for k in _EXPERTS}
        outs.append(moe_forward_ep(routed, cfg, xs, [at(p_) for p_ in row],
                                   experts).to(x.device))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def apply_moe(p, cfg, x):
    mesh = sharding.get_mesh()
    routed = {k: p[k] for k in _ROUTED}
    tp = sharding._STATE["tp"]
    cfg_r = cfg.with_(num_shared_experts=0)
    if (
        mesh is None
        or tp not in mesh.axis_names
        or cfg.num_experts % mesh.shape[tp] != 0
    ):
        out = moe_forward(routed, cfg_r, x)
    else:
        out = _moe_expert_parallel(routed, cfg_r, x, mesh, tp)
    if cfg.num_shared_experts:
        out = out + glu_mlp(p["shared"], x)
    return out


# --------------------------------------------------------------------------
# forward (no cache)
# --------------------------------------------------------------------------

def apply_layer(lp, cfg, lt, ffn, x, positions, memory=None, causal=True):
    attend = mla_forward if is_mla(cfg) else attn_forward
    if cfg.parallel_block and lt == "attn" and ffn == "mlp":
        # parallel residual: attention and MLP both read x
        h = attend(lp["attn"], cfg, rmsnorm(lp["ln1"], x), positions,
                   causal=causal)
        h = h + glu_mlp(lp["mlp"], rmsnorm(lp["ln2"], x))
        return x + h
    if lt in ("attn", "attn_cross"):
        x = x + attend(lp["attn"], cfg, rmsnorm(lp["ln1"], x), positions,
                       causal=causal)
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
    if is_mla(cfg) and lt in ("attn", "attn_cross"):
        no_latent_cache()
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
    if is_mla(cfg) and lt in ("attn", "attn_cross"):
        no_latent_cache()
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
