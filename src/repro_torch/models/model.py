"""Top-level model assembly: embeddings -> stages -> head, with train
loss, prefill and single-token decode entry points.

Port of ``repro.models.model``. The reference casts every float32 leaf to
bf16 on every call; ``loss_fn``, ``prefill`` and ``decode_step`` here
call ``cast_params`` too, which returns a bf16 leaf as it is, so a model
cast once (``Engine`` casts at construction, or ``init_params`` builds in
bf16) pays nothing per call. In ``loss_fn`` the cast of a float32 master
is an autograd op, so the gradients land on the float32 leaves, as the
reference's land on its masters. ``input_specs`` / ``abstract_params``
/ ``decode_cache_specs`` give the shapes and dtypes of the inputs,
parameters and decode caches as meta and fake tensors, allocating
nothing, where the reference gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from ..core.device import resolve_device
from .layers import (embed_init, embed_lookup, rmsnorm, rmsnorm_init, _init,
                     cross_entropy_chunked)
from .transformer import (
    build_stages, encoder_stages, stage_init, stages_forward, stages_prefill,
    stages_decode,
)

COMPUTE_DTYPE = torch.bfloat16


def _pdtype(cfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def map_params(fn, params):
    """``fn`` applied to every tensor of a parameter (or cache) tree of
    dicts, lists and tuples; the structure is kept."""
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(map_params(fn, v) for v in params)
    return fn(params)


def leaves(params):
    """Every tensor of a tree of dicts, lists and tuples, in order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in leaves(v)]
    return [params]


def cast_params(params, device=None):
    """Mixed precision: every float32 leaf as ``COMPUTE_DTYPE`` (other
    leaves as they are), on ``device`` if one is given. A leaf already in
    bf16 on that device is returned as it is."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def cast(w):
        if dev is not None and w.device != dev:
            w = w.to(dev)
        return w.to(COMPUTE_DTYPE) if w.dtype == torch.float32 else w
    return map_params(cast, params)


def init_params(cfg, gen: torch.Generator = None, *, seed: int = 0,
                device=None, dtype=None) -> Dict[str, Any]:
    """Random parameters of ``cfg``, drawn from ``gen`` (a generator on
    ``device``; by default one seeded with ``seed``) in float32 and cast
    at once to ``dtype`` (by default the config's ``param_dtype``, with
    the MoE routers in float32 as the reference keeps them; pass
    ``torch.bfloat16`` for what ``cast_params`` would give, without a
    float32 copy of the model)."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    elif torch.device(gen.device) != dev:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    # at the config's dtype the MoE router is float32, as the reference
    # keeps it; an asked-for dtype applies to every leaf
    router_dtype = torch.float32 if dtype is None else dtype
    dtype = _pdtype(cfg) if dtype is None else dtype
    stages = build_stages(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "lm_head": _init(gen, (cfg.d_model, cfg.vocab_padded), dtype=dtype),
        "stages": [stage_init(gen, cfg, spec, n, dtype, router_dtype)
                   for spec, n in stages],
    }
    if cfg.family == "audio":
        params["encoder"] = {
            "stages": [stage_init(gen, cfg, spec, n, dtype, router_dtype)
                       for spec, n in encoder_stages(cfg)],
            "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        }
    return params


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _embed_inputs(params, cfg, batch):
    """Returns (x (B,S,d) bf16, positions (B,S), loss_mask (B,S), memory)."""
    memory = None
    if cfg.input_mode == "frames":
        frames = batch["frames"].to(COMPUTE_DTYPE)
        enc_pos = _positions(frames.shape[0], frames.shape[1], frames.device)
        memory = stages_forward(
            params["encoder"]["stages"], cfg, encoder_stages(cfg),
            frames, enc_pos, causal=False,
        )
        memory = rmsnorm(params["encoder"]["final_norm"], memory)
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens).to(COMPUTE_DTYPE)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    if cfg.input_mode == "tokens+patches":
        patches = batch["patches"].to(COMPUTE_DTYPE)
        x = torch.cat([patches, x], dim=1)
        mask = torch.cat([torch.zeros(patches.shape[:2], dtype=torch.float32,
                                      device=x.device), mask], dim=1)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    return x, positions, mask, memory


def loss_fn(params, cfg, batch):
    """Next-token CE. batch['tokens']: (B, S+1) int (inputs||label tail).
    A scalar float32 tensor that autograd carries back to ``params``."""
    params = cast_params(params)
    tokens = batch["tokens"]
    inp = {**batch, "tokens": tokens[:, :-1]}
    x, positions, mask, memory = _embed_inputs(params, cfg, inp)
    stages = build_stages(cfg)
    x = stages_forward(params["stages"], cfg, stages, x, positions,
                       memory=memory)
    x = rmsnorm(params["final_norm"], x)
    # align labels with the (possibly patch-prefixed) sequence
    n_prefix = x.shape[1] - (tokens.shape[1] - 1)
    labels = tokens[:, 1:]
    if n_prefix:
        labels = torch.cat([labels.new_zeros((x.shape[0], n_prefix)),
                            labels], dim=1)
    head = params["lm_head"]

    def logits_fn(xc):
        return xc.to(COMPUTE_DTYPE) @ head

    return cross_entropy_chunked(logits_fn, x, labels, mask)


def prefill(params, cfg, batch):
    """Returns (caches, last_logits (B, vocab_padded))."""
    params = cast_params(params)
    x, positions, _, memory = _embed_inputs(params, cfg, batch)
    stages = build_stages(cfg)
    x, caches = stages_prefill(params["stages"], cfg, stages, x, positions,
                               memory=memory)
    x = rmsnorm(params["final_norm"], x[:, -1:])
    logits = (x.to(COMPUTE_DTYPE) @ params["lm_head"])[:, 0]
    return caches, logits


def decode_step(params, cfg, caches, token, pos: int):
    """token: (B, 1) int; pos: a Python int. Returns (logits (B, V),
    caches); the self-attention caches are written in place."""
    params = cast_params(params)
    x = embed_lookup(params["embed"], token).to(COMPUTE_DTYPE)
    stages = build_stages(cfg)
    x, caches = stages_decode(params["stages"], cfg, stages, x, caches,
                              int(pos))
    x = rmsnorm(params["final_norm"], x)
    logits = (x.to(COMPUTE_DTYPE) @ params["lm_head"])[:, 0]
    return logits, caches


def pad_caches(cfg, caches, max_len: int):
    """Grow self-attention KV caches to max_len slots (serving headroom).
    Mamba/cross caches are length-independent and pass through."""
    def grow(cache):
        out = dict(cache)
        for name in ("self_k", "self_v"):
            if name in out:
                leaf = out[name]                  # (B, S, KvH, Dh)
                pad = max_len - leaf.shape[1]
                if pad > 0:
                    out[name] = F.pad(leaf, (0, 0, 0, 0, 0, pad))
        return out
    return [[{li: grow(c) for li, c in period.items()} for period in stage]
            for stage in caches]


def _spec(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` that holds no data."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, seq_len: int, batch: int, kind: str = "train"):
    """Meta-tensor stand-ins for every model input: the reference's keys,
    shapes and dtypes (int32 tokens, bf16 frames and patches)."""
    i32, bf16 = torch.int32, torch.bfloat16
    if kind == "train":
        b = {"tokens": _spec((batch, seq_len + 1), i32)}
    elif kind == "prefill":
        b = {"tokens": _spec((batch, seq_len), i32)}
    elif kind == "decode":
        return {"token": _spec((batch, 1), i32),
                "pos": _spec((), i32)}
    else:
        raise ValueError(kind)
    if cfg.input_mode == "frames":
        # encoder frames: precomputed frame embeddings (frontend stub)
        b["frames"] = _spec((batch, seq_len, cfg.d_model), bf16)
    if cfg.input_mode == "tokens+patches":
        b["patches"] = _spec((batch, cfg.num_patch_tokens, cfg.d_model),
                             bf16)
        # patches occupy part of the sequence budget
        toks = max(seq_len - cfg.num_patch_tokens, 8)
        b["tokens"] = _spec((batch, toks + 1 if kind == "train" else toks),
                            i32)
    return b


def abstract_params(cfg):
    """``init_params``' tree as fake tensors (``FakeTensorMode``): every
    leaf's shape and dtype, nothing allocated."""
    with FakeTensorMode():
        return init_params(cfg, seed=0, device="cpu")


def decode_cache_specs(cfg, batch_size: int, seq_len: int):
    """Meta-tensor stand-ins of ``prefill``'s caches for a prefill batch
    of ``input_specs(cfg, seq_len, batch_size, "prefill")``, built from
    the config (the reference traces ``prefill``; the routers' data-
    dependent shapes are not traced here): self-attention K/V (B, S, KvH,
    Dh) in the compute dtype, cross-attention K/V over the encoder's
    frames, and the Mamba conv tails (B, 3, ...) and float32 SSD state."""
    from .mamba import mamba_dims

    specs = input_specs(cfg, seq_len, batch_size, kind="prefill")
    s = specs["tokens"].shape[1] + (cfg.num_patch_tokens
                                    if cfg.input_mode == "tokens+patches"
                                    else 0)
    b, ct = batch_size, COMPUTE_DTYPE
    kv = (b, s, cfg.num_kv_heads, cfg.head_dim)

    def layer(lt, ffn):
        cache = {}
        if lt in ("attn", "attn_cross"):
            cache["self_k"], cache["self_v"] = _spec(kv, ct), _spec(kv, ct)
            if lt == "attn_cross":
                mem = (b, specs["frames"].shape[1], cfg.num_kv_heads,
                       cfg.head_dim)
                cache["cross_k"] = _spec(mem, ct)
                cache["cross_v"] = _spec(mem, ct)
        elif lt == "mamba":
            d_inner, headdim, nheads, d_state = mamba_dims(cfg)
            cache["mamba"] = (_spec((b, 3, d_inner), ct),
                              _spec((b, 3, d_state), ct),
                              _spec((b, 3, d_state), ct),
                              _spec((b, nheads, headdim, d_state),
                                    torch.float32))
        return cache
    return [[{f"l{i}": layer(lt, ffn) for i, (lt, ffn) in enumerate(spec)}
             for _ in range(n)] for spec, n in build_stages(cfg)]
