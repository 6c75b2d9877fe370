"""Dry-run: a per-device plan of every (arch x shape x mesh) cell.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell's step (train, prefill or decode) for the 256- or 512-device
production mesh (FSDP over 'data', tensor and expert parallel over
'model') and reads XLA's ``memory_analysis``, ``cost_analysis`` and HLO
text. The port has no partitioner and no compiled module, and it does
not execute FSDP or tensor parallelism of the dense layers (the
reference does not execute them either: it compiles them onto
placeholder devices). What it executes across devices stays batch and
matrix placement of the solver and the expert-parallel MoE branch, in one
process. So each cell here is a plan, built from the port's own specs and
from one recording of the step under ``FakeTensorMode``
(``roofline/plan.py``), which allocates nothing and needs no card. Its
JSON record has the reference's keys, and says the basis of each number:

- ``memory.argument_bytes`` / ``output_bytes`` / ``alias_bytes``: the
  per-device block bytes of each argument and output under its
  ``NamedSharding`` (``param_pspecs``, :func:`opt_pspecs`,
  :func:`batch_specs`, :func:`_cache_spec`), a dimension that does not
  divide rounded up as XLA pads. Alias bytes are the state the step hands
  back: params and optimizer state (updated in place; the int32 step
  counter is replaced) and a decode step's caches.
- ``memory.temp_bytes``: the peak of the live bytes of the storages the
  step creates, recorded on one 'data' shard's step (batch = global / dp)
  over the full-width parameters, not split over 'model'
  (``temp_basis``).
- ``roofline.flops_per_device``: ``FlopCounterMode`` over the 'data'
  shard's step, divided by the 'model' axis size;
  ``bytes_per_device``: every recorded aten op's input and output bytes,
  divided the same way (an unfused upper bound); ``dus_alias_bytes``:
  the decode caches rebuilt out of place (Mamba's conv tails, by
  ``torch.cat``; attention writes its caches in place and adds nothing).
- ``roofline.collective``: the collectives that the specs imply, one
  record each in ``collective_records`` (see :func:`collective_records`),
  through ``roofline.analysis.collective_bytes``; ``while_ops`` counts the
  MoE router's ``fused_ot_phases`` launches, which the plan keeps as
  custom calls and does not cost.
- ``model_flops`` and ``hlo_flops_ratio``: the model FLOPs over the
  plan's counted FLOPs.

With ``unroll=False`` (``--no-unroll``) the step is recorded with one
period of each stage, then once more for each stage of more than one
period with two, and the counts are scaled to the full depth
(``periods_scaled``); the reference costs a scanned body once instead.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --small --smoke
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-unroll \\
        --only-mesh sp
    PYTHONPATH=src python -m repro_torch.roofline.aggregate

Importing this module sets no environment variable and touches no
device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from collections import Counter
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.registry import (
    ARCHS, SHAPES, SMOKE_SHAPES, get_arch, reduced, shape_applicable,
)
from ..models import model as M
from ..models import sharding
from ..models.sharding import NamedSharding, P
from ..models.transformer import build_stages, encoder_stages
from ..optim.optimizer import OptState, _up_to
from ..roofline.analysis import (
    collective_bytes, dus_alias_bytes, model_flops, roofline_terms,
    hlo_lines,
)
from ..roofline.plan import _key, record
from ..train.train_step import make_train_step
from .mesh import make_production_mesh, make_small_mesh

_HLO = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
        torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
        torch.bool: "pred"}


class Placed(NamedTuple):
    """An argument or output of a step: a stand-in tensor (meta or fake:
    shape and dtype) and its sharding."""
    like: torch.Tensor
    sharding: NamedSharding


def block_shape(sh: NamedSharding, shape) -> tuple:
    """Each mesh position's block of a ``shape`` tensor under ``sh``,
    a dimension that does not divide rounded up (XLA pads it)."""
    shape = tuple(int(s) for s in shape)
    return tuple(-(-s // n) for s, n in zip(shape, sh.num_blocks(len(shape))))


def shard_bytes(placed: Placed) -> int:
    return (math.prod(block_shape(placed.sharding, placed.like.shape))
            * placed.like.element_size())


def _walk(tree, path=()):
    """(path, leaf) for every tensor of a tree of dicts, lists, tuples and
    NamedTuples (fields by name); None is skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(path, tree)]
    return [pl for k, v in items for pl in _walk(v, path + (k,))]


def _with_specs(tree, specs, mesh) -> List[Placed]:
    """``tree``'s tensors, each placed by the spec at the same place of
    ``specs`` (a tree of ``P``, which is a tuple, so it is read as a
    leaf here)."""
    out = []
    for path, leaf in _walk(tree):
        spec = specs
        for k in path:
            spec = getattr(spec, k) if isinstance(k, str) and hasattr(
                spec, "_fields") else spec[k]
        out.append(Placed(leaf, NamedSharding(mesh, spec)))
    return out


def _rebuild(tree, it):
    """A tree shaped like ``tree`` with the next item of ``it`` at each
    tensor."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in sharding._STATE["dp"])


def _batch_axis(n: int, mesh) -> Any:
    return "dp" if n % _dp_size(mesh) == 0 else None


def batch_specs(cfg, shape, kind, mesh) -> Dict[str, Placed]:
    """Each model input (``input_specs``) with its batch dimension over
    'dp' when the global batch divides, else replicated."""
    specs = M.input_specs(cfg, shape.seq_len, shape.global_batch, kind)
    ba = _batch_axis(shape.global_batch, mesh)

    def one(leaf):
        spec = P() if leaf.ndim == 0 else sharding.pspec(
            ba, *([None] * (leaf.ndim - 1)))
        return Placed(leaf, NamedSharding(mesh, spec))

    return {k: one(v) for k, v in specs.items()}


def opt_pspecs(cfg, params_abs, opt_abs) -> OptState:
    """Optimizer-state specs mirror the param specs; Adafactor's factored
    leaves inherit truncated specs (vr: drop the last dim; vc: drop the
    second-last)."""
    pspecs = sharding.param_pspecs(params_abs)
    spec_leaves = _up_to(params_abs, pspecs)
    if cfg.optimizer == "adamw":
        return OptState(step=P(), m=pspecs, v=pspecs, comp_err=None)
    v_leaves = []
    for spec, leaf in zip(spec_leaves, M.leaves(params_abs)):
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        if leaf.ndim >= 2:
            v_leaves.append((P(*parts[:-1]), P(*(parts[:-2] + parts[-1:]))))
        else:
            v_leaves.append((P(*parts),))
    return OptState(step=P(), m=None,
                    v=_rebuild(params_abs, iter(v_leaves)), comp_err=None)


def _cache_spec(path, leaf, mesh, batch) -> P:
    """A decode cache leaf's spec: K/V (B, S, KvH, Dh) and the SSD state
    (B, H, P, N) with the batch over 'dp' and dimension 1 over 'tp'
    (flash-decode style); the conv tails (B, 3, C) with C over 'tp' when
    it divides and is at least 1024."""
    name = next((k for k in reversed(path) if isinstance(k, str)), "")
    ba = _batch_axis(batch, mesh)
    nd = leaf.ndim
    if name in ("self_k", "self_v", "cross_k", "cross_v") or nd == 4:
        return sharding.pspec(ba, "tp", None, None)
    if nd == 3:
        tp_n = mesh.shape[sharding._STATE["tp"]]
        tp = "tp" if leaf.shape[-1] % tp_n == 0 and leaf.shape[-1] >= 1024 \
            else None
        return sharding.pspec(ba, None, tp)
    return sharding.pspec(*([None] * nd))


# --------------------------------------------------------------------------
# the collectives the specs imply
# --------------------------------------------------------------------------

_ROW_PARALLEL = ("wo", "w_down", "out_proj", "embed")


def _seq_lens(cfg, shape, kind):
    """(decoder tokens a sequence, encoder frames a sequence) of the
    step's activations."""
    if kind == "decode":
        return 1, 0
    specs = M.input_specs(cfg, shape.seq_len, 1, kind)
    s = specs["tokens"].shape[1] - (1 if kind == "train" else 0)
    if "patches" in specs:
        s += specs["patches"].shape[1]
    frames = specs["frames"].shape[1] if "frames" in specs else 0
    return s, frames


def collective_records(cfg, shape, kind, mesh, params_abs,
                       custom_calls=()) -> List[Dict]:
    """One record a collective the sharding rules imply for one step
    (``_RULES``, reference ``sharding.py:73``), with ``b`` the 'data'
    shard's batch and activations in the compute dtype:

    - every 'dp'-sharded parameter: an all-gather over 'dp' of its
      'model' block (after the cast to the compute dtype) in the forward
      pass, and again in the backward pass where remat recomputes a
      stage's period; in training, a reduce-scatter over 'dp' of its
      float32 gradient;
    - in training, every parameter not split over 'dp': an all-reduce
      over 'dp' of its float32 gradient;
    - ``wo``, ``w_down``, ``out_proj`` and ``embed`` (their contracting
      dimension on 'model'): an all-reduce over 'model' of the (b x
      tokens, d_model) activation in the forward pass, again in a remat
      recompute, and once in the backward pass;
    - a MoE layer whose experts divide over 'model': the expert-parallel
      partial sum, (b x tokens, d_model) over 'model', in the forward
      pass and in a remat recompute;
    - each custom call of the recording (the router's ``fused_ot_phases``
      launch): a ``while`` record, a loop the plan costs once.

    A decode step runs no encoder, so its leaves add nothing. Groups of
    one device are left out."""
    dp_axes = [a for a in sharding._STATE["dp"] if a in mesh.axis_names]
    tp = sharding._STATE["tp"]
    sizes = mesh.shape
    dp_n = math.prod(sizes[a] for a in dp_axes)
    tp_n = sizes.get(tp, 1)
    act = _HLO[M.COMPUTE_DTYPE]
    train = kind == "train"
    remat = train and cfg.remat
    b = shape.global_batch // dp_n if _batch_axis(
        shape.global_batch, mesh) else shape.global_batch
    s_dec, s_enc = _seq_lens(cfg, shape, kind)
    ep = tp_n > 1 and cfg.num_experts and cfg.num_experts % tp_n == 0
    out: List[Dict] = []

    def add(op, dtype, shp, group, where, rule):
        if group > 1:
            out.append({"op": op, "dtype": dtype,
                        "shape": [int(d) for d in shp], "group": group,
                        "where": where, "rule": rule})

    for path, leaf in _walk(params_abs):
        keys = [k for k in path if isinstance(k, str)]
        encoder = path[0] == "encoder"
        if kind == "decode" and encoder:
            continue
        in_stage = "stages" in keys
        where = "/".join(str(k) for k in path)
        sh = NamedSharding(mesh, sharding._leaf_rule(keys, leaf))
        dims = sh._dims(leaf.ndim)
        passes = ["forward"] + (["remat recompute"] if remat and in_stage
                                else [])
        if any(a in dp_axes for axes in dims for a in axes):
            kept = NamedSharding(mesh, P(*[
                tuple(a for a in axes if a not in dp_axes) or None
                for axes in dims]))
            wdt = act if leaf.is_floating_point() else _HLO[leaf.dtype]
            for ps in passes:
                add("all-gather", wdt, block_shape(kept, leaf.shape), dp_n,
                    where, f"FSDP all-gather over 'dp' ({ps})")
            if train:
                add("reduce-scatter", "f32", block_shape(sh, leaf.shape),
                    dp_n, where, "gradient reduce-scatter over 'dp'")
        elif train:
            add("all-reduce", "f32", block_shape(sh, leaf.shape), dp_n,
                where, "gradient all-reduce over 'dp' (leaf not on 'dp')")
        name = keys[-1]
        parent = keys[-2] if len(keys) > 1 else ""
        rows = b * (s_enc if encoder else s_dec)
        if name in _ROW_PARALLEL and parent != "moe" and tp in dims[0]:
            for ps in passes + (["backward"] if train else []):
                add("all-reduce", act, (rows, cfg.d_model), tp_n, where,
                    f"row-parallel output over 'model' ({ps})")
        if parent == "moe" and name == "router" and ep:
            for ps in passes:
                add("all-reduce", act, (rows, cfg.d_model), tp_n,
                    where.rsplit("/", 1)[0],
                    f"expert-parallel partial sum over 'model' ({ps})")
    for i, call in enumerate(custom_calls):
        out.append({"op": "while", "dtype": "s32", "shape": [], "group": 1,
                    "where": f"custom call {i}: {call['name']} "
                             f"{list(call['shape'])}",
                    "rule": f"{call['phases']} phases of at most "
                            f"{call['max_rounds']} rounds, costed once"})
    return out


# --------------------------------------------------------------------------
# recording the step
# --------------------------------------------------------------------------

def _stage_counts(cfg) -> List[int]:
    """Periods of each stage: the decoder's, then the encoder's."""
    counts = [n for _, n in build_stages(cfg)]
    if cfg.family == "audio":
        counts += [n for _, n in encoder_stages(cfg)]
    return counts


def _with_counts(cfg, counts: List[int]):
    """``cfg`` with ``counts`` periods in its stages (``_stage_counts``
    order)."""
    fam = cfg.family
    if fam == "moe" and cfg.first_dense_layers:
        out = cfg.with_(first_dense_layers=counts[0],
                        num_layers=counts[0] + counts[1])
    elif fam == "hybrid":
        out = cfg.with_(num_layers=counts[0] * cfg.attn_period)
    elif fam == "audio":
        out = cfg.with_(num_layers=counts[0], encoder_layers=counts[1])
    else:
        out = cfg.with_(num_layers=counts[0])
    if _stage_counts(out) != list(counts):
        raise ValueError(f"cannot give {cfg.name} the stage periods "
                         f"{counts}")
    return out


def _zeros_like(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros(t.shape, dtype=t.dtype)


def _record(cfg, shape, kind, b: int) -> Dict:
    """One recording of ``cfg``'s step at batch ``b`` (fake tensors):
    counts, the custom calls and the decode caches rebuilt out of
    place, each keyed without its period index."""
    with FakeTensorMode():
        params = M.init_params(cfg, seed=0, device="cpu")
        known = M.leaves(params)
        if kind == "train":
            opt_init, step_fn = make_train_step(cfg)
            opt = opt_init(params)
            batch = {k: _zeros_like(v) for k, v in
                     M.input_specs(cfg, shape.seq_len, b, kind).items()}
            known += [t for t in M.leaves(opt) if t is not None]
            known += list(batch.values())

            def fn():
                return step_fn(params, opt, batch)
        elif kind == "prefill":
            batch = {k: _zeros_like(v) for k, v in
                     M.input_specs(cfg, shape.seq_len, b, kind).items()}
            known += list(batch.values())

            def fn():
                with torch.no_grad():
                    return M.prefill(params, cfg, batch)
        else:
            caches = M.map_params(_zeros_like, M.decode_cache_specs(
                cfg, b, shape.seq_len))
            token = torch.zeros((b, 1), dtype=torch.int32)
            known += M.leaves(caches) + [token]

            def fn():
                with torch.no_grad():
                    return M.decode_step(params, cfg, caches, token,
                                         shape.seq_len - 1)
        out, counts, rec = record(fn, known)
        rebuilds = Counter()
        if kind == "decode":
            for (path, a), (_, o) in zip(_walk(caches), _walk(out[1])):
                if _key(o) != _key(a) and rec.producer.get(_key(o)) == "cat":
                    # path: (stage, period, layer, name[, index])
                    rebuilds[json.dumps({
                        "where": "/".join(str(k) for k in (
                            "stages", path[0], "*") + path[2:]),
                        "op": "cat", "dtype": _HLO[o.dtype],
                        "shape": list(o.shape)})] += 1
    calls = Counter(json.dumps({**c, "shape": list(c["shape"])},
                               sort_keys=True) for c in rec.custom_calls)
    return {"counts": Counter(counts), "calls": calls, "rebuilds": rebuilds}


def _record_periods(cfg, shape, kind, b: int, unroll: bool):
    """The step's recording at full depth: one recording (``unroll``), or
    one period a stage scaled by the stage's periods. Returns (the
    recording, recordings made, scaled or not)."""
    full = _stage_counts(cfg)
    if unroll or all(n == 1 for n in full):
        return _record(cfg, shape, kind, b), 1, False
    ones = [1] * len(full)
    base = _record(_with_counts(cfg, ones), shape, kind, b)
    total = {f: Counter(c) for f, c in base.items()}
    made = 1
    for i, n in enumerate(full):
        if n > 1:
            two = list(ones)
            two[i] = 2
            other = _record(_with_counts(cfg, two), shape, kind, b)
            made += 1
            for f, c in total.items():
                for k in set(base[f]) | set(other[f]):
                    c[k] += (n - 1) * (other[f][k] - base[f][k])
    return total, made, True


def _expand(counter: Counter) -> List[Dict]:
    return [json.loads(k) for k, n in sorted(counter.items())
            for _ in range(int(n))]


# --------------------------------------------------------------------------
# the plan of one step on one mesh
# --------------------------------------------------------------------------

def _arguments(cfg, shape, kind, mesh, params_abs):
    """(arguments, outputs, aliased) as lists of ``Placed`` at the
    global shapes."""
    params = _with_specs(params_abs, sharding.param_pspecs(params_abs),
                         mesh)
    ba = _batch_axis(shape.global_batch, mesh)
    logits = Placed(torch.empty((shape.global_batch, cfg.vocab_padded),
                                dtype=M.COMPUTE_DTYPE, device="meta"),
                    NamedSharding(mesh, sharding.pspec(ba, None)))
    if kind == "train":
        with FakeTensorMode():
            opt_init, _ = make_train_step(cfg)
            opt_abs = opt_init(M.map_params(_zeros_like, params_abs))
        opt = _with_specs(opt_abs, opt_pspecs(cfg, params_abs, opt_abs),
                          mesh)
        batch = list(batch_specs(cfg, shape, kind, mesh).values())
        metric = Placed(torch.empty((), device="meta"),
                        NamedSharding(mesh, P()))
        return params + opt + batch, params + opt + [metric] * 3, \
            params + opt
    caches = M.decode_cache_specs(cfg, shape.global_batch, shape.seq_len)
    cache = [Placed(leaf, NamedSharding(mesh, _cache_spec(
        path, leaf, mesh, shape.global_batch)))
        for path, leaf in _walk(caches)]
    if kind == "prefill":
        batch = list(batch_specs(cfg, shape, kind, mesh).values())
        return params + batch, cache + [logits], []
    step = batch_specs(cfg, shape, "decode", mesh)
    # pos is read by attention alone; the reference's jit prunes it
    # from a model without attention
    attn = any(lt.startswith("attn") for spec, _ in build_stages(cfg)
               for lt, _ in spec)
    return params + cache + [step["token"]] + ([step["pos"]] if attn
                                               else []), \
        [logits] + cache, cache


def plan_step(cfg, shape, mesh, *, unroll: bool = True) -> Dict:
    """The per-device plan of one ``shape.kind`` step of ``cfg`` on
    ``mesh`` (see the module docstring). The sharding state is restored
    on return; the step is recorded with no mesh set, on one 'data'
    shard."""
    kind = shape.kind
    saved = dict(sharding._STATE)
    try:
        sharding.set_mesh(mesh)
        params_abs = M.abstract_params(cfg)
        args, outs, alias = _arguments(cfg, shape, kind, mesh, params_abs)
        dp_n = _dp_size(mesh)
        tp_n = mesh.shape.get(sharding._STATE["tp"], 1)
        b = shape.global_batch // dp_n if _batch_axis(
            shape.global_batch, mesh) else shape.global_batch
        sharding.set_mesh(None)
        rec, made, scaled = _record_periods(cfg, shape, kind, b, unroll)
        sharding.set_mesh(mesh)
        calls = _expand(rec["calls"])
        records = collective_records(cfg, shape, kind, mesh, params_abs,
                                     calls)
    finally:
        sharding._STATE.clear()
        sharding._STATE.update(saved)
    counts = rec["counts"]
    rebuilds = _expand(rec["rebuilds"])
    arg_b = sum(shard_bytes(p) for p in args)
    out_b = sum(shard_bytes(p) for p in outs)
    alias_b = sum(shard_bytes(p) for p in alias)
    temp_b = int(counts["temp_bytes"])
    cost = {"flops": counts["flops"] / tp_n,
            "bytes accessed": counts["bytes"] / tp_n,
            "dus_alias_bytes": dus_alias_bytes(rebuilds) / tp_n}
    return {
        "memory": {
            "argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": temp_b, "alias_bytes": alias_b,
            "peak_per_device_gb": round(
                (arg_b + temp_b + out_b - alias_b) / 2**30, 3),
            "temp_basis": "dp shard, tp unsplit",
            "basis": "argument/output/alias: per-device blocks of the "
                     "port's specs, ceil per dimension; temp: peak live "
                     "bytes of the storages the step creates",
        },
        "roofline": roofline_terms(cost, collective_bytes(records)),
        "plan": {
            "dp_shard_batch": b, "dp": dp_n, "tp": tp_n,
            "flops_dp_shard": int(counts["flops"]),
            "op_bytes_dp_shard": int(counts["bytes"]),
            "aten_ops": int(counts["ops"]),
            "stage_periods": _stage_counts(cfg), "recordings": made,
            "custom_calls": calls, "cache_rebuilds": rebuilds,
            "basis": {
                "flops": "FlopCounterMode over the dp shard's step / tp",
                "bytes": "sum of aten op input and output bytes (views "
                         "none; unfused upper bound) / tp",
                "dus_alias_bytes": "2 x bytes of decode cache leaves "
                                   "rebuilt by aten.cat (Mamba conv "
                                   "tails); attention caches are written "
                                   "in place",
                "collective": "records from the specs' rules "
                              "(collective_records)",
            },
        },
        "periods_scaled": scaled,
        "collective_records": records,
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               router: Optional[str] = None, small: bool = False,
               smoke: bool = False, unroll: bool = True,
               seq_shard: bool = False, fast_decode: bool = False,
               parallel_block: bool = False):
    """Returns (plan, meta) for one (arch x shape x mesh) cell, or
    (None, {"skipped": reason})."""
    cfg = get_arch(arch)
    if smoke:
        cfg = reduced(cfg)
    if router:
        cfg = cfg.with_(router=router)
    cfg = cfg.with_(scan_unroll=unroll, seq_shard=seq_shard,
                    fast_decode_math=fast_decode,
                    parallel_block=parallel_block)
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": reason}
    mesh = make_small_mesh(devices="meta") if small else \
        make_production_mesh(multi_pod=multi_pod)
    plan = plan_step(cfg, shape, mesh, unroll=unroll)
    return plan, {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "multi_pod": multi_pod, "router": cfg.router,
        "n_chips": mesh.size, "mesh": dict(mesh.shape),
        "cfg_shape": shape, "cfg": cfg,
    }


def run_cell(arch, shape_name, *, multi_pod=False, router=None,
             small=False, smoke=False, save_hlo: Optional[str] = None,
             unroll=True, seq_shard=False, fast_decode=False,
             parallel_block=False) -> Dict:
    """One cell's JSON record (the reference's keys and the plan's basis
    fields); ``ok: False`` with the error for a cell that fails."""
    t0 = time.time()
    try:
        plan, meta = lower_cell(
            arch, shape_name, multi_pod=multi_pod, router=router,
            small=small, smoke=smoke, unroll=unroll, seq_shard=seq_shard,
            fast_decode=fast_decode, parallel_block=parallel_block,
        )
        if plan is None:
            return {"arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "ok": True, **meta}
        terms = plan["roofline"]
        mf = model_flops(meta["cfg"], meta["cfg_shape"], meta["n_chips"])
        result = {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "router": meta["router"], "ok": True,
            "n_chips": meta["n_chips"], "mesh": meta["mesh"],
            "kind": meta["kind"],
            "compile_s": round(time.time() - t0, 1),
            "memory": plan["memory"],
            "unroll": unroll, "seq_shard": seq_shard,
            "periods_scaled": plan["periods_scaled"],
            "roofline": terms,
            "model_flops": mf,
            "hlo_flops_ratio": (mf["model_flops_per_device"]
                                / max(terms["flops_per_device"], 1.0)),
            "plan": plan["plan"],
            "collective_records": plan["collective_records"],
        }
        if save_hlo:
            os.makedirs(save_hlo, exist_ok=True)
            tag = f"{arch}__{shape_name}__{'mp' if multi_pod else 'sp'}"
            with open(os.path.join(save_hlo, tag + ".collectives.txt"),
                      "w") as f:
                f.write(hlo_lines(plan["collective_records"]) + "\n")
        return result
    except Exception as e:  # a cell's failure is its record, as upstream
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "ok": False, "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
            "compile_s": round(time.time() - t0, 1),
        }


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            for mp in (False, True):
                yield arch, shape, mp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--router", default=None)
    ap.add_argument("--small", action="store_true",
                    help="2x4 CI mesh instead of production mesh")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced arch config + tiny shapes")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell in "
                         "subprocesses")
    ap.add_argument("--only-mesh", choices=["sp", "mp"], default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells planned at once, each in its "
                         "own process")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--save-hlo", default=None,
                    help="write each cell's collective records as HLO "
                         "lines here")
    ap.add_argument("--no-unroll", action="store_true",
                    help="record one period a stage and scale it to the "
                         "full depth")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel residual stream (config flag)")
    ap.add_argument("--fast-decode", action="store_true",
                    help="bf16 cache reads w/ fp32 accumulation")
    ap.add_argument("--parallel-block", action="store_true",
                    help="PaLM-style parallel attn+FFN block")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        running: List[subprocess.Popen] = []
        for arch, shape, mp in all_cells():
            if args.only_mesh == "sp" and mp:
                continue
            if args.only_mesh == "mp" and not mp:
                continue
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out]
            if mp:
                cmd.append("--multi-pod")
            if args.no_unroll:
                cmd.append("--no-unroll")
            if args.save_hlo:
                cmd += ["--save-hlo", args.save_hlo]
            print(f"[dryrun] {tag} ...", flush=True)
            while len(running) >= args.jobs:
                running.pop(0).wait()
            running.append(subprocess.Popen(cmd))
        for proc in running:
            proc.wait()
        return

    res = run_cell(
        args.arch, args.shape, multi_pod=args.multi_pod, router=args.router,
        small=args.small, smoke=args.smoke, save_hlo=args.save_hlo,
        unroll=not args.no_unroll, seq_shard=args.seq_shard,
        fast_decode=args.fast_decode, parallel_block=args.parallel_block,
    )
    tag = f"{args.arch}__{args.shape}__{'mp' if args.multi_pod else 'sp'}"
    if args.router:
        tag += f"__{args.router}"
    if args.smoke or args.small:
        tag += "__smoke"
    if args.tag:
        tag += f"__{args.tag}"
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(json.dumps(
        {k: res.get(k) for k in ("arch", "shape", "multi_pod", "ok",
                                 "skipped", "error", "compile_s")},
        default=str))
    if res.get("ok") and "roofline" in res:
        r = res["roofline"]
        print(f"  terms: compute={r['t_compute_s']:.4f}s "
              f"memory={r['t_memory_s']:.4f}s "
              f"collective={r['t_collective_s']:.4f}s "
              f"dominant={r['dominant']} "
              f"roofline_frac={r['roofline_fraction']:.3f}")
        print(f"  mem/device: {res['memory']['peak_per_device_gb']} GiB; "
              f"model/plan flops ratio: {res['hlo_flops_ratio']:.3f}")


if __name__ == "__main__":
    main()
