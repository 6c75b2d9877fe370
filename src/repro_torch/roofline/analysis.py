"""Three-term roofline of a dry-run plan, and the model FLOPs of a
configuration.

Port of ``repro.roofline.analysis``:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = moved_bytes_per_device / LINK_BW

The reference parses XLA's compiled HLO text; the port has no compiled
module, so these functions read the records of a plan
(``launch/dryrun.py``): ``collective_bytes`` takes the collectives the
plan's sharding rules imply, one record each (``op``, ``dtype`` as HLO
names it, the result ``shape``, the replica ``group`` size, ``where``
and ``rule``), and converts each to wire bytes with the reference's ring
model over the group size N:

  all-reduce       2 (N-1)/N * result
  all-gather       (N-1)/N * result      (result == gathered buffer)
  reduce-scatter   (N-1)   * result      (operand == N * result)
  all-to-all       (N-1)/N * result
  collective-permute        result

A record with ``op == "while"`` is a loop the plan costs once (the MoE
router's ``fused_ot_phases`` launch) and counts in ``while_ops``, as the
reference counts XLA's while loops. :func:`hlo_lines` renders records as
the HLO lines the reference's parser reads, so both parsers can be held
against each other.

The constants are the H100 SXM's (NVIDIA's data sheet, at its 700 W
power limit): dense bf16 on the tensor cores, HBM3, and NVLink's 900 GB/s
a card, 450 GB/s each way. A card set below 700 W runs below them; a
record built on the card states its ``nvidia-smi`` name and power limit.

``model_flops`` counts the parameters of ``init_params`` under
``FakeTensorMode``, which gives every shape and allocates nothing, so a
full-width model is counted on any host.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from torch._subclasses.fake_tensor import FakeTensorMode

# H100 SXM (NVIDIA data sheet, 700 W)
PEAK_FLOPS = 989e12          # bf16, dense, tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink, each way
CONSTANTS = {"card": "H100 SXM (data sheet, 700 W)", "peak_flops": PEAK_FLOPS,
             "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW}

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


def record_bytes(rec: Dict) -> float:
    """The result bytes of one collective record."""
    n = 1
    for d in rec["shape"]:
        n *= int(d)
    return float(_DTYPE_BYTES[rec["dtype"]] * n)


def moved_bytes(rec: Dict) -> float:
    """Wire bytes of one record under the ring model (N at least 2)."""
    op, rb, n = rec["op"], record_bytes(rec), max(int(rec["group"]), 2)
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * rb
    if op in ("all-gather", "all-to-all"):
        return (n - 1) / n * rb
    if op == "reduce-scatter":
        return (n - 1) * rb
    return rb


def collective_bytes(records: Iterable[Dict]) -> Dict:
    """The reference's ``collective_bytes`` dict over plan records."""
    out = {op: 0.0 for op in OPS}
    counts = {op: 0 for op in OPS}
    moved, loops = 0.0, 0
    for rec in records:
        if rec["op"] == "while":
            loops += 1
            continue
        mv = moved_bytes(rec)
        out[rec["op"]] += mv
        counts[rec["op"]] += 1
        moved += mv
    return {"moved_bytes": moved, "by_op": out, "counts": counts,
            "while_ops": loops}


def hlo_lines(records: Iterable[Dict]) -> str:
    """The records as HLO instruction lines (result shape, op, replica
    groups of the record's size), one a line."""
    lines: List[str] = []
    for i, rec in enumerate(records):
        if rec["op"] == "while":
            lines.append(f"  %while.{i} = s32[] while(s32[] %c{i}), "
                         f"condition=%cond, body=%body  // {rec['where']}")
            continue
        t = f"{rec['dtype']}[{','.join(str(int(d)) for d in rec['shape'])}]"
        n = int(rec["group"])
        lines.append(f"  %{rec['op']}.{i} = {t} {rec['op']}({t} %x{i}), "
                     f"replica_groups=[1,{n}]<=[{n}]  // {rec['where']}: "
                     f"{rec['rule']}")
    return "\n".join(lines)


def dus_alias_bytes(rebuilds: Iterable[Dict]) -> float:
    """Bytes of a step's out-of-place rebuilds of a cache it carries: 2 x
    each rebuilt leaf's bytes (read and write, as the reference charges a
    dynamic-update-slice of a donated buffer). ``rebuilds``: records
    (``dtype``, ``shape``, ``where``, ``op``) of the returned cache leaves
    that are new storages; a cache written in place has none."""
    return sum(2.0 * record_bytes(r) for r in rebuilds)


def roofline_terms(cost: Dict, collective: Dict) -> Dict:
    """The reference's terms from a plan's ``cost`` ({"flops", "bytes
    accessed", "dus_alias_bytes"}, per device) and its
    ``collective_bytes`` dict."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    dus = float(cost.get("dus_alias_bytes", 0.0))
    bytes_adj = max(bytes_ - dus, 0.0)
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_ / HBM_BW
    t_memory_adj = bytes_adj / HBM_BW
    t_coll = collective["moved_bytes"] / LINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory_adj),
        ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "dus_alias_bytes": dus,
        "bytes_per_device_alias_adjusted": bytes_adj,
        "collective": collective,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_adjusted_s": t_memory_adj,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_time_s": max(t_compute, t_memory_adj, t_coll),
        "roofline_fraction": t_compute / max(t_compute, t_memory_adj,
                                             t_coll, 1e-30),
        "constants": CONSTANTS,
    }


def _paths(tree, keys=()):
    """(dict keys on the way, tensor) for every tensor of the tree."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _paths(v, keys + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for v in tree for kv in _paths(v, keys)]
    return [(keys, tree)]


def model_flops(cfg, shape, n_chips: int) -> Dict:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for train;
    2 N_active per token for decode/prefill forward-only."""
    from ..models import model as M

    with FakeTensorMode():
        tree = M.init_params(cfg, seed=0, device="cpu")
    total = 0
    active = 0
    for keys, leaf in _paths(tree):
        n = leaf.numel()
        total += n
        if any(k in ("w_gate", "w_up", "w_down") for k in keys) and \
                any(k == "moe" for k in keys):
            active += int(n * cfg.top_k / max(cfg.num_experts, 1))
        elif "embed" in keys:
            pass  # embedding lookup is a gather, not a matmul
        else:
            active += n
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return {
        "n_params_total": total,
        "n_params_active": active,
        "tokens": tokens,
        "model_flops_total": mult * active * tokens,
        "model_flops_per_device": mult * active * tokens / n_chips,
    }
