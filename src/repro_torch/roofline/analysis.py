"""Model FLOPs of a configuration.

Port of ``model_flops`` from ``repro.roofline.analysis``. The reference
counts the parameters of ``jax.eval_shape`` over ``init_params``; here
``init_params`` runs under ``FakeTensorMode``, which gives every
parameter's shape and allocates nothing, so a full-width model is counted
on any host. The reference's HLO-text parsers (``collective_bytes``,
``dus_alias_bytes``, ``roofline_terms``) read XLA's compiled modules and
have no counterpart here yet.
"""
from __future__ import annotations

from typing import Dict

from torch._subclasses.fake_tensor import FakeTensorMode


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
