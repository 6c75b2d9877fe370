"""The work of a training step of a model configuration, counted from its
shapes, and the least time of the MoE router's launch on one NVIDIA H100
SXM: what the training cell's ``step.mfu.train`` and
``moe.router_roofline.train`` divide by.

``config`` is a configuration file's object (``portbench/configs/``),
in the model's own ``config.json`` names.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # H100 SXM, dense bf16 tensor cores


def mla_params(c: dict) -> int:
    """Matmul weights of one latent-attention layer (no query latent):
    W_q, W_kv_a, W_kv_b and W_o."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    dq = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return (d * h * dq + d * (c["kv_lora_rank"] + c["qk_rope_head_dim"])
            + c["kv_lora_rank"] * h * (c["qk_nope_head_dim"]
                                       + c["v_head_dim"])
            + h * c["v_head_dim"] * d)


def active_params(c: dict) -> int:
    """Matmul weights a token passes through: every layer's attention,
    the dense layers' MLP, the MoE layers' router, their k routed
    experts and the shared experts, and the output head. The embedding
    (a lookup) and the norms (no matmul) are left out."""
    d = c["hidden_size"]
    layers = c["num_hidden_layers"]
    dense = c["first_k_dense_replace"]
    fe = c["moe_intermediate_size"]
    moe = (d * c["n_routed_experts"]
           + 3 * d * fe * (c["num_experts_per_tok"] + c["n_shared_experts"]))
    return (layers * mla_params(c) + dense * 3 * d * c["intermediate_size"]
            + (layers - dense) * moe + d * c["vocab_size"])


def attention_flops(c: dict, batch: int, seq: int) -> float:
    """Forward FLOPs of the causal score and value products of every
    layer: 2 B H (S (S + 1) / 2) (d_q + d_v)."""
    dq = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    pairs = seq * (seq + 1) / 2
    return (c["num_hidden_layers"] * 2.0 * batch * c["num_attention_heads"]
            * pairs * (dq + c["v_head_dim"]))


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of B sequences of S tokens:
    6 x active parameters x tokens, plus three times the attention's
    forward FLOPs (forward, and its two backward products). A recompute
    (remat) is not counted: it is work the model does not need."""
    return 6.0 * active_params(c) * batch * seq \
        + 3.0 * attention_flops(c, batch, seq)


def router_bytes(t: int, e: int) -> int:
    """Bytes one launch of the router's ``fused_ot_phases`` must move:
    the (T, E) int32 costs read once, and its state (token duals and
    free units, expert duals and free units, the two (T, E) flow
    matrices, phase and round counters, int32) read once and written
    once."""
    state = 4 * (2 * t + 2 * e + 2 * t * e + 2)
    return 4 * t * e + 2 * state


def router_bound_s(t: int, e: int) -> float:
    """The least time of one router launch: its bytes at the HBM rate."""
    return router_bytes(t, e) / HBM_BYTES_PER_S
