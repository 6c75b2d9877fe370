#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, in order; any failure exits non-zero:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions; build the CUDA kernels from ``src/repro_torch/csrc`` and
     print each entry function's registers, shared memory and spills
     (``ptxas -v``);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: ``slack_propose`` equal bit for bit,
     ``cost_matrix`` within the stated tolerance (each row with
     ``out_sha256``, the digest of the output, as the row kernel's rows
     too); CUDA-event times of kernel, plain version and library call
     beside the bound (``cost_bound``: an l1 term is two FP32
     instructions, an FFMA two flops). The fused
     kernels (``fused_assignment_phases`` at B = 16, 1024 x 1024;
     ``fused_ot_phases`` at B = 8, 512 x 512) run one k = 8 chunk from a
     state a few stepped phases in, every integer field equal to the
     plain version's and to the stepped core's; times of the chunk
     launch, the plain version and the stepped ``run_*_phases``.
     ``fused_assignment_phases`` also at full width: B = 1 on phase 3's
     Fig. 1 costs, one k = 8 chunk from phase 280 of that solve (reached
     on the fused route), against the plain version and the stepped
     core; ``fused_ot_phases`` also at full width: B = 1 at the OT
     cell's size (n = 4096, eps = 0.05) from the initial state, the
     whole solve in one chunk;
     ``sinkhorn_row_update`` at B = 1, 4096 x 4096 and at B = 8, 1024 x
     1000 (per-lane reg, ragged blocks, a zero-mass lane, half the lanes
     marked off by ``active_b``) within its stated tolerance;
     ``slack_propose`` also on the rounds the stepped route runs: round 0
     of phase 280 of phase 3's Fig. 1 solve (169 live rows), of an
     earlier phase with a few thousand, and a B = 16, 1024 x 1024 batch
     with 5 % of the rows live. Every kernel's time is device time
     (``cuda_ms``), cross-checked by ``torch.profiler``
     (``profiler_ms``);
  3. ``solve(ASSIGNMENT)`` at the paper's size (Fig. 1: n = 10 000 points
     in the unit square, euclidean, eps = 0.01) on the stepped route
     (``fused=False``; the default policy takes the fused route on the
     card) and under ``guaranteed=True``, with their certificates and
     the kernel launch counts;
  4. ``solve(OT)`` at n = 4096 with Dirichlet masses, eps = 0.05, with its
     certificates, and an OT solve at n = 512 against scipy's exact LP;
  5. card against CPU on a ragged batch of 8 instances (n = 128 .. 512)
     for both problems: integer state equal field by field; the n = 2048
     assignment cost against ``linear_sum_assignment``;
  6. the fused route, ``DispatchPolicy(fused=True)``: the solves of
     phases 3 and 4 again, on the same inputs, with the same integer
     state and certificates, one fused launch per chunk dispatch, no
     ``slack_propose`` launch and no round flag read; the ragged batch of
     phase 5 in lockstep and compact mode (each bucket run out in one
     launch) and in compact mode with ``chunk=8`` (the chunk loop with
     lane retirement: some bucket must shrink, and each chunk dispatch
     is one fused launch) against the CPU's stepped state;
  7. the solver portfolio on phase 4's inputs: ``solver="sinkhorn"``
     (stepped, then ``fused=True``, which launches ``sinkhorn_row_update``
     once per f-update), ``"hybrid"`` and ``"auto"`` at n = 4096, each
     with its certificates and, for Sinkhorn, plan marginals exact to
     f32; Sinkhorn and hybrid at n = 512 within their bound of scipy's LP
     optimum; then card against CPU on phase 5's ragged batch (Sinkhorn
     floats within a stated tolerance; the hybrid finish from the same
     warm duals with equal integer state);
  8. the serving path: (a) ``AsyncOTScheduler`` with 64 point-cloud
     requests (d = 2, euclidean, m and n from 256-2048, every other one
     OT with Dirichlet(1) masses, eps from {0.05, 0.1}, ``linger_ms=5``,
     ``validate=True``), one of them with a NaN point, which must come
     back ``RequestRejected`` while the rest of its bucket solves, then
     one request with an expired ``deadline``, which must come back
     ``degraded`` with a valid certificate; (b) ``OTService.run_batch``
     with 8 assignment requests of n = 1024-2048 784-pixel images each
     (l1, eps 0.1: Fig. 2's shape, the cost kernel's images instance);
     every healthy request at ladder level 0, not degraded, the
     ``cost_matrix`` and fused kernel counts moved (the services'
     default route on the card), no ``slack_propose``; p50/p99 latency,
     instances/s; (c) every bucket's costs equal to the plain version
     on the card within ``tolerance(metric, d)`` (the serve shapes: B x
     2048^2 at d = 2, 8 x 2048^2 at d = 784), its integer state equal to
     a direct ``solve()`` of the same padded costs on the card, and lane
     (k mod B) of bucket k on the CPU; (d) (a)'s requests again under a
     ``FaultInjector`` transient, retried on the card, every request at
     ladder level 0 and every integer state equal to (a)'s; the memory
     peak ``torch.cuda.max_memory_allocated()`` of (a) + (b), whose
     recordings for (c) hold every bucket on the card, and of (d), which
     records nothing (the service's own peak); the scheduler's buckets
     run under its default policy, mode "mesh" on a one-device mesh, and
     every Solution must say so (``SolveStats.mode == "mesh"``,
     ``devices == 1``);
  9. multi-device dispatch (``core/distributed.py``, ``core/sharded.py``),
     on logical meshes of the one card (D shards on separate streams),
     plus ``make_batch_mesh()`` (every card, a power of two); (a) batch
     placement: B = 4 Fig. 1 assignment instances (n = 10 000, eps 0.01)
     and B = 4 OT instances (n = 4096, Dirichlet(1) masses, eps 0.05),
     each on ``make_batch_mesh()``, D = 2 and D = 4 stepped, then D = 2
     with ``fused=True``, run out and with ``chunk=8`` (one fused launch
     per shard and dispatch; the assignment bucket must shrink); every
     lane's integer state equal to
     ``mode="compact"`` on the same inputs, field for field; (b) matrix
     placement through ``solve(..., DispatchPolicy(mode="mesh",
     placement="matrix"))`` on a logical (2, 2) grid: lane 0 of each of
     (a)'s batches, its integer outputs equal to the compact solve's,
     floats within the stated tolerance; ``slack_propose`` and, under
     ``fused=True``, the fused kernels must launch on each counted run;
 10. the audit layer (``repro_torch.analysis``) on the card: (a) under
     ``set_debug_checks(True)`` the solves of phases 3 and 4 (Fig. 1
     assignment, OT n = 4096) on the default policy and with
     ``fused=True``, every integer field and certificate equal to the
     plain solves of phases 3, 4 and 6 (the dispatch count to phases 3
     and 4's, which chunk by 8 as the checks do: phase 6's fused solves
     run out in one), ``slack_propose`` launched, no
     fused kernel (the sanitizer runs the stepped route), one "debug"
     read per chunk plus one each for the prologue and the epilogue;
     wall time with and without the checks; (b) a B = 4, 2048^2
     assignment batch and an OT batch, each with one NaN cost in lane
     1, ``validate=False``: ``DebugCheckError`` ("nan", lane 1) with the
     checks, a returned solve without them; (c) chunks on the card from
     corrupted states (``match_ba = 99``, ``free_b = -5``) raise the
     reference's messages before any kernel launches, and a clean state
     passes; (d) ``AsyncOTScheduler`` (``validate=False``, checks on,
     ``DispatchPolicy(mode="compact")``) with 8 point-cloud requests (d
     = 2, euclidean, n 1024-2048, eps 0.1, every other one OT), one with
     a NaN point: that one comes back ``RequestRejected``, the other
     seven at ladder level 0, one quarantined, ``cost_matrix`` and
     ``slack_propose`` launched; (e) ``python -m repro_torch.analysis
     --strict`` in a child process exits 0, its dynamic pass on the card
     (no kernel built or loaded anew across the descent), and no kernel
     was built anew during this phase;
 11. the model-serving path (``repro_torch.models``,
     ``serve/engine.Engine``) at the full width of deepseek-moe-16b (28
     layers, d_model 2048, 64 routed experts top-6 plus 2 shared, vocab
     102 400; random bf16 weights from the seed, built on the card):
     (a) the parameter count, bytes and memory peak; (b) ``Engine`` with
     ``router="topk"`` serving 4 requests (prompts of 37, 128, 300 and
     512 tokens, 32 new tokens, one asking for none, one stopping at an
     eos taken from its warm-up run), after a warm-up run: prefill time,
     decode time per step, tokens/s, each completion's accounting, one
     decode step under ``torch.profiler``, and decode through the caches
     against prefill (B = 1, the 512-token prompt): in bf16 at full
     depth, reported, and in float32 compute at full width on the first
     four layers with nothing dropped, within rtol = atol = 1e-3;
     (c) the same with ``router="pushrelabel"``: ``fused_ot_phases``
     launched exactly once per MoE layer per forward pass (27 a pass),
     no host read, the router's flows on the card at the prefill (2048 x
     64) and decode (4 x 64) shapes bit-equal to the plain version on the
     CPU, and each router's device time per layer; (d)
     ``fused_ot_phases`` rows at those two shapes (24 phases of at most 8
     rounds) against the plain version and the stepped core; (e) reduced
     qwen3-4b, deepseek-moe-16b (pushrelabel) and jamba-1.5-large, float32
     compute, card against CPU: logits within rtol = atol = 1e-3 and the
     router's flows bit-equal;
 12. the training path (``models.model.loss_fn``, ``optim/``, ``train/``,
     ``data/``, ``checkpoint/``), after phase 11's model is freed: (a)
     deepseek-moe-16b at full width cut to 4 layers (the dense layer and
     3 MoE layers, 2 267 039 744 parameters), ``router="pushrelabel"``,
     float32 masters drawn on the card from the seed, AdamW, remat:
     parameter count, bytes of params, m and v, the memory peak; (b)
     ``make_train_step``'s step on ``synthetic_batch(cfg, 512, 4, seed,
     step)`` (2048 tokens, the router's 2048 x 64 instance): one warm-up
     step, then 6 counted steps, each with finite loss, grad_norm and
     lr; median step time (host clock to the ``float(loss)`` read, as
     ``Trainer.run``), tokens/s, the memory peak, every float32 master
     moved, no host read, exactly 6 x 3 x 2 = 36 ``fused_ot_phases``
     launches (forward and remat recompute of each MoE layer); one more
     step under ``torch.profiler`` (busy share, top kernels, the router's
     device time a launch); the step's model FLOPs (``roofline.analysis.
     model_flops``) as a share of the bf16 peak; (c) the same under
     ``router="topk"``, from (b)'s state, reported, with 0 launches; (d)
     a rebuild from the seed repeats (b)'s warm-up step with loss and
     grad_norm bit-equal, and two 3-step runs of reduced
     deepseek-moe-16b (``pushrelabel``) give bit-equal parameters; (e)
     reduced llama3.2-3b and deepseek-moe-16b (``pushrelabel``), float32
     compute, 2 steps from the same parameters on the card and on the
     CPU: loss and grad_norm within rtol = atol = 1e-3, the router's
     flows bit-equal to the plain version; (f) the ``Trainer`` on the
     card, reduced deepseek-moe-16b (``pushrelabel``): 8 steps against 4,
     a dropped object and a resumed ``Trainer`` for 4 more (checkpoints
     under ``build/``), the last 4 losses bit-equal, and the reference's
     loss-decrease check (40 steps, lr 2e-3, warmup 5: the mean of the
     last 5 losses below the first 5's minus 0.1); 16-23 s of the whole
     script on an H100, within the 90 s it may take;
 13. expert parallelism (``models/sharding.py``, the mesh branch of
     ``transformer.apply_moe``), on logical mesh shards of the card,
     after phase 12's model is freed: (a) deepseek-moe-16b at full width
     in bf16 (as phase 11 builds it), phase 11's 4 prompts (2048 prefill
     tokens) with 8 new tokens each through ``Engine``, under
     ``router="pushrelabel"`` and ``"topk"``, each alone and under
     ``set_mesh`` of a ('data', 'model') = (2, 4) mesh (8 shards), after
     a warm-up run each: prefill ms, decode ms a step, tokens/s, the
     memory peak; gates: ``fused_ot_phases`` launched 27 MoE layers x 2
     'dp' shards a forward pass under the mesh (27 alone), no host read,
     the eos-free accounting, the mesh run's memory peak within 1 GB of
     the single-device run's (no expert copied: the blocks are views),
     the router's flows at the shard's shapes (1024 x 64 at prefill, 2 x
     64 at decode) bit-equal to the plain version on the CPU, and
     ``fused_ot_phases`` rows at those shapes against the plain version
     and the stepped core on the card; a 3-request batch (B does not
     divide over 'data': the reference's replicated path) under the
     mesh, 27 launches a pass; (b) float32 compute at full width on the
     dense layer and 3 MoE layers: prefill under the mesh against the
     single-device forward applied to each 'dp' shard (the other layers
     on the whole batch), the 4 requests and the 3, within 1e-4; (c)
     phase 12's training configuration (full width, 4 layers, float32
     masters, AdamW, remat, B = 4 x S = 512) under a (2, 2) mesh: a
     warm-up step and 3 counted steps with 3 MoE layers x 2 shards x 2
     (forward and recompute) = 12 router launches a step, finite
     metrics, every master moved, no host read; a rebuild repeats the
     first step bit for bit; the single-device twin's 3 steps; reduced
     deepseek-moe-16b (``pushrelabel``) under (2, 2), 2 steps on the card
     and on the CPU in float32 within rtol = atol = 1e-3, flows
     bit-equal;
 14. the dry-run group (``launch/dryrun.py``, ``roofline/``,
     ``core/sharded.lower_sharded_solver``): (a) ``run_cell`` with
     ``unroll=False`` at full width on the 16 x 16 production mesh of
     ``meta`` devices: deepseek-moe-16b ``train_4k`` and ``decode_32k``,
     qwen3-4b ``prefill_32k``, mamba2-2.7b ``decode_32k``, deepseek-moe-16b
     ``train_4k`` on the 2 x 16 x 16 mesh and under
     ``router="pushrelabel"``, every cell ``ok``, each with its GiB a
     device, the three roofline terms (the plan's counts over the H100
     SXM's data-sheet rates), the dominant term and its collective
     records; (b) phase 12's training configuration (full width, 4
     layers, float32, AdamW, B = 4 x S = 512, ``pushrelabel``) planned on
     a (1, 1) mesh of the card, then placed and stepped there: the plan's
     argument bytes against the growth of ``memory_allocated()`` (within
     the allocator's rounding: 512 B a tensor, and up to 1 MiB more for
     a tensor of 1 MiB or more), its argument +
     temp bytes against the growth of ``max_memory_allocated()`` over a
     step (the ratio reported), its FLOPs equal to ``FlopCounterMode``
     over a real step, the step's time against the plan's bound, and
     ``fused_ot_phases`` launched once per custom call of the plan (3
     MoE layers x forward and remat recompute); (c)
     ``lower_sharded_solver(1024, 0.05)`` on a logical (2, 2) mesh of the
     card, its ``.compile()`` (the kernel library), and
     ``solve_assignment_sharded`` on the same mesh: ``slack_propose``
     launched on exactly the plan's blocks, one launch a block a round,
     the result bit-equal to the single-device ``solve_assignment``;
 15. one JSON line with every kernel's numbers;
 16. last line: ``{"ok": true, "device": {...}}``.

Phases 3-4 (the stepped route), each part of phase 6 (the fused route),
each solve of phase 7, phase 8's (a) and (b) together (the serve route),
each run of phase 9, each sanitized solve of phase 10, each ``Engine``
run of phase 11, the counted steps of phase 12 (b) and (c) and each
``Engine`` run and the counted training steps of phase 13, and phase
14's training step and sharded solve are driven
with the launch counts set to 0 just before and read just after; the
kernels line gives each kernel's launches on its route, on the serve
route as ``serve_launches``, on the engine's (``router="pushrelabel"``)
as ``engine_launches``, on phase 12 (b)'s training steps as
``train_launches`` and on phase 13 (a)'s expert-parallel ``Engine`` run
(``pushrelabel``, (2, 4) mesh) as ``ep_launches`` and on phase 14's real
training step and sharded solve as ``dryrun_launches``. ``profiler_ms``
counts a
profiler session only if it recorded every launch (see there); the
record keeps each incomplete session under ``profiler_misses``.

It needs one card and exits non-zero when CUDA is unavailable or when it
is run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import copy
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
# int32 ALU instructions: the fp32 rate counts an FMA as 2 flops, so one
# instruction per lane per clock is half of it
INT32_OP_PER_S = FP32_FLOP_PER_S / 2
BF16_FLOP_PER_S = 989e12      # H100 SXM, dense bf16 on the tensor cores

# the shapes of each phase (see the module docstring)
SIZES = {
    # (B, m, n)
    "slack_propose": [(1, 10_000, 10_000), (16, 1024, 1024)],
    # (metric, B, m, n, d)
    "cost_matrix": ([(mt, 1, 10_000, 10_000, 2)
                     for mt in ("euclidean", "sqeuclidean", "l1")]
                    + [(mt, 16, 1024, 1024, 2)
                       for mt in ("euclidean", "sqeuclidean", "l1")]
                    + [("l1", 1, 2048, 2048, 784)]),
    "assignment": (10_000, 0.01),                       # (n, eps)
    "ot": [(4096, 0.05, False), (512, 0.05, True)],     # (n, eps, exact)
    "card_vs_cpu": [128, 160, 200, 256, 300, 384, 450, 512],
    "assignment_exact": (2048, 0.05),                   # (n, eps)
    # fused kernels, phase 2: (B, n, eps, stepped phases before the chunk)
    "fused_assignment": (16, 1024, 0.01, 3),
    # (n, eps, phase the chunk starts at), on phase 3's Fig. 1 costs
    "fused_assignment_full": (10_000, 0.01, 280),
    "fused_ot": (8, 512, 0.02, 2),
    # (n, eps): the OT cell's solve, from the initial state
    "fused_ot_full": (4096, 0.05),
    "fused_k": 8,
    # slack_propose on the stepped route's rounds, phase 2: the Fig. 1
    # round with at most mid_free free rows, and (B, m, n, share of rows
    # active) of a batch
    "propose_rounds": {"mid_free": 4000, "batch": (16, 1024, 1024, 0.05)},
    # sinkhorn_row_update, phase 2: (B, m, n)
    "sinkhorn_row": [(1, 4096, 4096), (8, 1024, 1000)],
    # phase 8, serving: (a) scheduler requests (m, n drawn from sizes,
    # eps from eps, request nan_at poisoned), the expired-deadline
    # request (n, eps: far more phases than the first chunk's 8, so the
    # cut always leaves it degraded); (b) image_reqs assignment requests of n (drawn
    # from images) 784-pixel images each, l1, image_eps
    "serve": {"requests": 64, "sizes": (256, 2048), "eps": (0.05, 0.1),
              "nan_at": 11, "linger_ms": 5.0,
              "want": ("cost", "duals", "state"),
              "deadline": (2048, 0.01),
              "images": (1024, 2048), "image_reqs": 8, "image_eps": 0.1},
    # phase 9, multi-device: B instances a batch, (n, eps) of each
    # problem, the logical shard counts of batch placement and the
    # logical (row, col) grid of matrix placement
    "mesh": {"batch": 4, "assignment": (10_000, 0.01), "ot": (4096, 0.05),
             "logical": (2, 4), "grid": (2, 2)},
    # phase 10, the audit layer: (b) the NaN batches (B, n, eps of each
    # problem), (c) the corrupted chunks' (B, n), (d) the scheduler's
    # requests (count, n range, eps, the NaN one)
    "audit": {"nan": (4, 2048, 0.05), "corrupt": (2, 64),
              "requests": 8, "sizes": (1024, 2048), "eps": 0.1,
              "nan_at": 3},
    # phase 11, the model-serving path: the model (full width; "reduce"
    # shrinks it for a rehearsal on the CPU), the Engine's requests (one
    # prompt of each length, new_tokens each but request zero_new_at,
    # which asks for none; request eos_at[0] stops at the token its
    # warm-up run gave at step eos_at[1]), the cache length, the MoE
    # layers and tolerance of the float32 decode-against-prefill check at
    # full width (the dense layer before them), and (e)'s
    # reduced models (arch, router) with the card-vs-CPU tolerance of
    # their float32 logits
    "models": {"arch": "deepseek-moe-16b", "prompts": (37, 128, 300, 512),
               "new_tokens": 32, "zero_new_at": 1, "eos_at": (2, 4),
               "max_len": 576, "f32_moe_layers": 3,
               "f32_tol": {"rtol": 1e-3, "atol": 1e-3},
               "card_vs_cpu": [("qwen3-4b", None),
                               ("deepseek-moe-16b", "pushrelabel"),
                               ("jamba-1.5-large-398b", None)],
               "card_vs_cpu_tol": {"rtol": 1e-3, "atol": 1e-3}},
    # phase 12, the training path: the model at full width cut to
    # num_layers (the dense layer and 3 MoE layers; "reduce" shrinks it
    # for a rehearsal on the CPU), the batch of each step (B x S =
    # 2048 tokens: the router's 2048 x 64 instance), the counted steps
    # after one warm-up; (d) the reduced runs' steps; (e) the reduced
    # models, their batch ("small"), steps, lr and the card-vs-CPU
    # tolerance of loss and grad_norm; (f) the Trainer's kill/resume and
    # the reference's loss-decrease run
    "train": {"arch": "deepseek-moe-16b", "num_layers": 4, "seq_len": 512,
              "batch": 4, "steps": 6, "reduced_steps": 3,
              "small": {"seq_len": 16, "batch": 2}, "small_lr": 1e-3,
              "card_vs_cpu": [("llama3.2-3b", None),
                              ("deepseek-moe-16b", "pushrelabel")],
              "card_vs_cpu_steps": 2,
              "card_vs_cpu_tol": {"rtol": 1e-3, "atol": 1e-3},
              "resume": {"seq_len": 16, "batch": 2, "ckpt_every": 4},
              "decrease": {"seq_len": 32, "batch": 4, "steps": 40,
                           "lr": 2e-3, "warmup": 5}},
    # phase 13, expert parallelism: the model-serving path's model under
    # a ('data', 'model') mesh of logical shards of the card ("reduce"
    # shrinks it for a rehearsal on the CPU): phase 11's prompts, each
    # asking for new_tokens, the cache length, the replicated batch (the
    # first `replicated` requests: B does not divide over 'data'), the
    # memory peak's allowance over the single-device Engine's; (b) the
    # float32 check on the dense layer and f32_moe_layers MoE layers and
    # its tolerance; (c) phase 12's training configuration under
    # train_mesh for train_steps counted steps
    "ep": {"arch": "deepseek-moe-16b", "mesh": (2, 4), "new_tokens": 8,
           "max_len": 528, "replicated": 3, "memory_slack": 1e9,
           "f32_moe_layers": 3, "f32_tol": 1e-4,
           "train_mesh": (2, 2), "train_steps": 3},
    # phase 14, the dry-run group: (a) full-width cells planned on the
    # production mesh (arch, shape, run_cell options; "reduce" plans the
    # smoke shapes on the small mesh for a rehearsal on the CPU); (b)
    # phase 12's training configuration planned on a (1, 1) mesh of the
    # card and run there once; (c) the sharded solver's plan and solve
    # (n, eps, grid)
    "dryrun": {"cells": [("deepseek-moe-16b", "train_4k", {}),
                         ("deepseek-moe-16b", "decode_32k", {}),
                         ("qwen3-4b", "prefill_32k", {}),
                         ("mamba2-2.7b", "decode_32k", {}),
                         ("deepseek-moe-16b", "train_4k",
                          {"multi_pod": True}),
                         ("deepseek-moe-16b", "train_4k",
                          {"router": "pushrelabel"})],
               "solver": (1024, 0.05, (2, 2))},
}

# kernel -> (source, Pallas kernel it replaces)
KERNELS = {
    "slack_propose": (
        "src/repro_torch/csrc/slack_propose.cu",
        "src/repro/kernels/slack_propose.py:86 (slack_propose; "
        "slack_propose_batched at :157)"),
    "cost_matrix": (
        "src/repro_torch/csrc/cost_matrix.cu",
        "src/repro/kernels/cost_matrix.py:76 (cost_matrix; "
        "cost_matrix_batched at :117)"),
    "fused_assignment_phases": (
        "src/repro_torch/csrc/fused_assignment.cu",
        "src/repro/kernels/fused_phase.py:181 (fused_assignment_phases; "
        "_assignment_kernel at :87)"),
    "fused_ot_phases": (
        "src/repro_torch/csrc/fused_ot.cu",
        "src/repro/kernels/fused_phase.py:334 (fused_ot_phases; "
        "_ot_kernel at :230)"),
    "sinkhorn_row_update": (
        "src/repro_torch/csrc/sinkhorn_row.cu",
        "src/repro/kernels/sinkhorn_step.py:50 (sinkhorn_row_update; "
        "pallas_call at :73)"),
}
# the route whose launches the kernels line gives for each kernel
ROUTE = {"slack_propose": "stepped", "cost_matrix": "stepped",
         "fused_assignment_phases": "fused_assignment",
         "fused_ot_phases": "fused_ot",
         "sinkhorn_row_update": "sinkhorn_fused"}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


FLUSH_BYTES = 256 << 20        # read before a cold call: > the 50 MB L2
PROFILER_TRIES = 3             # profiler sessions before giving up
_TIMING: dict = {}


def _spacer(torch, host_s: float, cold: bool) -> None:
    """Enqueue what the card runs just before a timed call: a spin
    (``torch.cuda._sleep``) of twice ``host_s`` plus 50 us (at most 20 ms),
    then, if ``cold``, a read of a ``FLUSH_BYTES`` scratch."""
    st = _TIMING.get("state")
    if st is None:
        flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        b.synchronize()
        st = _TIMING["state"] = {"flush": flush,
                                 "cycles_per_s": 1e9 / a.elapsed_time(b)}
    spin_s = min(2 * host_s + 50e-6, 20e-3)
    torch.cuda._sleep(int(spin_s * st["cycles_per_s"]))
    if cold:
        st["flush"].sum()


def _warm_up(torch, fn, warmup: int) -> float:
    """Run ``fn()`` ``warmup`` times (at least once); the host seconds the
    last call took to return, which is what the spacer must cover."""
    host = 0.0
    for _ in range(max(warmup, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host


def cuda_ms(torch, fn, reps: int, warmup: int = 2, cold: bool = True
            ) -> float:
    """Median device time in ms of ``fn()`` over ``reps`` calls, each
    bracketed by two CUDA events, after ``warmup`` calls.

    Before each first event the stream gets a spacer: a spin of twice the
    host time of one call, then (``cold``) a read of 256 MB. The card
    reaches the first event only after the host has enqueued the call and
    the second event, so the interval holds the call's kernels and the
    gaps between them on the card, not the wrapper's host work (checks,
    allocations, the ctypes call). Recorded on an idle card, the first
    event would let that host work into the interval, most of it for a
    kernel of a few tens of us. A function that reads the device
    from the host (the stepped cores) still waits on it inside the
    interval.

    The L2 is cold (the read evicts the call's operands; its lines are
    clean, so evicting them writes nothing), as the bounds assume: every
    operand byte read from HBM once. On their routes: ``slack_propose``'s
    operands exceed the L2 except in late rounds (169 live rows of
    10 000: 6.8 MB), whose rows the previous round read, with only (B, m)
    and (B, n) vectors touched between; those rows carry a ``warm_ms``
    (``cold=False``) beside. ``cost_matrix`` reads kilobytes and writes
    B m n floats, so the L2 does not matter. A fused chunk's c_int stays
    in L2 across the chunks of a solve only at B = 8, 512^2 (8 MB).
    ``sinkhorn_row_update`` follows the column update, which reads all of
    c (32-64 MB here), so at most c's tail is warm."""
    host = _warm_up(torch, fn, warmup)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _spacer(torch, host, cold)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_us(evt) -> float:
    """Device microseconds of one ``key_averages()`` entry."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profiler_ms(torch, fn, kernel: str, reps: int = 5, cold: bool = True):
    """The cross-check of ``cuda_ms``: mean device time in ms, per call
    of ``fn()`` (which launches the kernel once), of the CUDA kernels
    whose name contains ``kernel``, as ``torch.profiler`` records them
    (CUPTI's start and end of each kernel), with the same spacer before
    each call.

    A session sometimes loses its GPU records: in runs of the whole
    script a few sessions kept only the last call's records, or none,
    whatever ran on the card before the first call (a 50 ms spin there
    was lost with the rest), and the session right after saw every
    launch. So a session counts only if it saw exactly ``reps``
    launches of the kernel; up to ``PROFILER_TRIES`` sessions are run,
    each incomplete one is logged and kept under
    ``_TIMING["profiler_misses"]``, and None is returned if none was
    complete."""
    host = _warm_up(torch, fn, 1)
    tries = []
    for _ in range(PROFILER_TRIES):
        us, n, spins, order = _profiled(torch, fn, kernel, reps, cold,
                                        host)
        tries.append({"us": us, "launches_seen": n, "spins_seen": spins,
                      "device_order": order})
        if n == reps:
            break
    if len(tries) > 1 or n != reps:
        miss = {"kernel": kernel, "reps": reps, "tries": tries}
        _TIMING.setdefault("profiler_misses", []).append(miss)
        log(f"profiler_ms: incomplete session(s): {json.dumps(miss)}")
    return us / reps / 1e3 if n == reps else None


def _profiled(torch, fn, kernel, reps, cold, host):
    """One ``torch.profiler`` session (CUDA activity) over ``reps`` calls
    of ``fn()``, each after the spacer: the summed device us and the
    launches of the kernels named ``kernel``, the spacer's spins seen,
    and the order of the device events (``_device_order``)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            _spacer(torch, host, cold)
            fn()
        torch.cuda.synchronize()
    evts = prof.key_averages()
    hit = [e for e in evts if kernel in e.key and device_us(e) > 0]
    spins = sum(e.count for e in evts if "spin_kernel" in e.key)
    return (sum(device_us(e) for e in hit), sum(e.count for e in hit),
            spins, _device_order(prof, kernel))


def _device_order(prof, kernel) -> str:
    """The session's device events in start order, one letter each: "s"
    a spin, "K" the kernel asked for, "o" any other (which records a
    lossy session dropped)."""
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    dev.sort(key=lambda e: e.time_range.start)
    return "".join("s" if "spin_kernel" in e.name
                   else "K" if kernel in e.name else "o" for e in dev)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")


def ptxas_summary(text: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {entry function: {"registers",
    "smem" (static bytes), "spill_stores", "spill_loads"}}."""
    out, entry = {}, None
    for line in text.splitlines():
        if (e := _PTXAS_ENTRY.search(line)):
            entry = e.group(1)
            out[entry] = {"registers": None, "smem": 0, "spill_stores": 0,
                          "spill_loads": 0}
        elif entry is None:
            continue
        elif (sp := _PTXAS_SPILL.search(line)):
            out[entry].update(spill_stores=int(sp.group(1)),
                              spill_loads=int(sp.group(2)))
        elif (u := _PTXAS_USED.search(line)):
            out[entry].update(registers=int(u.group(1)),
                              smem=int(u.group(2) or 0))
    return out


def out_sha256(t) -> str:
    """SHA-256 of a tensor's bytes (copied to the host): two kernels'
    outputs are bit-equal iff their digests are."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the full record of the run is written")
    args = ap.parse_args()

    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        return fail("src/repro_torch not found beside chip_smoke.py; run "
                    "it from a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script "
                    "drives the port on an NVIDIA GPU")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import device as rdev
    from repro_torch.kernels import ops

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    record = {"seed": args.seed, "phases": {}}
    t_start = time.monotonic()

    # -- 1. the card, the build --------------------------------------
    smi = smi_line()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    build_s = ops.build_kernels()
    log(f"[1] built {sorted(ops.build_log) or 'no'} kernels in "
        f"{build_s:.1f} s")
    record["ptxas"] = {name: ptxas_summary(text)
                       for name, text in sorted(ops.build_log.items())}
    for name, entries in record["ptxas"].items():
        log(f"[1] ptxas {name}: {json.dumps(entries)}")
    record["card"] = smi
    record["build_s"] = build_s

    # -- 2. kernels against their plain versions -----------------------
    kernel_rows = {}
    record["phases"]["kernels"] = rows = []
    if not phase_kernels(torch, ops, rng, dev, rows, kernel_rows):
        return fail("a kernel disagreed with its plain version")
    # its own generator, so phases 3-5 draw the inputs they always drew;
    # a copy of the main one draws phase 3's Fig. 1 points
    if not phase_fused_kernels(torch, ops, np.random.default_rng(
            [args.seed, 2]), dev, rows, kernel_rows,
            fig1_rng=copy.deepcopy(rng), seed=args.seed):
        return fail("a fused kernel disagreed with its plain version")
    if not phase_sinkhorn_kernel(torch, ops, np.random.default_rng(
            [args.seed, 3]), dev, rows, kernel_rows):
        return fail("sinkhorn_row_update disagreed with its plain version")
    if not phase_propose_rounds(torch, ops, copy.deepcopy(rng),
                                np.random.default_rng([args.seed, 5]), dev,
                                rows):
        return fail("slack_propose disagreed with its plain version on "
                    "the route's rounds")
    log(f"[2] done at {time.monotonic() - t_start:.0f} s")

    # -- 3-5: the stepped route, counted --------------------------------
    ctx = {"seed": args.seed}
    launches = {}
    ops.reset_launches()
    rdev.reset_sync_counts()
    ok = phase_assignment(torch, rng, dev, record, ctx)
    launches["stepped"] = main_launches = dict(ops.launches)
    log(f"[3] launches {main_launches}, syncs {dict(rdev.sync_counts)}; "
        f"done at {time.monotonic() - t_start:.0f} s")
    if not ok:
        return fail("full-size assignment")
    for name in ("slack_propose", "cost_matrix"):
        if main_launches[name] == 0:
            return fail(f"the main path never launched {name}")

    ops.reset_launches()
    rdev.reset_sync_counts()
    ok = phase_ot(torch, rng, dev, record, ctx)
    ot_launches = dict(ops.launches)
    log(f"[4] launches {ot_launches}, syncs {dict(rdev.sync_counts)}; "
        f"done at {time.monotonic() - t_start:.0f} s")
    if not ok:
        return fail("OT")
    if ot_launches["slack_propose"] == 0:
        return fail("the OT path never launched slack_propose")

    if not phase_card_vs_cpu(torch, rng, dev, record, ctx):
        return fail("card against CPU")
    log(f"[5] done at {time.monotonic() - t_start:.0f} s")

    # -- 6. the fused route, counted --------------------------------------
    if not phase_fused(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the fused route")
    log(f"[6] done at {time.monotonic() - t_start:.0f} s")

    # -- 7. the solver portfolio, counted ---------------------------------
    if not phase_portfolio(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the solver portfolio")
    if not phase_portfolio_card_vs_cpu(torch, dev, record, ctx):
        return fail("the solver portfolio, card against CPU")
    log(f"[7] done at {time.monotonic() - t_start:.0f} s")

    # -- 8. the serving path, counted -------------------------------------
    if not phase_serving(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the serving path")
    log(f"[8] done at {time.monotonic() - t_start:.0f} s")

    # -- 9. multi-device dispatch, counted --------------------------------
    if not phase_mesh(torch, ops, rdev, dev, record, ctx, launches):
        return fail("multi-device dispatch")
    log(f"[9] done at {time.monotonic() - t_start:.0f} s")

    # -- 10. the audit layer, counted --------------------------------------
    t10 = time.monotonic()
    if not phase_audit(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the audit layer")
    record["phases"]["audit"]["phase_s"] = time.monotonic() - t10
    log(f"[10] phase 10 took {time.monotonic() - t10:.1f} s; done at "
        f"{time.monotonic() - t_start:.0f} s")

    # -- 11. the model-serving path, counted --------------------------------
    t11 = time.monotonic()
    if not phase_models(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the model-serving path")
    record["phases"]["models"]["phase_s"] = time.monotonic() - t11
    log(f"[11] phase 11 took {time.monotonic() - t11:.1f} s; done at "
        f"{time.monotonic() - t_start:.0f} s")

    # -- 12. the training path, counted -------------------------------------
    t12 = time.monotonic()
    if not phase_train(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the training path")
    record["phases"]["train"]["phase_s"] = time.monotonic() - t12
    log(f"[12] phase 12 took {time.monotonic() - t12:.1f} s; done at "
        f"{time.monotonic() - t_start:.0f} s")

    # -- 13. expert parallelism, counted ---------------------------------
    t13 = time.monotonic()
    if not phase_ep(torch, ops, rdev, dev, record, ctx, launches):
        return fail("expert parallelism")
    record["phases"]["ep"]["phase_s"] = time.monotonic() - t13
    log(f"[13] phase 13 took {time.monotonic() - t13:.1f} s; done at "
        f"{time.monotonic() - t_start:.0f} s")

    # -- 14. the dry-run group, counted ---------------------------------
    t14 = time.monotonic()
    if not phase_dryrun(torch, ops, rdev, dev, record, ctx, launches):
        return fail("the dry-run group")
    record["phases"]["dryrun"]["phase_s"] = time.monotonic() - t14
    log(f"[14] phase 14 took {time.monotonic() - t14:.1f} s; done at "
        f"{time.monotonic() - t_start:.0f} s")

    # -- 15. kernels line -----------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = dict(kernel_rows[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[ROUTE[name]][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "ok": row["ok"], "shape": row["shape"],
            "serve_launches": launches["serve"][name],
            "engine_launches": launches["engine"][name],
            "train_launches": launches["train"][name],
            "ep_launches": launches["ep"][name],
            "dryrun_launches": launches["dryrun"].get(name, 0),
            **({"stepped_ms": row["stepped_ms"]} if "stepped_ms" in row
               else {}),
            # the path of csrc/fused_assignment.cu the row held
            **({"path": row["path"], "cluster": row["cluster"]}
               if "cluster" in row else {})})
    # fused_ot_phases at the pushrelabel router's shapes; its launches are
    # the Engine run's (phase 11 (c)), then the expert-parallel Engine
    # run's (phase 13 (a), the shapes of a 'dp' shard)
    source, replaces = KERNELS["fused_ot_phases"]
    for phase, route, path in (
            ("models", "engine", "engine (pushrelabel router)"),
            ("ep", "ep", None)):
        for row in record["phases"][phase]["router_rows"]:
            kernels.append({
                "name": "fused_ot_phases", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": launches[route]["fused_ot_phases"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "ok": row["ok"],
                "shape": row["shape"], "k": row["k"],
                "path": path or row["path"],
                "engine_launches": launches["engine"]["fused_ot_phases"],
                "train_launches": launches["train"]["fused_ot_phases"],
                "ep_launches": launches["ep"]["fused_ot_phases"],
                "dryrun_launches": launches["dryrun"].get(
                    "fused_ot_phases", 0),
                "stepped_ms": row["stepped_ms"]})
    record["kernels"] = kernels
    record["launches"] = launches
    record["ot_launches"] = ot_launches
    record["profiler_misses"] = _TIMING.get("profiler_misses", [])
    record["wall_s"] = time.monotonic() - t_start
    out = root / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=float))
    log(f"[15] record written to {args.out}")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def propose_bound(b: int, m: int, n: int, n_active: int):
    """``(bound_ms, bound_by)`` of one ``slack_propose`` launch: bytes, the
    live rows of c_int read once (4 n per row) and the vectors (y_b,
    active, y_a, avail, salt) read once, the outputs (12 B per row)
    written once, over the HBM rate; operations, 3 int32 (add, compare,
    select) per element of the live rows, over the int32 rate."""
    nbytes = (4 * n_active * n + 4 * b * m + 4 * b * n + b * n + b * m
              + 4 * b + 12 * b * m)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * n_active * n / INT32_OP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _propose_row(torch, ops, kargs, active, reps=20, **extra):
    """``slack_propose`` on one set of operands against its plain version:
    equality bit for bit (col and key), the kernel's time (cold, warm
    and under the profiler), the plain version's, and the bound."""
    from repro_torch.kernels.slack_propose import slack_propose_ref

    c, y_b, y_a, avail, salt = kargs
    b, m, n = c.shape
    col, key = ops.slack_propose_batched(*kargs, active_b=active)
    rcol, rkey = slack_propose_ref(*kargs, active)
    torch.cuda.synchronize()
    ok = bool(torch.equal(col, rcol) and torch.equal(key, rkey))
    adm = float(((y_b[:, :, None] + y_a[:, None, :] == c + 1)
                 & avail[:, None, :]).float().mean())

    def kernel():
        return ops.slack_propose_batched(*kargs, active_b=active)
    ms = cuda_ms(torch, kernel, reps=reps)
    warm_ms = cuda_ms(torch, kernel, reps=reps, cold=False)
    prof_ms = profiler_ms(torch, kernel, "slack_propose_kernel")
    plain_ms = cuda_ms(torch, lambda: slack_propose_ref(*kargs, active),
                       reps=3, warmup=1)
    n_active = int(active.sum())
    bound_ms, bound_by = propose_bound(b, m, n, n_active)
    row = {"name": "slack_propose", "shape": [b, m, n], **extra,
           "active_rows": n_active, "admissible_frac": adm, "ok": ok,
           "max_abs_err": float((col - rcol).abs().max()), "ms": ms,
           "warm_ms": warm_ms, "profiler_ms": prof_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms,
           "proposing_rows": int((col >= 0).sum())}
    log(f"[2] {json.dumps(row)}")
    return row


def _propose_arrays(rng, b, m, n, active_frac):
    """Random ``slack_propose`` operands as numpy arrays ``(c, y_b, y_a,
    avail, salt, active)``: duals drawn so y_b + y_a - 1 lies in [0, 32)
    and c in [0, 32), so about 1/32 of the (available) edges are
    admissible; each row active with probability ``active_frac``."""
    c = rng.integers(0, 32, (b, m, n), dtype=np.int32)
    y_b = rng.integers(1, 17, (b, m), dtype=np.int32)
    y_a = rng.integers(0, 16, (b, n), dtype=np.int32)
    avail = rng.uniform(size=(b, n)) < 0.9
    active = rng.uniform(size=(b, m)) < active_frac
    salt = rng.integers(0, 2**31 - 1, b, dtype=np.int32)
    return c, y_b, y_a, avail, salt, active


def _propose_operands(torch, rng, dev, b, m, n, active_frac):
    """``_propose_arrays`` on ``dev``: ``(kargs, active)``."""
    *kargs, active = (torch.as_tensor(a, device=dev) for a in
                      _propose_arrays(rng, b, m, n, active_frac))
    return tuple(kargs), active


def _cost_arrays(rng, b, m, n, d):
    return (rng.uniform(size=(b, m, d)).astype(np.float32),
            rng.uniform(size=(b, n, d)).astype(np.float32))


def skip_kernel_draws(rng):
    """Advance ``rng`` past what ``phase_kernels`` draws from it, without
    running a kernel."""
    for b, m, n in SIZES["slack_propose"]:
        _propose_arrays(rng, b, m, n, 0.95)
    for _, b, m, n, d in SIZES["cost_matrix"]:
        _cost_arrays(rng, b, m, n, d)


def phase_kernels(torch, ops, rng, dev, rows, kernel_rows) -> bool:
    ok_all = True
    # slack_propose with 95 % of the rows active
    for b, m, n in SIZES["slack_propose"]:
        kargs, active = _propose_operands(torch, rng, dev, b, m, n, 0.95)
        row = _propose_row(torch, ops, kargs, active, round="dense")
        rows.append(row)
        ok_all &= row["ok"]
        kernel_rows.setdefault("slack_propose", row)
        del kargs, active
        torch.cuda.empty_cache()
    # then cost_matrix, from the same generator
    ok_cost = phase_cost_rows(torch, ops, rng, dev, rows, kernel_rows)
    return ok_all and ok_cost


def cost_bound(metric: str, b: int, m: int, n: int, d: int):
    """``(bound_ms, bound_by)`` of one ``cost_matrix`` launch: bytes, x and
    y read once and the (B, m, n) output written once, over the HBM rate;
    operations, the B m n d terms. A sqeuclidean or euclidean term is one
    FFMA, 2 flops at the fp32 rate. An l1 term |x - y| is two FP32
    instructions (FADD, then FADD with |.|) and no multiply, so it is
    counted as 2 instructions at the instruction rate, half the flop rate
    (which counts an FFMA as 2)."""
    nbytes = 4 * b * (m * d + n * d + m * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if metric == "l1":
        t_ops = 2 * b * m * n * d / (FP32_FLOP_PER_S / 2)
    else:
        t_ops = 2 * b * m * n * d / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_cost_rows(torch, ops, rng, dev, rows, kernel_rows) -> bool:
    """``cost_matrix`` at every metric on the 2-D shapes and l1 on 784-d
    images, against the plain version within ``tolerance(metric, d)``;
    each row carries ``out_sha256``, the digest of the kernel's output, so
    two versions' rows show whether their costs are bit-equal."""
    from repro_torch.kernels.cost_matrix import cost_matrix_ref, tolerance

    ok_all = True
    for metric, b, m, n, d in SIZES["cost_matrix"]:
        x, y = (torch.as_tensor(a, device=dev)
                for a in _cost_arrays(rng, b, m, n, d))
        out = ops.cost_matrix_batched(x, y, metric)
        ref = cost_matrix_ref(x, y, metric)
        torch.cuda.synchronize()
        rtol, atol = tolerance(metric, d)
        err = (out - ref).abs()
        ok = bool((err <= atol + rtol * ref.abs()).all())
        digest = out_sha256(out)
        ms = cuda_ms(torch, lambda: ops.cost_matrix_batched(x, y, metric),
                     reps=20)
        prof_ms = profiler_ms(torch, lambda: ops.cost_matrix_batched(
            x, y, metric), "cost_")
        plain_ms = cuda_ms(torch, lambda: cost_matrix_ref(x, y, metric),
                           reps=3, warmup=1)
        p = {"euclidean": 2.0, "l1": 1.0}.get(metric)
        library_ms = None if p is None else cuda_ms(
            torch, lambda: torch.cdist(x, y, p=p), reps=5, warmup=1)
        bound_ms, bound_by = cost_bound(metric, b, m, n, d)
        row = {"name": "cost_matrix", "metric": metric,
               "shape": [b, m, n, d], "ok": ok, "rtol": rtol, "atol": atol,
               "max_abs_err": float(err.max()), "out_sha256": digest,
               "ms": ms, "profiler_ms": prof_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms}
        log(f"[2] {json.dumps(row)}")
        rows.append(row)
        ok_all &= ok
        if metric == "euclidean" and b == 1:
            kernel_rows["cost_matrix"] = row
        del x, y, out, ref, err
        torch.cuda.empty_cache()
    return ok_all


def _points(rng, n):
    return rng.uniform(size=(n, 2)).astype(np.float32)


def _assignment_certificates(sol, n, guaranteed):
    """Gap, bound, dual feasibility and permutation of one Fig. 1 solve;
    see ``phase_assignment``."""
    gap, bound = sol.additive_gap(), sol.additive_gap_bound()
    limit = bound if guaranteed else 2 * bound
    res = {"cost": sol.cost, "phases": sol.phases, "rounds": sol.rounds,
           "additive_gap": gap, "additive_gap_bound": bound,
           "gap_limit": limit, "dual_feasible": sol.dual_feasible(),
           "perfect_matching": bool(np.array_equal(np.sort(sol.matching()),
                                                   np.arange(n))),
           "dispatches": sol.stats.dispatches}
    ok = bool(gap <= limit and res["dual_feasible"]
              and res["perfect_matching"] and np.isfinite(sol.cost))
    return ok, res


def phase_assignment(torch, rng, dev, record, ctx) -> bool:
    """The default policy, then ``guaranteed=True`` on the same costs.

    Certificates: with the default policy the run's eps bounds the gap by
    2 eps m max(c) (matched edges are tight in units of eps, so rounding
    adds < 1 unit per edge, and the <= eps m rows left free are completed
    at cost <= max(c) each, while the duals of free rows are >= 0); only
    ``guaranteed=True`` (eps/3 inside) brings it under eps m max(c), the
    ``additive_gap_bound``. The costs and each solve's integer state are
    kept in ``ctx`` for the fused route (phase 6)."""
    from repro_torch.core.api import ASSIGNMENT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix

    n, eps = SIZES["assignment"]
    c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                          device=dev)
    ctx["assignment_c"] = c
    ctx["assignment"] = []
    ok = True
    for guaranteed in (False, True):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        # the pre-batched form: a ragged list would pad n = 10 000 to the
        # ceil-pow2 bucket 16 384
        sol = solve(ASSIGNMENT, {"c": c[None]}, eps,
                    DispatchPolicy(guaranteed=guaranteed, fused=False),
                    want=("cost", "duals", "matching", "state"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        cert_ok, cert = _assignment_certificates(sol, n, guaranteed)
        res = {"n": n, "eps": eps, "guaranteed": guaranteed, **cert,
               "wall_s": wall}
        log(f"[3] assignment {json.dumps(res, default=float)}")
        record["phases"].setdefault("assignment", []).append(res)
        ctx["assignment"].append((guaranteed, sol.state(), wall))
        ok &= cert_ok
    return ok


def _ot_certificates(sol, n, nu):
    gap, bound = sol.additive_gap(), sol.additive_gap_bound()
    plan = sol.plan_sparse()
    rows = np.zeros(n)
    np.add.at(rows, plan.rows, plan.vals)
    res = {"cost": sol.cost, "phases": sol.phases, "rounds": sol.rounds,
           "additive_gap": gap, "additive_gap_bound": bound,
           "dual_feasible": sol.dual_feasible(), "plan_nnz": plan.nnz,
           "row_marginal_err": float(np.abs(rows - nu).max()),
           "dispatches": sol.stats.dispatches}
    ok = bool(gap <= bound and res["dual_feasible"] and np.isfinite(sol.cost)
              and res["row_marginal_err"] < 1e-5)
    return ok, res


def phase_ot(torch, rng, dev, record, ctx) -> bool:
    """The OT cells; inputs and integer states are kept in ``ctx`` for
    the fused route (phase 6)."""
    from repro_torch.core.api import OT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.exact import exact_ot_cost

    ok = True
    ctx["ot"] = []
    for n, eps, exact in SIZES["ot"]:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                              device=dev)
        nu = rng.dirichlet(np.ones(n)).astype(np.float32)
        mu = rng.dirichlet(np.ones(n)).astype(np.float32)
        policy = DispatchPolicy(guaranteed=exact, fused=False)
        sol = solve(OT, [(c, nu, mu)], eps, policy,
                    want=("cost", "duals", "plan_sparse", "state"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        cert_ok, cert = _ot_certificates(sol, n, nu)
        res = {"n": n, "eps": eps, "guaranteed": exact, **cert,
               "wall_s": wall}
        ok &= cert_ok
        if exact:
            t1 = time.monotonic()
            opt = exact_ot_cost(c.cpu().numpy(), nu, mu)
            res.update(exact_cost=opt, exact_s=time.monotonic() - t1)
            # guaranteed: cost <= OPT + eps * mass * max(c)
            bound = cert["additive_gap_bound"]
            ok &= bool(opt - 1e-6 <= sol.cost <= opt + bound + 1e-6)
            ctx.setdefault("exact_ot", {})[n] = opt
        log(f"[4] ot {json.dumps(res, default=float)}")
        record["phases"].setdefault("ot", []).append(res)
        ctx["ot"].append(((n, eps, exact), (c, nu, mu), sol.state(), wall))
    return ok


def _state_diff(a, b):
    """Fields of two integer states (on any devices) that differ."""
    out = []
    for f in a._fields:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if x.shape != y.shape or not bool((x == y).all()):
            out.append(f)
    return out


def phase_card_vs_cpu(torch, rng, dev, record, ctx) -> bool:
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.exact import exact_assignment_cost

    ok = True
    sizes = SIZES["card_vs_cpu"]
    costs = [build_cost_matrix(_points(rng, n), _points(rng, n),
                               "euclidean", device=dev) for n in sizes]
    host = [c.cpu() for c in costs]   # the same float matrices on both
    policy = DispatchPolicy(mode="compact", fused=False)
    for name, spec, eps, insts_dev, insts_cpu in [
        ("assignment", ASSIGNMENT, 0.05, costs, host),
        ("ot", OT, 0.1, None, None),
    ]:
        if name == "ot":
            masses = [(rng.dirichlet(np.ones(n)).astype(np.float32),
                       rng.dirichlet(np.ones(n)).astype(np.float32))
                      for n in sizes]
            insts_dev = [(c, nu, mu) for c, (nu, mu) in zip(costs, masses)]
            insts_cpu = [(c, nu, mu) for c, (nu, mu) in zip(host, masses)]
        want = ("cost", "state")
        t0 = time.monotonic()
        on_card = solve(spec, insts_dev, eps, policy, want=want,
                        device=dev)
        t1 = time.monotonic()
        on_cpu = solve(spec, insts_cpu, eps, policy, want=want,
                       device="cpu")
        t2 = time.monotonic()
        fields_ok = True
        for a, b in zip(on_card, on_cpu):
            for f in _state_diff(a.state(), b.state()):
                log(f"[5] {name} n={a.shape} field {f} differs")
                fields_ok = False
        ctx.setdefault("ragged", {})[name] = (spec, eps, insts_dev,
                                              [b.state() for b in on_cpu])
        res = {"problem": name, "eps": eps, "sizes": sizes,
               "state_equal": fields_ok, "card_s": t1 - t0,
               "cpu_s": t2 - t1,
               "phases": [s.phases for s in on_card]}
        log(f"[5] {json.dumps(res)}")
        record["phases"].setdefault("card_vs_cpu", []).append(res)
        ok &= fields_ok

    n, eps = SIZES["assignment_exact"]
    c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                          device=dev)
    sol = solve(ASSIGNMENT, [c], eps, DispatchPolicy(guaranteed=True),
                want=("cost", "duals"), device=dev)[0]
    opt = exact_assignment_cost(c.cpu().numpy())
    res = {"n": n, "eps": eps, "guaranteed": True, "cost": sol.cost,
           "exact_cost": opt, "additive_gap_bound": sol.additive_gap_bound()}
    log(f"[5] exact {json.dumps(res, default=float)}")
    record["phases"]["assignment_exact"] = res
    # guaranteed: cost <= OPT + eps * m * max(c)
    ok &= bool(opt - 1e-3 <= sol.cost <= opt + sol.additive_gap_bound())
    return ok


def _count_scanned(ops, run):
    """Run ``run()`` with ``slack_propose`` counting what its active rows
    read; returns (elements read, distinct (lane, row) pairs read, run's
    result)."""
    seen, rows = [0], [None]
    orig = ops.slack_propose_batched

    def counting(c_int, *a, active_b=None):
        seen[0] += int(active_b.sum()) * int(c_int.shape[2])
        rows[0] = active_b if rows[0] is None else rows[0] | active_b
        return orig(c_int, *a, active_b=active_b)

    ops.slack_propose_batched = counting
    try:
        out = run()
    finally:
        ops.slack_propose_batched = orig
    return seen[0], 0 if rows[0] is None else int(rows[0].sum()), out


def _fused_row(torch, ops, name, shape, kernel, plain, stepped, state0,
               c_int, k, kernel_name, plain_reps=3):
    """One fused kernel against its plain version and the stepped core on
    the same state and k: equality, times and the bound. The work depends
    on the data, so the bound counts what this chunk needs, as the stepped
    run's ``slack_propose`` calls show it (they are the only reads of
    c_int): each row of c_int that a propose step reads, read once; the
    state read and written once; and 3 int32 operations (add, compare,
    select) per element the propose steps read."""
    got = kernel()
    ref = plain()
    scanned, rows_read, step = _count_scanned(ops, stepped)
    torch.cuda.synchronize()
    diff_plain = _state_diff(got, ref)
    diff_stepped = _state_diff(got, step)
    ok = not diff_plain and not diff_stepped
    err = max(int((getattr(got, f).cpu().long()
                   - getattr(ref, f).cpu().long()).abs().max())
              for f in got._fields)
    ms = cuda_ms(torch, kernel, reps=10)
    prof_ms = profiler_ms(torch, kernel, kernel_name)
    plain_ms = cuda_ms(torch, plain, reps=plain_reps, warmup=1)
    stepped_ms = cuda_ms(torch, stepped, reps=3, warmup=1)
    rounds = (got.rounds - state0.rounds).tolist()
    state_bytes = sum(t.numel() * 4 for t in state0)
    nbytes = rows_read * c_int.shape[2] * 4 + 2 * state_bytes
    nops = 3 * scanned
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / INT32_OP_PER_S
    row = {"name": name, "shape": list(shape), "k": k, "ok": ok,
           "differs_from_plain": diff_plain,
           "differs_from_stepped": diff_stepped, "max_abs_err": float(err),
           "ms": ms, "profiler_ms": prof_ms, "plain_ms": plain_ms,
           "stepped_ms": stepped_ms,
           "library_ms": None, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_bytes": nbytes, "bound_ops": nops, "rows_read": rows_read,
           "phases": (got.phases - state0.phases).tolist(),
           "rounds": rounds, "ms_per_round": ms / max(max(rounds), 1)}
    row["bound_share"] = row["bound_ms"] / ms
    return row


def fused_assignment_chunk(torch, rng, dev):
    """Phase 2's ``fused_assignment_phases`` chunk: B lanes of Fig. 1-like
    costs (n uniform points each side, euclidean) a few stepped phases in
    (``SIZES["fused_assignment"]``). Returns ``(c_int, state, threshold,
    phase_cap, m_valid)``; ``tools/fused_chunk_split.py`` times the same
    chunk."""
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.pushrelabel import (
        _max_phases, assignment_prologue, init_assignment_state,
        run_assignment_phases)

    b, n, eps, warm = SIZES["fused_assignment"]
    i32 = torch.int32
    c = torch.stack([build_cost_matrix(
        _points(rng, n), _points(rng, n), "euclidean", device=dev)
        for _ in range(b)])
    _, c_int, _, _, _ = assignment_prologue(
        c, torch.full((b,), eps, dtype=torch.float32, device=dev))
    thr = torch.full((b,), int(eps * n), dtype=i32, device=dev)
    cap = torch.full((b,), _max_phases(eps, n), dtype=i32, device=dev)
    mv = torch.full((b,), n, dtype=i32, device=dev)
    s0 = run_assignment_phases(c_int, init_assignment_state(b, n, n, dev),
                               thr, cap, warm)
    return c_int, s0, thr, cap, mv


def fused_assignment_full_chunk(torch, ops, rng, dev):
    """The same chunk at the Fig. 1 size: B = 1 on the costs of phase 3
    (``rng`` is the generator phase 3 draws its points from, see
    ``fig1_generator``), from phase ``SIZES["fused_assignment_full"][2]``
    of the default policy's solve, where few rows are still free; the
    state is reached by k = 8 fused chunks, as ``solve(..., fused=True)``
    would reach it."""
    start = SIZES["fused_assignment_full"][2]
    c_int, thr, cap, mv, states = fig1_walk(torch, ops, rng, dev)
    for s0 in states:
        if int(s0.phases[0]) >= start:
            break
    return c_int, s0, thr, cap, mv


def fig1_walk(torch, ops, rng, dev, k=None):
    """Phase 3's Fig. 1 costs in units of eps, B = 1 (``rng`` is the
    generator phase 3 draws its points from, see ``fig1_generator``), and
    the states the fused route passes at its chunk boundaries (every
    ``k`` phases, by default ``SIZES["fused_k"]``) from the initial state,
    as an iterator that ends when the solve does. Returns ``(c_int,
    threshold, phase_cap, m_valid, states)``."""
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.pushrelabel import (
        _max_phases, assignment_prologue, init_assignment_state)

    n, eps, _ = SIZES["fused_assignment_full"]
    i32 = torch.int32
    c = build_cost_matrix(_points(rng, n), _points(rng, n), "euclidean",
                          device=dev)[None]
    _, c_int, _, _, _ = assignment_prologue(
        c, torch.full((1,), eps, dtype=torch.float32, device=dev))
    del c
    thr = torch.full((1,), int(eps * n), dtype=i32, device=dev)
    cap = torch.full((1,), _max_phases(eps, n), dtype=i32, device=dev)
    mv = torch.full((1,), n, dtype=i32, device=dev)

    def states():
        s = init_assignment_state(1, n, n, dev)
        while True:
            yield s
            nxt = ops.fused_run_assignment_phases(
                c_int, s, thr, cap, k or SIZES["fused_k"], m_valid=mv)
            if int(nxt.phases[0]) == int(s.phases[0]):
                return
            s = nxt
    return c_int, thr, cap, mv, states()


def phase_propose_rounds(torch, ops, fig1_rng, rng, dev, rows) -> bool:
    """``slack_propose`` on the rounds the stepped route runs.

    Late and mid: round 0 of a phase of phase 3's Fig. 1 solve (B = 1,
    10 000^2; ``fig1_rng`` draws its points), with the operands that
    ``greedy_maximal_matching`` hands the kernel in a phase's first
    round: the free rows active, every column available, salt = phases *
    7919. Late is the state at phase ``SIZES["fused_assignment_full"][2]``
    (280: 169 free rows), mid the first phase with at most
    ``SIZES["propose_rounds"]["mid_free"]`` free rows (the walk goes one
    phase at a time: 803 rows are left at phase 8). Batch: B lanes of
    random operands (``_propose_operands``, from ``rng``) with a few
    percent of the rows active."""
    late = SIZES["fused_assignment_full"][2]
    cfg = SIZES["propose_rounds"]
    c_int, _, _, _, states = fig1_walk(torch, ops, fig1_rng, dev, k=1)
    picked = {}
    for s in states:
        if "mid" not in picked and int((s.match_ba < 0).sum()) <= \
                cfg["mid_free"]:
            picked["mid"] = s
        if int(s.phases[0]) >= late:
            break
    picked["late"] = s              # or the last state, if the solve ended
    picked.setdefault("mid", s)
    ok = True
    n = c_int.shape[2]
    for label in ("late", "mid"):
        s = picked[label]
        kargs = (c_int, s.y_b, s.y_a,
                 torch.ones((1, n), dtype=torch.bool, device=dev),
                 (s.phases * 7919).to(torch.int32))
        row = _propose_row(torch, ops, kargs, s.match_ba < 0, round=label,
                           phase=int(s.phases[0]))
        rows.append(row)
        ok &= row["ok"]
    del c_int, picked, states, kargs
    torch.cuda.empty_cache()

    b, m, n, frac = cfg["batch"]
    kargs, active = _propose_operands(torch, rng, dev, b, m, n, frac)
    row = _propose_row(torch, ops, kargs, active, round="batch")
    rows.append(row)
    return ok and row["ok"]


def fig1_generator(seed):
    """The generator in the state phase 3 draws its Fig. 1 points from:
    ``main``'s after phase 2's kernel checks (``skip_kernel_draws``)."""
    rng = np.random.default_rng(seed)
    skip_kernel_draws(rng)
    return rng


def _assignment_route(ops, c_int):
    """The route ``fused_run_assignment_phases`` takes for ``c_int``'s
    bucket (``ops.Route``: the path and C), and the name of the kernel it
    launches there (the profiler's cross-check counts that kernel's
    launches, so it also shows the path)."""
    b, m, n = c_int.shape
    route = ops.fused_assignment_route(b, m, n, ops._sm_count(c_int.device))
    return route, ("fused_assignment_lane_kernel" if route.path == "lane"
                   else "fused_assignment_kernel")


def phase_fused_kernels(torch, ops, rng, dev, rows, kernel_rows,
                        fig1_rng, seed) -> bool:
    """Each fused kernel for one k = 8 chunk from a state a few stepped
    phases in: Fig. 1-like point clouds (B lanes of n uniform points,
    euclidean), and Dirichlet masses for OT. Then both kernels at full
    width: the assignment kernel late in phase 3's solve
    (``fused_assignment_full_chunk``; ``fig1_rng`` draws phase 3's
    points), the OT kernel on the OT cell's whole solve
    (``fused_ot_full_chunk``). ``ms_per_round`` divides the chunk's time
    by its largest lane's rounds."""
    from repro_torch.core.pushrelabel import run_assignment_phases
    from repro_torch.kernels.fused_phase import fused_assignment_phases_ref

    k = SIZES["fused_k"]

    c_int, s0, thr, cap, mv = fused_assignment_chunk(torch, rng, dev)
    route, kernel_name = _assignment_route(ops, c_int)
    row_a = _fused_row(
        torch, ops, "fused_assignment_phases", tuple(c_int.shape),
        lambda: ops.fused_run_assignment_phases(c_int, s0, thr, cap, k,
                                                m_valid=mv),
        lambda: type(s0)(*fused_assignment_phases_ref(
            c_int, *s0, thr, cap, mv, k=k)),
        lambda: run_assignment_phases(c_int, s0, thr, cap, k, m_valid=mv),
        s0, c_int, k, kernel_name)
    row_a.update(path=route.path, cluster=route.cluster)
    del c_int, s0

    c_int, s0, thr, cap, mr = fused_ot_chunk(torch, rng, dev)
    row_o = _ot_row(torch, ops, c_int, s0, thr, cap, mr, k)
    del c_int, s0
    torch.cuda.empty_cache()

    # full width; the plain version takes ~0.4 s there, so it is timed once
    c_int, s0, thr, cap, mv = fused_assignment_full_chunk(torch, ops,
                                                          fig1_rng, dev)
    route, kernel_name = _assignment_route(ops, c_int)
    row_f = _fused_row(
        torch, ops, "fused_assignment_phases", tuple(c_int.shape),
        lambda: ops.fused_run_assignment_phases(c_int, s0, thr, cap, k,
                                                m_valid=mv),
        lambda: type(s0)(*fused_assignment_phases_ref(
            c_int, *s0, thr, cap, mv, k=k)),
        lambda: run_assignment_phases(c_int, s0, thr, cap, k, m_valid=mv),
        s0, c_int, k, kernel_name, plain_reps=1)
    row_f.update(path=route.path, cluster=route.cluster,
                 start_phase=int(s0.phases[0]),
                 free_rows_before=int((s0.match_ba < 0).sum()))
    del c_int, s0
    torch.cuda.empty_cache()

    # the whole OT cell's solve in one chunk; the plain version is slow at
    # 4096^2, so it is timed once
    c_int, s0, thr, cap, mr = fused_ot_full_chunk(torch, seed, dev)
    row_of = _ot_row(torch, ops, c_int, s0, thr, cap, mr, k, plain_reps=1)
    del c_int, s0
    torch.cuda.empty_cache()
    done = (row_a, row_o, row_f, row_of)
    for row in done:
        log(f"[2] {json.dumps(row)}")
        rows.append(row)
        # the kernels line keeps the B = 16 and B = 8 rows, as in earlier
        # runs
        kernel_rows.setdefault(row["name"], row)
    return all(row["ok"] for row in done)


def _ot_row(torch, ops, c_int, s0, thr, cap, mr, k, plain_reps=3):
    """``_fused_row`` of ``fused_ot_phases`` on one chunk."""
    from repro_torch.core.transport import run_ot_phases
    from repro_torch.kernels.fused_phase import fused_ot_phases_ref

    return _fused_row(
        torch, ops, "fused_ot_phases", tuple(c_int.shape),
        lambda: ops.fused_run_ot_phases(c_int, s0, thr, cap, k, mr),
        lambda: type(s0)(*fused_ot_phases_ref(
            c_int, *s0, thr, cap, k=k, max_rounds=mr)),
        lambda: run_ot_phases(c_int, s0, thr, cap, k, mr),
        s0, c_int, k, "fused_ot_kernel", plain_reps=plain_reps)


def _ot_lanes(torch, rng, dev, b, n, eps):
    """B lanes of the OT cell's kind: n uniform points each side,
    euclidean, Dirichlet(1) masses, theta = 4n/eps. Returns ``(c_int,
    initial state, threshold, phase_cap, max_rounds)``."""
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.transport import (
        init_ot_state, ot_phase_cap, ot_prologue, ot_termination_threshold)

    i32 = torch.int32
    c = torch.stack([build_cost_matrix(
        _points(rng, n), _points(rng, n), "euclidean", device=dev)
        for _ in range(b)])
    nu = rng.dirichlet(np.ones(n), b).astype(np.float32)
    mu = rng.dirichlet(np.ones(n), b).astype(np.float32)
    theta = np.float32(4.0 * n / eps)
    theta_t = torch.full((b,), float(theta), dtype=torch.float32, device=dev)
    eps_t = torch.full((b,), eps, dtype=torch.float32, device=dev)
    c_int, s_int, d_int, _ = ot_prologue(
        c, torch.as_tensor(nu, device=dev), torch.as_tensor(mu, device=dev),
        theta_t, eps_t)
    thr = torch.as_tensor(
        [ot_termination_threshold(x, theta, eps) for x in nu], dtype=i32,
        device=dev)
    cap = torch.full((b,), ot_phase_cap(eps), dtype=i32, device=dev)
    return c_int, init_ot_state(s_int, d_int), thr, cap, 2 * n + 2


def fused_ot_chunk(torch, rng, dev):
    """Phase 2's ``fused_ot_phases`` chunk: B lanes of the OT cell's kind
    a few stepped phases in (``SIZES["fused_ot"]``). Returns ``(c_int,
    state, threshold, phase_cap, max_rounds)``;
    ``tools/fused_chunk_split.py`` times the same chunk."""
    from repro_torch.core.transport import run_ot_phases

    b, n, eps, warm = SIZES["fused_ot"]
    c_int, s0, thr, cap, mr = _ot_lanes(torch, rng, dev, b, n, eps)
    s0 = run_ot_phases(c_int, s0, thr, cap, warm, mr)
    return c_int, s0, thr, cap, mr


def fused_ot_full_chunk(torch, seed, dev):
    """The same chunk at the OT cell's size (``SIZES["fused_ot_full"]``:
    B = 1, n = 4096, eps = 0.05) from the initial state: one k = 8 chunk
    is the whole solve. The inputs are phase 4's distribution drawn from
    their own generator, ``default_rng([seed, 4])``."""
    n, eps = SIZES["fused_ot_full"]
    return _ot_lanes(torch, np.random.default_rng([seed, 4]), dev, 1, n,
                     eps)


def phase_fused(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The fused route on the inputs of phases 3-5: the same integer
    state and certificates, one fused launch per chunk dispatch, no
    ``slack_propose`` launch and no round flag read."""
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve

    ok = True

    def counted(route, fn):
        ops.reset_launches()
        rdev.reset_sync_counts()
        res = fn()
        launches[route] = dict(ops.launches)
        syncs = dict(rdev.sync_counts)
        log(f"[6] {route}: launches {launches[route]}, syncs {syncs}")
        return res, syncs

    def route_ok(route, kernel, dispatches, syncs):
        got = launches[route]
        good = (got[kernel] == dispatches and got["slack_propose"] == 0
                and syncs["round"] == 0 and dispatches > 0)
        if not good:
            log(f"[6] {route}: {kernel} launched {got[kernel]} times for "
                f"{dispatches} chunk dispatches, slack_propose "
                f"{got['slack_propose']}, round reads {syncs['round']}")
        return good

    # the Fig. 1 assignment, the costs of phase 3
    n, eps = SIZES["assignment"]
    c = ctx["assignment_c"]

    def assignment():
        out = []
        for guaranteed, state, stepped_wall in ctx["assignment"]:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            sol = solve(ASSIGNMENT, {"c": c[None]}, eps,
                        DispatchPolicy(guaranteed=guaranteed, fused=True),
                        want=("cost", "duals", "matching", "state"),
                        device=dev)[0]
            sol.cost
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            cert_ok, cert = _assignment_certificates(sol, n, guaranteed)
            diff = _state_diff(sol.state(), state)
            res = {"n": n, "eps": eps, "guaranteed": guaranteed, **cert,
                   "wall_s": wall, "stepped_wall_s": stepped_wall,
                   "state_differs": diff}
            log(f"[6] fused assignment {json.dumps(res, default=float)}")
            record["phases"].setdefault("fused_assignment", []).append(res)
            out.append((cert_ok and not diff, cert["dispatches"]))
        return out

    out, syncs = counted("fused_assignment", assignment)
    ok &= all(o for o, _ in out)
    ok &= route_ok("fused_assignment", "fused_assignment_phases",
                   sum(d for _, d in out), syncs)

    def transport():
        out = []
        for (n, eps, exact), (c, nu, mu), state, stepped_wall in ctx["ot"]:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            sol = solve(OT, [(c, nu, mu)], eps,
                        DispatchPolicy(guaranteed=exact, fused=True),
                        want=("cost", "duals", "plan_sparse", "state"),
                        device=dev)[0]
            sol.cost
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            cert_ok, cert = _ot_certificates(sol, n, nu)
            diff = _state_diff(sol.state(), state)
            res = {"n": n, "eps": eps, "guaranteed": exact, **cert,
                   "wall_s": wall, "stepped_wall_s": stepped_wall,
                   "state_differs": diff}
            log(f"[6] fused ot {json.dumps(res, default=float)}")
            record["phases"].setdefault("fused_ot", []).append(res)
            out.append((cert_ok and not diff, cert["dispatches"]))
        return out

    out, syncs = counted("fused_ot", transport)
    ok &= all(o for o, _ in out)
    ok &= route_ok("fused_ot", "fused_ot_phases", sum(d for _, d in out),
                   syncs)

    # the ragged batch of phase 5 against the CPU's stepped state; with
    # chunk unset each bucket runs out in one launch, so chunk=8 is what
    # runs the chunk loop and its lane retirement
    def ragged():
        good, shrank = True, False
        kernel = {"assignment": "fused_assignment_phases",
                  "ot": "fused_ot_phases"}
        for name, (spec, eps, insts, cpu_states) in ctx["ragged"].items():
            for mode, chunk in (("lockstep", None), ("compact", None),
                                ("compact", 8)):
                before = ops.launches[kernel[name]]
                t0 = time.monotonic()
                sols = solve(spec, insts, eps,
                             DispatchPolicy(mode=mode, fused=True,
                                            chunk=chunk),
                             want=("cost", "state"), device=dev)
                wall = time.monotonic() - t0
                fused = ops.launches[kernel[name]] - before
                diffs = [_state_diff(s.state(), st)
                         for s, st in zip(sols, cpu_states)]
                buckets = list({id(s.stats): s.stats
                                for s in sols}.values())
                dispatches = sum(st.dispatches for st in buckets)
                res = {"problem": name, "mode": mode, "chunk": chunk,
                       "eps": eps, "state_equal": not any(diffs),
                       "card_s": wall, "fused_launches": fused,
                       "dispatches": dispatches,
                       "occupancy": [st.occupancy for st in buckets]}
                log(f"[6] fused ragged {json.dumps(res)}")
                record["phases"].setdefault("fused_ragged", []).append(res)
                good &= not any(diffs) and fused == dispatches
                if chunk is not None:
                    shrank |= any(min(bb for bb, _ in st.occupancy)
                                  < st.occupancy[0][0] for st in buckets)
        if not shrank:
            log("[6] fused ragged: no bucket shrank under chunk=8")
        return good and shrank

    good, syncs = counted("fused_ragged", ragged)
    got = launches["fused_ragged"]
    ok &= bool(good and got["fused_assignment_phases"] > 0
               and got["fused_ot_phases"] > 0 and got["slack_propose"] == 0
               and syncs["round"] == 0)
    return ok


def sinkhorn_row_arrays(rng, b, m, n):
    """The row kernel's operands ``(c, g, log_nu, reg)`` as numpy arrays,
    as ``phase_sinkhorn_kernel`` draws them (see there)."""
    c = rng.uniform(size=(b, m, n)).astype(np.float32)
    nu = rng.dirichlet(np.ones(m), b).astype(np.float32)
    g = rng.normal(0.0, 0.2, (b, n)).astype(np.float32)
    if b > 1:
        for i in range(b):
            mi, ni = m - 37 * i, n - 53 * i
            c[i, mi:], c[i, :, ni:], nu[i, mi:] = 0.0, 0.0, 0.0
        nu[-1] = 0.0
    nu_hat = nu / np.maximum(nu.sum(1, keepdims=True), 1e-30)
    log_nu = np.log(np.maximum(nu_hat, 1e-30)).astype(np.float32)
    eps = np.resize([0.05] if b == 1 else [0.3, 0.1, 0.05, 0.03], b)
    reg = (eps / (4 * np.log(max(m, n)))).astype(np.float32)
    return c, g, log_nu, reg


def phase_sinkhorn_kernel(torch, ops, rng, dev, rows, kernel_rows) -> bool:
    """``sinkhorn_row_update`` against its plain version at the shapes of
    the portfolio's solves: the OT cell of phase 4 (B = 1, 4096 x 4096)
    and a batch of 8 lanes of 1024 x 1000 with per-lane reg from eps in
    {0.3, 0.1, 0.05, 0.03}, ragged valid blocks (cost 0 and no mass
    outside, as the Sinkhorn spec's prepare leaves them) and a zero-mass
    lane; then the batch again with ``active_b`` marking off the odd
    lanes, which must get ``f`` back unchanged.

    Tolerance: rtol 1e-5, atol 1e-5 * max|f|. Both sum the same n terms
    exp(z - max) in another order (32 strided partial sums merged by a
    butterfly against 128-column tiles) and the card's expf is within 2
    ulp, so the log-sum differs by a few ulp of its value; f = reg *
    (log_nu - lse) can cancel, hence the absolute part scaled to max|f|.

    Bound: bytes, c read once (4 B m n) plus g, log_nu, reg and f (4 B (n
    + 2 m + 1)), over the HBM rate; operations, 4 fp32 operations per
    element (subtract, scale, exp, accumulate) over the fp32 rate. The
    library call is the stepped spec's row update, ``reg * (log_nu -
    torch.logsumexp((g - c) / reg))``."""
    from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref
    from repro_torch.portfolio.sinkhorn_spec import _row_update_torch

    ok_all = True
    for b, m, n in SIZES["sinkhorn_row"]:
        c, g, log_nu, reg = (torch.as_tensor(a, device=dev)
                             for a in sinkhorn_row_arrays(rng, b, m, n))
        kargs = (c, g, log_nu, reg)
        got = ops.sinkhorn_row_update(*kargs)
        ref = sinkhorn_row_ref(*kargs)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all() and (
            (got - ref).abs() <= 1e-5 * scale + 1e-5 * ref.abs()).all())
        masked_ok = None
        if b > 1:
            active = torch.arange(b, device=dev) % 2 == 0
            f_old = torch.full((b, m), 7.0, device=dev)
            masked = ops.sinkhorn_row_update(*kargs, active_b=active,
                                             f=f_old)
            torch.cuda.synchronize()
            masked_ok = bool(torch.equal(masked[~active], f_old[~active])
                             and torch.equal(masked[active], got[active]))
            ok &= masked_ok
        ms = cuda_ms(torch, lambda: ops.sinkhorn_row_update(*kargs), reps=20)
        prof_ms = profiler_ms(torch, lambda: ops.sinkhorn_row_update(*kargs),
                              "sinkhorn_row_kernel")
        plain_ms = cuda_ms(torch, lambda: sinkhorn_row_ref(*kargs), reps=3,
                           warmup=1)
        library_ms = cuda_ms(torch, lambda: _row_update_torch(*kargs),
                             reps=10)
        nbytes = 4 * b * m * n + 4 * b * (n + 2 * m + 1)
        nops = 4 * b * m * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S
        row = {"name": "sinkhorn_row_update", "shape": [b, m, n], "ok": ok,
               "rtol": 1e-5, "atol": 1e-5 * scale, "max_abs_err": err,
               "max_abs_f": scale, "active_b_ok": masked_ok,
               "out_sha256": out_sha256(got),
               "ms": ms, "profiler_ms": prof_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "reg * (log_nu - torch.logsumexp((g - c) / reg))",
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        row["bound_share"] = row["bound_ms"] / ms
        log(f"[2] {json.dumps(row)}")
        rows.append(row)
        ok_all &= ok
        kernel_rows.setdefault("sinkhorn_row_update", row)
        del c, g, got, ref
        torch.cuda.empty_cache()
    return ok_all


def _portfolio_certificates(sol, nu, mu, marginals: bool):
    """Gap, bound, dual feasibility and the plan's marginals (from the
    sparse plan, summed in float64 on the host)."""
    gap, bound = sol.additive_gap(), sol.additive_gap_bound()
    plan = sol.plan_sparse()
    rows = np.zeros(len(nu))
    cols = np.zeros(len(mu))
    np.add.at(rows, plan.rows, plan.vals)
    np.add.at(cols, plan.cols, plan.vals)
    res = {"cost": sol.cost, "phases": sol.phases,
           "additive_gap": gap, "additive_gap_bound": bound,
           "dual_feasible": sol.dual_feasible(), "plan_nnz": plan.nnz,
           "row_marginal_err": float(np.abs(rows - nu).max()),
           "col_marginal_err": float(np.abs(cols - mu).max()),
           "dispatches": sol.stats.dispatches, "solver": sol.stats.solver,
           "predicted_s": sol.stats.predicted_s}
    ok = bool(gap <= bound and res["dual_feasible"] and np.isfinite(sol.cost))
    if marginals:
        # AWR rounding puts the plan ON the transport polytope: exact up
        # to f32 sums (2e-6, the reference's own tolerance)
        ok &= res["row_marginal_err"] <= 2e-6
        ok &= res["col_marginal_err"] <= 2e-6
    return ok, res


def phase_portfolio(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The solver portfolio on phase 4's inputs. At n = 4096 (eps = 0.05):
    Sinkhorn stepped and fused (the row kernel launched once per
    f-update, and only there), hybrid, and auto (the port's cost-model
    table when one is committed, else push-relabel), each with its
    certificates; Sinkhorn plans' marginals exact to f32. At n = 512
    (``guaranteed=True``): Sinkhorn and hybrid within their bound of
    scipy's LP optimum."""
    from repro_torch.core.api import OT, DispatchPolicy, solve
    from repro_torch.portfolio import get_model, sinkhorn_spec

    ok = True
    (n, eps, _), (c, nu, mu), _, pr_wall = ctx["ot"][0]
    runs = [("sinkhorn", "sinkhorn", False), ("sinkhorn_fused", "sinkhorn",
                                               True),
            ("hybrid", "hybrid", False), ("auto", "auto", False)]
    model = get_model()
    log(f"[7] cost model: "
        + ("none committed: auto falls back to push-relabel"
           if model is None else f"{model.mode} table, {model.backend}"))
    for route, solver, fused in runs:
        ops.reset_launches()
        rdev.reset_sync_counts()
        sinkhorn_spec.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sol = solve(OT, [(c, nu, mu)], eps,
                    DispatchPolicy(solver=solver, fused=fused),
                    want=("cost", "duals", "plan_sparse", "stats"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches[route] = dict(ops.launches)
        f_updates = sinkhorn_spec.counts["f_updates"]
        ran = sol.stats.solver
        cert_ok, cert = _portfolio_certificates(sol, nu, mu,
                                                ran == "sinkhorn")
        kernel = launches[route]["sinkhorn_row_update"]
        if fused:
            # one launch per f-update, at least one per iteration run
            route_ok = kernel == f_updates >= sol.phases > 0
        else:
            route_ok = kernel == 0
        if solver == "auto":
            route_ok &= ran == ("pushrelabel" if model is None else
                                model.choose(n, eps)[0])
        res = {"n": n, "eps": eps, "route": route, **cert, "wall_s": wall,
               "f_updates": f_updates, "syncs": dict(rdev.sync_counts),
               "launches": launches[route],
               "pushrelabel_stepped_wall_s": pr_wall, "route_ok": route_ok}
        log(f"[7] portfolio {json.dumps(res, default=float)}")
        record["phases"].setdefault("portfolio", []).append(res)
        ok &= cert_ok and route_ok

    (n, eps, exact), (c, nu, mu), _, pr_wall = ctx["ot"][1]
    opt = ctx["exact_ot"][n]
    for solver in ("sinkhorn", "hybrid"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sol = solve(OT, [(c, nu, mu)], eps,
                    DispatchPolicy(solver=solver, guaranteed=exact),
                    want=("cost", "duals", "plan_sparse", "stats"),
                    device=dev)[0]
        sol.cost
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        cert_ok, cert = _portfolio_certificates(sol, nu, mu,
                                                solver == "sinkhorn")
        bound = cert["additive_gap_bound"]
        exact_ok = bool(opt - 1e-6 <= sol.cost <= opt + bound + 1e-6)
        res = {"n": n, "eps": eps, "guaranteed": exact, **cert,
               "exact_cost": opt, "within_bound_of_exact": exact_ok,
               "wall_s": wall, "pushrelabel_stepped_wall_s": pr_wall}
        log(f"[7] portfolio exact {json.dumps(res, default=float)}")
        record["phases"].setdefault("portfolio_exact", []).append(res)
        ok &= cert_ok and exact_ok
    return ok


def phase_portfolio_card_vs_cpu(torch, dev, record, ctx) -> bool:
    """Phase 5's ragged OT batch on the card and on the CPU.

    Sinkhorn (compact and lockstep): the card's exp, logsumexp and sums
    run in another order than the CPU's over a few hundred iterations,
    which the contraction of the iteration keeps small. Held: iteration
    counts equal or one apart (a lane whose error crossed tol within f32
    noise), and where equal, costs within rtol 1e-4 and duals within rtol
    1e-4, atol 1e-5 * max|y| of the CPU's.

    Hybrid, per instance: the warm duals come from the float stage 1, so
    the two devices' differ where a potential sits on a rounding boundary.
    The finish is given the card's warm duals on both devices and its
    integer state must be equal; the card's hybrid solve must equal that
    finish. The default policy's gap is held to twice the bound, as in
    phase 3 (only ``guaranteed=True`` promises the bound itself)."""
    from repro_torch.core.api import OT, DispatchPolicy, solve
    from repro_torch.portfolio.hybrid import WARM_OT, warm_duals

    ok = True
    _, eps, insts_dev, _ = ctx["ragged"]["ot"]
    insts_cpu = [(c.cpu(), nu, mu) for c, nu, mu in insts_dev]
    for mode in ("compact", "lockstep"):
        policy = DispatchPolicy(mode=mode, solver="sinkhorn")
        want = ("cost", "duals")
        t0 = time.monotonic()
        on_card = solve(OT, insts_dev, eps, policy, want=want, device=dev)
        t1 = time.monotonic()
        on_cpu = solve(OT, insts_cpu, eps, policy, want=want, device="cpu")
        t2 = time.monotonic()
        good, worst = True, {"cost_rel": 0.0, "dual_abs": 0.0}
        phases = []
        for a, b in zip(on_card, on_cpu):
            phases.append((a.phases, b.phases))
            good &= abs(a.phases - b.phases) <= 1
            if a.phases != b.phases:
                continue
            rel = abs(a.cost - b.cost) / max(abs(b.cost), 1e-30)
            worst["cost_rel"] = max(worst["cost_rel"], rel)
            good &= rel <= 1e-4
            for x, y in zip(a.duals(), b.duals()):
                d = np.abs(x - y)
                worst["dual_abs"] = max(worst["dual_abs"], float(d.max()))
                good &= bool((d <= 1e-4 * np.abs(y) + 1e-5
                              * np.abs(y).max()).all())
        res = {"solver": "sinkhorn", "mode": mode, "eps": eps,
               "phases_card_cpu": phases, **worst, "ok": good,
               "card_s": t1 - t0, "cpu_s": t2 - t1}
        log(f"[7] card vs cpu {json.dumps(res, default=float)}")
        record["phases"].setdefault("portfolio_card_vs_cpu", []).append(res)
        ok &= good

    diffs, phases = [], []
    t0 = time.monotonic()
    for c, nu, mu in insts_dev:
        one = {"c": c[None], "nu": torch.as_tensor(nu, device=dev)[None],
               "mu": torch.as_tensor(mu, device=dev)[None]}
        sol = solve(OT, one, eps, DispatchPolicy(solver="hybrid"),
                    want=("cost", "duals", "state"), device=dev)[0]
        y_b0, _ = warm_duals(WARM_OT.canonicalize(one, dev), eps,
                             device=dev)
        card, cpu = (solve(WARM_OT, {k: v.to(where) for k, v in one.items()},
                           eps, DispatchPolicy(), want=("cost", "state"),
                           device=where, y_b0=y_b0.to(where))[0]
                     for where in (dev, torch.device("cpu")))
        diffs.append(_state_diff(card.state(), cpu.state())
                     + [f"hybrid:{f}" for f in _state_diff(sol.state(),
                                                           card.state())])
        phases.append(sol.phases)
        ok &= bool(sol.dual_feasible()
                   and sol.additive_gap() <= 2 * sol.additive_gap_bound())
    res = {"solver": "hybrid", "eps": eps, "state_differs": diffs,
           "phases": phases,
           "card_s": time.monotonic() - t0}
    log(f"[7] card vs cpu {json.dumps(res, default=float)}")
    record["phases"].setdefault("portfolio_card_vs_cpu", []).append(res)
    return ok and not any(diffs)


def _images(rng, n):
    """``n`` L1-normalized 784-pixel images (28 x 28, Fig. 2's shape):
    sparse non-negative intensities, most pixels dark."""
    x = rng.uniform(size=(n, 784)).astype(np.float32) ** 4
    x[rng.uniform(size=(n, 784)) < 0.8] = 0.0
    x[:, 0] += 1e-3                      # no all-dark image
    return x / x.sum(axis=1, keepdims=True)


def serving_requests(rng):
    """Phase 8 (a)'s requests: ``SIZES["serve"]["requests"]`` point
    clouds (d = 2, uniform in the unit square), m and n drawn from
    256-2048, every other one OT with Dirichlet(1) masses, eps from
    {0.05, 0.1}; request ``nan_at`` is a copy of the shapes of the one
    before it with a NaN point, so the two share a bucket."""
    cfg = SIZES["serve"]
    lo, hi = cfg["sizes"]
    out = []
    for i in range(cfg["requests"]):
        m, n = (int(v) for v in rng.integers(lo, hi + 1, size=2))
        if i == cfg["nan_at"]:
            m, n = out[-1][0].shape[0], out[-1][1].shape[0]
        x, y = _points(rng, m), _points(rng, n)
        nu = mu = None
        if i % 2:
            nu = rng.dirichlet(np.ones(m)).astype(np.float32)
            mu = rng.dirichlet(np.ones(n)).astype(np.float32)
        if i == cfg["nan_at"]:
            x[0, 0] = np.nan
        out.append((x, y, nu, mu, float(rng.choice(cfg["eps"]))))
    return out


class _RecordSolves:
    """Record every bucket ``core.api.solve`` call the services make
    (they import it at call time): ``(spec, inputs, eps, sizes, device,
    result)``, so each bucket can be solved again directly; and every
    ``ops.cost_matrix_batched`` launch of their collate: ``(x, y, metric,
    out)``, the padded points and the kernel's costs. Both hold their
    tensors on the card."""

    def __init__(self):
        self.calls, self.costs = [], []

    def __enter__(self):
        from repro_torch.core import api
        from repro_torch.kernels import ops

        self._api, self._solve = api, api.solve
        self._ops, self._cost = ops, ops.cost_matrix_batched

        def solve(spec, inputs, eps, policy=None, **kw):
            out = self._solve(spec, inputs, eps, policy, **kw)
            self.calls.append((spec, dict(inputs), eps, kw.get("sizes"),
                               kw.get("device"), out))
            return out

        def cost(x, y, metric="sqeuclidean"):
            out = self._cost(x, y, metric)
            self.costs.append((x, y, metric, out))
            return out

        api.solve, ops.cost_matrix_batched = solve, cost
        return self

    def __exit__(self, *exc):
        self._api.solve = self._solve
        self._ops.cost_matrix_batched = self._cost
        return False


def _bucket_costs_equal(torch, costs) -> tuple:
    """Each recorded collate launch of ``cost_matrix`` against the plain
    version on the same padded points, on the card, within
    ``tolerance(metric, d)`` (phase 2's); a NaN point must give NaN
    exactly where the plain version does. Returns (rows, all ok)."""
    from repro_torch.kernels.cost_matrix import cost_matrix_ref, tolerance

    rows, ok = [], True
    for x, y, metric, out in costs:
        ref = cost_matrix_ref(x, y, metric)
        rtol, atol = tolerance(metric, int(x.shape[-1]))
        nan_same = torch.equal(out.isnan(), ref.isnan())
        fin = ~ref.isnan()
        err = (out[fin] - ref[fin]).abs()
        good = bool(nan_same and (err <= atol + rtol * ref[fin].abs()).all())
        rows.append({"metric": metric, "shape": list(x.shape[:2])
                     + [int(y.shape[1]), int(x.shape[2])], "ok": good,
                     "max_abs_err": float(err.max()) if err.numel() else 0.0,
                     "rtol": rtol, "atol": atol})
        ok &= good
        del ref, err, fin
    return rows, ok


def _bucket_states_equal(torch, dev, calls) -> tuple:
    """Each recorded bucket's integer state against a direct ``solve()``
    of the same padded costs (the stepped compact policy): every lane on
    the card, and lane (k mod B) of bucket k on the CPU, so lanes past 0
    are covered too. Lanes never interact, so one lane alone at the
    bucket's padded shape is that lane of the bucket; the CPU's plain
    versions take seconds per lane at 2048^2, and all lanes of all
    buckets took over 800 s on the H100 machine's CPU. Returns
    (mismatches, seconds on the card, on the CPU)."""
    from repro_torch.core.api import DispatchPolicy, solve
    from repro_torch.core.problem import tree_map

    bad, secs = [], {"card": 0.0, "cpu": 0.0}
    for j, (spec, inputs, eps, sizes, _, batch) in enumerate(calls):
        b = int(inputs["c"].shape[0])
        eps = np.broadcast_to(np.asarray(eps, np.float64), (b,))
        for where, lanes in ((dev, slice(None)),
                             (torch.device("cpu"),
                              slice(j % b, j % b + 1))):
            t0 = time.monotonic()
            direct = solve(spec, {k: v[lanes].to(where)
                                  for k, v in inputs.items()},
                           eps[lanes], DispatchPolicy(mode="compact"),
                           sizes=None if sizes is None else sizes[lanes],
                           want=("state",), device=where)
            mine = tree_map(lambda a: a[lanes], batch.state())
            diff = _state_diff(mine, direct.state())
            secs["card" if where == dev else "cpu"] += (time.monotonic()
                                                        - t0)
            if diff:
                bad.append((spec.name, tuple(inputs["c"].shape),
                            str(where), lanes.start, diff))
    return bad, secs["card"], secs["cpu"]


def _latency_row(lat, wall, n_done):
    lat = np.sort(np.asarray(lat, np.float64))
    return {"p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)),
            "instances_per_s": n_done / wall, "wall_s": wall,
            "resolved": n_done}


def _run_scheduler(torch, dev, reqs, *, faults=None, sink=None,
                   deadline_req=None, record=True):
    """Submit ``reqs`` to one ``AsyncOTScheduler`` on ``dev`` and wait;
    then, alone in a second round, ``deadline_req`` with an expired
    budget. Returns (futures, latencies of the resolved ones, deadline
    future, wall seconds of the first round, stats, the
    ``_RecordSolves`` or None without ``record``)."""
    import contextlib

    from repro_torch.serve.scheduler import AsyncOTScheduler

    cfg = SIZES["serve"]
    done_t = {}
    rec = _RecordSolves() if record else contextlib.nullcontext()
    with rec, AsyncOTScheduler(
            eps=0.1, metric="euclidean", linger_ms=cfg["linger_ms"],
            validate=True, device=dev, faults=faults, join_timeout_s=30,
            sinks=() if sink is None else (sink,),
            retry_backoff_s=0.001) as sched:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        futs = []
        for i, (x, y, nu, mu, eps) in enumerate(reqs):
            f = sched.submit(x, y, nu, mu, eps=eps, want=cfg["want"])
            f.add_done_callback(
                lambda _f, i=i: done_t.__setitem__(i, time.monotonic()))
            futs.append((f, time.monotonic()))
        if not sched.flush(timeout=600):
            raise RuntimeError("the scheduler did not drain in 600 s")
        wall = time.monotonic() - t0
        lat = [done_t[i] - t for i, (f, t) in enumerate(futs)
               if f.exception(timeout=0) is None]
        dl = None
        if deadline_req is not None:
            x, y, nu, mu, eps = deadline_req
            dl = sched.submit(x, y, nu, mu, eps=eps,
                              want=("cost", "duals"), deadline=0.0)
            if not sched.flush(timeout=600):
                raise RuntimeError("the deadline request did not resolve")
        stats = sched.stats_dict()
        stats.pop("occupancy")          # long; dispatches says enough
    return ([f for f, _ in futs], lat, dl, wall, stats,
            rec if record else None)


def phase_serving(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The serving path on the card (see the module docstring, phase 8):
    (a) ``AsyncOTScheduler`` and (b) ``OTService.run_batch`` driven with
    the launch counts set to 0 just before and read just after; then (c)
    every bucket of both against the plain costs and a direct ``solve()``
    on the card and the CPU, and (d) (a)'s requests again, unrecorded,
    under a transient fault retried on the card."""
    from repro_torch.core.problem import tree_map
    from repro_torch.obs import InMemorySink
    from repro_torch.serve.engine import OTService
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    from repro_torch.serve.ft import RequestRejected

    cfg = SIZES["serve"]
    card = smi_line()           # beside every number of the phase
    rng = np.random.default_rng([ctx["seed"], 8])
    reqs = serving_requests(rng)
    m_dl, eps_dl = cfg["deadline"]
    deadline_req = (_points(rng, m_dl), _points(rng, m_dl), None, None,
                    eps_dl)
    n_lo, n_hi = cfg["images"]
    images = [(_images(rng, n), _images(rng, n))
              for n in rng.integers(n_lo, n_hi + 1, size=cfg["image_reqs"])]
    ok = True

    # -- (a) + (b), counted ---------------------------------------------
    sink = InMemorySink()
    ops.reset_launches()
    rdev.reset_sync_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    futs, lat, dl, wall, stats, rec = _run_scheduler(
        torch, dev, reqs, sink=sink, deadline_req=deadline_req)
    torch.cuda.synchronize()
    sched_launches = dict(ops.launches)
    svc = OTService(eps=cfg["image_eps"], metric="l1", device=dev,
                    want=("cost", "duals", "state"))
    for x, y in images:
        svc.submit(x, y)
    with _RecordSolves() as svc_rec:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sols_b = svc.run_batch()
        for s in sols_b:
            s.cost
        torch.cuda.synchronize()
        wall_b = time.monotonic() - t0
    launches["serve"] = dict(ops.launches)
    peak_recorded = torch.cuda.max_memory_allocated(dev)
    svc_launches = {k: launches["serve"][k] - sched_launches[k]
                    for k in sched_launches}
    syncs = dict(rdev.sync_counts)

    # (a)'s outcomes
    nan_at = cfg["nan_at"]
    sols, levels, degraded, modes = {}, [], 0, set()
    for i, f in enumerate(futs):
        exc = f.exception(timeout=0)
        if i == nan_at:
            ok &= isinstance(exc, RequestRejected) and exc.code == 1
            continue
        if exc is not None:
            log(f"[8] request {i} failed: {exc!r}")
            ok = False
            continue
        sols[i] = sol = f.result(timeout=0)
        levels.append(sol.stats.ladder_level)
        modes.add((sol.stats.mode, sol.stats.devices))
        degraded += int(sol.degraded)
        ok &= bool(np.isfinite(sol.cost) and sol.dual_feasible())
    # the NaN request's bucket went on without it
    rej = sink.events("rejected")
    kept = [s.get("kept") for s in sink.spans("collate")
            if len(rej) == 1 and s["trace_id"] == rej[0]["trace_id"]]
    dl_sol = dl.result(timeout=0)
    res_a = {
        "card": card, "requests": len(reqs),
        **_latency_row(lat, wall, len(sols)),
        "buckets": len(rec.calls), "stats": stats,
        "ladder_levels": sorted(set(levels)), "degraded": degraded,
        "modes": sorted(modes),
        "nan_request_rejected": isinstance(futs[nan_at].exception(0),
                                           RequestRejected),
        "nan_bucket_kept": kept,
        "deadline": {"degraded": dl_sol.degraded,
                     "dual_feasible": dl_sol.dual_feasible(),
                     "additive_gap": dl_sol.additive_gap(),
                     "dispatches": dl_sol.stats.dispatches},
        "launches": sched_launches}
    log(f"[8] (a) scheduler {json.dumps(res_a, default=float)}")
    # the scheduler's default policy is mesh mode, on a one-device mesh
    ok &= (modes == {("mesh", 1)} and set(levels) == {0} and degraded == 0
           and len(kept) == 1
           and kept[0] >= 1 and dl_sol.degraded
           and dl_sol.dual_feasible() and stats["rejected"] == 1
           and stats["degraded"] == 1 and stats["retries"] == 0)

    # (b)'s outcomes
    levels_b = {s.stats.ladder_level for s in sols_b}
    ok_b = (levels_b == {0} and not any(s.degraded for s in sols_b)
            and all(np.isfinite(s.cost) and s.dual_feasible()
                    for s in sols_b))
    res_b = {"card": card, "requests": len(images), "n": [int(x.shape[0])
                                           for x, _ in images],
             "wall_s": wall_b, "instances_per_s": len(sols_b) / wall_b,
             "buckets": len(svc_rec.calls), "ladder_levels":
             sorted(levels_b), "modes": sorted({s.stats.mode
                                                for s in sols_b}),
             "launches": svc_launches,
             "stats": svc.stats_dict()}
    log(f"[8] (b) service {json.dumps(res_b, default=float)}")
    ok &= ok_b
    # the services' default route on the card: the fused kernels
    for lc in (sched_launches, svc_launches):
        ok &= (lc["cost_matrix"] > 0 and lc["slack_propose"] == 0
               and lc["fused_assignment_phases"] + lc["fused_ot_phases"] > 0)
    # one cost launch per bucket (the deadline request's bucket too)
    ok &= sched_launches["cost_matrix"] == len(rec.costs) == len(rec.calls)
    ok &= svc_launches["cost_matrix"] == len(svc_rec.costs)

    # -- (c) every bucket: costs against the plain version, state against
    # direct solve on the card and the CPU -------------------------------
    t0 = time.monotonic()
    cost_rows, costs_ok = _bucket_costs_equal(torch,
                                              rec.costs + svc_rec.costs)
    torch.cuda.synchronize()
    cost_s = time.monotonic() - t0
    # the deadline request's bucket was cut: a direct solve runs on
    bad, card_s, cpu_s = _bucket_states_equal(
        torch, dev, rec.calls[:-1] + svc_rec.calls)
    res_c = {"card": card, "costs": cost_rows, "costs_ok": costs_ok,
             "cost_check_s": cost_s,
             "buckets": len(rec.calls) - 1 + len(svc_rec.calls),
             "mismatches": bad, "card_s": card_s, "cpu_lane_s": cpu_s,
             "wall_s": time.monotonic() - t0}
    log(f"[8] (c) buckets against plain costs and direct solve "
        f"{json.dumps(res_c)}")
    ok &= costs_ok and not bad

    # -- (d) (a) again with nothing recorded, a transient retried on the
    # card; its peak is the service's own --------------------------------
    states_a = {i: tree_map(lambda t: t.cpu(), sol.state())
                for i, sol in sols.items()}
    del futs, f, exc, sols, sol, dl, dl_sol, rec, svc_rec, sols_b, s, svc
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    inj = FaultInjector(FaultPlan(transient_dispatches=1))
    futs_d, lat_d, _, wall_d, stats_d, _ = _run_scheduler(
        torch, dev, reqs, faults=inj, record=False)
    torch.cuda.synchronize()
    peak_service = torch.cuda.max_memory_allocated(dev)
    same, levels_d, retried = True, set(), 0
    for i, f in enumerate(futs_d):
        exc = f.exception(timeout=0)
        if i == nan_at:
            same &= isinstance(exc, RequestRejected)
            continue
        if exc is not None:
            log(f"[8] (d) request {i} failed: {exc!r}")
            same = False
            continue
        sol = f.result(timeout=0)
        levels_d.add(sol.stats.ladder_level)
        retried += sol.stats.attempts == 2
        same &= not _state_diff(sol.state(), states_a[i])
    res_d = {"card": card, "log": inj.log, "ladder_levels":
             sorted(levels_d), "requests_retried_on_card": retried,
             "state_equal_to_a": bool(same), "stats": stats_d,
             **_latency_row(lat_d, wall_d, len(futs_d) - 1)}
    log(f"[8] (d) transient retried on the card "
        f"{json.dumps(res_d, default=float)}")
    ok &= bool(same and levels_d == {0} and retried > 0
               and stats_d["retries"] == 1
               and inj.log == [("transient", 0)])
    res_mem = {"card": card, "serve": launches["serve"], "syncs": syncs,
               "max_memory_allocated_recorded_a_b": peak_recorded,
               "max_memory_allocated_service_d": peak_service,
               "memory_allocated_before_d": held}
    log(f"[8] launches and memory {json.dumps(res_mem)}")
    record["phases"]["serving"] = {"a": res_a, "b": res_b, "c": res_c,
                                   "d": res_d, **res_mem}
    return ok



def _mesh_batch(torch, rng, dev, spec_name):
    """Phase 9's B instances of one problem on the card: Fig. 1 points
    (uniform in the unit square, euclidean) and, for OT, Dirichlet(1)
    masses. Returns (inputs dict, eps)."""
    from repro_torch.core.costs import build_cost_matrix

    cfg = SIZES["mesh"]
    b = cfg["batch"]
    n, eps = cfg[spec_name]
    x = np.stack([_points(rng, n) for _ in range(b)])
    y = np.stack([_points(rng, n) for _ in range(b)])
    inputs = {"c": build_cost_matrix(x, y, "euclidean", device=dev)}
    if spec_name == "ot":
        inputs["nu"] = torch.as_tensor(
            rng.dirichlet(np.ones(n), size=b).astype(np.float32), device=dev)
        inputs["mu"] = torch.as_tensor(
            rng.dirichlet(np.ones(n), size=b).astype(np.float32), device=dev)
    return inputs, eps


def _mesh_run(torch, ops, rdev, dev, spec, inputs, eps, policy, keep_state):
    """One counted ``solve`` (launch and sync counts from 0); returns
    (result, stats, wall seconds, launches, syncs)."""
    from repro_torch.core.api import solve

    torch.cuda.synchronize()
    ops.reset_launches()
    rdev.reset_sync_counts()
    t0 = time.monotonic()
    r, st = solve(spec, inputs, eps, policy, keep_state=keep_state,
                  device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return r, st, wall, dict(ops.launches), dict(rdev.sync_counts)


def phase_mesh(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """Multi-device dispatch on the card (see the module docstring, phase
    9). Logical shards of one card run on separate streams: they show the
    schedule, the bucket descent and the bit-identity, not a speed-up
    across cards."""
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy
    from repro_torch.launch.mesh import (largest_pow2_at_most,
                                         make_batch_mesh, make_small_mesh)

    cfg = SIZES["mesh"]
    card = smi_line()               # beside every number of the phase
    rng = np.random.default_rng([ctx["seed"], 9])
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[9] one card ({card}): only logical shards ran (D shards "
            f"on separate streams of cuda:0)")
    meshes = [("make_batch_mesh", make_batch_mesh())]
    meshes += [(f"logical{d}", make_small_mesh((d,), ("data",),
                                               devices=dev))
               for d in cfg["logical"]]
    grid = make_small_mesh(cfg["grid"], ("data", "model"), devices=dev)
    ok = True
    res = {"card": card, "cards": cards,
           "batch_mesh_devices": largest_pow2_at_most(cards), "batch": [],
           "matrix": []}
    mesh_launches = {k: 0 for k in ops.launches}
    for spec_name, spec in (("assignment", ASSIGNMENT), ("ot", OT)):
        inputs, eps = _mesh_batch(torch, rng, dev, spec_name)
        base, bst, wall, lc, sc = _mesh_run(
            torch, ops, rdev, dev, spec, inputs, eps,
            DispatchPolicy(mode="compact"), True)
        row = {"spec": spec_name, "placement": "compact", "devices": 1,
               "wall_s": wall, "chunk_syncs": sc["chunk"],
               "round_syncs": sc["round"], "dispatches": bst.dispatches,
               "slot_phases": bst.slot_phases,
               "phases": base.phases.tolist(), "launches": lc}
        log(f"[9] (a) {json.dumps(row, default=float)}")
        res["batch"].append(row)
        runs = [(name, mesh, False, None) for name, mesh in meshes]
        # fused: each shard run out in one launch, then the chunk loop
        # with lane retirement (chunk=8)
        runs += [("logical2", meshes[1][1], True, None),
                 ("logical2", meshes[1][1], True, 8)]
        for name, mesh, fused, chunk in runs:
            pol = DispatchPolicy(mode="mesh", mesh=mesh, placement="batch",
                                 fused=fused, chunk=chunk)
            r, st, wall, lc, sc = _mesh_run(torch, ops, rdev, dev, spec,
                                            inputs, eps, pol, True)
            diff = _state_diff(st.final_state, bst.final_state)
            kernel = ("fused_assignment_phases" if spec_name == "assignment"
                      else "fused_ot_phases") if fused else "slack_propose"
            row = {"spec": spec_name, "mesh": name, "fused": fused,
                   "chunk": st.chunk, "devices": st.devices,
                   "devices_per_dispatch": st.devices_per_dispatch,
                   "collapsed_at": st.collapsed_at,
                   "slot_phases": st.slot_phases,
                   "dispatches": st.dispatches,
                   "occupancy": st.occupancy,
                   "chunk_syncs": sc["chunk"], "round_syncs": sc["round"],
                   "wall_s": wall, "state_differs": diff,
                   "launches": lc, "card": card}
            log(f"[9] (a) {json.dumps(row, default=float)}")
            res["batch"].append(row)
            for k, v in lc.items():
                mesh_launches[k] += v
            ok &= (not diff and lc[kernel] > 0
                   and sc["chunk"] == st.dispatches
                   and torch.equal(r.phases, base.phases))
            if fused:
                # one fused launch per shard and dispatch
                ok &= lc[kernel] == sum(st.devices_per_dispatch)
            if chunk is not None and spec_name == "assignment":
                # the Fig. 1 lanes end ~30 chunks apart (the OT lanes
                # within one chunk): retirement must narrow the bucket
                ok &= min(bb for bb, _ in st.occupancy) < st.occupancy[0][0]
            del r, st
        # (b) matrix placement: lane 0 on the logical grid
        one = {k: v[:1] for k, v in inputs.items()}
        pol = DispatchPolicy(mode="mesh", mesh=grid, placement="matrix")
        keep = spec_name == "ot"
        r, st, wall, lc, sc = _mesh_run(torch, ops, rdev, dev, spec, one,
                                        eps, pol, keep)
        if spec_name == "ot":
            lane0 = type(bst.final_state)(*(a[:1]
                                            for a in bst.final_state))
            diff = _state_diff(r.state, lane0)
            err = float((r.plan[0] - base.plan[0]).abs().max())
            tol = 1e-6          # plan entries are masses of about 1/n
        else:
            diff = [f for f in ("matching", "phases", "rounds",
                                "matched_before_completion", "y_b", "y_a")
                    if not torch.equal(getattr(r, f)[:1],
                                       getattr(base, f)[:1])]
            err = float((r.y_b[0] - base.y_b[0]).abs().max())
            tol = 0.0           # duals of equal integer duals, same scale
        cost_err = abs(float(r.cost[0]) - float(base.cost[0]))
        cost_tol = 1e-5 * abs(float(base.cost[0]))
        row = {"spec": spec_name, "placement": "matrix",
               "grid": list(cfg["grid"]), "devices": st.devices,
               "phases": int(r.phases[0]), "rounds": int(r.rounds[0]),
               "wall_s": wall, "round_syncs": sc["round"],
               "state_differs": diff, "max_abs_err": err, "tol": tol,
               "cost_abs_err": cost_err, "cost_tol": cost_tol,
               "launches": lc, "card": card}
        log(f"[9] (b) {json.dumps(row, default=float)}")
        res["matrix"].append(row)
        for k, v in lc.items():
            mesh_launches[k] += v
        ok &= (not diff and err <= tol and cost_err <= cost_tol
               and lc["slack_propose"] > 0 and st.placement == "matrix"
               and st.devices == int(np.prod(cfg["grid"])))
        del r, st, base, bst, inputs, one
        gc.collect()
    launches["mesh"] = mesh_launches
    res["launches"] = mesh_launches
    record["phases"]["mesh"] = res
    return ok


def _sanitized(torch, ops, rdev, fn):
    """``fn()`` under ``set_debug_checks(True)``, with the launch and sync
    counts set to 0 just before and read just after: ``(fn(), launches,
    syncs)``."""
    from repro_torch.analysis import set_debug_checks

    set_debug_checks(True)
    try:
        ops.reset_launches()
        rdev.reset_sync_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(ops.launches), dict(rdev.sync_counts)
    finally:
        set_debug_checks(None)


def _raised(fn, exc_type):
    """The ``exc_type`` error ``fn()`` raised, or None when it returned."""
    try:
        fn()
    except exc_type as e:
        return e
    return None


def _audit_solves(torch, ops, rdev, dev, record, ctx, res) -> bool:
    """(a): phases 3 and 4's solves again under the checks, on the
    default policy and with ``fused=True``; every integer field and
    certificate equal to the plain solves of phases 3, 4 and 6."""
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve

    ok = True
    n_a, eps_a = SIZES["assignment"]
    c_a = ctx["assignment_c"]
    _, state3, _ = ctx["assignment"][0]       # the default policy's solve
    (n_o, eps_o, exact), (c_o, nu, mu), state4, _ = ctx["ot"][0]
    cells = [
        ("assignment", False, "assignment", state3,
         lambda pol: solve(ASSIGNMENT, {"c": c_a[None]}, eps_a, pol,
                           want=("cost", "duals", "matching", "state"),
                           device=dev)[0],
         lambda sol: _assignment_certificates(sol, n_a, False)),
        ("ot", exact, "ot", state4,
         lambda pol: solve(OT, [(c_o, nu, mu)], eps_o, pol,
                           want=("cost", "duals", "plan_sparse", "state"),
                           device=dev)[0],
         lambda sol: _ot_certificates(sol, n_o, nu)),
    ]
    for name, guaranteed, rec_name, state, run, certify in cells:
        for fused in (False, True):
            plain = record["phases"][("fused_" if fused else "")
                                     + rec_name][0]

            def timed():
                torch.cuda.synchronize()
                t0 = time.monotonic()
                sol = run(DispatchPolicy(guaranteed=guaranteed, fused=fused))
                sol.cost
                torch.cuda.synchronize()
                return sol, time.monotonic() - t0

            (sol, wall), lc, sc = _sanitized(torch, ops, rdev, timed)
            cert_ok, cert = certify(sol)
            d = cert["dispatches"]
            on_card = all(t.is_cuda for t in sol.state())
            diff = _state_diff(sol.state(), state)
            # phase 6's plain fused solves equal phase 3/4's; both held.
            # The checks chunk by 8, as phases 3-4 do; phase 6's fused
            # solves run out in one dispatch, so only phases 3-4 hold
            # the dispatch count
            cert_diff = sorted(
                k for k in cert
                for ref in (record["phases"][rec_name][0], plain)
                if cert[k] != ref[k]
                and not (k == "dispatches" and ref is plain and fused))
            fused_launches = (lc["fused_assignment_phases"]
                              + lc["fused_ot_phases"])
            row = {"problem": name, "fused": fused, "wall_s": wall,
                   "plain_wall_s": plain["wall_s"],
                   "dispatches": d, "debug_reads": sc["debug"],
                   "chunk_reads": sc["chunk"], "round_reads": sc["round"],
                   "state_differs": diff, "cert_differs": cert_diff,
                   "launches": lc, **cert}
            log(f"[10] (a) {json.dumps(row, default=float)}")
            res["solves"].append(row)
            ok &= bool(cert_ok and on_card and not diff and not cert_diff
                       and lc["slack_propose"] > 0 and fused_launches == 0
                       and lc["sinkhorn_row_update"] == 0
                       and sc["chunk"] == d and sc["debug"] == d + 2)
            del sol
    return ok


def _audit_nan(torch, ops, rdev, dev, ctx, res) -> bool:
    """(b): one NaN cost in lane 1 of an assignment and an OT batch,
    ``validate=False``: ``DebugCheckError`` with the checks (before any
    kernel launches), a returned solve without them."""
    from repro_torch.analysis import set_debug_checks
    from repro_torch.analysis.checked import DebugCheckError
    from repro_torch.core.api import ASSIGNMENT, OT, DispatchPolicy, solve

    b, n, eps = SIZES["audit"]["nan"]
    gen = torch.Generator(device=dev).manual_seed(ctx["seed"])
    ok = True
    for name, spec in (("assignment", ASSIGNMENT), ("ot", OT)):
        c = torch.rand((b, n, n), device=dev, generator=gen)
        c[1, 5, 7] = float("nan")
        inputs = {"c": c}
        if name == "ot":
            inputs["nu"] = torch.full((b, n), 1.0 / n, device=dev)
            inputs["mu"] = torch.full((b, n), 1.0 / n, device=dev)
        pol = DispatchPolicy(validate=False)

        def run():
            return solve(spec, inputs, eps, pol, want=("cost",),
                         device=dev)

        err, lc, sc = _sanitized(
            torch, ops, rdev, lambda: _raised(run, DebugCheckError))
        set_debug_checks(False)
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            costs = run().cost()
            wall = time.monotonic() - t0
        finally:
            set_debug_checks(None)
        row = {"problem": name, "shape": [b, n, n],
               "raised": None if err is None else str(err),
               "check": getattr(err, "check", None),
               "lane": getattr(err, "lane", None),
               "launches_before_raise": lc, "debug_reads": sc["debug"],
               "plain_returned": list(costs.shape), "plain_wall_s": wall,
               "plain_cost_lane1_finite": bool(np.isfinite(costs[1]))}
        log(f"[10] (b) {json.dumps(row, default=float)}")
        res["nan"].append(row)
        ok &= bool(err is not None and "nan" in str(err) and err.lane == 1
                   and sum(lc.values()) == 0 and costs.shape == (b,))
        del c, inputs
    return ok


def _audit_corrupt(torch, ops, dev, ctx, res) -> bool:
    """(c): chunks on the card from corrupted states raise the
    reference's messages before any kernel launches; the clean state
    runs and launches ``slack_propose``."""
    from repro_torch.analysis.checked import DebugCheckError, checked_spec_fns
    from repro_torch.core.api import ASSIGNMENT, OT

    b, n = SIZES["audit"]["corrupt"]
    rng = np.random.default_rng([ctx["seed"], 10])
    c = rng.random((b, n, n)).astype(np.float32)
    ok = True
    for spec, field, value, match in (
            (ASSIGNMENT, "match_ba", 99, "matching index out of range"),
            (OT, "free_b", -5, "negative free mass")):
        inputs = {"c": c}
        if spec is OT:
            inputs["nu"] = np.full((b, n), 1.0 / n, np.float32)
            inputs["mu"] = np.full((b, n), 1.0 / n, np.float32)
        p = spec.prepare(spec.canonicalize(inputs, dev), 0.1)
        prologue, init, chunk, _, _ = checked_spec_fns(spec, 2)
        data, ctx_ = prologue(p.ops)
        state = init(data, ctx_)
        bad = state._replace(**{field: torch.full_like(getattr(state, field),
                                                       value)})
        ops.reset_launches()
        err = _raised(lambda: chunk(data, bad), DebugCheckError)
        launched = dict(ops.launches)
        out = chunk(data, state)
        torch.cuda.synchronize()
        row = {"problem": spec.name, "corrupted": {field: value},
               "raised": None if err is None else str(err),
               "launches_before_raise": launched,
               "clean_chunk_launches": dict(ops.launches),
               "clean_phases": out.phases.tolist()}
        log(f"[10] (c) {json.dumps(row)}")
        res["corrupt"].append(row)
        ok &= bool(err is not None and match in str(err)
                   and sum(launched.values()) == 0 and out.phases.is_cuda
                   and ops.launches["slack_propose"] > 0)
    return ok


def _audit_scheduler(torch, ops, rdev, dev, ctx, res) -> bool:
    """(d): the scheduler quarantines the request that trips the checks;
    the other seven solve at ladder level 0."""
    from repro_torch.core.api import DispatchPolicy
    from repro_torch.serve.ft import RequestRejected
    from repro_torch.serve.scheduler import AsyncOTScheduler

    cfg = SIZES["audit"]
    rng = np.random.default_rng([ctx["seed"], 11])
    lo, hi = cfg["sizes"]
    reqs = []
    for i in range(cfg["requests"]):
        m, n = (int(v) for v in rng.integers(lo, hi + 1, size=2))
        x, y = _points(rng, m), _points(rng, n)
        nu = mu = None
        if i % 2:
            nu = rng.dirichlet(np.ones(m)).astype(np.float32)
            mu = rng.dirichlet(np.ones(n)).astype(np.float32)
        if i == cfg["nan_at"]:
            x[0, 0] = np.nan
        reqs.append((x, y, nu, mu))

    def run():
        with AsyncOTScheduler(
                eps=cfg["eps"], metric="euclidean", linger_ms=20.0,
                validate=False, device=dev, join_timeout_s=30,
                policy=DispatchPolicy(mode="compact"),
                retry_backoff_s=0.001) as sched:
            t0 = time.monotonic()
            futs = [sched.submit(x, y, nu, mu, want=("cost", "duals"))
                    for x, y, nu, mu in reqs]
            if not sched.flush(timeout=600):
                raise RuntimeError("the scheduler did not drain in 600 s")
            return futs, time.monotonic() - t0, sched.stats_dict()

    (futs, wall, stats), lc, sc = _sanitized(torch, ops, rdev, run)
    ok = True
    levels, rejected = [], None
    for i, f in enumerate(futs):
        exc = f.exception(timeout=0)
        if i == cfg["nan_at"]:
            rejected = None if exc is None else str(exc)
            ok &= isinstance(exc, RequestRejected)
            continue
        if exc is not None:
            log(f"[10] (d) request {i} failed: {exc!r}")
            ok = False
            continue
        sol = f.result(timeout=0)
        levels.append(sol.stats.ladder_level)
        ok &= bool(np.isfinite(sol.cost) and sol.dual_feasible()
                   and not sol.degraded)
    stats.pop("occupancy")
    row = {"requests": len(reqs), "wall_s": wall, "rejected": rejected,
           "ladder_levels": levels, "stats": stats, "launches": lc,
           "syncs": sc}
    log(f"[10] (d) {json.dumps(row, default=float)}")
    res["scheduler"] = row
    return bool(ok and levels == [0] * (len(reqs) - 1)
                and stats["quarantined"] == 1 and lc["cost_matrix"] > 0
                and lc["slack_propose"] > 0 and sc["debug"] > 0)


def phase_audit(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The audit layer on the card (see the module docstring, phase 10):
    (a) the sanitized solves, (b) NaN batches, (c) corrupted chunks, (d)
    the scheduler's quarantine, (e) ``python -m repro_torch.analysis
    --strict`` in a child process. Every kernel is loaded before it
    starts, and none may be built or loaded anew during it."""
    libs = dict(ops._libs)
    res = {"card": smi_line(), "solves": [], "nan": [], "corrupt": []}
    record["phases"]["audit"] = res
    ok = _audit_solves(torch, ops, rdev, dev, record, ctx, res)
    launches["audit"] = {k: sum(r["launches"][k] for r in res["solves"])
                         for k in ops.launches}
    ok &= _audit_nan(torch, ops, rdev, dev, ctx, res)
    ok &= _audit_corrupt(torch, ops, dev, ctx, res)
    ok &= _audit_scheduler(torch, ops, rdev, dev, ctx, res)

    # (e) the static and dynamic passes, as a user runs them
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    env.pop("REPRO_DEBUG_CHECKS", None)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    cli = {"returncode": out.returncode, "s": time.monotonic() - t0,
           "stdout": out.stdout.splitlines(),
           "stderr": out.stderr.splitlines()[-20:]}
    for line in cli["stdout"]:
        log(f"[10] (e) {line}")
    res["cli"] = cli
    rebuilt = (ops.build_kernels() != 0.0 or ops._libs.keys() != libs.keys()
               or any(ops._libs[k] is not v for k, v in libs.items()))
    res["kernels_rebuilt"] = rebuilt
    log(f"[10] (e) analysis --strict rc {out.returncode} in {cli['s']:.1f} "
        f"s; kernels rebuilt in this phase: {rebuilt}")
    ok &= bool(out.returncode == 0
               and "no unsuppressed findings" in out.stdout
               and "no kernel rebuilt" in out.stdout and not rebuilt)
    return ok


# -- phase 11: the model-serving path ------------------------------------

def _record_calls(torch, mod, names):
    """Wrap ``mod.<name>`` for each name so every call is synchronized and
    timed on the host clock; returns (calls {name: [seconds]}, restore)."""
    calls = {n: [] for n in names}
    orig = {n: getattr(mod, n) for n in names}

    def wrap(n):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[n](*a, **kw)
            torch.cuda.synchronize()
            calls[n].append(time.perf_counter() - t0)
            return out
        return timed
    for n in names:
        setattr(mod, n, wrap(n))

    def restore():
        for n in names:
            setattr(mod, n, orig[n])
    return calls, restore


def _tap_router(moe, keep):
    """Record ``moe.pushrelabel_assign``'s calls whose token count is in
    ``keep`` (first call of each): {T: (affinity, k, capacity, flow,
    keyword arguments)}.
    Returns (taps, restore); the tap launches nothing of its own."""
    taps = {}
    orig = moe.pushrelabel_assign

    def tapped(affinity, k, capacity, **kw):
        flow = orig(affinity, k, capacity, **kw)
        t = affinity.shape[0]
        if t in keep and t not in taps:
            taps[t] = (affinity.clone(), k, capacity, flow.clone(), kw)
        return flow
    moe.pushrelabel_assign = tapped

    def restore():
        moe.pushrelabel_assign = orig
    return taps, restore


def _model_requests(rng, cfg, spec):
    """Phase 11's requests: (prompt, max_new_tokens) for each prompt
    length, one of them with max_new_tokens = 0."""
    out = []
    for i, n in enumerate(spec["prompts"]):
        new = 0 if i == spec["zero_new_at"] else spec["new_tokens"]
        out.append((rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                    new))
    return out


def _serve_once(torch, ops, rdev, engine, Request, reqs, eos, moe_layers,
                tap_keep=()):
    """One counted ``Engine.run_batch``: launches and syncs from 0, the
    model's prefill and decode calls timed, the router's calls tapped."""
    from repro_torch.models import model as M
    from repro_torch.models import moe

    for (prompt, new), e in zip(reqs, eos):
        engine.submit(Request(prompt=prompt, max_new_tokens=new, eos_id=e))
    calls, restore = _record_calls(torch, M, ("prefill", "decode_step"))
    taps, untap = _tap_router(moe, set(tap_keep))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rdev.reset_sync_counts()
    t0 = time.perf_counter()
    try:
        comps = engine.run_batch()
        torch.cuda.synchronize()
    finally:
        restore()
        untap()
    wall = time.perf_counter() - t0
    launched = dict(ops.launches)
    passes = len(calls["prefill"]) + len(calls["decode_step"])
    dec = calls["decode_step"]
    n_tok = sum(c.decode_steps for c in comps)
    run = {
        "wall_s": wall, "prefill_s": calls["prefill"][0],
        "decode_steps": len(dec),
        "decode_ms_per_step": 1e3 * float(np.median(dec)) if dec else None,
        "decode_s": float(sum(dec)), "tokens": n_tok,
        "tokens_per_s": n_tok / wall,
        "forward_passes": passes, "launches": launched,
        "syncs": dict(rdev.sync_counts),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "completions": [{"prefill_len": c.prefill_len,
                         "decode_steps": c.decode_steps,
                         "latency_s": c.latency_s,
                         "tokens": c.tokens.tolist()} for c in comps],
        "moe_layers": moe_layers,
    }
    return run, comps, taps


def _check_accounting(reqs, eos, comps, plen) -> list:
    """The reference's per-sequence accounting, from the tokens: each
    completion ends at its first eos or at max_new_tokens."""
    bad = []
    for i, ((prompt, new), e, c) in enumerate(zip(reqs, eos, comps)):
        toks = list(c.tokens)
        want = max(new, 0)
        if e is not None and e in toks:
            want = min(want, toks.index(e) + 1)
        ok = (c.prefill_len == plen and c.decode_steps == len(toks) == want
              and (e is None or e not in toks[:-1]) and c.latency_s > 0)
        if not ok:
            bad.append(i)
    return bad


def _router_flows_equal(torch, moe, taps) -> dict:
    """Each tapped router call's flow on the card against the plain
    version on the CPU, on the same affinity."""
    out = {}
    for t, (aff, k, capacity, flow, kw) in sorted(taps.items()):
        ref = moe.pushrelabel_assign(aff.cpu(), k, capacity, **kw)
        out[t] = {"shape": list(aff.shape), "k": k, "capacity": capacity,
                  "equal": bool(torch.equal(flow.cpu(), ref)),
                  "units": int(flow.sum())}
    return out


def _decode_matches_prefill(torch, M, params, cfg, prompt, dev,
                            tol=None):
    """Max |logit difference| between the prefill of ``prompt`` and the
    decode of its last token after prefilling the rest (B = 1); ok within
    ``tol`` (the reference's bf16 tolerance, rtol = atol = 0.15, by
    default)."""
    from repro_torch.models import moe

    tol = tol or {"rtol": 0.15, "atol": 0.15}
    toks = torch.as_tensor(prompt[None], device=dev)
    # the last token's top-k experts in each MoE layer, in the prefill of
    # all tokens and in the decode step
    picks = {"prefill": [], "decode": []}
    orig = moe.route_topk

    def tapped(logits, k, norm=True):
        sel, gates = orig(logits, k, norm)
        if logits.shape[0] in (1, len(prompt)):
            picks["decode" if logits.shape[0] == 1 else "prefill"].append(
                sorted(sel[-1].tolist()))
        return sel, gates
    moe.route_topk = tapped
    try:
        with torch.inference_mode():
            _, full = M.prefill(params, cfg, {"tokens": toks})
            caches, _ = M.prefill(params, cfg, {"tokens": toks[:, :-1]})
            caches = M.pad_caches(cfg, caches, toks.shape[1] + 1)
            step, _ = M.decode_step(params, cfg, caches, toks[:, -1:],
                                    toks.shape[1] - 1)
    finally:
        moe.route_topk = orig
    full, step = full.float(), step.float()
    err = float((full - step).abs().max())
    ok = bool(torch.allclose(full, step, **tol))
    flips = [i for i, (a, b) in enumerate(zip(picks["prefill"],
                                               picks["decode"])) if a != b]
    return {"max_abs_diff": err, "ok": ok, "tol": tol,
            "moe_layers_routed_otherwise": flips}


def _decode_vs_prefill_f32(torch, M, cfg, prompt, seed, dev):
    """Decode against prefill in float32 compute at full width, depth cut
    to the dense layer and ``SIZES["models"]["f32_moe_layers"]`` MoE
    layers (float32 weights of the whole model would not fit beside the
    bf16 ones), with nothing dropped: the cache path without bf16
    rounding, whose differences at full depth move the routers."""
    spec = SIZES["models"]
    cut = cfg.with_(num_layers=cfg.first_dense_layers
                    + spec["f32_moe_layers"],
                    capacity_factor=float(cfg.num_experts))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    saved = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    try:
        params = M.init_params(cut, gen, device=dev, dtype=torch.float32)
        out = _decode_matches_prefill(torch, M, params, cut, prompt, dev,
                                      tol=spec["f32_tol"])
    finally:
        M.COMPUTE_DTYPE = saved
    out["num_layers"] = cut.num_layers
    return out


def _left_padded(torch, reqs, dev):
    """The requests' prompts left-padded with 0 to the longest, as
    ``Engine.run_batch`` pads them: (B, plen) int32 on ``dev``."""
    plen = max(len(p) for p, _ in reqs)
    toks = np.zeros((len(reqs), plen), np.int32)
    for i, (p, _) in enumerate(reqs):
        toks[i, plen - len(p):] = p
    return torch.as_tensor(toks, device=dev)


def _profile_decode(torch, M, engine, reqs, top: int = 8):
    """One decode step of the Engine's batch under ``torch.profiler``:
    device time by kernel (the ``top`` largest), their sum against the
    step's wall time (the busy share)."""
    cfg, dev = engine.cfg, engine.device
    toks = _left_padded(torch, reqs, dev)
    plen = toks.shape[1]
    with torch.inference_mode():
        caches, logits = M.prefill(engine.params, cfg, {"tokens": toks})
        caches = M.pad_caches(cfg, caches, engine.max_len)
        cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
        M.decode_step(engine.params, cfg, caches, cur, plen)   # warm
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            M.decode_step(engine.params, cfg, caches, cur, plen + 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return _profile_summary(prof, wall, top)


def _profile_summary(prof, wall: float, top: int) -> dict:
    """A profile's kernels against the wall seconds it covered: their
    summed device time, the busy share, launches, the ``top`` largest."""
    kern = sorted(((device_us(e), e.key, e.count)
                   for e in prof.key_averages() if device_us(e) > 0),
                  reverse=True)
    busy = sum(us for us, _, _ in kern) / 1e3
    return {"wall_ms": 1e3 * wall, "kernels_ms": busy,
            "busy_share": busy / (1e3 * wall),
            "kernel_launches": sum(c for _, _, c in kern),
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": c}
                    for us, k, c in kern[:top]]}


def _router_times(torch, moe, taps):
    """Device time of each router per layer on the tapped inputs (the
    logits of one MoE layer), ``cuda_ms``: the whole ``pushrelabel``
    router, its ``pushrelabel_assign`` alone, and ``topk``."""
    out = {}
    for t, (aff, k, capacity, _, kw) in sorted(taps.items()):
        out[t] = {
            "pushrelabel_ms": cuda_ms(
                torch, lambda: moe.route_pushrelabel(aff, k), reps=10),
            "pushrelabel_assign_ms": cuda_ms(
                torch, lambda: moe.pushrelabel_assign(aff, k, capacity,
                                                      **kw), reps=10),
            "topk_ms": cuda_ms(torch, lambda: moe.route_topk(aff, k),
                               reps=10),
        }
    return out


def _router_rows(torch, ops, moe, taps, launches_engine):
    """``fused_ot_phases`` at the router's shapes (phase 11 (d)): one
    launch of 24 phases of at most 8 rounds from the router's start
    state, against the plain version and the stepped core."""
    rows = []
    for t, (aff, k, capacity, _, kw) in sorted(taps.items()):
        e = aff.shape[1]
        phases = 24
        c_int = moe.router_costs(aff)[None].contiguous()
        s0 = moe.router_state(t, e, k, capacity, aff.device)
        thr = torch.full((1,), -1, dtype=torch.int32, device=aff.device)
        cap = torch.full((1,), phases, dtype=torch.int32, device=aff.device)
        row = _ot_row(torch, ops, c_int, s0, thr, cap, 8, phases)
        row.update(router_tokens=t, capacity=capacity,
                   engine_launches=launches_engine)
        rows.append(row)
    return rows


def _card_vs_cpu_model(torch, M, moe, cfg, seed, dev):
    """Phase 11 (e): one reduced model, float32 compute, card against
    CPU: prefill and two decode steps (teacher-forced with the CPU's
    argmax); the router's flows on the card against the plain version."""
    from repro_torch.models.model import COMPUTE_DTYPE

    tol = SIZES["models"]["card_vs_cpu_tol"]
    rng = np.random.default_rng([seed, 11])
    p_cpu = M.init_params(cfg, seed=seed, device="cpu")
    p_dev = M.cast_params(p_cpu, dev)          # float32: moved, not cast
    toks = rng.integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    res, diffs = {"arch": cfg.name, "router": cfg.router}, []
    taps, untap = _tap_router(moe, {48, 2})
    try:
        outs = {}
        for where, p, d in (("cpu", p_cpu, torch.device("cpu")),
                            ("card", p_dev, dev)):
            tk = torch.as_tensor(toks, device=d)
            caches, lg = M.prefill(p, cfg, {"tokens": tk})
            caches = M.pad_caches(cfg, caches, 32)
            got = [lg.float().cpu()]
            for i in range(2):
                src = outs["cpu"][i] if where == "card" else got[i]
                nxt = src.argmax(-1)[:, None].to(torch.int32).to(d)
                lg, caches = M.decode_step(p, cfg, caches, nxt, 24 + i)
                got.append(lg.float().cpu())
            outs[where] = got
            if where == "cpu":
                taps.clear()
    finally:
        untap()
    for a, b in zip(outs["card"], outs["cpu"]):
        diffs.append(float((a - b).abs().max()))
    res["max_abs_diff"] = diffs
    res["logits_ok"] = all(torch.allclose(a, b, **tol)
                           for a, b in zip(outs["card"], outs["cpu"]))
    res["flows"] = _router_flows_equal(torch, moe, taps)
    res["ok"] = res["logits_ok"] and all(
        f["equal"] for f in res["flows"].values())
    res["compute_dtype"] = str(COMPUTE_DTYPE)
    return res


def phase_models(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The model-serving path (see the module docstring, phase 11)."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve.engine import Engine, Request

    spec = SIZES["models"]
    res = {"card": smi_line()}
    record["phases"]["models"] = res
    for key in [k for k in ctx if k != "seed"]:
        del ctx[key]
    gc.collect()
    torch.cuda.empty_cache()
    res["memory_before"] = torch.cuda.memory_allocated()

    # (a) the model at full width, bf16, on the card
    cfg = ARCHS[spec["arch"]]
    if spec.get("reduce"):
        cfg = reduced(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx["seed"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    leaves = M.leaves(params)
    res["build"] = {
        "s": time.perf_counter() - t0,
        "parameters": sum(t.numel() for t in leaves),
        "bytes": sum(t.numel() * t.element_size() for t in leaves),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "dtypes": sorted({str(t.dtype) for t in leaves})}
    log(f"[11] (a) {cfg.name}: {res['build']['parameters']:,} parameters, "
        f"{res['build']['bytes'] / 1e9:.2f} GB, built in "
        f"{res['build']['s']:.1f} s, peak "
        f"{res['build']['max_memory_allocated'] / 1e9:.2f} GB")
    ok = res["build"]["dtypes"] == ["torch.bfloat16"]
    n_moe = cfg.num_layers - cfg.first_dense_layers
    rng = np.random.default_rng([ctx["seed"], 11])
    reqs = _model_requests(rng, cfg, spec)
    plen = max(len(p) for p, _ in reqs)
    t_tok = len(reqs) * plen
    no_eos = [None] * len(reqs)

    # (b), (c): each router, a warm-up run, then the counted run
    engines = {}
    for router in ("topk", "pushrelabel"):
        rcfg = cfg.with_(router=router)
        engine = Engine(rcfg, params, max_len=spec["max_len"], device=dev)
        # the bf16 weights on the card are served as they are, not copied
        shared = all(a is b for a, b in zip(M.leaves(engine.params), leaves))
        warm, warm_c, _ = _serve_once(torch, ops, rdev, engine, Request,
                                      reqs, no_eos, n_moe)
        eos_at = spec["eos_at"]
        eos = list(no_eos)
        eos[eos_at[0]] = int(warm_c[eos_at[0]].tokens[eos_at[1]])
        run, comps, taps = _serve_once(
            torch, ops, rdev, engine, Request, reqs, eos, n_moe,
            tap_keep=(t_tok, len(reqs)) if router == "pushrelabel" else ())
        run["warm_up_wall_s"] = warm["wall_s"]
        run["eos"] = eos
        bad = _check_accounting(reqs, eos, comps, plen)
        # deterministic: the requests without eos decode as in the warm-up
        same = all(list(c.tokens) == list(w.tokens)
                   for i, (c, w) in enumerate(zip(comps, warm_c))
                   if eos[i] is None)
        run["accounting_bad"] = bad
        run["same_tokens_as_warm_up"] = same
        run["weights_shared"] = shared
        ok_r = shared and not bad and all(
            ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()
            for c in comps)
        n_ot = run["launches"]["fused_ot_phases"]
        if router == "pushrelabel":
            want = n_moe * run["forward_passes"]
            run["fused_ot_per_pass"] = n_ot / run["forward_passes"]
            flows = _router_flows_equal(torch, moe, taps)
            run["router_flows"] = flows
            run["router_ms"] = _router_times(torch, moe, taps)
            ok_r &= (n_ot == want and sum(run["syncs"].values()) == 0
                     and len(flows) == 2
                     and all(f["equal"] for f in flows.values()))
            launches["engine"] = run["launches"]
            res["router_rows"] = _router_rows(torch, ops, moe, taps, n_ot)
            ok_r &= all(r["ok"] for r in res["router_rows"])
            del taps
        else:
            ok_r &= n_ot == 0
            # decode through the caches against prefill, B = 1 on the
            # longest prompt: in bf16 at full depth as published and with
            # nothing dropped (capacity_factor = E), reported; in float32
            # on the depth-cut model with nothing dropped, checked (see
            # _decode_vs_prefill_f32)
            long = reqs[int(np.argmax([len(p) for p, _ in reqs]))][0]
            run["decode_vs_prefill"] = {
                "bf16_published": _decode_matches_prefill(
                    torch, M, engine.params, rcfg, long, dev),
                "bf16_no_drops": _decode_matches_prefill(
                    torch, M, engine.params, rcfg.with_(
                        capacity_factor=float(cfg.num_experts)), long, dev),
                "f32_no_drops": _decode_vs_prefill_f32(
                    torch, M, rcfg, long, ctx["seed"], dev)}
            ok_r &= run["decode_vs_prefill"]["f32_no_drops"]["ok"]
        run["ok"] = bool(ok_r)
        res[router] = run
        show = {k: v for k, v in run.items()
                if k not in ("completions", "router_ms")}
        log(f"[11] ({'b' if router == 'topk' else 'c'}) {router}: "
            f"{json.dumps(show, default=str)}")
        log(f"[11]     decode_steps "
            f"{[c.decode_steps for c in comps]}, latency_s "
            f"{[round(c.latency_s, 4) for c in comps]}")
        if router == "pushrelabel":
            log(f"[11]     router ms per layer {json.dumps(run['router_ms'])}")
            for row in res["router_rows"]:
                log(f"[11] (d) {json.dumps(row)}")
        ok &= ok_r
        engines[router] = engine
        del engine, comps, warm_c
        gc.collect()
    # one decode step of each router under the profiler, after every
    # timed row
    for router, engine in engines.items():
        res[router]["decode_profile"] = prof = _profile_decode(
            torch, M, engine, reqs)
        log(f"[11] {router} decode step profiled: {json.dumps(prof)}")
    del params, leaves, gen, engines
    gc.collect()
    torch.cuda.empty_cache()

    # (e) reduced models, card against CPU, float32 compute
    res["card_vs_cpu"] = []
    saved = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    try:
        for arch, router in spec["card_vs_cpu"]:
            rc = reduced(ARCHS[arch])
            if router:
                rc = rc.with_(router=router)
            r = _card_vs_cpu_model(torch, M, moe, rc, ctx["seed"], dev)
            log(f"[11] (e) {json.dumps(r)}")
            res["card_vs_cpu"].append(r)
            ok &= r["ok"]
    finally:
        M.COMPUTE_DTYPE = saved
    return bool(ok)


def _train_batch(torch, cfg, spec, seed, step, dev):
    """The pipeline's batch of ``step`` on ``dev``."""
    from repro_torch.data.pipeline import synthetic_batch

    return {k: torch.as_tensor(v, device=dev) for k, v in synthetic_batch(
        cfg, spec["seq_len"], spec["batch"], seed=seed, step=step).items()}


def _run_steps(torch, step_fn, params, opt, cfg, spec, seed, steps, dev):
    """``step_fn`` on the pipeline's batches of the step numbers
    ``steps``: each step's metrics and seconds on the host clock from the
    call to the ``float(loss)`` read, as ``Trainer.run`` times a step
    (the read waits for the whole step, the optimizer included)."""
    out = []
    for s in steps:
        b = _train_batch(torch, cfg, spec, seed, s, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        loss = float(m["loss"])
        out.append({"step": s, "loss": loss, "s": time.perf_counter() - t0,
                    "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"])})
    return params, opt, out


def _masters_sample(M, params, n: int = 4096):
    """The first ``n`` entries of every leaf, copied: enough to see that
    the steps moved every master, without a copy of the model."""
    return [t.detach().reshape(-1)[:n].clone() for t in M.leaves(params)]


def _train_counted(torch, ops, rdev, M, step_fn, params, opt, cfg, spec,
                   seed, dev, first):
    """Phase 12 (b) / (c): a warm-up step (step ``first``), then
    ``spec["steps"]`` counted steps with the launch and sync counts from
    0 and the memory peak reset; returns (params, opt, run)."""
    params, opt, warm = _run_steps(torch, step_fn, params, opt, cfg, spec,
                                   seed, [first], dev)
    before = _masters_sample(M, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rdev.reset_sync_counts()
    params, opt, steps = _run_steps(
        torch, step_fn, params, opt, cfg, spec, seed,
        range(first + 1, first + 1 + spec["steps"]), dev)
    launched = dict(ops.launches)
    syncs = dict(rdev.sync_counts)
    after = _masters_sample(M, params)
    times = [r["s"] for r in steps]
    med = float(np.median(times))
    tokens = spec["seq_len"] * spec["batch"]
    run = {"warm_up": warm[0], "steps": steps,
           "step_s_median": med, "step_s": times,
           "tokens_per_step": tokens, "tokens_per_s": tokens / med,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launched, "syncs": syncs,
           "masters_changed": sum(not torch.equal(a, b)
                                  for a, b in zip(before, after)),
           "masters": len(before),
           "finite": all(np.isfinite([r["loss"], r["grad_norm"], r["lr"]]
                                     ).all() for r in warm + steps)}
    return params, opt, run


def _profile_step(torch, step_fn, params, opt, batches, want_router,
                  top: int = 8):
    """One training step (to the ``float(loss)`` read) under
    ``torch.profiler``: the kernel table and busy share, and the router
    kernel's device time a launch. A session
    that recorded other than ``want_router`` router launches lost
    records (see ``profiler_ms``): the next step of ``batches`` is
    profiled instead, up to ``PROFILER_TRIES`` steps; the returned
    profile says how many."""
    for i in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batches[i])
            float(m["loss"])
            wall = time.perf_counter() - t0
        router = [(device_us(e), e.count) for e in prof.key_averages()
                  if "fused_ot_kernel" in e.key]
        n = sum(c for _, c in router)
        if n == want_router:
            break
    out = _profile_summary(prof, wall, top)
    us = sum(u for u, _ in router)
    out.update(steps_profiled=i + 1, router_launches=n,
               router_launches_want=want_router, router_ms=us / 1e3,
               router_ms_per_launch=us / 1e3 / n if n else None,
               router_share=us / 1e3 / out["wall_ms"])
    return params, opt, out


def _train_reduced_equal(torch, M, cfg, spec, seed, dev):
    """Phase 12 (d) at reduced size: two runs of ``spec["reduced_steps"]``
    steps from the seed on the card; are their parameters bit-equal?"""
    from repro_torch.train.train_step import make_train_step

    runs = []
    for _ in range(2):
        init, step_fn = make_train_step(cfg)
        p = M.init_params(cfg, seed=seed, device=dev)
        p, _, hist = _run_steps(torch, step_fn, p, init(p), cfg,
                                spec["small"], seed,
                                range(spec["reduced_steps"]), dev)
        runs.append((p, [(r["loss"], r["grad_norm"]) for r in hist]))
    (a, ha), (b, hb) = runs
    return {"arch": cfg.name, "router": cfg.router,
            "steps": spec["reduced_steps"], "metrics_equal": ha == hb,
            "params_equal": all(torch.equal(x, y) for x, y in
                                zip(M.leaves(a), M.leaves(b)))}


def _train_card_vs_cpu(torch, M, moe, cfg, spec, seed, dev,
                       mesh_shape=None):
    """Phase 12 (e): one reduced model in float32 compute, the same
    carried parameters, ``spec["card_vs_cpu_steps"]`` steps on the CPU
    and on the card: loss and grad_norm within the tolerance; the
    router's flows on the card bit-equal to the plain version on the CPU
    on the same logits. With ``mesh_shape`` (phase 13 (c)) each run is
    under a ('data', 'model') mesh of that shape on its own device."""
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import sharding
    from repro_torch.train.train_step import make_train_step

    tol = spec["card_vs_cpu_tol"]
    small = spec["small"]
    p_cpu = M.init_params(cfg, seed=seed, device="cpu")
    p_dev = M.map_params(lambda t: t.to(dev, copy=True), p_cpu)
    hist = {}
    # the router's tokens: a 'dp' shard's under a mesh
    taps, untap = _tap_router(moe, {small["seq_len"] * small["batch"]
                                    // (mesh_shape or (1,))[0]})
    try:
        for where, p, d in (("cpu", p_cpu, torch.device("cpu")),
                            ("card", p_dev, dev)):
            if mesh_shape is not None:
                sharding.set_mesh(make_small_mesh(
                    mesh_shape, ("data", "model"), devices=d))
            init, step_fn = make_train_step(cfg, lr=spec["small_lr"],
                                            warmup=1)
            _, _, h = _run_steps(torch, step_fn, p, init(p), cfg, small,
                                 seed, range(spec["card_vs_cpu_steps"]), d)
            hist[where] = [(r["loss"], r["grad_norm"]) for r in h]
            if where == "cpu":
                taps.clear()
    finally:
        untap()
        if mesh_shape is not None:
            sharding.set_mesh(None)
    close = all(np.allclose(a, b, **tol)
                for a, b in zip(hist["card"], hist["cpu"]))
    flows = _router_flows_equal(torch, moe, taps)
    res = {"arch": cfg.name, "router": cfg.router, "card": hist["card"],
           "cpu": hist["cpu"], "metrics_ok": bool(close), "tol": tol,
           "flows": flows, "mesh": mesh_shape}
    res["ok"] = close and all(f["equal"] for f in flows.values()) and (
        len(flows) == 1 if cfg.num_experts else not flows)
    return res


def _trainer_on_card(torch, cfg, spec, seed, dev):
    """Phase 12 (f): the ``Trainer`` on the card. Kill and resume (8 steps
    against 4, a dropped object, and a new ``Trainer`` resuming at step
    4 for 4 more: the last 4 losses bit-equal), then the reference's
    loss-decrease check. Checkpoints under ``build/`` of the checkout."""
    import shutil

    from repro_torch.train.trainer import Trainer

    base = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(base, ignore_errors=True)
    r = spec["resume"]
    kw = dict(seq_len=r["seq_len"], batch_size=r["batch"],
              ckpt_every=r["ckpt_every"], seed=seed, device=dev)
    t0 = time.perf_counter()
    full = Trainer(cfg, str(base / "full"), **kw).run(2 * r["ckpt_every"])
    half = Trainer(cfg, str(base / "half"), **kw)
    half.run(r["ckpt_every"])
    del half
    resumed = Trainer(cfg, str(base / "half"), **kw)
    start = resumed.step
    rest = resumed.run(r["ckpt_every"])
    want = [h["loss"] for h in full[r["ckpt_every"]:]]
    got = [h["loss"] for h in rest]
    d = spec["decrease"]
    hist = Trainer(cfg, str(base / "decrease"), seq_len=d["seq_len"],
                   batch_size=d["batch"], lr=d["lr"], warmup=d["warmup"],
                   ckpt_every=10 * d["steps"], seed=seed,
                   device=dev).run(d["steps"])
    first = float(np.mean([h["loss"] for h in hist[:5]]))
    last = float(np.mean([h["loss"] for h in hist[-5:]]))
    res = {"arch": cfg.name, "router": cfg.router, "resumed_at": start,
           "losses_full": want, "losses_resumed": got,
           "resume_equal": start == r["ckpt_every"] and got == want,
           "decrease": {"first5": first, "last5": last,
                        "ok": last < first - 0.1, "steps": d["steps"]},
           "s": time.perf_counter() - t0}
    shutil.rmtree(base, ignore_errors=True)
    res["ok"] = res["resume_equal"] and res["decrease"]["ok"]
    return res


def phase_train(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The training path (see the module docstring, phase 12)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.train.train_step import make_train_step

    spec = SIZES["train"]
    seed = ctx["seed"]
    res = {"card": smi_line()}
    record["phases"]["train"] = res
    gc.collect()
    torch.cuda.empty_cache()
    res["memory_before"] = torch.cuda.memory_allocated()

    # (a) full width, 4 layers, float32 masters and AdamW state on the card
    base = ARCHS[spec["arch"]]
    if spec.get("reduce"):
        base = reduced(base)
    cfg = base.with_(num_layers=spec["num_layers"], router="pushrelabel")
    n_moe = cfg.num_layers - cfg.first_dense_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen, device=dev)
    opt_init, step_fn = make_train_step(cfg)
    opt = opt_init(params)
    torch.cuda.synchronize()
    lv = M.leaves(params)
    flops = model_flops(cfg, ShapeConfig("step", spec["seq_len"],
                                         spec["batch"], "train"), 1)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in M.leaves(tree))
    res["build"] = {
        "s": time.perf_counter() - t0, "arch": cfg.name,
        "num_layers": cfg.num_layers, "moe_layers": n_moe,
        "remat": cfg.remat, "optimizer": cfg.optimizer,
        "parameters": sum(t.numel() for t in lv),
        "active_parameters": flops["n_params_active"],
        "params_bytes": nbytes(params), "m_bytes": nbytes(opt.m),
        "v_bytes": nbytes(opt.v),
        "dtypes": sorted({str(t.dtype) for t in lv}),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"[12] (a) {json.dumps(res['build'])}")
    ok = (res["build"]["dtypes"] == ["torch.float32"]
          and res["build"]["parameters"] == flops["n_params_total"])
    del lv

    # (b) pushrelabel: warm-up, counted steps, one profiled step
    params, opt, run = _train_counted(torch, ops, rdev, M, step_fn, params,
                                      opt, cfg, spec, seed, dev, first=0)
    want = spec["steps"] * n_moe * 2
    n_ot = run["launches"]["fused_ot_phases"]
    run["fused_ot_want"] = want
    run["model_flops_per_step"] = flops["model_flops_total"]
    run["model_flops_share_of_bf16_peak"] = (
        flops["model_flops_total"] / run["step_s_median"] / BF16_FLOP_PER_S)
    launches["train"] = run["launches"]
    params, opt, run["profile"] = _profile_step(
        torch, step_fn, params, opt,
        [_train_batch(torch, cfg, spec, seed, spec["steps"] + 1 + i, dev)
         for i in range(PROFILER_TRIES)], 2 * n_moe)
    run["ok"] = bool(run["finite"] and n_ot == want
                     and sum(run["syncs"].values()) == 0
                     and run["masters_changed"] == run["masters"])
    res["pushrelabel"] = run
    log(f"[12] (b) pushrelabel: {json.dumps(run)}")
    ok &= run["ok"]
    warm_b = run["warm_up"]

    # (c) the same steps under topk, from (b)'s parameters and state
    t_cfg = cfg.with_(router="topk")
    _, t_step = make_train_step(t_cfg)
    first = spec["steps"] + 1 + PROFILER_TRIES
    params, opt, trun = _train_counted(torch, ops, rdev, M, t_step, params,
                                       opt, t_cfg, spec, seed, dev,
                                       first=first)
    params, opt, trun["profile"] = _profile_step(
        torch, t_step, params, opt,
        [_train_batch(torch, t_cfg, spec, seed, first + 1 + spec["steps"],
                      dev)], 0)
    trun["ok"] = bool(trun["launches"]["fused_ot_phases"] == 0)
    res["topk"] = trun
    log(f"[12] (c) topk: {json.dumps(trun)}")
    ok &= trun["ok"]

    # (d) determinism: the first step again from a rebuild
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen, device=dev)
    opt = opt_init(params)
    params, opt, again = _run_steps(torch, step_fn, params, opt, cfg, spec,
                                    seed, [0], dev)
    det = {"first_step": again[0], "warm_up_b": warm_b,
           "bit_equal": (again[0]["loss"] == warm_b["loss"]
                         and again[0]["grad_norm"] == warm_b["grad_norm"])}
    del params, opt, gen
    gc.collect()
    torch.cuda.empty_cache()
    small = reduced(ARCHS[spec["arch"]]).with_(router="pushrelabel")
    det["reduced"] = _train_reduced_equal(torch, M, small, spec, seed, dev)
    det["ok"] = bool(det["bit_equal"] and det["reduced"]["params_equal"]
                     and det["reduced"]["metrics_equal"])
    res["determinism"] = det
    log(f"[12] (d) {json.dumps(det)}")
    ok &= det["ok"]

    # (e) card against CPU, reduced models, float32 compute
    res["card_vs_cpu"] = []
    saved = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    try:
        for arch, router in spec["card_vs_cpu"]:
            rc = reduced(ARCHS[arch])
            if router:
                rc = rc.with_(router=router)
            r = _train_card_vs_cpu(torch, M, moe, rc, spec, seed, dev)
            log(f"[12] (e) {json.dumps(r)}")
            res["card_vs_cpu"].append(r)
            ok &= r["ok"]
    finally:
        M.COMPUTE_DTYPE = saved

    # (f) the Trainer on the card
    res["trainer"] = tr = _trainer_on_card(torch, small, spec, seed, dev)
    log(f"[12] (f) {json.dumps(tr)}")
    ok &= tr["ok"]
    return bool(ok)


def _per_shard_moe(torch, T, dp):
    """(the original, a stand-in) of ``transformer.apply_moe``: the
    stand-in runs it without a mesh on each of ``dp`` batch shards (on
    the whole batch when B does not divide), the single-device forward
    that the mesh branch must equal; every layer outside the MoE runs on
    the whole batch, as under the mesh."""
    orig = T.apply_moe

    def split(p, cfg, x):
        if x.shape[0] % dp:
            return orig(p, cfg, x)
        return torch.cat([orig(p, cfg, xs) for xs in torch.chunk(x, dp)])
    return orig, split


def _ep_f32(torch, M, T, sharding, cfg, mesh, reqs, seed, dev):
    """Phase 13 (b): float32 compute at full width on the dense layer and
    ``f32_moe_layers`` MoE layers: prefill's last logits and every cache
    under the mesh against the single-device forward applied to each
    'dp' shard, on the requests (split) and on the first ``replicated``
    of them (B does not divide: the single-device forward itself)."""
    spec = SIZES["ep"]
    cut = cfg.with_(num_layers=cfg.first_dense_layers
                    + spec["f32_moe_layers"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    saved = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    out = {"num_layers": cut.num_layers, "tol": spec["f32_tol"]}
    try:
        params = M.init_params(cut, gen, device=dev, dtype=torch.float32)
        for name, rs in (("split", reqs),
                         ("replicated", reqs[:spec["replicated"]])):
            toks = _left_padded(torch, rs, dev)
            with torch.inference_mode():
                sharding.set_mesh(mesh)
                try:
                    got = M.prefill(params, cut, {"tokens": toks})
                finally:
                    sharding.set_mesh(None)
                orig, split = _per_shard_moe(torch, T, mesh.shape["data"])
                T.apply_moe = split
                try:
                    want = M.prefill(params, cut, {"tokens": toks})
                finally:
                    T.apply_moe = orig
            diffs = [float((a.float() - b.float()).abs().max())
                     for a, b in zip(M.leaves(got), M.leaves(want))]
            out[name] = {"batch": len(rs), "tokens": int(toks.numel()),
                         "max_abs_diff_logits": diffs[-1],
                         "max_abs_diff": max(diffs),
                         "ok": max(diffs) <= spec["f32_tol"]}
        del params, got, want
    finally:
        M.COMPUTE_DTYPE = saved
    out["ok"] = out["split"]["ok"] and out["replicated"]["ok"]
    return out


def _ep_train(torch, ops, rdev, M, sharding, base, seed, dev):
    """Phase 13 (c): phase 12's configuration (full width cut to
    ``SIZES["train"]["num_layers"]``, float32 masters, AdamW, remat,
    ``router="pushrelabel"``) under a ``train_mesh`` of logical shards of
    the card: a warm-up step and ``train_steps`` counted steps; a rebuild
    from the seed repeats the warm-up step bit for bit; then the
    single-device twin's steps from there."""
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.train.train_step import make_train_step

    spec = dict(SIZES["train"], steps=SIZES["ep"]["train_steps"])
    mesh = make_small_mesh(SIZES["ep"]["train_mesh"], ("data", "model"),
                           devices=dev)
    dp = mesh.shape["data"]
    cfg = base.with_(num_layers=spec["num_layers"], router="pushrelabel")
    n_moe = cfg.num_layers - cfg.first_dense_layers

    def build():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = M.init_params(cfg, gen, device=dev)
        opt_init, step_fn = make_train_step(cfg)
        return params, opt_init(params), step_fn

    params, opt, step_fn = build()
    sharding.set_mesh(mesh)
    try:
        params, opt, run = _train_counted(torch, ops, rdev, M, step_fn,
                                          params, opt, cfg, spec, seed, dev,
                                          first=0)
    finally:
        sharding.set_mesh(None)
    want = spec["steps"] * n_moe * dp * 2
    run["fused_ot_want"] = want
    run["mesh"] = list(SIZES["ep"]["train_mesh"])
    run["ok"] = bool(run["finite"]
                     and run["launches"]["fused_ot_phases"] == want
                     and sum(run["syncs"].values()) == 0
                     and run["masters_changed"] == run["masters"])
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    params, opt, step_fn = build()
    sharding.set_mesh(mesh)
    try:
        params, opt, again = _run_steps(torch, step_fn, params, opt, cfg,
                                        spec, seed, [0], dev)
    finally:
        sharding.set_mesh(None)
    warm = run["warm_up"]
    run["rebuilt_first_step"] = again[0]
    run["bit_equal"] = (again[0]["loss"] == warm["loss"]
                        and again[0]["grad_norm"] == warm["grad_norm"])
    params, opt, twin = _train_counted(torch, ops, rdev, M, step_fn, params,
                                       opt, cfg, spec, seed, dev, first=1)
    twin["fused_ot_want"] = spec["steps"] * n_moe * 2
    twin["ok"] = bool(twin["finite"] and twin["launches"]["fused_ot_phases"]
                      == twin["fused_ot_want"])
    run["ok"] = bool(run["ok"] and run["bit_equal"])
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return run, twin


def phase_ep(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """Expert parallelism (see the module docstring, phase 13)."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe, sharding
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, Request

    spec = SIZES["ep"]
    res = {"card": smi_line()}
    record["phases"]["ep"] = res
    gc.collect()
    torch.cuda.empty_cache()
    res["memory_before"] = torch.cuda.memory_allocated()

    # (a) the bf16 model at full width; the Engine under the mesh and
    # alone, each router
    cfg = ARCHS[spec["arch"]]
    if spec.get("reduce"):
        cfg = reduced(cfg)
    mesh = make_small_mesh(spec["mesh"], ("data", "model"), devices=dev)
    dp = mesh.shape["data"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx["seed"])
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    res["mesh"] = {"shape": list(spec["mesh"]),
                   "devices": [str(d) for d in mesh.flat_devices]}
    n_moe = cfg.num_layers - cfg.first_dense_layers
    rng = np.random.default_rng([ctx["seed"], 11])
    reqs = [(p, spec["new_tokens"])
            for p, _ in _model_requests(rng, cfg, SIZES["models"])]
    plen = max(len(p) for p, _ in reqs)
    shard_tokens, shard_decode = len(reqs) * plen // dp, len(reqs) // dp
    no_eos = [None] * len(reqs)
    ok = True

    def serve(engine, rs, mesh_on, tap_keep=()):
        if mesh_on:
            sharding.set_mesh(mesh)
        try:
            return _serve_once(torch, ops, rdev, engine, Request, rs,
                               [None] * len(rs), n_moe, tap_keep=tap_keep)
        finally:
            sharding.set_mesh(None)

    for router in ("pushrelabel", "topk"):
        engine = Engine(cfg.with_(router=router), params,
                        max_len=spec["max_len"], device=dev)
        out = {}
        for where in ("single", "mesh"):
            mesh_on = where == "mesh"
            serve(engine, reqs, mesh_on)                  # warm-up
            keep = ((shard_tokens, shard_decode)
                    if mesh_on and router == "pushrelabel" else ())
            run, comps, taps = serve(engine, reqs, mesh_on, keep)
            passes = run["forward_passes"]
            n_ot = run["launches"]["fused_ot_phases"]
            shards = dp if mesh_on else 1
            run["fused_ot_per_pass"] = n_ot / passes
            run["fused_ot_want"] = (n_moe * shards * passes
                                    if router == "pushrelabel" else 0)
            run["tokens_out"] = [c.tokens.tolist() for c in comps]
            ok_r = (n_ot == run["fused_ot_want"]
                    and sum(run["syncs"].values()) == 0
                    and not _check_accounting(reqs, no_eos, comps, plen))
            if keep:
                flows = _router_flows_equal(torch, moe, taps)
                run["router_flows"] = flows
                res["router_rows"] = _router_rows(torch, ops, moe, taps,
                                                  n_ot)
                for row in res["router_rows"]:
                    row["path"] = (f"engine, expert parallel "
                                   f"{tuple(spec['mesh'])}")
                ok_r &= (len(flows) == 2
                         and all(f["equal"] for f in flows.values())
                         and all(r["ok"] for r in res["router_rows"]))
                launches["ep"] = run["launches"]
                del taps
            run["ok"] = bool(ok_r)
            out[where] = run
            ok &= ok_r
        mem = {w: out[w]["max_memory_allocated"] for w in out}
        out["memory_diff"] = mem["mesh"] - mem["single"]
        out["memory_ok"] = abs(out["memory_diff"]) <= spec["memory_slack"]
        out["same_tokens"] = out["mesh"]["tokens_out"] == \
            out["single"]["tokens_out"]
        ok &= out["memory_ok"]
        if router == "pushrelabel":
            # the replicated batch: B = 3 does not divide over 'data'
            rep, _, _ = serve(engine, reqs[:spec["replicated"]], True)
            rep["fused_ot_want"] = n_moe * rep["forward_passes"]
            rep["fused_ot_per_pass"] = (rep["launches"]["fused_ot_phases"]
                                        / rep["forward_passes"])
            rep["ok"] = bool(rep["launches"]["fused_ot_phases"]
                             == rep["fused_ot_want"]
                             and sum(rep["syncs"].values()) == 0)
            out["replicated"] = rep
            ok &= rep["ok"]
        res[router] = out
        for where in [w for w in ("single", "mesh", "replicated")
                      if w in out]:
            r = out[where]
            log(f"[13] (a) {router} {where}: prefill "
                f"{1e3 * r['prefill_s']:.1f} ms, decode "
                f"{r['decode_ms_per_step']} ms a step, "
                f"{r['tokens_per_s']:.1f} tokens/s, fused_ot "
                f"{r['launches']['fused_ot_phases']} (want "
                f"{r['fused_ot_want']}, {r['forward_passes']} passes), "
                f"syncs {r['syncs']}, peak "
                f"{r['max_memory_allocated']}, ok {r['ok']}")
        log(f"[13] (a) {router}: memory mesh - single "
            f"{out['memory_diff']} B (ok {out['memory_ok']}), same tokens "
            f"{out['same_tokens']}")
        del engine
    for row in res.get("router_rows", []):
        log(f"[13] (a) router row {json.dumps(row)}")

    # (b) float32 at full width on the first layers
    res["f32"] = _ep_f32(torch, M, T, sharding, cfg, mesh, reqs,
                         ctx["seed"], dev)
    log(f"[13] (b) {json.dumps(res['f32'])}")
    ok &= res["f32"]["ok"]
    del params, gen
    gc.collect()
    torch.cuda.empty_cache()

    # (c) training under a mesh, after the serving model is freed
    run, twin = _ep_train(torch, ops, rdev, M, sharding, cfg, ctx["seed"],
                          dev)
    res["train"], res["train_single"] = run, twin
    log(f"[13] (c) mesh: {json.dumps(run)}")
    log(f"[13] (c) single-device twin: {json.dumps(twin)}")
    ok &= run["ok"] and twin["ok"]
    small = reduced(ARCHS[spec["arch"]]).with_(router="pushrelabel")
    saved = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    try:
        res["train_card_vs_cpu"] = r = _train_card_vs_cpu(
            torch, M, moe, small, SIZES["train"], ctx["seed"], dev,
            mesh_shape=spec["train_mesh"])
    finally:
        M.COMPUTE_DTYPE = saved
    log(f"[13] (c) card vs CPU under the mesh: {json.dumps(r)}")
    ok &= r["ok"]
    return bool(ok)


def _dryrun_cells(spec) -> tuple:
    """Phase 14 (a): each cell through the dry-run's command line,
    ``python -m repro_torch.launch.dryrun --no-unroll``, at full width on
    the production mesh (a rehearsal plans the smoke shapes on the small
    mesh), the cells in parallel processes; their records are read from
    ``build/chip_smoke_dryrun/``."""
    import shutil

    root = Path(__file__).resolve().parent
    out = root / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    small = bool(spec.get("reduce"))
    procs = []
    try:
        for arch, shape, kw in spec["cells"]:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--no-unroll",
                   "--out", str(out)]
            tag = f"{arch}__{shape}__{'mp' if kw.get('multi_pod') else 'sp'}"
            if kw.get("multi_pod"):
                cmd.append("--multi-pod")
            if kw.get("router"):
                cmd += ["--router", kw["router"]]
                tag += f"__{kw['router']}"
            if small:
                cmd += ["--small", "--smoke"]
                tag += "__smoke"
            log_f = open(out / f"{tag}.log", "w")
            procs.append((arch, shape, kw, tag, log_f, subprocess.Popen(
                cmd, cwd=str(root), env=env, stdout=log_f,
                stderr=subprocess.STDOUT)))
        for *_, proc in procs:
            proc.wait(timeout=600)
    finally:
        for *_, log_f, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
    rows, ok = [], True
    for arch, shape, kw, tag, _, proc in procs:
        path = out / f"{tag}.json"
        r = json.loads(path.read_text()) if path.exists() else {
            "ok": False, "error": f"no record (exit {proc.returncode}): "
            + (out / f"{tag}.log").read_text()[-1500:]}
        row = {"arch": arch, "shape": shape, **kw, "ok": r["ok"],
               "plan_s": r.get("compile_s")}
        if r["ok"] and "roofline" in r:
            t = r["roofline"]
            row.update(
                n_chips=r["n_chips"], mesh=r["mesh"],
                gib_per_device=r["memory"]["peak_per_device_gb"],
                memory=r["memory"], t_compute_s=t["t_compute_s"],
                t_memory_s=t["t_memory_s"],
                t_memory_adjusted_s=t["t_memory_adjusted_s"],
                t_collective_s=t["t_collective_s"],
                dominant=t["dominant"], bound_time_s=t["bound_time_s"],
                flops_per_device=t["flops_per_device"],
                bytes_per_device=t["bytes_per_device"],
                collective_counts=t["collective"]["counts"],
                moved_bytes=t["collective"]["moved_bytes"],
                while_ops=t["collective"]["while_ops"],
                collective_records=len(r["collective_records"]),
                hlo_flops_ratio=r["hlo_flops_ratio"],
                recordings=r["plan"]["recordings"],
                periods_scaled=r["periods_scaled"])
        else:
            row["error"] = r.get("error")
            row["traceback"] = r.get("traceback")
        log(f"[14] (a) {arch} {shape} {kw or ''}: ok {row['ok']}, "
            f"{row.get('gib_per_device')} GiB/device, terms compute "
            f"{row.get('t_compute_s')} s / memory "
            f"{row.get('t_memory_adjusted_s')} s / collective "
            f"{row.get('t_collective_s')} s, dominant "
            f"{row.get('dominant')}, {row.get('collective_records')} "
            f"collective records, planned in {row['plan_s']} s"
            + (f"; {row['error']}" if not row["ok"] else ""))
        rows.append(row)
        ok &= bool(r["ok"])
    return rows, ok


def allocator_slack(tensors) -> int:
    """The most the caching allocator's blocks may add to the tensors'
    bytes: a block below 1 MiB is rounded up to 512 B; a larger one may
    also keep up to 1 MiB of its segment that is too small to split
    off."""
    return sum(512 if t.numel() * t.element_size() < 1 << 20
               else 512 + (1 << 20) for t in tensors)


def _dryrun_against_card(torch, ops, rdev, spec, seed, dev) -> dict:
    """Phase 14 (b): phase 12's training configuration planned on a (1,
    1) mesh of the card, then placed and stepped there: argument bytes
    against the growth of ``memory_allocated``, argument + temp bytes
    against the step's memory peak, the plan's FLOPs against
    ``FlopCounterMode`` over a real step, the step's time against the
    plan's bound, and ``fused_ot_phases`` launches against the plan's
    custom calls."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.launch.dryrun import plan_step
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_train_step

    train = SIZES["train"]
    base = ARCHS[train["arch"]]
    if train.get("reduce"):
        base = reduced(base)
    cfg = base.with_(num_layers=train["num_layers"], router="pushrelabel")
    shape = ShapeConfig("step", train["seq_len"], train["batch"], "train")
    t0 = time.perf_counter()
    plan = plan_step(cfg, shape, make_small_mesh((1, 1), devices=dev))
    out = {"plan_s": time.perf_counter() - t0, "arch": cfg.name,
           "num_layers": cfg.num_layers, "router": cfg.router,
           "tokens": train["seq_len"] * train["batch"],
           "plan_memory": plan["memory"],
           "plan_flops": plan["plan"]["flops_dp_shard"],
           "plan_bound_time_s": plan["roofline"]["bound_time_s"],
           "plan_terms": {k: plan["roofline"][k] for k in (
               "t_compute_s", "t_memory_s", "t_memory_adjusted_s",
               "t_collective_s", "dominant")},
           "plan_custom_calls": len(plan["plan"]["custom_calls"])}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen, device=dev)
    opt_init, step_fn = make_train_step(cfg)
    opt = opt_init(params)
    batch = _train_batch(torch, cfg, train, seed, 0, dev)
    torch.cuda.synchronize()
    args = [t for t in M.leaves(params) + M.leaves(opt)
            + list(batch.values()) if t is not None]
    placed = torch.cuda.memory_allocated() - m0
    arg_b = plan["memory"]["argument_bytes"]
    slack = allocator_slack(args)
    out["arguments"] = {
        "plan_bytes": arg_b, "memory_allocated_growth": placed,
        "tensors": len(args), "allowed": slack,
        "ok": 0 <= placed - arg_b <= slack}
    # a warm-up step (step 0), then the measured step: its peak over the
    # memory before the arguments, its launches and its time
    params, opt, _ = _run_steps(torch, step_fn, params, opt, cfg, train,
                                seed, [0], dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rdev.reset_sync_counts()
    params, opt, steps = _run_steps(torch, step_fn, params, opt, cfg, train,
                                    seed, [1], dev)
    peak = torch.cuda.max_memory_allocated() - m0
    launched = dict(ops.launches)
    planned = arg_b + plan["memory"]["temp_bytes"]
    out["peak"] = {"plan_argument_plus_temp": planned,
                   "max_memory_allocated_growth": peak,
                   "ratio": peak / planned}
    out["step_s"] = steps[0]["s"]
    out["step_over_bound"] = steps[0]["s"] / out["plan_bound_time_s"]
    out["launches"] = launched
    out["fused_ot_phases"] = {"launched": launched["fused_ot_phases"],
                              "plan_custom_calls": out["plan_custom_calls"]}
    with FlopCounterMode(display=False) as fc:
        params, opt, counted = _run_steps(torch, step_fn, params, opt, cfg,
                                          train, seed, [2], dev)
    out["flops"] = {"plan": out["plan_flops"],
                    "real_step": int(fc.get_total_flops()),
                    "equal": out["plan_flops"] == int(fc.get_total_flops())}
    out["finite"] = bool(np.isfinite([s["loss"] for s in steps + counted]
                                     ).all())
    out["ok"] = bool(out["arguments"]["ok"] and out["flops"]["equal"]
                     and launched["fused_ot_phases"]
                     == out["plan_custom_calls"] > 0 and out["finite"])
    del params, opt, batch, args
    gc.collect()
    torch.cuda.empty_cache()
    return out, launched


def _dryrun_solver(torch, ops, spec, seed, dev) -> dict:
    """Phase 14 (c): ``lower_sharded_solver`` on a logical grid of the
    card, its ``.compile()``, then ``solve_assignment_sharded`` on the
    same mesh: the blocks it launches ``slack_propose`` on equal the
    plan's, one launch a block a round, and the result is bit-equal to
    the single-device solve."""
    from repro_torch.core import sharded as S
    from repro_torch.core.pushrelabel import solve_assignment
    from repro_torch.launch.mesh import make_small_mesh

    n, eps, grid = spec["solver"]
    mesh = make_small_mesh(grid, ("data", "model"), devices=dev)
    plan = S.lower_sharded_solver(n, eps, mesh)
    compiled = plan.compile()
    c = torch.as_tensor(np.random.default_rng([seed, 14]).uniform(
        size=(n, n)).astype(np.float32), device=dev)
    seen = []
    orig = S.ops.slack_propose_batched

    def spy(c_int, *a, **kw):
        seen.append((tuple(c_int.shape), str(c_int.device)))
        return orig(c_int, *a, **kw)
    S.ops.slack_propose_batched = spy
    torch.cuda.synchronize()
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        got = S.solve_assignment_sharded(c, eps, mesh)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        S.ops.slack_propose_batched = orig
    launched = dict(ops.launches)
    want = solve_assignment(c, eps, device=dev)
    per_round = plan.per_round["slack_propose_launches"]
    blocks = [(tuple(b["shape"]), b["device"]) for b in plan.blocks]
    rounds = len(seen) // per_round
    out = {"n": n, "eps": eps, "grid": list(grid), "compile": compiled,
           "blocks": [b["shape"] for b in plan.blocks],
           "block_bytes": [b["bytes"] for b in plan.blocks],
           "rounds": rounds, "launches": launched, "solve_s": solve_s,
           "blocks_equal": bool(seen) and len(seen) == rounds * per_round
           and all(seen[r * per_round:(r + 1) * per_round] == blocks
                   for r in range(rounds)),
           "bit_equal": all(torch.equal(getattr(got, f), getattr(want, f))
                            for f in got._fields)}
    out["ok"] = bool(compiled["built"] and out["blocks_equal"]
                     and out["bit_equal"]
                     and launched["slack_propose"] == len(seen))
    return out, launched


def phase_dryrun(torch, ops, rdev, dev, record, ctx, launches) -> bool:
    """The dry-run group (see the module docstring, phase 14)."""
    spec = SIZES["dryrun"]
    res = {"card": smi_line()}
    record["phases"]["dryrun"] = res
    t0 = time.monotonic()
    res["cells"], ok = _dryrun_cells(spec)
    res["cells_s"] = time.monotonic() - t0
    b, train_launches = _dryrun_against_card(torch, ops, rdev, spec,
                                             ctx["seed"], dev)
    res["card_check"] = b
    log(f"[14] (b) {json.dumps(b)}")
    ok &= b["ok"]
    c, solver_launches = _dryrun_solver(torch, ops, spec, ctx["seed"], dev)
    res["solver"] = c
    log(f"[14] (c) {json.dumps(c)}")
    ok &= c["ok"]
    launches["dryrun"] = {k: train_launches.get(k, 0)
                          + solver_launches.get(k, 0)
                          for k in set(train_launches) | set(
                              solver_launches)}
    return bool(ok)


if __name__ == "__main__":
    sys.exit(main())
