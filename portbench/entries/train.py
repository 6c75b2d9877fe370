"""Entry ``train``: a closed loop of training steps through the port's
``repro_torch.train.trainer.Trainer.train_step()``.

The model is the configuration's architecture from the port's registry
(``port_arch``, resolved by ``registry.get_arch``), cut to the file's
``num_hidden_layers`` and held to its other sizes (a mismatch raises).
The ``Trainer`` draws the weights and the token batches (its
``synthetic_batch`` Markov streams over the whole vocabulary) from one
seed, drawn from the run's seed (stream ``"tokens"``), builds AdamW's
state on the card, and each ``train_step()`` trains one batch of
``batch`` sequences of ``seq_len`` tokens: forward, backward, clip,
AdamW, and the loss read that waits for the card. ``warmup_steps`` steps
run before the window. One instance is one sequence trained, so a step
answers ``batch`` instances.

After the window one more ``train_step()`` is the answer the reference
checks (``checked_step``): its loss, gradient norm, the gradients of the
reference's ``grad_names`` leaves before the clip, those leaves' AdamW
updates, the first layer's attention core (its q, k, v and answer) and
the MoE router's captures. The instance is its tokens, the
weights it ran on, and those leaves' AdamW moments and step count.

With ``--trace 1`` the port's span recorder is on for the whole window
(``tracing.record(True)``), so the ``train.step`` spans and their
counters cover every step, and ``torch.profiler`` runs over the last
``trace_seconds``; that trace's kernels by kind go to
``Window.notes["device_s_by_kind"]``, the router kernel's launches and
device time to ``Window.notes["router_kernel"]``.

Workload keys: ``batch``, ``seq_len``, ``grad_accum``, ``warmup_steps``,
``trace_seconds``, and the optimizer's (``optim_settings``): ``lr``,
``lr_warmup_steps``, ``total_steps``, ``max_grad_norm``, ``adamw``.
"""
from __future__ import annotations

import gc
import os
import shutil
import tempfile
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any

import numpy as np

# the device kernel ``ops.fused_run_ot_phases`` launches for the router
# (csrc/fused_ot.cu)
ROUTER_KERNEL = "fused_ot_kernel"


@dataclass
class TrainInstance:
    """The checked step's inputs: its tokens (B, S + 1), the weights it
    ran on, in the reference's layout (``reference_params``), AdamW's
    moments ({name: (m, v)}, on the host) of the leaves the answer
    updates, AdamW's step count before the step, and the workload's
    optimizer settings (``optim_settings``)."""
    tokens: Any
    params: Any
    moments: dict
    step: int
    optim: dict
    shape: tuple


def optim_settings(params: dict) -> dict:
    """The workload's optimizer: the learning rate's peak, warm-up and
    cosine length, which the entry gives the ``Trainer``, and the clip's
    norm and AdamW's constants, which the program fixes (the clip at 1.0
    in ``make_train_step``, AdamW's in ``adamw_update``) and the
    reference holds it to."""
    return {"lr": float(params["lr"]),
            "warmup": int(params["lr_warmup_steps"]),
            "total_steps": int(params["total_steps"]),
            "max_grad_norm": float(params["max_grad_norm"]),
            **{k: float(v) for k, v in params["adamw"].items()}}


def model_config(config: dict):
    """The port's config of the file's architecture, cut to its depth;
    raises if a size the file states differs from the port's."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(config["port_arch"]).with_(
        num_layers=int(config["num_hidden_layers"]),
        capacity_factor=float(config["capacity_factor"]),
        router=config["router"])
    rs = config["rope_scaling"]
    want = {"d_model": config["hidden_size"],
            "num_heads": config["num_attention_heads"],
            "d_ff": config["intermediate_size"],
            "vocab_size": config["vocab_size"],
            "num_experts": config["n_routed_experts"],
            "top_k": config["num_experts_per_tok"],
            "num_shared_experts": config["n_shared_experts"],
            "d_ff_expert": config["moe_intermediate_size"],
            "first_dense_layers": config["first_k_dense_replace"],
            "norm_eps": config["rms_norm_eps"],
            "rope_theta": config["rope_theta"],
            "kv_lora_rank": config["kv_lora_rank"],
            "qk_nope_head_dim": config["qk_nope_head_dim"],
            "qk_rope_head_dim": config["qk_rope_head_dim"],
            "v_head_dim": config["v_head_dim"],
            "rope_factor": rs["factor"],
            "rope_orig_len": rs["original_max_position_embeddings"],
            "beta_fast": rs["beta_fast"], "beta_slow": rs["beta_slow"],
            "mscale": rs["mscale"], "mscale_all_dim": rs["mscale_all_dim"],
            "norm_topk_prob": config["norm_topk_prob"]}
    bad = {k: (getattr(cfg, k), v) for k, v in want.items()
           if getattr(cfg, k) != v}
    if bad or config["routed_scaling_factor"] != 1:
        raise ValueError(f"the port's {config['port_arch']} differs from "
                         f"the configuration file: {bad}")
    return cfg


def reference_params(params) -> dict:
    """The port's parameter tree as the reference's layout: views of the
    same tensors (``reference/deepseek_v2_lite.LAYOUT``)."""
    layers = []
    for stage in params["stages"]:
        for period in stage:
            lp = period["l0"]
            d = {"ln1": lp["ln1"], **lp["attn"], "ln2": lp["ln2"]}
            if "mlp" in lp:
                m = lp["mlp"]
                d.update(mlp_gate=m["w_gate"], mlp_up=m["w_up"],
                         mlp_down=m["w_down"])
            else:
                m = lp["moe"]
                d.update(router=m["router"], w_gate=m["w_gate"],
                         w_up=m["w_up"], w_down=m["w_down"],
                         shared_gate=m["shared"]["w_gate"],
                         shared_up=m["shared"]["w_up"],
                         shared_down=m["shared"]["w_down"])
            layers.append(d)
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"], "layers": layers}


def _leaf_names(params) -> dict:
    """id(tensor) -> its name in the reference's layout."""
    ref = reference_params(params)
    names = {id(ref[n]): n for n in ("embed", "final_norm", "lm_head")}
    for i, lp in enumerate(ref["layers"]):
        names.update({id(w): f"layers.{i}.{n}" for n, w in lp.items()})
    return names


def checked_step(trainer, keep, n_moe: int, optim: dict):
    """(instance, answer) of one more ``trainer.train_step()``, the
    router's captures on (``moe.RouterTap(capture=True)``), the
    gradients of the leaves ``keep`` names (reference layout) copied
    before the clip (``train_step.watch_grads``) and the first latent
    attention core's inputs and answer (``attention.watch_core``). The
    weights before the step wait on the host, with AdamW's moments of
    the ``keep`` leaves; after the step the answer takes each ``keep``
    leaf's update (its weights after, less before), the trainer's
    weights go back to those before (the instance's) and its AdamW state
    is freed: the trainer steps no more. ``optim``: the workload's
    optimizer settings, which the reference's update follows."""
    import torch
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.attention import watch_core
    from repro_torch.train.train_step import watch_grads

    names = _leaf_names(trainer.params)
    leaves = M.leaves(trainer.params)
    kept = [(i, names[id(p)]) for i, p in enumerate(leaves)
            if names[id(p)] in keep]
    host = torch.device("cpu")
    before = [p.to(host, copy=True) for p in leaves]
    m, v = M.leaves(trainer.opt_state.m), M.leaves(trainer.opt_state.v)
    moments = {n: (m[i].to(host, copy=True), v[i].to(host, copy=True))
               for i, n in kept}
    step = int(trainer.opt_state.step)
    tokens = torch.as_tensor(synthetic_batch(
        trainer.cfg, trainer.seq_len, trainer.batch_size, seed=trainer.seed,
        step=trainer.step)["tokens"], device=trainer.device)
    grads, core = {}, {}

    def keep_grads(gs):
        for i, n in kept:
            grads[n] = gs[i].detach().float().clone()

    def keep_core(q, k, v, out):
        if not core:                 # the first layer's, in the forward
            core.update(q=q.detach().clone(), k=k.detach().clone(),
                        v=v.detach().clone(), out=out.detach().clone())

    hook = moe.RouterTap(capture=True)
    with moe.tap(hook), watch_grads(keep_grads), watch_core(keep_core):
        rec = trainer.train_step()
    after = M.leaves(trainer.params)
    update = {n: after[i].float() - before[i].to(after[i].device).float()
              for i, n in kept}
    with torch.no_grad():
        for p, b in zip(after, before):
            p.copy_(b)
    del before, m, v
    trainer.opt_state = None
    gc.collect()
    if trainer.device.type == "cuda":
        torch.cuda.empty_cache()
    fwd, back = hook.calls[:n_moe], hook.calls[n_moe:][::-1]
    routes = []
    for i, call in enumerate(fwd):
        r = dict(call)
        if i < len(back):
            r["flow_recompute"] = back[i]["flow"]
        routes.append(r)
    answer = {"loss": rec["loss"], "grad_norm": rec["grad_norm"],
              "grads": grads, "update": update, "routes": routes,
              "attn_core": core}
    instance = TrainInstance(tokens=tokens,
                             params=reference_params(trainer.params),
                             moments=moments, step=step, optim=optim,
                             shape=tuple(tokens[:, 1:].shape))
    return instance, answer


def kernel_kinds(events, window_span: str) -> dict:
    """{kind: [launches, device seconds]} of the device's kernels that
    overlap the traced window (the host span ``window_span``), counted as
    ``lib.trace.summarize`` counts its ``kernel_s`` (copies apart, under
    ``copy``), by ``kind_of`` of their names."""
    from portbench.lib.trace import _annotation, _is_copy

    window, kernels = None, []
    for e in events:
        s = e.start_ns() * 1e-9
        end = s + e.duration_ns() * 1e-9
        if str(e.device_type()).endswith("CUDA"):
            if not _annotation(e):
                kernels.append((s, end, e.name()))
        elif e.name() == window_span:
            window = (s, end)
    out: dict = {}
    if window is None:
        return out
    for s, end, name in kernels:
        if end > window[0] and s < window[1]:
            k = out.setdefault("copy" if _is_copy(name) else kind_of(name),
                               [0, 0.0])
            k[0] += 1
            k[1] += end - s
    return out


def kind_of(name: str) -> str:
    """The router (``ROUTER_KERNEL``); float32 GEMMs (cuBLAS's SIMT and
    f32 kernels: the attention core's einsums, the router's logits); the
    other GEMMs (tensor-core kernels: the bf16 projections, experts, MLPs
    and head); elementwise kernels; the rest."""
    low = name.lower()
    if ROUTER_KERNEL in name:
        return "router"
    if any(t in low for t in ("sgemm", "f32f32", "simt")):
        return "gemm_fp32"
    if any(t in low for t in ("nvjet", "gemm", "xmma", "cutlass", "wgmma")):
        return "gemm_tc"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def _tracer(env):
    """A ``lib.trace.Tracer`` whose ``stop`` also keeps the traced
    window's kernels by kind (``kinds``, ``kernel_kinds``)."""
    from portbench.lib import trace

    class KindTracer(trace.Tracer):
        def stop(self):
            prof = self._prof
            summary = super().stop()
            self.kinds = kernel_kinds(prof.profiler.kineto_results.events(),
                                      trace.WINDOW_SPAN)
            return summary

    return KindTracer(env.torch, env.device)


def run(env):
    from repro_torch.obs import tracing
    from repro_torch.train.trainer import Trainer

    from portbench.lib import gen
    from portbench.lib.harness import Window, load_file
    from portbench.lib.trace import lost_records
    from portbench.model_bounds import train_step_flops

    torch = env.torch
    conf, params = env.cell.config, env.cell.params
    cfg = model_config(conf)
    b, s = int(params["batch"]), int(params["seq_len"])
    seed = int(gen.rng_for(env.seed, "tokens").integers(0, 2 ** 31))
    optim = optim_settings(params)
    workdir = tempfile.mkdtemp(prefix="portbench_train_")
    try:
        t_init = env.clock()
        trainer = Trainer(cfg, workdir, seq_len=s, batch_size=b,
                          lr=optim["lr"], warmup=optim["warmup"],
                          total_steps=optim["total_steps"], seed=seed,
                          grad_accum=int(params.get("grad_accum", 1)),
                          device=env.device)
        env.sync()
        t_warm = env.clock()
        for _ in range(int(params.get("warmup_steps", 2))):
            trainer.train_step()
        env.sync()
        split = {"before_trainer_s": t_init - env.t_start,
                 "trainer_s": t_warm - t_init,
                 "warmup_s": env.clock() - t_warm}
        w = _window(env, trainer, tracing, lost_records, Window, b)
        w.notes["setup_split"] = split
        w.notes["step_flops"] = train_step_flops(conf, b, s)
        ref = load_file("reference", conf["reference"], env.cell.root)
        n_moe = conf["num_hidden_layers"] - conf["first_k_dense_replace"]
        inst, ans = checked_step(trainer, set(ref.grad_names(conf)), n_moe,
                                 optim)
        w.answers.append((inst, ans))
        w.notes["checked"] = {"step": inst.step, "loss": ans["loss"],
                              "grad_norm": ans["grad_norm"]}
        del trainer
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    return w


def _window(env, trainer, tracing, lost_records, Window, b: int):
    """The measured window of training steps (and, traced, the profile)."""
    params = env.cell.params
    w = Window()
    tracer = _tracer(env) if env.trace else None
    trace_s = float(params.get("trace_seconds", 4.0))
    setup_peak = env.peak()
    env.reset_peak()
    if env.trace:
        tracing.clear()
        tracing.record(True)
    cpu0 = os.times()
    t0 = env.clock()
    w.setup_s = t0 - env.t_start
    durations, losses = [], []
    try:
        while env.clock() - t0 < env.seconds:
            t_step = env.clock()
            w.attempted += b
            traced = tracer is not None and (
                tracer.started or env.clock() - t0 >= env.seconds - trace_s)
            if traced and not tracer.started:
                w.notes["profiled_from"] = tracing.now()
                tracer.start()
            try:
                with tracer.call_span() if traced else nullcontext():
                    rec = trainer.train_step()
            except Exception as e:       # counted and reported; no answer
                w.notes.setdefault("errors", []).append(repr(e)[:300])
                break
            durations.append(env.clock() - t_step)
            losses.append(rec["loss"])
            w.calls_done += 1
            w.instances_done += b
            if traced:
                w.traced_calls += 1
        env.sync()
        w.elapsed_s = env.clock() - t0
        cpu1 = os.times()
        w.peak_bytes = env.peak()
        w.process_peak_bytes = max(setup_peak, w.peak_bytes)
        if tracer is not None:
            if not tracer.started:
                tracer.start()
            tracer.stop()
            if lost_records(tracer.summary):
                # trace steps again, after the window, in a new session
                w.notes["trace_lost"] = [tracer.summary.launches,
                                         tracer.summary.host_launches]
                tracer = _tracer(env)
                w.traced_calls = 0
                w.notes.setdefault("profiled_from", tracing.now())
                tracer.start()
                t1 = env.clock()
                while w.traced_calls == 0 or env.clock() - t1 < trace_s:
                    with tracer.call_span():
                        trainer.train_step()
                    w.traced_calls += 1
                tracer.stop()
            w.trace = tracer.summary
            w.notes["device_s_by_kind"] = tracer.kinds
            launches, dev_s = tracer.kinds.get("router", (0, 0.0))
            w.notes["router_kernel"] = {
                "launches": launches, "device_s": dev_s,
                "tokens": b * int(params["seq_len"]),
                "experts": env.cell.config["n_routed_experts"]}
            w.notes["tracer_host_s"] = tracer.host_s
    finally:
        if env.trace:
            tracing.record(None)
    w.notes["host_cpu_s"] = {"user": cpu1.user - cpu0.user,
                             "system": cpu1.system - cpu0.system}
    if durations:
        d, half = np.asarray(durations), len(durations) // 2
        w.notes["step_s"] = {
            "p10": float(np.percentile(d, 10)),
            "p50": float(np.percentile(d, 50)),
            "p90": float(np.percentile(d, 90)),
            "halves": [float(d[:max(half, 1)].mean()), float(d[half:].mean())]}
        w.notes["loss"] = {"first": losses[0], "last": losses[-1]}
    w.notes["steps"] = w.calls_done
    return w
