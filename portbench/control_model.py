#!/usr/bin/env python3
"""Readings that a model cell's correctness limits are set from, on the
card: the program as it stands, and controls and faults, each of which
must come out not correct.

    python3 portbench/control_model.py --workload deepseek_v2_lite.train_8k \
        --seconds <s> [--seeds 0] [--control-seeds 2] [--fault-seeds 1] \
        [--controls scale,fp8,bf16_attn,noop,noclip] [--first-seed N] \
        [--out FILE]

In one process, runs the cell at its own size for a window of
``--seconds`` on ``--seeds`` seeds as the program stands, then on
``--control-seeds`` further seeds under each control and
``--fault-seeds`` under each fault:

  scale      (control) the latent attention's softmax scale without
             YaRN's m^2 (192^-0.5 where the model has 192^-0.5 m^2, m =
             1.2608...): a mechanism left out that would still train;
  fp8        (control) the inputs of every MLA and routed-expert matmul
             rounded to float8_e4m3fn (saturated at +-448), the precision
             below the configuration's bfloat16; the gradients pass the
             rounding unchanged (straight through);
  bf16_attn  (control) the attention core in bfloat16 (the scores, the
             softmax and the value sum), where the configuration states
             float32;
  noop       (fault) AdamW's update leaves the weights and moments as
             they were (the step count still advances);
  noclip     (fault) the gradients reach AdamW unclipped.

Prints each run's numbers (every number the reference returns, the
per-leaf breakdown included) and, per compared number, the lower reading
(the largest over the program's seeds) and each control's and fault's
upper one (the smallest over its seeds). The benchmark's own runs never
switch one on.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FP8_MAX = 448.0


def _fp8(x):
    """x with its values rounded to float8_e4m3fn (saturating), the
    gradient passed through unchanged."""
    import torch

    y = x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)
    return x + (y - x).detach()


def _fp8_mla_forward(p, cfg, x, positions, *, causal=True):
    """``attention.mla_forward`` with every projection's inputs rounded."""
    import torch
    from repro_torch.models import attention as A

    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    x8 = _fp8(x)
    q = (x8 @ _fp8(p["wq"])).reshape(b, s, h, dn + dr)
    kv_a = x8 @ _fp8(p["wkv_a"])
    c = A.rmsnorm(p["kv_norm"], kv_a[..., :r], cfg.norm_eps)
    kv = (_fp8(c) @ _fp8(p["wkv_b"])).reshape(b, s, h, dn + dv)
    freqs, ms = A.mla_rope(cfg, x.device)
    q_pe = A.rope_rotate(A.deinterleave(q[..., dn:]), positions, freqs, ms)
    k_pe = A.rope_rotate(A.deinterleave(kv_a[..., r:].reshape(b, s, 1, dr)),
                         positions, freqs, ms)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], dim=-1)
    out = A.flash_attention(q, k, kv[..., dn:], causal=causal,
                            scale=A.mla_softmax_scale(cfg))
    if A._CORE_WATCH is not None:
        A._CORE_WATCH(q, k, kv[..., dn:], out)
    return _fp8(out.reshape(b, s, -1)) @ _fp8(p["wo"])


def _fp8_experts(p_experts, cfg, tokens, sel, gates, e0, e_loc):
    """``moe.moe_local_forward`` with the experts' matmul inputs rounded."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe

    t, d = tokens.shape
    cap = int(t * cfg.top_k / cfg.num_experts * cfg.capacity_factor) + 1
    buffer, buf_gate, src = moe._dispatch_local(tokens, sel, gates, e0,
                                                e_loc, cap)
    xb = _fp8(buffer.reshape(e_loc, cap, d))
    h = F.silu(torch.bmm(xb, _fp8(p_experts["w_gate"]))) \
        * torch.bmm(xb, _fp8(p_experts["w_up"]))
    yb = torch.bmm(_fp8(h), _fp8(p_experts["w_down"]))
    y_flat = yb.reshape(e_loc * cap, d) * buf_gate[:, None].to(yb.dtype)
    return moe._combine(y_flat, src, t, sel.shape[1])


def _bf16_attention(q, k, v, *, causal: bool, q_block: int = 512,
                    kv_block: int = 1024, scale=None):
    """``attention.flash_attention``'s arguments and answer, its core in
    bfloat16: per block of ``q_block`` queries, the scores over the keys
    it sees, their softmax and the value sum, each rounded to bfloat16."""
    import torch

    del kv_block
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    bf = torch.bfloat16
    qs = (q * scale).to(bf)
    k = k.to(bf).repeat_interleave(h // kvh, dim=2)
    v = v.to(bf).repeat_interleave(h // kvh, dim=2)
    outs = []
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        end = min(q1, sk) if causal else sk
        s_ = torch.einsum("bqhd,bkhd->bhqk", qs[:, q0:q1], k[:, :end])
        if causal:
            seen = (torch.arange(end, device=q.device)[None, :]
                    <= torch.arange(q0, q1, device=q.device)[:, None])
            s_ = s_.masked_fill(~seen, float("-inf"))
        p_ = torch.softmax(s_, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p_, v[:, :end]))
    return torch.cat(outs, dim=1).to(q.dtype)


def _noop_adamw(params, grads, state, lr, **kw):
    """An AdamW update that changes nothing but the step count."""
    return params, state._replace(step=state.step + 1)


def _noclip(grads, max_norm):
    """The clip's norm, the gradients left as they were."""
    import torch
    from repro_torch.models.model import leaves

    gs = leaves(grads)
    return grads, torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                 for g in gs))


@contextlib.contextmanager
def control(name: str):
    """The program with control or fault ``name`` switched on for the
    body (before the ``Trainer`` is built: it takes its optimizer then)."""
    from repro_torch.models import attention, moe, transformer
    from repro_torch.optim import optimizer
    from repro_torch.train import train_step

    if name == "scale":
        patches = [(attention, "mla_softmax_scale",
                    lambda cfg: cfg.q_head_dim ** -0.5)]
    elif name == "fp8":
        patches = [(transformer, "mla_forward", _fp8_mla_forward),
                   (moe, "moe_local_forward", _fp8_experts)]
    elif name == "bf16_attn":
        patches = [(attention, "flash_attention", _bf16_attention)]
    elif name == "noop":
        patches = [(optimizer, "OPTIMIZERS", dict(
            optimizer.OPTIMIZERS,
            adamw=(optimizer.adamw_init, _noop_adamw)))]
    elif name == "noclip":
        patches = [(train_step, "clip_by_global_norm", _noclip)]
    else:
        raise ValueError(name)
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


CONTROLS = ("scale", "fp8", "bf16_attn")
FAULTS = ("noop", "noclip")


def readings(cell, seeds, control_seeds, seconds, device, log=print):
    """Each run's numbers, then per compared number the program's lower
    reading and each control's (and fault's) upper one.
    ``control_seeds``: {control or fault: [seed, ...]}."""
    import torch
    from portbench.lib import harness

    seen = {}
    orig_check = harness.check_answers

    def keep_all(*a, **kw):          # every number, the breakdown too
        out = orig_check(*a, **kw)
        seen["numbers"] = dict(out)
        return out

    harness.check_answers = keep_all
    runs = []
    groups = [(None, seeds)] + list(control_seeds.items())
    try:
        for ctrl, group in groups:
            for seed in group:
                ctx = control(ctrl) if ctrl else contextlib.nullcontext()
                with ctx:
                    res, notes = harness.run_cell(cell, seed, seconds, False,
                                                  device, time.monotonic())
                row = {"seed": seed, "control": ctrl,
                       "correct": res["correct"],
                       "checked": notes.get("checked"),
                       "attempted": res["attempted"], "failed": res["failed"],
                       "checks": {k: v["value"]
                                  for k, v in res["checks"].items()},
                       "numbers": seen.pop("numbers", {}),
                       "steps": notes.get("steps"),
                       "step_s": notes.get("step_s")}
                log(json.dumps(row))
                runs.append(row)
                del res, notes
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        harness.check_answers = orig_check
    summary = {}
    for name in harness.limits_of(cell):
        prog = [r["checks"][name] for r in runs if r["control"] is None]
        entry = {"lower": max(prog) if prog else None}
        for c in control_seeds:
            ups = [r["checks"][name] for r in runs if r["control"] == c]
            entry[c] = min(ups) if ups else None
        summary[name] = entry
    return runs, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=0)
    ap.add_argument("--control-seeds", type=int, default=2)
    ap.add_argument("--fault-seeds", type=int, default=1)
    ap.add_argument("--controls", default=",".join(CONTROLS + FAULTS))
    ap.add_argument("--first-seed", type=int, default=3_100_000_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib import harness

    harness.cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control_model.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = harness.load_cell(args.workload, ROOT)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    cseeds, nxt = {}, len(seeds)
    for c in args.controls.split(","):
        if c not in CONTROLS + FAULTS:
            ap.error(f"no control or fault {c!r}")
        n = args.control_seeds if c in CONTROLS else args.fault_seeds
        cseeds[c] = [args.first_seed + 7919 * (nxt + k) for k in range(n)]
        nxt += n
    runs, summary = readings(cell, seeds, cseeds, args.seconds, dev)
    out = {"workload": args.workload, "seconds": args.seconds,
           "device": torch.cuda.get_device_name(0), "runs": runs,
           "summary": summary, "wall_s": time.monotonic() - T_START}
    print(json.dumps({"summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
