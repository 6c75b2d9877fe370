"""Shared harness of the model parity tests
(``test_torch_model_stack.py``, ``test_torch_model_bf16.py``): the
models, the carried weights, prefill then decode in each package.

Not a test module itself (no ``test_`` prefix); the test files import it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro_torch.configs import registry as treg
from repro_torch.models import model as TM

F32 = dict(atol=2e-4, rtol=1e-4)
BF16 = dict(atol=0.15, rtol=0.15)      # the reference's decode tolerance

# (arch, router): every family and input mode the Engine serves
MODELS = [("qwen3-4b", None), ("llama3.2-3b", None),
          ("deepseek-moe-16b", "topk"), ("deepseek-moe-16b", "pushrelabel"),
          ("mamba2-2.7b", None), ("jamba-1.5-large-398b", None),
          ("seamless-m4t-medium", None), ("llava-next-mistral-7b", None)]


def cfgs(arch, router):
    jc, tc = jreg.reduced(jreg.ARCHS[arch]), treg.reduced(treg.ARCHS[arch])
    if router:
        jc, tc = jc.with_(router=router), tc.with_(router=router)
    return jc, tc


def make_batch(cfg, rng, b, s):
    out = {"tokens": rng.integers(0, 500, size=(b, s)).astype(np.int32)}
    if cfg.input_mode == "frames":
        out["frames"] = rng.normal(size=(b, 10, cfg.d_model)).astype(
            np.float32)
    if cfg.input_mode == "tokens+patches":
        out["patches"] = rng.normal(
            size=(b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return out


def run_ref(jp, jc, batch, n_steps, max_len):
    """Reference: prefill of all but the last token, then decode steps
    teacher-forced with the batch's last token and then the argmax."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    prefill = jax.jit(lambda p, b: JM.prefill(p, jc, b))
    decode = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jc, c, t, pos))
    _, full = prefill(jp, jb)
    caches, _ = prefill(jp, {**jb, "tokens": jb["tokens"][:, :-1]})
    caches = JM.pad_caches(jc, caches, max_len)
    pos = batch["tokens"].shape[1] - 1 + jc.num_patch_tokens * (
        jc.input_mode == "tokens+patches")
    tok, steps = jb["tokens"][:, -1:], []
    for i in range(n_steps):
        lg, caches = decode(jp, caches, tok, jnp.int32(pos + i))
        steps.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    return np.asarray(full, np.float32), steps


def run_port(tp, tc, batch, n_steps, max_len, forced=None):
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, full = TM.prefill(tp, tc, tb)
    caches, _ = TM.prefill(tp, tc, {**tb, "tokens": tb["tokens"][:, :-1]})
    caches = TM.pad_caches(tc, caches, max_len)
    pos = batch["tokens"].shape[1] - 1 + tc.num_patch_tokens * (
        tc.input_mode == "tokens+patches")
    tok, steps = tb["tokens"][:, -1:], []
    for i in range(n_steps):
        lg, caches = TM.decode_step(tp, tc, caches, tok, pos + i)
        steps.append(lg.float().numpy())
        # teacher-forced with the reference's tokens where given
        nxt = torch.argmax(lg, -1) if forced is None else torch.as_tensor(
            forced[i].argmax(-1))
        tok = nxt[:, None].to(torch.int32)
    return full.float().numpy(), steps


def no_drops(jc, tc):
    """MoE configs with nothing dropped (see the module docstring)."""
    if not jc.num_experts or jc.router == "pushrelabel":
        return jc, tc
    return (jc.with_(capacity_factor=float(jc.num_experts)),
            tc.with_(capacity_factor=float(tc.num_experts)))
