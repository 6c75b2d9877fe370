"""repro_torch's ``Engine`` (``serve/engine.py``) against the JAX
reference's ``Engine`` on the same requests and carried weights, on the
CPU, and the ``Engine`` lock-scan target.

Both engines left-pad with token 0, prefill once and decode greedily in
lockstep. ``prefill_len``, ``decode_steps`` and the completions' lengths
must be identical (``max_new_tokens=0`` and an eos hit included). Tokens
must be equal up to the first step at which the reference's top-2 logit
margin of that sequence is within the logits' tolerance (0.15
in bf16, the reference's own decode tolerance; 1e-3 under float32
compute): past a near-tie, the argmax may rightly differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.analysis.locks import default_targets, scan_lock_discipline
from repro_torch.configs import registry as treg
from repro_torch.models import model as TM
from repro_torch.models import weights as W
from repro_torch.serve.engine import Engine, Request

MAX_LEN = 32
# (prompt length, max_new_tokens): one request is done before any step
SHAPES = [(5, 6), (9, 0), (3, 7), (12, 5)]


def _ref_margins(jp, jc, prompts, n_steps):
    """The reference engine's own path, recording each step's top-2
    margin per sequence (over ``vocab_size``)."""
    b = len(prompts)
    plen = max(len(p) for p in prompts)
    toks = np.zeros((b, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    caches, logits = jax.jit(lambda p, bb: JM.prefill(p, jc, bb))(
        jp, {"tokens": jnp.asarray(toks)})
    caches = JM.pad_caches(jc, caches, MAX_LEN)
    decode = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jc, c, t, pos))
    margins = []
    for t in range(n_steps):
        lg = np.sort(np.asarray(logits, np.float32)[:, :jc.vocab_size], -1)
        margins.append(lg[:, -1] - lg[:, -2])
        cur = jnp.argmax(logits[:, :jc.vocab_size], -1)[:, None].astype(
            jnp.int32)
        logits, caches = decode(jp, caches, cur, jnp.int32(plen + t))
    return np.stack(margins, 1)                      # (B, steps)


def _serve(engine, req_cls, prompts, max_new, eos):
    for p, n, e in zip(prompts, max_new, eos):
        engine.submit(req_cls(prompt=p, max_new_tokens=n, eos_id=e))
    return engine.run_batch()


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


# (arch, router, precision): the served bf16 for a dense and an SSM model;
# the MoE routers under float32 compute (see test_torch_model_stack.py:
# a bf16 router's choices differ between the packages)
CASES = [("qwen3-4b", None, "bf16"), ("mamba2-2.7b", None, "bf16"),
         ("deepseek-moe-16b", "topk", "f32"),
         ("deepseek-moe-16b", "pushrelabel", "f32")]


@pytest.mark.parametrize("arch,router,precision", CASES)
def test_engine_equals_reference(arch, router, precision, request):
    if precision == "f32":
        request.getfixturevalue("f32_compute")
    margin_tol = 0.15 if precision == "bf16" else 1e-3
    jc, tc = jreg.reduced(jreg.ARCHS[arch]), treg.reduced(treg.ARCHS[arch])
    if router:
        jc, tc = jc.with_(router=router), tc.with_(router=router)
    jp = JM.init_params(jc, jax.random.key(1))
    tp = W.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=n).astype(np.int32)
               for n, _ in SHAPES]
    max_new = [m for _, m in SHAPES]
    steps = max(max_new)
    margins = _ref_margins(jp, jc, prompts, steps)
    safe = [int(np.argmax(np.append(m <= margin_tol, True))) for m in margins]

    # a first pass without eos finds a token to stop on: request 2's
    # token at a step before its first near-tie
    first = _serve(JEngine(jc, jp, max_len=MAX_LEN), JRequest, prompts,
                   max_new, [None] * 4)
    stop_at = min(2, max(safe[2] - 1, 0))
    eos = [None, None, int(first[2].tokens[stop_at]), None]

    want = _serve(JEngine(jc, jp, max_len=MAX_LEN), JRequest, prompts,
                  max_new, eos)
    engine = Engine(tc, tp, max_len=MAX_LEN, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in TM.leaves(engine.params)) \
        == (precision == "bf16")
    got = _serve(engine, Request, prompts, max_new, eos)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.prefill_len == w.prefill_len == max(len(p) for p in prompts)
        assert g.decode_steps == w.decode_steps, i
        assert len(g.tokens) == len(w.tokens) == g.decode_steps, i
        n = min(safe[i], g.decode_steps)
        np.testing.assert_array_equal(g.tokens[:n], w.tokens[:n],
                                      err_msg=f"request {i}")
        assert 0.0 < g.latency_s
    assert got[1].decode_steps == 0 and len(got[1].tokens) == 0
    if safe[2] > stop_at:
        # request 2 stops at the first step that gives its eos, before its
        # max_new_tokens
        hit = list(first[2].tokens).index(eos[2])
        assert got[2].decode_steps == hit + 1 < max_new[2]
        assert got[2].tokens[-1] == eos[2]


def test_engine_queue_and_limits():
    tc = treg.reduced(treg.ARCHS["qwen3-4b"])
    engine = Engine(tc, TM.init_params(tc, seed=2, device="cpu"), max_len=12,
                    device="cpu")
    assert engine.run_batch() == []
    engine.submit(Request(prompt=np.arange(1, 9, dtype=np.int32),
                          max_new_tokens=10))
    (c,) = engine.run_batch()
    # the cache holds 12 slots: a prompt of 8 leaves 4 decode steps
    assert c.prefill_len == 8 and c.decode_steps == 4
    assert engine.queue == []


def test_engine_targets_single_threaded_contract():
    by_class = {t.class_name: t for t in default_targets()}
    t = by_class["Engine"]
    assert t.lock_attr is None and t.fields == () and t.note
    assert t.path.endswith("repro_torch/serve/engine.py")
    assert scan_lock_discipline(t) == []
