"""repro_torch's whole model (``models.model.prefill`` / ``decode_step``)
against the JAX reference at reduced size, with the reference's weights
carried across (``models.weights``), on the CPU.

Two precisions:

* float32 compute (both packages' ``COMPUTE_DTYPE`` set to float32): the
  mathematics, held to ``F32`` (atol 2e-4, rtol 1e-4: float32 sums in
  another order through a few layers). The routers see the same logits
  to ~1e-7, so they choose alike and the MoE models are held as tightly.
* bf16, as served (``test_torch_model_bf16.py``): dense, SSM, hybrid-free and frontend models within
  the reference's own bf16 tolerance (rtol = atol = 0.15,
  ``tests/test_models_smoke.py``). A MoE model's router chooses
  discretely from bf16 activations that differ in their last bit between
  the packages (XLA fuses elementwise chains in float32, torch rounds
  after each op), and a changed choice moves the logits by O(1); its
  bf16 run is held to the float32 comparison above and to the
  reference's decode-against-prefill check in the port (the reduced
  jamba fails that check in the reference itself, by 0.37).

Decode against prefill (the logits of the last token decoded after
prefilling the rest, against the prefill of all tokens) holds for a MoE
layer only where no token is dropped: ``moe_local_forward``'s capacity
``int(T k / E * 1.25) + 1`` differs between a prefill of T tokens and a
decode of B, and the last token is the first one dropped. So that check
runs MoE models with ``capacity_factor`` = E (nothing dropped) under the
per-token ``topk`` router; the ``pushrelabel`` router assigns all tokens
of a call jointly, so a decode of one token routes it by another
instance, and its check is the float32 comparison with the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import model as JM
from repro_torch.configs import registry as treg
from repro_torch.models import model as TM
from repro_torch.models import weights as W

from _model_parity import (F32, MODELS, cfgs, make_batch, no_drops, run_port,
                           run_ref)


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch,router", MODELS)
def test_prefill_decode_float32_equal_reference(arch, router, f32_compute):
    jc, tc = cfgs(arch, router)
    jp = JM.init_params(jc, jax.random.key(0))
    tp = W.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    batch = make_batch(jc, np.random.default_rng(1), 2, 20)
    full_j, steps_j = run_ref(jp, jc, batch, 2, 64)
    full_t, steps_t = run_port(tp, tc, batch, 2, 64, forced=steps_j)
    assert full_t.shape == (2, jc.vocab_padded)
    np.testing.assert_allclose(full_t, full_j, **F32)
    for got, want in zip(steps_t, steps_j):
        np.testing.assert_allclose(got, want, **F32)
    if not jc.num_experts:
        # decode of the last token after prefilling the rest = prefill
        np.testing.assert_allclose(steps_t[0], full_t, **F32)


def test_moe_decode_matches_prefill_without_drops(f32_compute):
    """The decode path through the caches of a MoE model, in float32,
    with nothing dropped: decode of the last token = its prefill."""
    jc, tc = no_drops(*cfgs("deepseek-moe-16b", "topk"))
    tp = TM.init_params(tc, seed=4, device="cpu")
    batch = make_batch(tc, np.random.default_rng(4), 2, 12)
    full_t, steps_t = run_port(tp, tc, batch, 1, 16)
    np.testing.assert_allclose(steps_t[0], full_t, **F32)


def test_weights_round_trip_and_layout():
    jc, tc = cfgs("jamba-1.5-large-398b", None)
    jp = jax.tree.map(np.asarray, JM.init_params(jc, jax.random.key(3)))
    tp = W.params_from_reference(jp, device="cpu")
    # one dict per period, the period axis unstacked
    assert len(tp["stages"]) == 1 and len(tp["stages"][0]) == 1
    assert sorted(tp["stages"][0][0]) == [f"l{i}" for i in range(8)]
    back = W.params_to_reference(tp)
    jl, jdef = jax.tree.flatten(jp)
    bl, bdef = jax.tree.flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's tree, shapes and dtypes
    mine = W.params_to_reference(TM.init_params(tc, seed=0, device="cpu"))
    ml, mdef = jax.tree.flatten(mine)
    assert mdef == jdef
    assert [a.shape for a in ml] == [a.shape for a in jl]


def test_init_params_bf16_is_cast_of_float32():
    """Built in bf16 from a seed = the float32 build from the same seed,
    cast: what the reference's per-call cast computes with."""
    tc = treg.reduced(treg.ARCHS["deepseek-moe-16b"])
    p32 = TM.init_params(tc, seed=5, device="cpu")
    p16 = TM.init_params(tc, seed=5, device="cpu", dtype=torch.bfloat16)
    for a, b in zip(TM.leaves(TM.cast_params(p32)), TM.leaves(p16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
