"""repro_torch's whole model in bf16, as served, against the JAX
reference at reduced size with carried weights, on the CPU (see
``test_torch_model_stack.py`` for the float32 comparison and why a MoE
model's bf16 logits are held to the decode-against-prefill check only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.models import weights as W

from _model_parity import (BF16, MODELS, cfgs, make_batch, no_drops, run_port,
                           run_ref)


@pytest.mark.parametrize("arch,router", MODELS)
def test_prefill_decode_bf16(arch, router):
    jc, tc = no_drops(*cfgs(arch, router))
    jp = JM.init_params(jc, jax.random.key(0))
    tp = TM.cast_params(W.params_from_reference(jax.tree.map(np.asarray, jp),
                                                device="cpu"))
    assert all(t.dtype == torch.bfloat16 for t in TM.leaves(tp))
    batch = make_batch(jc, np.random.default_rng(2), 2, 16)
    full_j, steps_j = run_ref(jp, jc, batch, 1, 32)
    full_t, steps_t = run_port(tp, tc, batch, 1, 32)
    assert np.isfinite(full_t).all() and np.isfinite(steps_t[0]).all()
    if jc.router != "pushrelabel" or not jc.num_experts:
        np.testing.assert_allclose(steps_t[0], full_t, **BF16)
    if not jc.num_experts:
        np.testing.assert_allclose(full_t, full_j, **BF16)
        np.testing.assert_allclose(steps_t[0], steps_j[0], **BF16)
