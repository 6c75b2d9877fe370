"""repro_torch's ``train.train_step.make_train_step`` against the JAX
reference's jitted step, at reduced size on the CPU in float32 compute,
with the reference's parameters carried across (dense llama here, the
MoE model under ``pushrelabel`` in ``test_torch_train_step_moe.py``).

Three steps with ``grad_accum`` 1 and 2 on the pipelines' batches:
``loss``, ``grad_norm`` and ``lr`` at each step within rtol 1e-5; the
first step's loss and gradient (over the micro-batches) within
``_train_parity.LOSS`` / ``GRAD`` before the optimizer. The parameters
after the three steps: AdamW's first update is about sign(g) * lr, so a
gradient entry at rounding level may flip its update between the
packages. The allowance: every entry within 1e-5 (1 % of the peak lr)
except at most 0.05 % of the entries, and those within twice the summed
learning rates (a flipped sign at every step). The largest deviation
seen is 3.8e-5 on 88 of 575 104 entries, no flip.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.train import train_step as TT

from _train_parity import batch_pair, cfgs, check_train_step


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_equals_reference(grad_accum, f32_compute):
    check_train_step("llama3.2-3b", None, grad_accum)


def test_value_and_grad_splits_rows_into_contiguous_micro_batches(
        f32_compute):
    """grad_accum = 2: the mean of the two halves' losses and grads."""
    _, tc = cfgs("llama3.2-3b", None)
    tc = tc.with_(num_layers=2)
    tp = TM.init_params(tc, seed=1, device="cpu")
    _, tb = batch_pair(*cfgs("llama3.2-3b", None), 12, 4, seed=1, step=0)
    loss_fn = TT.make_loss(tc)
    both, g2 = TT.value_and_grad(loss_fn, tp, tb, 2)
    halves = [TT.value_and_grad(loss_fn, tp, {k: v[i:i + 2]
                                               for k, v in tb.items()})
              for i in (0, 2)]
    assert float(both) == pytest.approx(
        0.5 * (float(halves[0][0]) + float(halves[1][0])), rel=1e-6)
    for g, a, b in zip(g2, halves[0][1], halves[1][1]):
        torch.testing.assert_close(g, 0.5 * (a + b), rtol=1e-6, atol=1e-7)
