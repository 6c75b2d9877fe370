"""repro_torch's ``make_train_step`` on the MoE model under the
``pushrelabel`` router against the JAX reference's jitted step, with
``grad_accum`` 1 and 2; the checks and tolerances of
``test_torch_train_step.py`` (``_train_parity.check_train_step``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models import model as JM
from repro_torch.models import model as TM

from _train_parity import check_train_step


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_equals_reference(grad_accum, f32_compute):
    check_train_step("deepseek-moe-16b", "pushrelabel", grad_accum)
