"""repro_torch's ``loss_fn`` and every gradient leaf against the JAX
reference for the MoE model under both routers (``pushrelabel`` runs
``fused_ot_phases``' plain version on the CPU; its gates' backward is the
port's deterministic gather) and the audio model (frames through the
encoder), at reduced size on the CPU in float32 compute, within
``_train_parity.LOSS`` / ``GRAD``. The other models are in
``test_torch_train.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models import model as JM
from repro_torch.models import model as TM

from _train_parity import check_loss_and_grads


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch,router", [("deepseek-moe-16b", "topk"),
                                         ("deepseek-moe-16b",
                                          "pushrelabel"),
                                         ("seamless-m4t-medium", None)])
def test_loss_and_grads_equal_reference(arch, router, f32_compute):
    check_loss_and_grads(arch, router)
