"""repro_torch's training loss (``models.layers.cross_entropy_chunked``,
``models.model.loss_fn``) and its gradients against the JAX reference,
at reduced size on the CPU, with the reference's parameters carried
across (``models.weights``).

Float32 compute (both packages' ``COMPUTE_DTYPE`` set to float32, the
``f32_compute`` fixture): the loss and every gradient leaf within
``_train_parity.LOSS`` / ``GRAD`` (see there).
The chunked CE alone within 1e-6. Remat on and off: equal loss and
gradients within 1e-6 (backward sums its contributions in another
order), and the router runs again in the recompute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

from _train_parity import (assert_grads_close, batch_pair, cfgs,
                           check_loss_and_grads, port_value_and_grad)

CE = dict(rtol=1e-6, atol=1e-6)

# the models of the loss test here: dense, SSM (autograd through
# ssd_scan), the patch prefix in the labels; the MoE routers and the
# audio encoder are in test_torch_train_moe.py (the file's time budget)
LOSS_MODELS = [("llama3.2-3b", None), ("mamba2-2.7b", None),
               ("llava-next-mistral-7b", None)]


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


# -- cross_entropy_chunked ---------------------------------------------------

def _ce_inputs(seed, b, s, d, v, masked):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (0.3 * rng.normal(size=(d, v))).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    if masked:
        mask[:, :3] = 0.0
        mask[0, -2:] = 0.0
    return x, head, labels, mask


@pytest.mark.parametrize("s,chunk,masked", [(13, 5, False), (13, 5, True),
                                            (8, 4, True), (6, 512, False)])
def test_cross_entropy_chunked_equals_reference(s, chunk, masked):
    """S not a multiple of the chunk (padded, masked), masked positions,
    a chunk larger than S; the value and the gradients of x and the
    head."""
    x, head, labels, mask = _ce_inputs(s, 2, s, 8, 37, masked)

    def ref(x_, h_):
        return JL.cross_entropy_chunked(lambda xc: xc @ h_, x_,
                                        jnp.asarray(labels),
                                        jnp.asarray(mask), chunk=chunk)
    want, (gx, gh) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    xt = torch.tensor(x, requires_grad=True)
    ht = torch.tensor(head, requires_grad=True)
    got = TL.cross_entropy_chunked(lambda xc: xc @ ht, xt,
                                   torch.tensor(labels), torch.tensor(mask),
                                   chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **CE)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **CE)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **CE)


def test_cross_entropy_all_masked_is_zero():
    x, head, labels, _ = _ce_inputs(1, 2, 7, 4, 11, False)
    mask = np.zeros((2, 7), np.float32)
    got = TL.cross_entropy_chunked(lambda xc: xc @ torch.tensor(head),
                                   torch.tensor(x), torch.tensor(labels),
                                   torch.tensor(mask), chunk=3)
    want = JL.cross_entropy_chunked(lambda xc: xc @ jnp.asarray(head),
                                    jnp.asarray(x), jnp.asarray(labels),
                                    jnp.asarray(mask), chunk=3)
    assert float(got) == float(want) == 0.0


def test_cross_entropy_keeps_no_chunk_logits_for_backward():
    """Under grad each chunk is checkpointed: what autograd saves holds
    no (B, chunk, V) logits, only the inputs (the reference's memory
    contract: the (B, S, V) logits never exist whole)."""
    b, s, d, v, chunk = 2, 16, 4, 97, 4
    x, head, labels, mask = _ce_inputs(2, b, s, d, v, False)
    xt = torch.tensor(x, requires_grad=True)
    ht = torch.tensor(head, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TL.cross_entropy_chunked(lambda xc: xc @ ht, xt,
                                        torch.tensor(labels),
                                        torch.tensor(mask), chunk=chunk)
    assert max(saved) < b * chunk * v
    loss.backward()
    assert xt.grad is not None and ht.grad is not None


# -- loss_fn and every gradient leaf -----------------------------------------

@pytest.mark.parametrize("arch,router", LOSS_MODELS)
def test_loss_and_grads_equal_reference(arch, router, f32_compute):
    check_loss_and_grads(arch, router)


# -- remat ---------------------------------------------------------------------

@pytest.mark.parametrize("arch,router", [("llama3.2-3b", None),
                                         ("deepseek-moe-16b",
                                          "pushrelabel")])
def test_remat_on_and_off_equal(arch, router, f32_compute, monkeypatch):
    _, tc = cfgs(arch, router)
    tp = TM.init_params(tc, seed=3, device="cpu")
    _, tb = batch_pair(*cfgs(arch, router), 16, 2, seed=2, step=1)
    calls = []
    orig = TMOE.pushrelabel_assign

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(TMOE, "pushrelabel_assign", counted)
    out = {}
    for remat in (True, False):
        calls.clear()
        out[remat] = port_value_and_grad(tp, tc.with_(remat=remat), tb)
        out[remat] += (len(calls),)
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]),
                               rtol=1e-6)
    assert_grads_close(out[True][1], out[False][1],
                       dict(rtol=1e-6, atol=1e-6))
    n_moe = tc.num_layers - tc.first_dense_layers if tc.num_experts else 0
    # the router runs in the forward and again in the recompute
    assert out[True][2] == 2 * n_moe and out[False][2] == n_moe
    # no recompute without grad: serving is unchanged
    calls.clear()
    with torch.inference_mode():
        TM.loss_fn(tp, tc, tb)
    assert len(calls) == n_moe
