"""Shared harness of the training parity tests (``test_torch_train.py``,
``test_torch_train_step.py``): reduced models with the reference's
parameters carried across, batches from both packages' pipelines, the
gradients of each package in the port's leaf order.

Not a test module itself (no ``test_`` prefix); the test files import it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import pipeline as JD
from repro.models import model as JM
from repro.train import train_step as JT
from repro_torch.data import pipeline as TD
from repro_torch.models import model as TM
from repro_torch.models import weights as W
from repro_torch.train import train_step as TT

from _model_parity import cfgs

# float32 compute: float32 sums in another order through a few layers
# and their backward (the largest gradient deviation seen is ~3e-6 of
# the leaf's scale); atol is relative to each leaf's largest entry
LOSS = dict(rtol=1e-5, atol=0.0)
GRAD = dict(rtol=1e-4, atol=1e-4)
# make_train_step's loss, grad_norm and lr at each step
STEP = dict(rtol=1e-5, atol=0.0)
LR, WARMUP, TOTAL = 1e-3, 2, 10


def params_pair(jc, seed=0):
    """(reference params, the port's copy of them on the CPU)."""
    jp = JM.init_params(jc, jax.random.key(seed))
    return jp, W.params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def batch_pair(jc, tc, seq_len, batch, seed, step):
    """The same batch from each package's ``synthetic_batch``."""
    jb = JD.synthetic_batch(jc, seq_len, batch, seed=seed, step=step)
    tb = TD.synthetic_batch(tc, seq_len, batch, seed=seed, step=step)
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.as_tensor(v) for k, v in tb.items()})


def ref_leaves(tree):
    """A reference tree (params or grads) as the port's leaves, in
    ``TM.leaves`` order."""
    return TM.leaves(W.params_from_reference(
        jax.tree.map(np.asarray, tree), device="cpu"))


def port_value_and_grad(tp, tc, tb):
    views = TM.map_params(lambda p: p.detach().requires_grad_(True), tp)
    loss = TM.loss_fn(views, tc, tb)
    return loss.detach(), torch.autograd.grad(loss, TM.leaves(views))


def assert_grads_close(got, want, tol):
    """Each leaf within ``tol["rtol"]`` and ``tol["atol"]`` times the
    leaf's largest reference entry."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale,
                                   err_msg=f"leaf {i}")


def check_loss_and_grads(arch, router):
    """``loss_fn`` and every gradient leaf of one reduced model against
    the reference's jitted ``value_and_grad``, on the same batch; both
    packages' ``COMPUTE_DTYPE`` must be set (the tests' fixtures)."""
    jc, tc = cfgs(arch, router)
    jp, tp = params_pair(jc)
    jb, tb = batch_pair(jc, tc, 20, 2, seed=1, step=3)
    want, gj = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jc, b)))(jp, jb)
    got, gt = port_value_and_grad(tp, tc, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **LOSS)
    assert_grads_close(gt, ref_leaves(gj), GRAD)


def _ref_grads(jc, jp, jb, grad_accum):
    """The reference's loss and gradient over the micro-batches, as its
    step computes them."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jc, b)))
    micro = jax.tree.map(
        lambda x: x.reshape((grad_accum, x.shape[0] // grad_accum)
                            + x.shape[1:]), jb)
    loss, grads = 0.0, None
    for i in range(grad_accum):
        l_, g = vg(jp, jax.tree.map(lambda x: x[i], micro))
        loss = loss + l_
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return loss / grad_accum, jax.tree.map(lambda g: g / grad_accum, grads)


def check_train_step(arch, router, grad_accum):
    """Three steps of ``make_train_step`` against the reference's jitted
    step (see ``test_torch_train_step.py`` for the tolerances); both
    packages' ``COMPUTE_DTYPE`` must be set (the tests' fixtures)."""
    jc, tc = cfgs(arch, router)
    jc, tc = jc.with_(num_layers=2), tc.with_(num_layers=2)
    jp, tp = params_pair(jc)
    kw = dict(lr=LR, warmup=WARMUP, total_steps=TOTAL,
              grad_accum=grad_accum)
    j_init, j_step = JT.make_train_step(jc, **kw)
    t_init, t_step = TT.make_train_step(tc, **kw)
    jo, to = j_init(jp), t_init(tp)
    lrs = []
    for step in range(3):
        jb, tb = batch_pair(jc, tc, 16, 4, seed=0, step=step)
        if step == 0:
            want, gj = _ref_grads(jc, jp, jb, grad_accum)
            got, gt = TT.value_and_grad(TT.make_loss(tc), tp, tb,
                                        grad_accum)
            np.testing.assert_allclose(float(got), float(want), **LOSS)
            assert_grads_close(gt, ref_leaves(gj), GRAD)
        jp, jo, jm = j_step(jp, jo, jb)
        tp2, to, tm = t_step(tp, to, tb)
        assert tp2 is tp                      # updated in place
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **STEP,
                                       err_msg=f"step {step} {k}")
        lrs.append(float(tm["lr"]))
        assert int(to.step) == int(jo.step) == step + 1
    ref, got = ref_leaves(jp), TM.leaves(tp)
    diff = [(g - r).abs() for g, r in zip(got, ref)]
    n = sum(d.numel() for d in diff)
    off = sum(int((d > 1e-5).sum()) for d in diff)
    assert off <= 5e-4 * n, (off, n)
    assert max(float(d.max()) for d in diff) <= 2 * sum(lrs)
