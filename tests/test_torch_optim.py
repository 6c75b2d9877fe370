"""repro_torch's optimizers (``optim.optimizer``) against the JAX
reference (``repro.optim.optimizer``), on the CPU.

The same arrays, drawn with numpy from a seed, go through both packages.
Tolerance: 1e-6 (absolute and relative) for the updates and the
schedule, float32 elementwise arithmetic that XLA may fuse (an FMA
rounds once where torch rounds twice); the int8 compressor's q and
scale, and the factored state's shapes, must be equal. The port updates
in place, so every call gets its own copies. The reference's own cases
(quadratic convergence, factored shapes, clipping, the schedule's shape,
error feedback) run on the port as well.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.optim import optimizer as J
from repro_torch.optim import optimizer as T

TOL = dict(atol=1e-6, rtol=1e-6)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "stack": [rng.normal(size=(3, 4, 2)).astype(np.float32)]}


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_updates_equal_reference_over_five_steps(opt):
    init_j, upd_j = J.OPTIMIZERS[opt]
    init_t, upd_t = T.OPTIMIZERS[opt]
    pj = jax.tree.map(jnp.asarray, _arrays(0))
    pt = _torch(_arrays(0))
    sj, st = init_j(pj), init_t(pt)
    rng = np.random.default_rng(1)
    for step in range(5):
        g = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), _arrays(0))
        lr = np.float32(1e-2 * (step + 1))
        pj, sj = upd_j(pj, jax.tree.map(jnp.asarray, g), sj, jnp.float32(lr))
        pt, st = upd_t(pt, _torch(g), st, torch.tensor(lr))
        assert int(st.step) == int(sj.step) == step + 1
        for a, b in zip(jax.tree.leaves(_np(pj)),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     pt))):
            np.testing.assert_allclose(b, a, **TOL)
    moments = [x for x in (st.m, st.v) if x is not None]
    ref = [x for x in (sj.m, sj.v) if x is not None]
    for a, b in zip(jax.tree.leaves(_np(ref)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 moments))):
        np.testing.assert_allclose(b, a, **TOL)


def test_cosine_schedule_every_step_equals_reference():
    """Within 1e-6 relative, or 1e-6 of the base rate near the end of
    the decay, where ``1 + cos(pi t)`` cancels: one float32 ulp of the
    cosine there moves the value by ~6e-8 of the base rate."""
    lj = J.cosine_schedule(1e-3, warmup=10, total=100)
    lt = T.cosine_schedule(1e-3, warmup=10, total=100)
    for s in range(0, 121):
        got = float(lt(torch.tensor(s, dtype=torch.int32)))
        want = float(lj(jnp.int32(s)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6 * 1e-3), s


def test_clip_by_global_norm_equals_reference():
    rng = np.random.default_rng(3)
    for scale in (0.01, 10.0):
        g = {"a": (scale * rng.normal(size=(7, 3))).astype(np.float32),
             "b": [(scale * rng.normal(size=(4,))).astype(np.float32)]}
        cj, nj = J.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        ct, nt = T.clip_by_global_norm(_torch(g), 1.0)
        assert float(nt) == pytest.approx(float(nj), rel=1e-6)
        for a, b in zip(jax.tree.leaves(_np(cj)),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     ct))):
            assert b.dtype == np.float32
            np.testing.assert_allclose(b, a, **TOL)


def test_clip_by_global_norm_scales_float32_in_place_and_copies_bf16():
    g32 = torch.full((10,), 10.0)
    g16 = torch.full((4,), 3.0, dtype=torch.bfloat16)
    clipped, norm = T.clip_by_global_norm({"a": g32, "b": g16}, 1.0)
    assert clipped["a"] is g32
    assert clipped["b"].dtype == torch.float32
    assert g16.float().eq(3.0).all()
    assert float(norm) == pytest.approx(np.sqrt(1000.0 + 36.0), rel=1e-6)


def test_compress_int8_equals_reference():
    rng = np.random.default_rng(4)
    g = rng.normal(size=(64,)).astype(np.float32)
    err = (1e-3 * rng.normal(size=(64,))).astype(np.float32)
    for e in (None, err):
        qj, sj, ej = J.compress_int8(jnp.asarray(g),
                                     None if e is None else jnp.asarray(e))
        qt, st, et = T.compress_int8(torch.tensor(g),
                                     None if e is None else torch.tensor(e))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert float(st) == float(sj)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), **TOL)
        np.testing.assert_array_equal(
            T.decompress_int8(qt, st).numpy(),
            np.asarray(J.decompress_int8(qj, sj)))


def test_make_optimizer_reads_the_schedule_at_the_state_step():
    lr_fn = T.cosine_schedule(1e-2, warmup=3, total=10)
    init, step = T.make_optimizer("adamw", lr_fn)
    p = {"w": torch.ones(3)}
    s = init(p)
    g = {"w": torch.ones(3)}
    before = p["w"].clone()
    p2, s = step(p, g, s)
    assert p2["w"] is p["w"]          # in place
    # first AdamW step: u = g / (|g| + eps) ~ 1, plus decay 0.1 * p
    want = before - float(lr_fn(torch.tensor(0))) * (1.0 + 0.1)
    np.testing.assert_allclose(p["w"].numpy(), want.numpy(), rtol=1e-6)
    assert int(s.step) == 1


# -- the reference's own cases, on the port ------------------------------

def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.5]),
            "b": torch.tensor([[1.0, -1.0]] * 2)}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_converges_on_quadratic(opt):
    params = _quadratic_params()
    init, update = T.OPTIMIZERS[opt]
    state = init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    for _ in range(300):
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        gs = torch.autograd.grad(loss(ps), list(ps.values()))
        params, state = update(params, dict(zip(ps, gs)), state,
                               torch.tensor(0.05), wd=0.0)
    assert float(loss(params)) < 1e-2


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((64, 32)), "v": torch.zeros((7,))}
    st = T.adafactor_init(params)
    ref = J.adafactor_init({"w": jnp.zeros((64, 32)), "v": jnp.zeros((7,))})
    assert st.m is None and ref.m is None
    assert st.v["w"][0].shape == (64,)
    assert st.v["w"][1].shape == (32,)
    assert st.v["v"][0].shape == (7,)
    assert [tuple(x.shape) for x in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), st.v))] == [
        x.shape for x in jax.tree.leaves(ref.v)]
    n_state = sum(x.numel() for x in (*st.v["w"], *st.v["v"]))
    assert n_state == 64 + 32 + 7


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = T.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0))
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in clipped.values()))
    assert float(total) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape():
    lr = T.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) < 1e-3 / 5
    assert float(lr(torch.tensor(10, dtype=torch.int32))) == pytest.approx(
        1e-3, rel=0.1)
    assert float(lr(torch.tensor(100, dtype=torch.int32))) < 1e-5 + 1e-9


def test_int8_error_feedback_is_unbiased_over_steps():
    rng = np.random.default_rng(0)
    g_true = torch.tensor(rng.standard_normal(512).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc_true = np.zeros(512)
    acc_deq = np.zeros(512)
    for step in range(50):
        g = g_true * (1.0 + 0.1 * step)
        q, scale, err = T.compress_int8(g, err)
        acc_true += g.numpy()
        acc_deq += T.decompress_int8(q, scale).numpy()
    resid = np.abs(acc_true - acc_deq).max()
    assert resid <= float(scale) * 2.0
