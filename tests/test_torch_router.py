"""repro_torch's MoE routers and dispatch against the JAX reference
(``repro.models.moe``), on the CPU.

``pushrelabel_assign`` is one ``ops.fused_run_ot_phases`` call (its plain
version on the CPU); its flow must be bit-equal to the reference's
jitted ``fori_loop`` over ``transport._phase`` (jitted, as ``Engine``
runs it: XLA may rewrite the cost quantization) and to a chain of the
port's stepped ``core.transport._phase``. Gates are float32 softmax
values of the same selection: within 1e-6. The dispatch is integer
bookkeeping and copies: exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import moe as JM
from repro_torch.configs import registry as treg
from repro_torch.core import transport as TT
from repro_torch.models import moe as TM

GATES = dict(atol=1e-6, rtol=0)


def _logits(kind, t, e, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(t, e)).astype(np.float32)
    if kind == "skewed":        # one hot expert, as the reference's test
        return np.concatenate([np.full((t, 1), 5.0, np.float32),
                               rng.normal(size=(t, e - 1)).astype(np.float32)
                               ], axis=1)
    # ties: logits on a coarse grid, so many entries quantize alike
    return (rng.integers(-3, 4, size=(t, e)) * 0.5).astype(np.float32)


# (kind, T, E, k): reduced shapes (E = 8), deepseek's router (E = 64,
# k = 6) at a prefill of 256 tokens and a decode of 4, ties, skew
ROUTER_CASES = [
    ("normal", 64, 8, 2), ("normal", 100, 8, 2), ("ties", 48, 8, 2),
    ("skewed", 512, 8, 1), ("skewed", 96, 8, 2), ("normal", 256, 64, 6),
    ("normal", 4, 64, 6), ("ties", 37, 16, 6),
]


@pytest.mark.parametrize("case", ROUTER_CASES)
def test_pushrelabel_assign_bit_equal_to_jitted_reference(case):
    kind, t, e, k = case
    lg = _logits(kind, t, e, t * e + k)
    cap = -(-t * k // e)
    want = np.asarray(jax.jit(
        lambda a: JM.pushrelabel_assign(a, k, cap, phases=24))(
            jnp.asarray(lg)))
    got = TM.pushrelabel_assign(torch.as_tensor(lg), k, cap, phases=24)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's quantized costs, jitted, are the port's
    c_j = np.asarray(jax.jit(lambda a: jnp.clip(jnp.floor(
        (jnp.max(a) - a) / jnp.maximum(jnp.max(a) - jnp.min(a), 1e-9)
        * 16).astype(jnp.int32), 0, 16))(jnp.asarray(lg)))
    np.testing.assert_array_equal(TM.router_costs(torch.as_tensor(lg))
                                  .numpy(), c_j)


@pytest.mark.parametrize("case", ROUTER_CASES[:5])
def test_pushrelabel_assign_equals_stepped_phase_chain(case):
    """The same phases through the port's stepped core, one ``_phase`` at
    a time (a host flag a round), from the router's start state."""
    kind, t, e, k = case
    lg = torch.as_tensor(_logits(kind, t, e, t * e + k))
    cap = -(-t * k // e)
    c_int = TM.router_costs(lg)[None].contiguous()
    state = TM.router_state(t, e, k, cap, "cpu")
    lanes = torch.ones((1,), dtype=torch.bool)
    for _ in range(24):
        state, ran = TT._phase(c_int, state, 8, lanes)
        assert ran
    flow = TM.pushrelabel_assign(lg, k, cap, phases=24)
    assert torch.equal(flow, (state.f_hi + state.f_lo)[0])
    assert int(state.phases) == 24


@pytest.mark.parametrize("router", ["topk", "sinkhorn", "pushrelabel"])
@pytest.mark.parametrize("case", ROUTER_CASES)
def test_routers_equal_reference(router, case):
    kind, t, e, k = case
    lg = _logits(kind, t, e, t + e + k)
    sel_j, g_j = jax.jit(lambda a: JM.ROUTERS[router](a, k))(jnp.asarray(lg))
    sel_t, g_t = TM.ROUTERS[router](torch.as_tensor(lg), k)
    assert sel_t.dtype == torch.int32 and g_t.dtype == torch.float32
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GATES)


def test_pushrelabel_router_balances_skewed_logits():
    """On adversarially skewed logits top-k collapses onto one expert;
    the paper's balanced-assignment router caps every expert at capacity
    (the reference's test of the same name, on the port)."""
    t, e, k = 512, 8, 1
    lg = torch.as_tensor(_logits("skewed", t, e, 0))
    sel_t, _ = TM.route_topk(lg, k)
    sel_p, _ = TM.route_pushrelabel(lg, k)
    load_t = np.bincount(sel_t.numpy().ravel(), minlength=e)
    load_p = np.bincount(sel_p.numpy().ravel(), minlength=e)
    assert load_t.max() > 0.9 * t          # collapse
    assert load_p.max() <= t / e + 1       # balanced to capacity


# (T, k, E, e0, e_loc, cap): every expert local; a shard of experts;
# a capacity that drops entries
DISPATCH_CASES = [(24, 2, 8, 0, 8, 8), (24, 2, 8, 2, 4, 8), (40, 3, 8, 0, 8, 4),
                  (9, 6, 16, 4, 8, 2)]


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_dispatch_local_exactly_equal(case):
    t, k, e, e0, e_loc, cap = case
    rng = np.random.default_rng(t * k + e0)
    tokens = rng.normal(size=(t, 16)).astype(np.float32)
    sel = rng.integers(0, e, size=(t, k)).astype(np.int32)
    gates = rng.uniform(size=(t, k)).astype(np.float32)
    want = JM._dispatch_local(jnp.asarray(tokens), jnp.asarray(sel),
                              jnp.asarray(gates), e0, e_loc, cap)
    got = TM._dispatch_local(torch.as_tensor(tokens), torch.as_tensor(sel),
                             torch.as_tensor(gates), e0, e_loc, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("router", ["topk", "pushrelabel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_equals_reference(router, dtype):
    """One MoE layer (shared experts included) on the same input: the
    same selection; float32 within 1e-5, bf16 within one bf16 step of the
    outputs' magnitude (4: 0.03125), the expert products being bf16
    matmuls in both packages."""
    cfg = jreg.reduced(jreg.ARCHS["deepseek-moe-16b"]).with_(router=router)
    tcfg = treg.reduced(treg.ARCHS["deepseek-moe-16b"]).with_(router=router)
    rng = np.random.default_rng(11)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    sh = cfg.num_shared_experts * ff
    p = {"router": rng.normal(size=(d, e)) * 0.02,
         "w_gate": rng.normal(size=(e, d, ff)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, ff)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, ff, d)) / np.sqrt(ff),
         "shared": {"w_gate": rng.normal(size=(d, sh)) / np.sqrt(d),
                    "w_up": rng.normal(size=(d, sh)) / np.sqrt(d),
                    "w_down": rng.normal(size=(sh, d)) / np.sqrt(sh)}}
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32).astype(jd), p)
    pt = jax.tree.map(lambda a: torch.as_tensor(np.asarray(
        a, np.float32)).to(td), p)
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TTr
    want = jax.jit(lambda pp, xx: JT.apply_moe(pp, cfg, xx))(
        pj, jnp.asarray(x).astype(jd))
    got = TTr.apply_moe(pt, tcfg, torch.as_tensor(x).to(td))
    assert got.dtype == td
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=0.03125, rtol=0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_load_balance_stats_equal_reference():
    rng = np.random.default_rng(2)
    sel = rng.integers(0, 8, size=(50, 2)).astype(np.int32)
    lg = rng.normal(size=(50, 8)).astype(np.float32)
    want = JM.load_balance_stats(jnp.asarray(lg), jnp.asarray(sel), 8)
    got = TM.load_balance_stats(torch.as_tensor(lg), torch.as_tensor(sel), 8)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6)
