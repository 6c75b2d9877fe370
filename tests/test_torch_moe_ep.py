"""The expert-parallel branch of ``repro_torch.models.transformer.apply_moe``
against the reference's ``shard_map`` branch, on the CPU.

The reference's branch needs a mesh of devices, so it runs once for the
module in a subprocess with 8 forced host devices (``XLA_FLAGS``), as
``tests/test_sharded_ot.py`` runs its mesh: reduced deepseek-moe-16b's
first MoE layer on meshes (1, 4), (2, 4) and (2, 2), routers ``topk``
and ``pushrelabel``, capacity factor 1.25, B = 4 (divisible by every
'dp' size) and B = 3 (replicated on a 'dp' size of 2), and
``value_and_grad(loss_fn)`` under (2, 2). The port runs the same inputs
on logical meshes of the CPU (``make_small_mesh(..., devices="cpu")``).

Two reference surfaces are not oracles (``ROADMAP.md``, reference
caveats): its branch fails under ``router="sinkhorn"`` (the varying-axes
check on the router's scan carry), so that router is held against the
reference's no-mesh ``apply_moe`` on each 'dp' shard; and its gradients
under the mesh differ, upstream of the last MoE layer's experts, from
the gradient of the same function computed without a mesh, so the
port's gradients are held against the latter (the loss and the last
layer's expert gradients against the mesh run too). All in float32
compute.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import registry as TR
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import sharding as S
from repro_torch.models import transformer as TT
from repro_torch.models import weights as W

from _train_parity import (GRAD, LOSS, assert_grads_close, batch_pair,
                           port_value_and_grad, ref_leaves)

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 4), (2, 4), (2, 2)]
BATCHES = [4, 3]
TOL = dict(rtol=0.0, atol=1e-5)
ARCH = "deepseek-moe-16b"

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import registry as R
from repro.data import pipeline as D
from repro.launch.mesh import make_small_mesh
from repro.models import model as M, sharding as S, transformer as T

M.COMPUTE_DTYPE = jnp.float32
out = {}
rng = np.random.default_rng(0)
xs = {b: rng.normal(size=(b, 16, 128)).astype(np.float32) for b in (4, 3)}
for b, x in xs.items():
    out[f"x{b}"] = x
for router in ("topk", "pushrelabel"):
    cfg = R.reduced(R.ARCHS["deepseek-moe-16b"]).with_(router=router)
    p = M.init_params(cfg, jax.random.key(0))
    moe = jax.tree.map(lambda a: a[0], p["stages"][1]["l0"]["moe"])
    for shape in ((1, 4), (2, 4), (2, 2)):
        S.set_mesh(make_small_mesh(shape, ("data", "model")))
        for b, x in xs.items():
            y = jax.jit(lambda m, xx: T.apply_moe(m, cfg, xx))(
                moe, jnp.asarray(x))
            out[f"{router}_{shape[0]}x{shape[1]}_b{b}"] = np.asarray(y)
        S.set_mesh(None)
cfg = R.reduced(R.ARCHS["deepseek-moe-16b"]).with_(router="pushrelabel")
p = M.init_params(cfg, jax.random.key(0))
b = {k: jnp.asarray(v) for k, v in
     D.synthetic_batch(cfg, 16, 4, seed=1, step=3).items()}
S.set_mesh(make_small_mesh((2, 2), ("data", "model")))
loss, g = jax.jit(jax.value_and_grad(lambda p, b: M.loss_fn(p, cfg, b)))(p, b)
S.set_mesh(None)
out["loss"] = np.asarray(loss)
for i, leaf in enumerate(jax.tree.leaves(g)):
    out[f"g{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's mesh branch, run once under 8 forced host
    devices."""
    path = tmp_path_factory.mktemp("ep") / "ref.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             # skip the TPU-backend probe
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TM, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture
def no_mesh(monkeypatch):
    """No mesh after the test, and the port's 'dp' / 'tp' as before it
    (``set_mesh(None)`` keeps them)."""
    monkeypatch.setattr(S, "_STATE", dict(S._STATE))
    yield
    S.set_mesh(None)


def _cfgs(router):
    return (JR.reduced(JR.ARCHS[ARCH]).with_(router=router),
            TR.reduced(TR.ARCHS[ARCH]).with_(router=router))


def _params(router):
    jc, tc = _cfgs(router)
    jp = JM.init_params(jc, jax.random.key(0))
    return jc, tc, jp, W.params_from_reference(jax.tree.map(np.asarray, jp),
                                               device="cpu")


def _moe_layer(tp):
    return tp["stages"][1][0]["l0"]["moe"]


def _mesh(shape, axes=("data", "model")):
    return make_small_mesh(shape, axes, devices="cpu")


def _port_mesh_moe(moe, tc, x, shape):
    S.set_mesh(_mesh(shape))
    try:
        return TT.apply_moe(moe, tc, torch.as_tensor(x))
    finally:
        S.set_mesh(None)


@pytest.mark.parametrize("router", ["topk", "pushrelabel"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("b", BATCHES)
def test_mesh_branch_equals_reference(ref, router, shape, b, no_mesh):
    _, tc, _, tp = _params(router)
    got = _port_mesh_moe(_moe_layer(tp), tc, ref[f"x{b}"], shape)
    want = ref[f"{router}_{shape[0]}x{shape[1]}_b{b}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reference_cases_drop_tokens(ref):
    """Capacity 1.25 drops tokens in the cases above: some 'dp' shard
    sends one expert more entries than its capacity."""
    _, tc, _, tp = _params("topk")
    moe = _moe_layer(tp)
    dropped = 0
    for shape in MESHES:
        x = torch.as_tensor(ref["x4"])
        for xs in torch.chunk(x, shape[0]):
            tokens = xs.reshape(-1, tc.d_model)
            sel, _ = TMOE.route_topk(tokens @ moe["router"], tc.top_k)
            t = tokens.shape[0]
            cap = int(t * tc.top_k / tc.num_experts * tc.capacity_factor) + 1
            load = torch.bincount(sel.reshape(-1).long(),
                                  minlength=tc.num_experts)
            dropped += int(torch.clamp(load - cap, min=0).sum())
    assert dropped > 0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("b", BATCHES)
def test_sinkhorn_mesh_branch_equals_reference_per_shard(ref, shape, b,
                                                         no_mesh):
    """The reference's branch fails under sinkhorn; its no-mesh
    ``apply_moe`` on each 'dp' shard (the whole batch when B does not
    divide) is the oracle."""
    jc, tc, jp, tp = _params("sinkhorn")
    x = ref[f"x{b}"]
    got = _port_mesh_moe(_moe_layer(tp), tc, x, shape)
    jmoe = jax.tree.map(lambda a: a[0], jp["stages"][1]["l0"]["moe"])
    f = jax.jit(lambda m, xx: JT.apply_moe(m, jc, xx))
    dp = shape[0] if b % shape[0] == 0 else 1
    want = np.concatenate([np.asarray(f(jmoe, jnp.asarray(xs)))
                           for xs in np.split(x, dp)])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _split_apply_moe(orig, dp):
    def split(p, cfg, x):
        return jnp.concatenate([orig(p, cfg, xs)
                                for xs in jnp.split(x, dp)], 0)
    return split


def test_loss_and_grads_under_mesh(ref, f32_compute, monkeypatch, no_mesh):
    """``loss_fn`` and every gradient leaf of reduced deepseek-moe-16b
    (``pushrelabel``) under a (2, 2) mesh: the loss against the
    reference's mesh run; the gradients against the reference's
    gradient of the same function without a mesh (``apply_moe`` on each
    'dp' shard), and the last MoE layer's expert gradients against the
    reference's mesh run too."""
    jc, tc, jp, tp = _params("pushrelabel")
    jb, tb = batch_pair(jc, tc, 16, 4, seed=1, step=3)
    S.set_mesh(_mesh((2, 2)))
    loss, grads = port_value_and_grad(tp, tc, tb)
    S.set_mesh(None)
    np.testing.assert_allclose(float(loss), float(ref["loss"]), **LOSS)

    monkeypatch.setattr(JT, "apply_moe", _split_apply_moe(JT.apply_moe, 2))
    want_loss, gj = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jc, b)))(jp, jb)
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS)
    assert_grads_close(list(grads), ref_leaves(gj), GRAD)

    treedef = jax.tree.structure(jp)
    mesh_g = ref_leaves(jax.tree.unflatten(
        treedef, [jnp.asarray(ref[f"g{i}"])
                  for i in range(treedef.num_leaves)]))
    last = TM.leaves(tp["stages"][-1][-1]["l0"]["moe"])
    names = list(_moe_layer(tp))
    idx = [len(grads) - len(last) + names.index(k)
           for k in ("w_gate", "w_up", "w_down")]
    assert_grads_close([grads[i] for i in idx], [mesh_g[i] for i in idx],
                       GRAD)


# --------------------------------------------------------------------------
# In-process cases against the single-device port
# --------------------------------------------------------------------------

def _moe_input(tc, b=4, s=16, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, tc.d_model, generator=g)


@pytest.mark.parametrize("shape,axes", [((1, 3), ("data", "model")),
                                        ((2, 3), ("data", "model")),
                                        ((2, 4), ("pod", "data"))],
                         ids=["e_mod_tp", "e_mod_tp_dp2", "no_model_axis"])
def test_no_expert_split_takes_single_device_branch(shape, axes, no_mesh):
    """E = 8 does not divide over 3, and a mesh without 'model' has no
    'tp' axis: ``apply_moe`` is the single-device branch, bit-equal."""
    _, tc, _, tp = _params("pushrelabel")
    moe, x = _moe_layer(tp), _moe_input(tc)
    want = TT.apply_moe(moe, tc, x)
    S.set_mesh(_mesh(shape, axes))
    got = TT.apply_moe(moe, tc, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("router", ["topk", "pushrelabel", "sinkhorn"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_branch_equals_single_device_per_shard(router, shape, no_mesh):
    """The port's mesh branch against its own no-mesh ``apply_moe`` on
    each 'dp' shard, and on the whole batch when B does not divide."""
    _, tc, _, tp = _params(router)
    moe = _moe_layer(tp)
    for b in BATCHES:
        x = _moe_input(tc, b=b)
        dp = shape[0] if b % shape[0] == 0 else 1
        want = torch.cat([TT.apply_moe(moe, tc, xs)
                          for xs in torch.chunk(x, dp)])
        got = _port_mesh_moe(moe, tc, x.numpy(), shape)
        torch.testing.assert_close(got, want, **TOL)


def _count_router(monkeypatch):
    calls = []
    orig = TMOE.pushrelabel_assign

    def counted(affinity, k, capacity, **kw):
        calls.append(tuple(affinity.shape))
        return orig(affinity, k, capacity, **kw)
    monkeypatch.setattr(TMOE, "pushrelabel_assign", counted)
    return calls


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_router_runs_once_per_dp_shard(shape, monkeypatch, no_mesh):
    """One ``pushrelabel_assign`` (one ``fused_ot_phases`` launch on the
    card) per MoE layer per 'dp' shard, on the shard's tokens; one on
    the whole batch when B does not divide; none per 'tp' block."""
    _, tc, _, tp = _params("pushrelabel")
    moe = _moe_layer(tp)
    calls = _count_router(monkeypatch)
    S.set_mesh(_mesh(shape))
    TT.apply_moe(moe, tc, _moe_input(tc, b=4))
    assert calls == [(4 * 16 // shape[0], tc.num_experts)] * shape[0]
    calls.clear()
    TT.apply_moe(moe, tc, _moe_input(tc, b=3))
    assert calls == [(3 * 16, tc.num_experts)]


def test_prefill_router_calls_per_pass(monkeypatch, f32_compute, no_mesh):
    """A whole model's prefill and decode step under (2, 4): MoE layers
    x 'dp' shards router calls a forward pass; prefill and decode equal
    the single-device model on each half of the batch."""
    _, tc, _, tp = _params("pushrelabel")
    n_moe = tc.num_layers - tc.first_dense_layers
    e = tc.num_experts
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(1, 500, size=(4, 12)).astype(np.int32))
    calls = _count_router(monkeypatch)
    S.set_mesh(_mesh((2, 4)))
    caches, logits = TM.prefill(tp, tc, {"tokens": toks})
    caches = TM.pad_caches(tc, caches, 16)
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    step, _ = TM.decode_step(tp, tc, caches, nxt, 12)
    S.set_mesh(None)
    assert calls == [(24, e)] * (2 * n_moe) + [(2, e)] * (2 * n_moe)
    for rows in (slice(0, 2), slice(2, 4)):
        c1, l1 = TM.prefill(tp, tc, {"tokens": toks[rows]})
        c1 = TM.pad_caches(tc, c1, 16)
        s1, _ = TM.decode_step(tp, tc, c1, nxt[rows], 12)
        torch.testing.assert_close(logits[rows], l1, **TOL)
        torch.testing.assert_close(step[rows], s1, **TOL)


def test_expert_blocks_are_views_on_one_device(no_mesh):
    """Every expert block of a mesh of one device shares the weight's
    storage: 8 logical shards hold one copy of the experts."""
    _, tc, _, tp = _params("topk")
    w = _moe_layer(tp)["w_gate"]
    placed = TT._expert_blocks(w, _mesh((2, 4)), "model")
    e_loc = tc.num_experts // 4
    for pos in placed.sharding.positions():
        blk = placed.block(pos)
        assert blk.untyped_storage().data_ptr() == \
            w.untyped_storage().data_ptr()
        assert torch.equal(blk, w[pos[1] * e_loc:(pos[1] + 1) * e_loc])


def test_training_through_mesh_is_repeatable(no_mesh):
    """``make_train_step`` under (2, 2) needs no change: two runs of two
    steps give bit-equal parameters, and every expert leaf moved (the
    gradients reach the full leaves through the blocks)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.train_step import make_train_step

    _, tc, _, _ = _params("pushrelabel")
    tc = tc.with_(num_layers=2)
    init_moe = TM.init_params(tc, seed=0, device="cpu")["stages"][-1][0][
        "l0"]["moe"]
    S.set_mesh(_mesh((2, 2)))
    runs = []
    for _ in range(2):
        p = TM.init_params(tc, seed=0, device="cpu")
        init, step = make_train_step(tc, lr=1e-3, warmup=1)
        opt = init(p)
        for s in range(2):
            b = {k: torch.as_tensor(v) for k, v in synthetic_batch(
                tc, 16, 4, seed=0, step=s).items()}
            p, opt, m = step(p, opt, b)
            assert np.isfinite(float(m["loss"]))
        runs.append(p)
    assert all(torch.equal(a, b) for a, b in zip(TM.leaves(runs[0]),
                                                 TM.leaves(runs[1])))
    moe = runs[0]["stages"][-1][0]["l0"]["moe"]
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert not torch.equal(moe[k], init_moe[k]), k


def test_blocks_for_other_devices_are_placed_once(no_mesh):
    """A weight whose blocks go to another device ('meta' stands for a
    second card here) is placed once per mesh and reused while it is not
    written in place; a write, or a weight that requires grad under
    autograd, places it again (the copies then carry gradients back)."""
    from repro_torch.launch.mesh import make_mesh

    _, tc, _, tp = _params("topk")
    w = _moe_layer(tp)["w_up"].clone()
    mesh = make_mesh((1, 2), ("data", "model"), ["cpu", "meta"])
    first = TT._expert_blocks(w, mesh, "model")
    assert first.block((0, 1)).device.type == "meta"
    assert first.block((0, 0)).untyped_storage().data_ptr() == \
        w.untyped_storage().data_ptr()
    assert TT._expert_blocks(w, mesh, "model") is first
    w.add_(0.0)
    again = TT._expert_blocks(w, mesh, "model")
    assert again is not first
    assert TT._expert_blocks(w, mesh, "model") is again
    g = w.detach().requires_grad_(True)
    live = TT._expert_blocks(g, mesh, "model")
    assert live.block((0, 1)).grad_fn is not None
    assert TT._expert_blocks(g, mesh, "model") is not live
