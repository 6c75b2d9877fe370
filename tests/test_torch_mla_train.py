"""DeepSeek-V2-Lite's training path in the port, on the CPU, against the
benchmark's plain reference (``portbench/reference/deepseek_v2_lite.py``,
plain torch in float32, written from the published equations): the
reduced model's loss and every leaf's gradient on seeded random weights,
the reference's plain push-relabel against ``pushrelabel_assign`` bit
for bit, ``Trainer.train_step()`` against ``Trainer.run()`` step for
step, and the step's spans and router counters.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.entries import train as entry  # noqa: E402
from portbench.reference import deepseek_v2_lite as ref  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.train.train_step import make_loss, value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

CFG = treg.reduced(treg.PORT_ARCHS["deepseek-v2-lite"]).with_(num_layers=3)


def ref_config(cfg):
    """The reference's config (the model's config.json names) of a port
    config."""
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "deepseek_v2_lite.json").read_text())
    conf.update(
        num_hidden_layers=cfg.num_layers, hidden_size=cfg.d_model,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.d_ff,
        vocab_size=cfg.vocab_size, n_routed_experts=cfg.num_experts,
        num_experts_per_tok=cfg.top_k, n_shared_experts=cfg.num_shared_experts,
        moe_intermediate_size=cfg.d_ff_expert,
        first_k_dense_replace=cfg.first_dense_layers,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        norm_topk_prob=cfg.norm_topk_prob,
        capacity_factor=cfg.capacity_factor)
    return conf


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32(monkeypatch):
    """The port's compute dtype as float32, so it and the reference
    compute the same function in the same precision."""
    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)


def _program_step(cfg, params, batch):
    """(loss, {reference name: gradient}, routes) of the port's own
    ``value_and_grad`` with the router's captures on."""
    hook = TM.RouterTap(capture=True)
    with TM.tap(hook):
        loss, grads = value_and_grad(make_loss(cfg), params, batch)
    names = entry._leaf_names(params)
    named = {names[id(w)]: g for w, g in zip(M.leaves(params), grads)}
    return loss, named, hook


@pytest.mark.parametrize("seed,s,norm", [(0, 24, False), (1, 40, False),
                                         (2, 32, True)])
def test_reduced_model_matches_the_plain_reference(f32, seed, s, norm):
    """Loss and every leaf's gradient, both in float32, the reference
    routed by the program's picks. Tolerances: the two sum in other
    orders (a blocked online softmax against a full one per query block,
    a sort-and-gather dispatch against per-expert index_add), so each
    gradient agrees to float32 accumulation over a few thousand terms:
    rtol 1e-4 of the leaf's norm; the loss to 1e-6."""
    cfg = CFG.with_(norm_topk_prob=norm)
    conf = ref_config(cfg)
    params = M.init_params(cfg, seed=seed, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        cfg, s, 2, seed=seed, step=0).items()}
    loss, grads, hook = _program_step(cfg, params, batch)
    n_moe = cfg.num_layers - cfg.first_dense_layers
    sels = [c["sel"] for c in hook.calls[:n_moe]]
    rloss, rgrads = ref.loss_and_grads(entry.reference_params(params), conf,
                                       batch["tokens"], sels)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-6)
    assert sorted(grads) == sorted(rgrads)
    for name, g in grads.items():
        err = float((g - rgrads[name]).norm() / rgrads[name].norm())
        assert err < 1e-4, (name, err)


def test_reference_routes_as_the_dispatch_drops():
    """A capacity below the demand: the reference keeps the first
    entries of each expert in token-then-slot order, as the dispatch."""
    cfg = CFG.with_(capacity_factor=0.3, router="topk")
    conf = ref_config(cfg)
    g = torch.Generator().manual_seed(3)
    p = TM.moe_init(g, cfg)
    x = torch.randn(1, 40, cfg.d_model, generator=g)
    routed = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    hook = TM.RouterTap()
    with TM.tap(hook):
        out = TM.moe_forward(routed, cfg.with_(num_shared_experts=0), x)
    assert float(hook.device_counts()[1]) > 0          # entries dropped
    sel, _ = TM.route(cfg, x[0] @ p["router"])
    rp = {**routed, "shared_gate": p["shared"]["w_gate"],
          "shared_up": p["shared"]["w_up"],
          "shared_down": p["shared"]["w_down"]}
    want = ref.moe(rp, conf, x, sel) - ref.glu(
        x, rp["shared_gate"], rp["shared_up"], rp["shared_down"])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("t,e,k,seed", [(64, 8, 2, 0), (700, 16, 4, 1),
                                        (3000, 64, 6, 2), (4096, 64, 6, 3)])
def test_plain_pushrelabel_bit_equal_to_the_router(t, e, k, seed):
    """The reference's transcription on the router's integer costs gives
    the flow ``pushrelabel_assign`` gives (the kernel's plain version on
    the CPU), entry for entry, at T up to 64x the experts."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(t, e, generator=g)
    capacity = -(-t * k // e)
    flow = TM.pushrelabel_assign(logits, k, capacity, phases=24,
                                 max_rounds=8)
    want = ref.pushrelabel_flow(TM.router_costs(logits), k, capacity, 24, 8)
    assert want.dtype == torch.int32
    assert torch.equal(flow, want)
    assert int(flow.sum(1).max()) <= k and int(flow.sum(0).max()) <= capacity


def test_router_numbers_catch_a_moved_unit():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(256, 8, generator=g)
    conf = ref_config(CFG.with_(top_k=2))
    sel, _ = TM.route_pushrelabel(logits, 2)
    flow = TM.pushrelabel_assign(logits, 2, 64, phases=24, max_rounds=8)
    route = {"c_int": TM.router_costs(logits), "sel": sel, "flow": flow,
             "flow_recompute": flow.clone()}
    assert ref.router_numbers(route, conf) == (0, 0)
    t0 = int(torch.nonzero(flow.sum(1) > 0)[0])
    e0 = int(torch.nonzero(flow[t0])[0])
    moved = flow.clone()
    moved[t0, e0] -= 1
    moved[t0, (e0 + 1) % 8] += 1
    mismatch, bad = ref.router_numbers(dict(route, flow=moved), conf)
    assert mismatch == 2 and bad >= 1


def test_tap_off_routes_without_extra_work(monkeypatch):
    """With no tap installed the router computes its integer costs once
    (inside the assignment); a capturing tap computes them once more."""
    calls = []
    orig = TM.router_costs

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(TM, "router_costs", counted)
    logits = torch.randn(64, 8, generator=torch.Generator().manual_seed(8))
    TM.route_pushrelabel(logits, 2)
    assert len(calls) == 1
    hook = TM.RouterTap(capture=True)
    with TM.tap(hook):
        TM.route_pushrelabel(logits, 2)
    assert len(calls) == 3 and len(hook.calls) == 1
    assert hook.launches == 1 and hook.units == 128
    assert TM._TAP is None


def test_train_step_matches_run_step_for_step(tmp_path):
    """``run(n)`` is n ``train_step()`` calls plus its checkpoints: the
    same records (times aside) and the same parameters bit for bit;
    ``train_step`` alone writes no checkpoint."""
    a = Trainer(CFG, str(tmp_path / "a"), seq_len=16, batch_size=2, seed=3,
                ckpt_every=2, device="cpu")
    b = Trainer(CFG, str(tmp_path / "b"), seq_len=16, batch_size=2, seed=3,
                ckpt_every=2, device="cpu")
    hist = a.run(3)
    recs = [b.train_step() for _ in range(3)]
    for x, y in zip(hist, recs):
        assert {k: v for k, v in x.items() if k != "time_s"} == \
            {k: v for k, v in y.items() if k != "time_s"}
    for x, y in zip(M.leaves(a.params), M.leaves(b.params)):
        assert torch.equal(x, y)
    assert os.listdir(tmp_path / "a" / "ckpt")
    assert not (tmp_path / "b" / "ckpt").exists()
    assert b.step == 3
    lines = (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3]


def test_train_step_spans_and_router_counts(tmp_path):
    tr = Trainer(CFG, str(tmp_path), seq_len=16, batch_size=2, seed=5,
                 device="cpu")
    tracing.clear()
    tracing.record(True)
    try:
        tr.train_step()
    finally:
        tracing.record(None)
    spans = tracing.recorded()
    tracing.clear()
    root = [s for s in spans if s["name"] == "train.step"]
    assert len(root) == 1 and root[0]["parent_id"] is None
    rid = root[0]["span_id"]
    kids = {s["name"] for s in spans if s.get("parent_id") == rid}
    assert kids == {"train.loss_grad", "train.optim"}
    lg = [s["span_id"] for s in spans if s["name"] == "train.loss_grad"]
    inner = [s["name"] for s in spans if s.get("parent_id") in lg]
    n_moe = CFG.num_layers - CFG.first_dense_layers
    # the forward opens them, and so does the remat recompute where
    # autograd runs it on this thread (the CPU; on the card it runs on
    # autograd's device thread, which opens none)
    assert sorted(set(inner)) == ["attn.mla", "moe.route"]
    assert inner.count("attn.mla") in (CFG.num_layers, 2 * CFG.num_layers)
    assert inner.count("moe.route") in (n_moe, 2 * n_moe)
    c = root[0]["moe"]
    t = 2 * 16
    assert c["router.launches"] == 2 * n_moe        # forward and recompute
    assert c["router.units"] == 2 * n_moe * CFG.top_k * t
    assert 0 <= c["router.unmatched"] <= c["router.units"]
    assert c["dispatch.dropped"] >= 0
    # off, a step records nothing and installs no tap
    tr.train_step()
    assert tracing.recorded() == [] and TM._TAP is None


def test_watch_grads_sees_the_step_gradients_before_the_clip(tmp_path):
    """Inside ``watch_grads`` a step hands its gradients to the watcher
    before the clip scales them: their norm is the step's ``grad_norm``
    (above the clip's 1.0 here, so the clip acts) and they equal
    ``value_and_grad`` on the step's batch and weights. Outside, nothing
    is watched, and the step trains the same weights."""
    from repro_torch.train import train_step as TS

    kw = dict(seq_len=16, batch_size=2, seed=7, device="cpu")
    a = Trainer(CFG, str(tmp_path / "a"), **kw)
    b = Trainer(CFG, str(tmp_path / "b"), **kw)
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        CFG, 16, 2, seed=7, step=0).items()}
    _, want = value_and_grad(make_loss(CFG), a.params, batch)
    seen = []
    with TS.watch_grads(lambda gs: seen.append([g.clone() for g in gs])):
        rec = a.train_step()
    assert TS._WATCH is None and len(seen) == 1
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in seen[0])))
    assert norm == pytest.approx(rec["grad_norm"], rel=1e-6)
    assert rec["grad_norm"] > 1.0
    for g, w in zip(seen[0], want):
        assert torch.equal(g, w)
    b.train_step()
    for x, y in zip(M.leaves(a.params), M.leaves(b.params)):
        assert torch.equal(x, y)
