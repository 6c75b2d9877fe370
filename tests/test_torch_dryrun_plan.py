"""The dry-run's plan recorder (``roofline/plan.py``) and what it needs
of the model.

The recorder's live-byte peak and op bytes on programs counted by hand;
the MoE layer forward and backward under ``FakeTensorMode`` for every
router (its counts are static-shape, and the push-relabel router records
its launch as a custom call instead of launching); the static-shape
counts equal to ``torch.bincount``; period scaling (``unroll=False``)
equal to the unrolled recording in FLOPs, op bytes, cache rebuilds and
custom calls; decode cache rebuilds (Mamba's conv tails by
``torch.cat``; attention caches written in place); and, on a (1, 1) CPU
mesh, the plan's argument bytes and FLOPs equal to the real step's
tensors and ``FlopCounterMode`` count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.transformer import apply_moe
from repro_torch.roofline.plan import PlanRecorder, record
from repro_torch.train.train_step import make_train_step


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_recorder_counts_new_storages_and_op_bytes():
    """y = x @ w (64 x 256 x 256, f32), z = relu(y), v = z.t() (a view),
    del y, s = z.sum(): the peak is y and z live together; the view and
    the arguments add nothing; a freed storage leaves the live bytes."""
    with FakeTensorMode():
        x = torch.empty((64, 256))
        w = torch.empty((256, 256))

        def step():
            y = x @ w
            z = torch.relu(y)
            v = z.t()
            del y
            return z, v, z.sum()
        (z, v, s), counts, rec = record(step, [x, w])
    act = 64 * 256 * 4
    assert counts["temp_bytes"] == 2 * act
    assert rec.live == act + 4              # z and the sum
    assert counts["flops"] == 2 * 64 * 256 * 256
    # mm: x, w in, y out; relu: y in, z out; sum: z in, 4 B out
    assert counts["bytes"] == (act + 256 * 256 * 4 + act) + 2 * act \
        + act + 4
    assert counts["ops"] == 3


@pytest.mark.parametrize("router", ["topk", "sinkhorn", "pushrelabel"])
def test_moe_forward_and_backward_under_fake_tensors(router):
    cfg = reduced(ARCHS["deepseek-moe-16b"]).with_(router=router)
    with FakeTensorMode():
        gen = torch.Generator()
        p = M.map_params(lambda t: t.requires_grad_(True),
                         moe.moe_init(gen, cfg))
        x = torch.empty((2, 16, cfg.d_model), requires_grad=True)
        with PlanRecorder() as rec:
            out = apply_moe(p, cfg, x)
            out.float().sum().backward()
            stats = moe.load_balance_stats(
                torch.empty((32, cfg.num_experts)),
                torch.zeros((32, cfg.top_k), dtype=torch.int32),
                cfg.num_experts)
    assert out.shape == x.shape and x.grad.shape == x.shape
    assert p["w_gate"].grad.shape == p["w_gate"].shape
    assert stats["load_entropy"].shape == ()
    calls = rec.custom_calls
    if router == "pushrelabel":
        assert calls == [{"name": "fused_ot_phases", "shape": (32, 8),
                          "phases": 24, "max_rounds": 8}]
    else:
        assert calls == []


def test_static_counts_equal_bincount():
    rng = np.random.default_rng(3)
    sel = torch.as_tensor(rng.integers(0, 8, size=(50, 2)), dtype=torch.int32)
    logits = torch.as_tensor(rng.standard_normal((50, 8)), dtype=torch.float32)
    got = moe.load_balance_stats(logits, sel, 8)
    counts = torch.bincount(sel.reshape(-1).long(), minlength=8).float()
    load = counts / counts.sum()
    assert torch.equal(got["load_entropy"],
                       -torch.sum(load * torch.log(load + 1e-9)))
    assert torch.equal(got["load_imbalance"], counts.max() / counts.mean())
    # _combine's per-token count: every token's slots summed in order
    src = torch.as_tensor(rng.integers(-1, 10, size=40), dtype=torch.int32)
    y = torch.as_tensor(rng.standard_normal((40, 3)), dtype=torch.float32)
    out = moe._combine(y, src, 10, 8)
    want = torch.zeros((10, 3))
    for i in range(40):
        if src[i] >= 0:
            want[src[i]] += y[i]
    assert torch.equal(out, want)


def test_router_on_real_tensors_still_launches_and_records_nothing():
    logits = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (24, 4)), dtype=torch.float32)
    with PlanRecorder() as rec:
        flow = moe.pushrelabel_assign(logits, 2, 12)
    assert rec.custom_calls == []
    assert flow.dtype == torch.int32 and int(flow.sum()) > 0
    meta = moe.pushrelabel_assign(torch.empty((24, 4), device="meta"), 2, 12)
    assert meta.is_meta and meta.shape == (24, 4)


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-moe-16b", "train_4k"),
    ("mamba2-2.7b", "decode_32k"),
    ("seamless-m4t-medium", "prefill_32k"),
])
def test_period_scaling_equals_unrolled(arch, shape):
    kw = dict(small=True, smoke=True)
    scaled = dryrun.run_cell(arch, shape, unroll=False, **kw)
    full = dryrun.run_cell(arch, shape, unroll=True, **kw)
    assert scaled["ok"] and full["ok"]
    assert scaled["periods_scaled"] and not full["periods_scaled"]
    assert scaled["plan"]["recordings"] > 1 == full["plan"]["recordings"]
    for k in ("flops_per_device", "bytes_per_device", "dus_alias_bytes"):
        assert scaled["roofline"][k] == full["roofline"][k], k
    for k in ("custom_calls", "cache_rebuilds", "flops_dp_shard",
              "op_bytes_dp_shard", "aten_ops"):
        assert scaled["plan"][k] == full["plan"][k], k
    assert scaled["collective_records"] == full["collective_records"]
    assert scaled["memory"]["argument_bytes"] == \
        full["memory"]["argument_bytes"]


def test_pushrelabel_router_calls_scale_with_depth():
    rec = dryrun.run_cell("deepseek-moe-16b", "train_4k", router="pushrelabel",
                          small=True, smoke=True, unroll=False)
    # 3 MoE layers, each routed in the forward pass and the remat
    # recompute, at the 'data' shard's 64 tokens
    assert len(rec["plan"]["custom_calls"]) == 6
    assert rec["roofline"]["collective"]["while_ops"] == 6
    assert {tuple(c["shape"]) for c in rec["plan"]["custom_calls"]} == \
        {(64, 8)}


def test_decode_cache_rebuilds():
    mamba = dryrun.run_cell("mamba2-2.7b", "decode_32k", small=True,
                            smoke=True)
    rebuilt = mamba["plan"]["cache_rebuilds"]
    # the three conv tails of each of the 4 layers, at the shard's batch
    assert sorted(tuple(r["shape"]) for r in rebuilt) == sorted(
        [(1, 3, 256)] * 4 + [(1, 3, 16)] * 8)
    assert mamba["roofline"]["dus_alias_bytes"] == sum(
        2 * 2 * np.prod(r["shape"]) for r in rebuilt) / 4
    qwen = dryrun.run_cell("qwen3-4b", "decode_32k", small=True, smoke=True)
    assert qwen["plan"]["cache_rebuilds"] == []
    assert qwen["roofline"]["dus_alias_bytes"] == 0.0


def test_plan_on_one_device_equals_the_real_step():
    """On a (1, 1) mesh the plan's arguments are the real step's tensors
    and its FLOPs the real step's ``FlopCounterMode`` count (the router's
    choices do not change the capacity-bounded expert matmuls)."""
    cfg = reduced(ARCHS["deepseek-moe-16b"]).with_(router="pushrelabel")
    shape = ShapeConfig("step", 16, 2, "train")
    plan = dryrun.plan_step(cfg, shape, make_small_mesh(
        (1, 1), devices="cpu"))
    assert plan["collective_records"] == [
        r for r in plan["collective_records"] if r["op"] == "while"]
    params = M.init_params(cfg, seed=0, device="cpu")
    init, step_fn = make_train_step(cfg)
    opt = init(params)
    batch = {"tokens": torch.zeros((2, 17), dtype=torch.int32)}
    real = [t for t in M.leaves(params) + M.leaves(opt) + [batch["tokens"]]
            if t is not None]
    assert plan["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in real)
    with FlopCounterMode(display=False) as fc:
        step_fn(params, opt, batch)
    assert plan["plan"]["flops_dp_shard"] == fc.get_total_flops()
    assert plan["roofline"]["flops_per_device"] == fc.get_total_flops()
    assert len(plan["plan"]["custom_calls"]) == 2 * 3
