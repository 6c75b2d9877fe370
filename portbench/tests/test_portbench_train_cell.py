"""The training cell ``deepseek_v2_lite.train_8k`` on the CPU: its files
resolve by name and agree with the port's config; a stub run of the
entry at a reduced size goes through the harness and the reference and
comes out correct, while a perturbed gradient, a router unit moved to
another expert, an optimizer that leaves the weights as they were and
an update of unclipped gradients each come out not correct; the cell's
readers read what the entry and the program leave, and nothing from a
window without them."""
import copy
import json
import sys
from contextlib import nullcontext
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control_model, model_bounds  # noqa: E402
from portbench.entries import train as entry  # noqa: E402
from portbench.lib import harness  # noqa: E402
from portbench.lib.trace import TraceSummary  # noqa: E402
from portbench.reference import deepseek_v2_lite as ref  # noqa: E402
from repro_torch.configs.registry import PORT_ARCHS, reduced  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402

CELL = "deepseek_v2_lite.train_8k"
SEED = 3_000_000_029
RED = reduced(PORT_ARCHS["deepseek-v2-lite"]).with_(num_layers=3)


def test_the_cells_files_resolve():
    cell = harness.load_cell(CELL, ROOT)
    assert cell.entry["chips"] == 1
    assert cell.params["entry"] == "train"
    assert harness.load_file("entries", "train", ROOT).run
    r = harness.load_file("reference", cell.config["reference"], ROOT)
    assert set(r.NUMBERS) == set(harness.limits_of(cell))
    names = {m["name"] for m in cell.per_layer}
    assert names == {"moe.router_share.train", "moe.router_roofline.train",
                     "moe.router_unmatched.train", "step.mfu.train",
                     "device.idle_share.train"}
    for m in cell.per_layer + cell.end_to_end:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert {m["name"] for m in cell.end_to_end} == {
        "instances_per_s", "peak_mem_gib", "setup_s"}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in manifest["configs"]
                if c["name"] == cell.entry["config"])
    assert conf["reduced"] == sorted(cell.config["reduced"])
    assert cell.config["num_hidden_layers"] == 5
    assert cell.config["published"] == {"num_hidden_layers": 27}


def test_the_port_config_agrees_with_the_file():
    cell = harness.load_cell(CELL, ROOT)
    cfg = entry.model_config(cell.config)
    assert (cfg.num_layers, cfg.router, cfg.capacity_factor) == \
        (5, "pushrelabel", 1.25)
    bad = dict(cell.config, kv_lora_rank=256)
    with pytest.raises(ValueError, match="kv_lora_rank"):
        entry.model_config(bad)


def test_model_bounds_count_the_published_shapes():
    conf = harness.load_cell(CELL, ROOT).config
    assert model_bounds.mla_params(conf) == 13_762_560
    active = model_bounds.active_params(conf)
    # 5 MLA layers, the dense MLP, 4 x (router + 6 routed + 2 shared
    # experts), the head
    assert active == (5 * 13_762_560 + 3 * 2048 * 10944
                      + 4 * (2048 * 64 + 3 * 2048 * 1408 * 8)
                      + 2048 * 102400)
    attn = model_bounds.attention_flops(conf, 2, 8192)
    assert attn == 5 * 2 * 2 * 16 * (8192 * 8193 / 2) * 320
    assert model_bounds.train_step_flops(conf, 2, 8192) == \
        6 * active * 16384 + 3 * attn
    t, e = 16384, 64
    assert model_bounds.router_bytes(t, e) == \
        4 * t * e + 2 * 4 * (2 * t + 2 * e + 2 * t * e + 2)


def _stub_cell():
    cell = harness.load_cell(CELL, ROOT)
    c = dict(cell.config)
    c.update(num_hidden_layers=RED.num_layers, hidden_size=RED.d_model,
             num_attention_heads=RED.num_heads, intermediate_size=RED.d_ff,
             vocab_size=RED.vocab_size, n_routed_experts=RED.num_experts,
             num_experts_per_tok=RED.top_k,
             moe_intermediate_size=RED.d_ff_expert,
             kv_lora_rank=RED.kv_lora_rank,
             qk_nope_head_dim=RED.qk_nope_head_dim,
             qk_rope_head_dim=RED.qk_rope_head_dim,
             v_head_dim=RED.v_head_dim)
    cell.config = c
    cell.params = dict(cell.params, batch=2, seq_len=32, warmup_steps=1,
                       trace_seconds=0.5)
    return cell


def _stub_run(seconds, trace, fault=None):
    """One run of the entry on the CPU at the reduced size, the program
    computing in float32 (the cell's limits are set for its bf16 at full
    size; a tiny model's bf16 loss strays further), with ``fault``
    (``control_model.control``) switched on: the result, the notes and
    the checked (instance, answer)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(entry, "model_config", lambda conf: RED)
    mp.setattr(M, "COMPUTE_DTYPE", torch.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    seen = []
    orig = entry.run

    def keep(env):
        w = orig(env)
        seen.extend(w.answers)
        return w

    mp.setattr(entry, "run", keep)
    cell = _stub_cell()
    try:
        with (control_model.control(fault) if fault else nullcontext()):
            out, notes = harness.run_cell(cell, SEED, seconds, trace,
                                          torch.device("cpu"), 0.0)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return cell, out, notes, seen


@pytest.fixture(scope="module")
def stub_run():
    """One traced run of the stub (``_stub_run``)."""
    return _stub_run(1.0, True)


def test_a_stub_run_is_correct(stub_run):
    cell, out, notes, seen = stub_run
    assert out["correct"], out["checks"]
    assert out["attempted"] == out["failed"] + 2 * notes["steps"] > 0
    assert len(seen) == 1 and notes["answers_checked"] == 1
    inst, ans = seen[0]
    assert inst.shape == (2, 32)
    n_moe = RED.num_layers - RED.first_dense_layers
    assert len(ans["routes"]) == n_moe
    assert all("flow_recompute" in r for r in ans["routes"])
    assert sorted(ans["grads"]) == sorted(ref.grad_names(cell.config))
    assert sorted(ans["update"]) == sorted(ans["grads"])
    assert sorted(inst.moments) == sorted(ans["grads"])
    # the checked step is the trainer's next: AdamW's count before it is
    # the warm-up's and the window's steps, and its clip acts
    assert inst.step == 1 + notes["steps"] == notes["checked"]["step"]
    assert notes["checked"]["grad_norm"] > cell.params["max_grad_norm"]
    core = ans["attn_core"]
    h, dv = RED.num_heads, RED.v_head_dim
    assert core["q"].shape == core["k"].shape == (2, 32, h, RED.q_head_dim)
    assert core["v"].shape == core["out"].shape == (2, 32, h, dv)
    assert out["checks"]["router_flow_mismatch"]["value"] == 0
    # the program's counters and spans reached the readers
    m = out["metrics"]
    assert 0 <= m["moe.router_unmatched.train"]["value"] <= 100
    assert m["step.mfu.train"]["value"] > 0
    # no device on the CPU: the device-trace metrics read nothing
    assert "moe.router_share.train" not in m
    assert "moe.router_roofline.train" not in m


def _judge(cell, inst, ans):
    checks = {k: float(v) for k, v in ref.check(inst, ans, cell.config)
              .items()}
    return harness.judge(checks, harness.limits_of(cell))


def test_a_perturbed_gradient_is_not_correct(stub_run):
    cell, _, _, seen = stub_run
    inst, ans = seen[0]
    assert _judge(cell, inst, ans)[0]
    bad = dict(ans, grads=dict(ans["grads"]))
    name = f"layers.{RED.first_dense_layers}.wq"
    bad["grads"][name] = ans["grads"][name] * 1.6
    ok, rows = _judge(cell, inst, bad)
    assert not ok
    assert dict((n, v > lim) for n, v, lim in rows)["grad_rel_err"]


def test_a_moved_router_unit_is_not_correct(stub_run):
    cell, _, _, seen = stub_run
    inst, ans = seen[0]
    routes = copy.deepcopy(ans["routes"])
    flow = routes[0]["flow"]
    t0 = int(torch.nonzero(flow.sum(1) > 0)[0])
    e0 = int(torch.nonzero(flow[t0])[0])
    flow[t0, e0] -= 1
    flow[t0, (e0 + 1) % flow.shape[1]] += 1
    ok, rows = _judge(cell, inst, dict(ans, routes=routes))
    assert not ok
    got = {n: v for n, v, _ in rows}
    assert got["router_flow_mismatch"] == 2 and got["router_infeasible"] >= 1


@pytest.mark.parametrize("fault", ["noop", "noclip"])
def test_a_wrong_optimizer_step_is_not_correct(fault):
    """AdamW leaving the weights as they were reads 1; an update of the
    unclipped gradients is caught too, while the gradients still match
    (the fault lies after them)."""
    cell, out, _, _ = _stub_run(0.3, False, fault)
    assert not out["correct"]
    got = {n: c["value"] for n, c in out["checks"].items()}
    lim = harness.limits_of(cell)
    assert got["param_update_rel_err"] > lim["param_update_rel_err"]
    assert got["grad_rel_err"] <= lim["grad_rel_err"]
    if fault == "noop":
        assert got["param_update_rel_err"] == pytest.approx(1.0)


def test_the_attention_core_number_reads_a_bf16_core(stub_run):
    """``attn_core_rel_err`` sees the first layer's attention core: a
    float32 core (the stub's program) reads float32's rounding, the
    control's bf16 core a hundred times that at least."""
    got = _stub_run(0.3, False, "bf16_attn")[1]["checks"]
    prog = stub_run[1]["checks"]["attn_core_rel_err"]["value"]
    assert prog < 1e-5
    assert got["attn_core_rel_err"]["value"] > max(100 * prog, 1e-3)


def test_the_bf16_attention_control_rounds_the_core():
    """``control_model``'s bf16 core answers ``flash_attention``'s call
    (a value width of its own, a scale, causal blocks) to bf16's
    rounding, and not bit for bit."""
    from repro_torch.models.attention import flash_attention

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 24, generator=g)
    k = torch.randn(2, 40, 4, 24, generator=g)
    v = torch.randn(2, 40, 4, 16, generator=g)
    want = flash_attention(q, k, v, causal=True, q_block=16, kv_block=16,
                           scale=0.3)
    got = control_model._bf16_attention(q, k, v, causal=True, q_block=16,
                                        kv_block=16, scale=0.3)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).norm() / want.norm())
    assert 1e-4 < err < 2e-2


def test_kernel_kinds_count_the_traced_windows_kernels():
    """The entry's split of the traced window's kernels by kind, on
    kineto-like events: a kernel that overlaps the window counts whole,
    as ``lib.trace.summarize`` counts it; annotations do not count."""
    class Ev:
        def __init__(self, name, s, d, dev="CUDA", kind="kernel"):
            self._n, self._s, self._d = name, s, d
            self._dev, self._kind = dev, kind

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def device_type(self):
            return f"DeviceType.{self._dev}"

        def activity_type(self):
            return self._kind

    evs = [Ev("portbench.window", 100, 1000, dev="CPU"),
           Ev("void fused_ot_kernel<8>(...)", 150, 10),
           Ev("void fused_ot_kernel<8>(...)", 1090, 20),      # overlaps
           Ev("void fused_ot_kernel<8>(...)", 1200, 20),      # after
           Ev("ampere_sgemm_128x64_tn", 200, 30),
           Ev("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", 300, 40),
           Ev("void at::native::vectorized_elementwise_kernel<4>", 400, 5),
           Ev("Memcpy DtoH (Device -> Pageable)", 500, 7),
           Ev("train.step", 100, 900, kind="gpu_user_annotation")]
    got = entry.kernel_kinds(evs, "portbench.window")
    assert got == {"router": [2, pytest.approx(30e-9)],
                   "gemm_fp32": [1, pytest.approx(30e-9)],
                   "gemm_tc": [1, pytest.approx(40e-9)],
                   "elementwise": [1, pytest.approx(5e-9)],
                   "copy": [1, pytest.approx(7e-9)]}
    assert entry.kernel_kinds(evs[1:], "portbench.window") == {}


def _read(name, w):
    return harness.load_file("metrics", name, ROOT).read(w)


def test_the_readers_read_nothing_from_an_empty_window():
    tracing.clear()
    w = harness.Window()
    for name in ("moe.router_share.train", "moe.router_roofline.train",
                 "moe.router_unmatched.train", "step.mfu.train",
                 "device.idle_share.train"):
        assert _read(name, w) is None, name


def test_the_readers_arithmetic():
    w = harness.Window()
    w.trace = TraceSummary(window_s=2.0, busy_s=1.5, kernel_s=1.6)
    t = 16384
    bound = model_bounds.router_bound_s(t, 64)
    w.notes["router_kernel"] = {"launches": 8, "device_s": 0.16,
                                "tokens": t, "experts": 64}
    assert _read("moe.router_share.train", w) == pytest.approx(10.0)
    assert _read("moe.router_roofline.train", w) == \
        pytest.approx(100 * 8 * bound / 0.16)
    assert _read("device.idle_share.train", w) == pytest.approx(25.0)
