"""DeepSeek-V2-Lite's pieces in the port, on the CPU: the port-only
config and its registry, YaRN's frequencies and softmax scale at the
published config, ``flash_attention``'s existing calls bit-equal to the
function as it was before it took ``scale`` and a value width of its own
(its old body is kept below as the oracle), latent attention (MLA)
against a naive full-softmax attention written from the equations, and
``norm_topk_prob``. The JAX package has no MLA, so nothing here is held
against it; the reduced model's loss and gradients are held against the
benchmark's plain reference in ``tests/test_torch_mla_train.py``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.deepseek_v2_lite import CONFIG, MLAConfig  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

RED = treg.reduced(CONFIG)


# -- the functions as they were (the oracles of bit equality) --------------

def _flash_attention_before(q, k, v, *, causal: bool, q_block: int = 512,
                    kv_block: int = 1024):
    """Online-softmax attention. q: (B, Sq, H, Dh); k/v: (B, Sk, KvH, Dh).

    Only the (q-block, kv-block) pairs that intersect causally are
    visited, and the (Sq, Sk) score matrix is never materialized. GQA via
    head-group reshape. Peak intermediate: (B, KvH, g, q_block, kv_block).
    """
    in_dtype = q.dtype
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = dh ** -0.5
    q = (q * scale).float()
    k = k.float()
    v = v.float()

    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    pq = (-sq) % q_block
    pk = (-sk) % kv_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq = q.shape[1] // q_block
    nk = k.shape[1] // kv_block
    # qr: (nq, B, KvH, g, qb, Dh)
    qr = q.reshape(b, nq, q_block, kvh, g, dh).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, nk, kv_block, kvh, dh)
    vr = v.reshape(b, nk, kv_block, kvh, dh)

    if causal:
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nk)
                 if ki * kv_block < (qi + 1) * q_block]
    else:
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nk)]

    dev = q.device
    m = [torch.full((b, kvh, g, q_block), TA.NEG_INF, device=dev)
         for _ in range(nq)]
    l_ = [torch.zeros((b, kvh, g, q_block), device=dev) for _ in range(nq)]
    acc = [torch.zeros((b, kvh, g, q_block, dh), device=dev)
           for _ in range(nq)]
    for qi, ki in pairs:
        s_ = torch.einsum("bhgqd,bkhd->bhgqk", qr[qi], kr[:, ki])
        k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
        valid = k_pos[None, :] < sk
        if causal:
            q_pos = qi * q_block + torch.arange(q_block, device=dev)
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        s_ = torch.where(valid[None, None, None], s_, TA.NEG_INF)
        m_new = torch.maximum(m[qi], s_.amax(dim=-1))
        p_ = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(m[qi] - m_new)
        l_[qi] = l_[qi] * corr + p_.sum(dim=-1)
        acc[qi] = acc[qi] * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p_, vr[:, ki])
        m[qi] = m_new
    out = torch.stack(acc) / torch.clamp(torch.stack(l_)[..., None],
                                         min=1e-30)
    # (nq, B, KvH, g, qb, Dh) -> (B, S, H, Dh)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * q_block, h, dh)
    return out[:, :sq].to(in_dtype)



def _apply_rope_before(x, positions, theta: float = 1e4):
    """x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    freqs = TL.rope_freqs(dh, theta, x.device)                    # (Dh/2,)
    angles = positions[..., :, None].float() * freqs           # (...,S,Dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)



# -- configs ---------------------------------------------------------------

def test_port_archs_share_no_name_with_archs():
    assert set(treg.PORT_ARCHS).isdisjoint(treg.ARCHS)
    assert set(treg.PORT_ARCHS).isdisjoint(jreg.ARCHS)
    assert "deepseek-v2-lite" in treg.PORT_ARCHS


def test_get_arch_resolves_both_registries():
    assert treg.get_arch("qwen3-4b") is treg.ARCHS["qwen3-4b"]
    assert treg.get_arch("deepseek-v2-lite") is CONFIG
    with pytest.raises(KeyError, match="unknown architecture"):
        treg.get_arch("no-such-model")


def test_mla_config_extends_arch_config():
    base = [f.name for f in dataclasses.fields(tbase.ArchConfig)]
    mine = [f.name for f in dataclasses.fields(MLAConfig)]
    assert mine[:len(base)] == base
    assert set(mine[len(base):]) == {
        "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "rope_factor", "rope_orig_len", "beta_fast",
        "beta_slow", "mscale", "mscale_all_dim", "norm_topk_prob"}
    # the published values (config.json of DeepSeek-V2-Lite)
    assert (CONFIG.num_layers, CONFIG.d_model, CONFIG.num_heads) == \
        (27, 2048, 16)
    assert (CONFIG.kv_lora_rank, CONFIG.qk_nope_head_dim,
            CONFIG.qk_rope_head_dim, CONFIG.v_head_dim) == (512, 128, 64, 128)
    assert (CONFIG.num_experts, CONFIG.top_k, CONFIG.num_shared_experts,
            CONFIG.d_ff_expert, CONFIG.d_ff, CONFIG.first_dense_layers) == \
        (64, 6, 2, 1408, 10944, 1)
    assert (CONFIG.rope_factor, CONFIG.rope_orig_len, CONFIG.beta_fast,
            CONFIG.beta_slow, CONFIG.mscale, CONFIG.mscale_all_dim) == \
        (40.0, 4096, 32.0, 1.0, 0.707, 0.707)
    assert CONFIG.norm_topk_prob is False and CONFIG.router == "pushrelabel"
    assert CONFIG.vocab_size == CONFIG.vocab_padded == 102400
    # with_ keeps the subclass and its fields
    cut = CONFIG.with_(num_layers=5)
    assert isinstance(cut, MLAConfig) and cut.kv_lora_rank == 512


def test_reduced_shrinks_the_mla_widths():
    assert isinstance(RED, MLAConfig)
    assert (RED.kv_lora_rank, RED.qk_nope_head_dim, RED.qk_rope_head_dim,
            RED.v_head_dim) == (32, 16, 8, 16)
    assert RED.num_kv_heads == RED.num_heads
    assert (RED.d_model, RED.vocab_size, RED.num_experts) == (128, 512, 8)
    assert RED.norm_topk_prob is False


def test_stage0_cut_has_2_840_b_parameters():
    """The cell's cut (1 dense + 4 MoE layers at published widths) as fake
    tensors: 2.840 B parameters, 45.4 GB at 16 bytes a parameter."""
    params = M.abstract_params(CONFIG.with_(num_layers=5))
    n = sum(t.numel() for t in M.leaves(params))
    assert n == 2_839_831_040
    assert round(16 * n / 1e9, 1) == 45.4


# -- YaRN ------------------------------------------------------------------

def test_yarn_ramp_and_mscale_at_the_published_config():
    assert TL.yarn_ramp_bounds(64, 1e4, 4096, 32, 1) == (10, 23)
    m = TL.yarn_mscale(40.0, 0.707)
    assert m == pytest.approx(0.1 * 0.707 * math.log(40) + 1)
    assert m == pytest.approx(1.26081, abs=1e-5)
    assert TL.yarn_mscale(1.0, 0.707) == 1.0
    assert TA.mla_softmax_scale(CONFIG) == pytest.approx(192 ** -0.5 * m * m)
    freqs, ms = TA.mla_rope(CONFIG, "cpu")
    assert ms == 1.0                       # mscale == mscale_all_dim


def test_yarn_inv_freq_at_the_published_config():
    """float32 frequencies against the equations in float64: pairs below
    10 keep theta^(-2i/64), pairs from 23 on are divided by 40, and the
    ramp (i - 10) / 13 blends the two in between."""
    got = TL.yarn_inv_freq(64, 1e4, 40.0, 4096, 32, 1).numpy()
    i = np.arange(32, dtype=np.float64)
    extra = 1e4 ** (-2 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    np.testing.assert_allclose(got, want, rtol=2e-6)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:10], TL.rope_freqs(64, 1e4)[:10])
    np.testing.assert_allclose(got[23:], extra[23:] / 40, rtol=2e-6)


def test_deinterleave_pairs_even_then_odd():
    x = torch.arange(8.0).reshape(1, 8)
    assert TL.deinterleave(x).tolist() == [[0, 2, 4, 6, 1, 3, 5, 7]]


# -- flash_attention and RoPE bit-equal to before ---------------------------

FLASH_CASES = [
    # (b, sq, sk, h, kvh, dh, causal, q_block, kv_block, dtype)
    (2, 37, 37, 4, 2, 16, True, 8, 16, torch.float32),
    (1, 64, 64, 4, 4, 32, True, 16, 16, torch.float32),
    (2, 20, 33, 6, 3, 8, False, 8, 8, torch.float32),
    (1, 48, 48, 4, 1, 16, True, 512, 1024, torch.bfloat16),
    (3, 1, 19, 2, 2, 16, False, 512, 1024, torch.bfloat16),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_existing_calls_bit_equal(case):
    b, sq, sk, h, kvh, dh, causal, qb, kb, dt = case
    g = torch.Generator().manual_seed(sq * 7 + sk)
    q = torch.randn(b, sq, h, dh, generator=g).to(dt)
    k = torch.randn(b, sk, kvh, dh, generator=g).to(dt)
    v = torch.randn(b, sk, kvh, dh, generator=g).to(dt)
    got = TA.flash_attention(q, k, v, causal=causal, q_block=qb, kv_block=kb)
    want = _flash_attention_before(q, k, v, causal=causal, q_block=qb,
                                   kv_block=kb)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_apply_rope_bit_equal(dt):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 11, 3, 16, generator=g).to(dt)
    pos = torch.arange(11)[None].expand(2, 11) + 5
    for theta in (1e4, 1e6):
        assert torch.equal(TL.apply_rope(x, pos, theta),
                           _apply_rope_before(x, pos, theta))


def _naive_attention(q, k, v, scale, causal=True):
    """Full-softmax attention in float64: q/k (B, S, H, Dq), v (B, S, H,
    Dv)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if causal:
        n = q.shape[1]
        s = s.masked_fill(torch.triu(torch.ones(n, n, dtype=torch.bool),
                                     1), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.double())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_scale_and_value_width(causal):
    g = torch.Generator().manual_seed(11)
    q = torch.randn(2, 29, 4, 24, generator=g)
    k = torch.randn(2, 29, 4, 24, generator=g)
    v = torch.randn(2, 29, 4, 10, generator=g)
    got = TA.flash_attention(q, k, v, causal=causal, q_block=8, kv_block=16,
                             scale=0.37)
    assert got.shape == (2, 29, 4, 10)
    np.testing.assert_allclose(got.numpy(),
                               _naive_attention(q, k, v, 0.37, causal).numpy(),
                               rtol=1e-5, atol=2e-6)


# -- MLA -------------------------------------------------------------------

def _interleaved_rope(x, pos, freqs):
    """RoPE on pairs (2i, 2i + 1) in place (the interleaved layout the
    published code de-interleaves), in float64."""
    x = x.double()
    ang = pos[:, :, None].double() * freqs.double()[None, None]   # B,S,D/2
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def _naive_mla(p, cfg, x, pos):
    """MLA from the equations, in float64, full softmax."""
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    pd = {k_: w.double() for k_, w in p.items()}
    x = x.double()
    q = (x @ pd["wq"]).reshape(b, s, h, dn + dr)
    ckv = x @ pd["wkv_a"]
    c = ckv[..., :r]
    c = c / torch.sqrt((c * c).mean(-1, keepdim=True) + cfg.norm_eps) \
        * pd["kv_norm"]
    kv = (c @ pd["wkv_b"]).reshape(b, s, h, dn + dv)
    freqs, _ = TA.mla_rope(cfg, "cpu")
    q_pe = _interleaved_rope(q[..., dn:], pos, freqs)
    k_pe = _interleaved_rope(ckv[..., r:].reshape(b, s, 1, dr), pos, freqs)
    qq = torch.cat([q[..., :dn], q_pe], -1)
    kk = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], -1)
    m = TL.yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    scale = (dn + dr) ** -0.5 * m * m
    out = _naive_attention(qq, kk, kv[..., dn:], scale)
    return out.reshape(b, s, h * dv) @ pd["wo"]


@pytest.mark.parametrize("s,seed", [(13, 0), (40, 1)])
def test_mla_forward_matches_naive_attention(s, seed):
    """float32 MLA (blocked online softmax, de-interleaved rope) against
    the float64 equations (full softmax, interleaved rope pairs):
    float32 rounding of O(1) values over sums of a few hundred terms."""
    g = torch.Generator().manual_seed(seed)
    p = TA.mla_init(g, RED)
    p["kv_norm"] = 1 + 0.1 * torch.randn(RED.kv_lora_rank, generator=g)
    x = torch.randn(2, s, RED.d_model, generator=g)
    pos = torch.arange(s)[None].expand(2, s) * 97   # past the ramp's pairs
    got = TA.mla_forward(p, RED, x, pos)
    want = _naive_mla(p, RED, x, pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=2e-5)


def test_watch_core_sees_the_attention_core_of_each_call():
    """Inside ``watch_core`` each ``mla_forward`` hands its core's q, k,
    v and answer to the watcher: the answer is the core of those inputs
    at ``mla_softmax_scale`` and, through ``wo``, the layer's output;
    outside, nothing is watched and the output is the same."""
    g = torch.Generator().manual_seed(5)
    p = TA.mla_init(g, RED)
    x = torch.randn(2, 12, RED.d_model, generator=g)
    pos = torch.arange(12)[None].expand(2, 12)
    seen = []
    with TA.watch_core(lambda *t: seen.append(t)):
        got = TA.mla_forward(p, RED, x, pos)
    assert TA._CORE_WATCH is None and len(seen) == 1
    q, k, v, out = seen[0]
    assert q.shape == k.shape == (2, 12, RED.num_heads, RED.q_head_dim)
    assert v.shape == out.shape == (2, 12, RED.num_heads, RED.v_head_dim)
    np.testing.assert_allclose(
        out.numpy(), _naive_attention(q, k, v, TA.mla_softmax_scale(RED))
        .numpy(), rtol=1e-4, atol=2e-6)
    assert torch.equal(got, out.reshape(2, 12, -1) @ p["wo"])
    assert torch.equal(got, TA.mla_forward(p, RED, x, pos))


def test_mla_params_have_the_published_shapes():
    params = M.abstract_params(CONFIG.with_(num_layers=2))
    attn = params["stages"][0][0]["l0"]["attn"]
    assert {k: tuple(v.shape) for k, v in attn.items()} == {
        "wq": (2048, 16 * 192), "wkv_a": (2048, 576), "kv_norm": (512,),
        "wkv_b": (512, 16 * 256), "wo": (16 * 128, 2048)}
    moe = params["stages"][1][0]["l0"]["moe"]
    assert tuple(moe["w_gate"].shape) == (64, 2048, 1408)
    assert tuple(moe["shared"]["w_gate"].shape) == (2048, 2816)


def test_mla_serving_raises_naming_the_latent_cache():
    params = M.init_params(RED.with_(num_layers=2), seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="latent KV cache"):
        M.prefill(params, RED.with_(num_layers=2), batch)


# -- norm_topk_prob --------------------------------------------------------

@pytest.mark.parametrize("router", ["topk", "sinkhorn", "pushrelabel"])
def test_norm_topk_prob_false_keeps_the_softmax_gates(router):
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(96, 8, generator=g)
    probs = torch.softmax(logits, -1)
    sel_n, gates_n = TM.ROUTERS[router](logits, 3)
    sel, gates = TM.ROUTERS[router](logits, 3, False)
    assert torch.equal(sel, sel_n)
    raw = torch.gather(probs, 1, sel.long())
    assert torch.equal(gates, raw)
    np.testing.assert_allclose(gates_n.numpy(),
                               (raw / raw.sum(-1, keepdim=True)).numpy(),
                               rtol=1e-6)
    if router != "pushrelabel":          # distinct picks: a partial sum
        assert bool((gates.sum(-1) < 1).all())


def test_route_follows_the_config():
    g = torch.Generator().manual_seed(6)
    logits = torch.randn(64, 8, generator=g)
    cfg = RED.with_(router="topk")
    _, raw = TM.route(cfg, logits)
    _, normed = TM.route(cfg.with_(norm_topk_prob=True), logits)
    _, plain = TM.route(treg.reduced(treg.ARCHS["deepseek-moe-16b"]), logits)
    assert torch.equal(normed, plain)
    assert not torch.allclose(raw, normed)


def test_moe_forward_with_raw_gates_differs_by_the_gate_sum():
    """With a single expert chosen (k = 1) the raw gate is the top
    probability and the renormalised one is 1: the routed part of the
    output scales by exactly that probability."""
    cfg = RED.with_(top_k=1, num_shared_experts=0, router="topk",
                    capacity_factor=8.0)
    g = torch.Generator().manual_seed(7)
    p = TM.moe_init(g, cfg)
    x = torch.randn(1, 16, cfg.d_model, generator=g)
    raw = TM.moe_forward(p, cfg, x)
    normed = TM.moe_forward(p, cfg.with_(norm_topk_prob=True), x)
    top = torch.softmax(x[0] @ p["router"], -1).amax(-1)
    np.testing.assert_allclose(raw[0].numpy(),
                               (normed[0] * top[:, None]).numpy(),
                               rtol=1e-5, atol=1e-6)
