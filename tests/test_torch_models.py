"""repro_torch's configs and model building blocks against the JAX
reference (``repro.configs``, ``repro.models``), on the CPU.

The same inputs, drawn with numpy from a seed, go through both packages
in float32. Tolerances: ``F32`` (atol 2e-5, rtol 1e-5) for the
elementwise blocks and for attention / SSD, whose float32 sums run in
another order in each package; configs must be equal field by field.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB

F32 = dict(atol=2e-5, rtol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **(tol or F32))


# -- configs ---------------------------------------------------------------

def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(jreg.ARCHS))
def test_config_equals_reference(name):
    got, want = treg.ARCHS[name], jreg.ARCHS[name]
    assert _fields(got) == _fields(want)
    assert _fields(treg.reduced(got)) == _fields(jreg.reduced(want))
    assert got.vocab_padded == want.vocab_padded


def test_config_surface_equals_reference():
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    assert [f.name for f in dataclasses.fields(tbase.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ArchConfig)]
    for shapes in ("SHAPES", "SMOKE_SHAPES"):
        got, want = getattr(tbase, shapes), getattr(jbase, shapes)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.items()}
    for name in sorted(jreg.ARCHS):
        for shape in jbase.SHAPES:
            assert tbase.shape_applicable(treg.ARCHS[name],
                                          tbase.SHAPES[shape]) == \
                jbase.shape_applicable(jreg.ARCHS[name], jbase.SHAPES[shape])
    cfg = treg.ARCHS["qwen3-4b"].with_(router="pushrelabel")
    assert cfg.router == "pushrelabel" and cfg.name == "qwen3-4b"


# -- layers ----------------------------------------------------------------

def test_rmsnorm_rope_glu_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    _close(TL.rmsnorm(_t(w), _t(x)), JL.rmsnorm(_j(w), _j(x)))
    for theta in (1e4, 1e6):
        _close(TL.rope_freqs(32, theta), JL.rope_freqs(32, theta))
        pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
        _close(TL.apply_rope(_t(x), _t(pos), theta),
               JL.apply_rope(_j(x), _j(pos), theta), atol=1e-4, rtol=1e-5)
    p = {k: rng.normal(size=s).astype(np.float32) / 6 for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    xs = rng.normal(size=(3, 5, 32)).astype(np.float32)
    _close(TL.glu_mlp({k: _t(v) for k, v in p.items()}, _t(xs)),
           JL.glu_mlp({k: _j(v) for k, v in p.items()}, _j(xs)))
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    _close(TL.embed_lookup(_t(table), _t(ids)),
           JL.embed_lookup(_j(table), _j(ids)), atol=0, rtol=0)


def test_init_follows_fan_in_rule():
    gen = torch.Generator().manual_seed(0)
    w = TL._init(gen, (400, 300))
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - 400 ** -0.5) < 0.002
    e = TL.embed_init(gen, 1000, 64, dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std())
                                             - 0.02) < 0.001


# -- attention -------------------------------------------------------------

# (b, sq, sk, h, kvh, dh, causal, q_block, kv_block): one block, ragged
# blocks in both axes, GQA, non-causal
ATTN_CASES = [
    (2, 16, 16, 4, 4, 8, True, 512, 1024),
    (1, 37, 37, 4, 2, 16, True, 8, 16),
    (2, 20, 33, 6, 2, 8, False, 8, 8),
    (1, 24, 24, 8, 1, 16, True, 16, 8),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_equals_reference(case):
    b, sq, sk, h, kvh, dh, causal, qb, kb = case
    rng = np.random.default_rng(sq * sk + h)
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, dh)).astype(np.float32)
    got = TA.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             q_block=qb, kv_block=kb)
    want = JA.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                              q_block=qb, kv_block=kb)
    _close(got, want)
    # and against a dense softmax (the blocks change nothing)
    g = h // kvh
    kk = np.repeat(k, g, axis=2)
    vv = np.repeat(v, g, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) * dh ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((sq, sk), bool)), s, -np.inf)
    pr = np.exp(s - s.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    _close(got, np.einsum("bhqk,bkhd->bqhd", pr, vv), atol=1e-4, rtol=1e-4)


def _attn_params(rng, cfg):
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": (d, h * dh), "wk": (d, kvh * dh), "wv": (d, kvh * dh),
         "wo": (h * dh, d)}
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in p.items()}
    if cfg.qkv_bias:
        for n, w in (("bq", h), ("bk", kvh), ("bv", kvh)):
            p[n] = rng.normal(size=(w * dh,)).astype(np.float32) * 0.1
    if cfg.qk_norm:
        p["q_norm"] = rng.uniform(0.5, 1.5, size=(dh,)).astype(np.float32)
        p["k_norm"] = rng.uniform(0.5, 1.5, size=(dh,)).astype(np.float32)
    return p


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-4b", "codeqwen1.5-7b"])
def test_attn_prefill_decode_and_cross_equal_reference(arch, fast):
    cfg = jreg.reduced(jreg.ARCHS[arch]).with_(fast_decode_math=fast)
    tcfg = treg.reduced(treg.ARCHS[arch]).with_(fast_decode_math=fast)
    rng = np.random.default_rng(3)
    p = _attn_params(rng, cfg)
    pj = {k: _j(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    out_j, (kj, vj) = JA.attn_prefill(pj, cfg, _j(x), _j(pos))
    out_t, (kt, vt) = TA.attn_prefill(pt, tcfg, _t(x), _t(pos))
    _close(out_t, out_j)
    _close(kt, kj)
    _close(vt, vj)
    # one decode step at position 9 into a 12-slot cache
    pad = ((0, 0), (0, 3), (0, 0), (0, 0))
    kc, vc = np.pad(np.asarray(kj), pad), np.pad(np.asarray(vj), pad)
    xd = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    dj, (kj2, vj2) = JA.attn_decode(pj, cfg, _j(xd), (_j(kc), _j(vc)),
                                    jnp.int32(9))
    dt, (kt2, vt2) = TA.attn_decode(pt, tcfg, _t(xd), (_t(kc), _t(vc)), 9)
    _close(dt, dj)
    _close(kt2, kj2)
    _close(vt2, vj2)
    mem = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    _close(TA.cross_attn_forward(pt, tcfg.with_(qk_norm=False), _t(x),
                                 _t(mem)),
           JA.cross_attn_forward(pj, cfg.with_(qk_norm=False), _j(x),
                                 _j(mem)))


# -- mamba -----------------------------------------------------------------

def _mamba_params(rng, cfg):
    d_inner, _, nheads, n = JMB.mamba_dims(cfg)
    d = cfg.d_model
    shapes = {"in_z": (d, d_inner), "in_x": (d, d_inner), "in_b": (d, n),
              "in_c": (d, n), "in_dt": (d, nheads), "conv_x": (4, d_inner),
              "conv_b": (4, n), "conv_c": (4, n), "out_proj": (d_inner, d)}
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    for k, w in (("conv_bias_x", d_inner), ("conv_bias_b", n),
                 ("conv_bias_c", n), ("a_log", nheads), ("dt_bias", nheads)):
        p[k] = (rng.normal(size=(w,)) * 0.3).astype(np.float32)
    p["d_skip"] = rng.uniform(0.5, 1.5, size=(nheads,)).astype(np.float32)
    p["norm_w"] = rng.uniform(0.5, 1.5, size=(d_inner,)).astype(np.float32)
    return p


@pytest.mark.parametrize("l,chunk", [(40, 16), (7, 256), (64, 64)])
def test_ssd_scan_equals_reference(l, chunk):
    rng = np.random.default_rng(l)
    b, h, p_, n = 2, 4, 8, 16
    x = rng.normal(size=(b, l, h, p_)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, l, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p_, n)).astype(np.float32)
    yj, sj = JMB.ssd_scan(_j(x), _j(dt), _j(a), _j(bm), _j(cm), chunk=chunk,
                          init_state=_j(s0))
    yt, st = TMB.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk,
                          init_state=_t(s0))
    _close(yt, yj, atol=1e-4, rtol=1e-4)
    _close(st, sj, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("l", [2, 21])
def test_mamba_forward_and_decode_equal_reference(l):
    cfg = jreg.reduced(jreg.ARCHS["mamba2-2.7b"])
    tcfg = treg.reduced(treg.ARCHS["mamba2-2.7b"])
    rng = np.random.default_rng(l + 5)
    p = _mamba_params(rng, cfg)
    pj = {k: _j(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    u = rng.normal(size=(2, l, cfg.d_model)).astype(np.float32)
    yj, cj = JMB.mamba_forward(pj, cfg, _j(u))
    yt, ct = TMB.mamba_forward(pt, tcfg, _t(u))
    _close(yt, yj, atol=1e-4, rtol=1e-4)
    for got, want in zip(ct, cj):
        _close(got, want, atol=1e-4, rtol=1e-4)
    ud = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    dj, nj = JMB.mamba_decode(pj, cfg, _j(ud), cj)
    dt, nt = TMB.mamba_decode(pt, tcfg, _t(ud), ct)
    _close(dt, dj, atol=1e-4, rtol=1e-4)
    for got, want in zip(nt, nj):
        _close(got, want, atol=1e-4, rtol=1e-4)
    for got, want in zip(TMB.mamba_cache_init(tcfg, 3),
                         JMB.mamba_cache_init(cfg, 3)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
