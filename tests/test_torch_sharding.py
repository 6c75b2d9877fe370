"""``repro_torch.models.sharding``, the model's abstract specs and
``checkpoint.restore(shardings=)`` against the reference, on the CPU.

* ``param_pspecs`` equals the reference's ``param_pspecs(abstract_params
  (cfg))`` for all ten configs, leaf by leaf, the reference's leading
  period axis stripped from stage leaves (the port keeps a dict a
  period); with no mesh set and with a ('data', 'model') mesh set.
* ``pspec`` resolves logical axes as the reference does, with and without
  a 'model' axis and on a ('pod', 'data', 'model') mesh.
* ``NamedSharding.shard_shape`` equals ``jax.sharding.NamedSharding(
  AbstractMesh(...), spec).shard_shape``; both refuse a dimension that
  does not divide.
* ``device_put`` on a mesh of one device gives views of the source;
  ``full`` reassembles it.
* ``restore(shardings=)`` mirrors ``tests/test_sharded_ot.py::
  test_elastic_checkpoint_reshard`` on a logical CPU mesh.
* ``input_specs`` and ``decode_cache_specs`` equal the reference's
  shapes and dtypes for all ten configs (and every input kind), and a
  real prefill's caches of the port on the reduced configs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.models import model as JM
from repro.models import sharding as JS
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs import registry as TR
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.models import model as TM
from repro_torch.models import sharding as S

ARCHS = sorted(JR.ARCHS)


@pytest.fixture
def both_states(monkeypatch):
    """Both packages' sharding state, restored after the test (their
    ``set_mesh(None)`` keeps the resolved 'dp' / 'tp')."""
    for mod in (JS, S):
        monkeypatch.setattr(mod, "_STATE", dict(mod._STATE))


def _jdtype(a):
    return str(np.dtype(a.dtype))


def _tdtype(t):
    return str(t.dtype).removeprefix("torch.")


def _pairs(ref_tree, port_tree, stacked=False):
    """(reference leaf, port leaf, the reference leaf carries a leading
    period axis) for every leaf, matching the reference's stacked stages
    to the port's list of periods."""
    if isinstance(ref_tree, dict):
        assert set(ref_tree) == set(port_tree)
        for k in ref_tree:
            if k == "stages":
                for rs, ps in zip(ref_tree[k], port_tree[k], strict=True):
                    for period in ps:
                        yield from _pairs(rs, period, stacked=True)
            else:
                yield from _pairs(ref_tree[k], port_tree[k], stacked)
    elif isinstance(ref_tree, (list, tuple)) and not isinstance(ref_tree,
                                                                 JP):
        for r, p in zip(ref_tree, port_tree, strict=True):
            yield from _pairs(r, p, stacked)
    else:
        yield ref_tree, port_tree, stacked


def _spec_pairs(cfg_name):
    jc, tc = JR.ARCHS[cfg_name], TR.ARCHS[cfg_name]
    ref = JS.param_pspecs(JM.abstract_params(jc))
    port = S.param_pspecs(TM.abstract_params(tc))
    return list(_pairs(ref, port))


@pytest.mark.parametrize("mesh_axes", [None, ("data", "model")],
                         ids=["no_mesh", "data_model"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_reference(arch, mesh_axes, both_states):
    if mesh_axes is not None:
        JS.set_mesh(AbstractMesh((2, 4), mesh_axes))
        S.set_mesh(make_small_mesh((2, 4), mesh_axes, devices="cpu"))
    pairs = _spec_pairs(arch)
    assert pairs
    for ref, port, stacked in pairs:
        want = tuple(ref)[1:] if stacked else tuple(ref)
        assert isinstance(port, S.PartitionSpec)
        assert tuple(port) == want, (ref, port)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_reference(arch):
    jc, tc = JR.ARCHS[arch], TR.ARCHS[arch]
    ref, port = JM.abstract_params(jc), TM.abstract_params(tc)
    n = 0
    for r, p, stacked in _pairs(ref, port):
        assert tuple(p.shape) == (r.shape[1:] if stacked else r.shape)
        assert _tdtype(p) == _jdtype(r)
        n += 1
    assert n == len(TM.leaves(port))


def test_param_shardings_need_a_mesh_and_use_it(both_states):
    tc = TR.reduced(TR.ARCHS["deepseek-moe-16b"])
    params = TM.abstract_params(tc)
    with pytest.raises(AssertionError):
        S.param_shardings(params)
    mesh = make_small_mesh((2, 4), ("data", "model"), devices="cpu")
    S.set_mesh(mesh)
    shs = S.param_shardings(params)
    specs = S.param_pspecs(params)
    def walk(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in walk(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in walk(v)]
        return [tree]
    flat_sh, flat_spec = walk(shs), walk(specs)
    assert len(flat_sh) == len(flat_spec) == len(TM.leaves(params))
    for sh, spec in zip(flat_sh, flat_spec):
        assert sh.mesh is mesh and sh.spec == spec
    moe = shs["stages"][1][0]["l0"]["moe"]["w_gate"]
    assert moe.spec == S.P("model", "data", None)
    assert moe.shard_shape((8, 128, 64)) == (2, 64, 64)


LOGICAL = [("dp", "tp"), ("tp", "dp", None), (None,), ("dp",), ("tp",),
           ("dp", None, "tp"), ()]


@pytest.mark.parametrize("shape,axes", [
    (None, None), ((2, 4), ("data", "model")), ((8,), ("data",)),
    ((2, 2, 2), ("pod", "data", "model")), ((2, 4), ("pod", "data"))],
    ids=["no_mesh", "data_model", "data_only", "pod_data_model",
         "pod_data"])
def test_pspec_resolution_equals_reference(shape, axes, both_states):
    if shape is not None:
        JS.set_mesh(AbstractMesh(shape, axes))
        S.set_mesh(make_small_mesh(shape, axes, devices="cpu"))
    assert S._STATE["dp"] == JS._STATE["dp"]
    assert S._STATE["tp"] == JS._STATE["tp"]
    for logical in LOGICAL:
        assert tuple(S.pspec(*logical)) == tuple(JS.pspec(*logical))
    if shape is None:
        assert S.named("dp") is None and S.get_mesh() is None
    else:
        sh = S.named("dp", "tp")
        assert sh.mesh is S.get_mesh()
        assert tuple(sh.spec) == tuple(JS.pspec("dp", "tp"))
    assert S.constrain(x := torch.ones(2, 2), "dp", "tp") is x


SHARD_CASES = [
    ((2, 4), ("data", "model"), ("data", "model"), (64, 32)),
    ((2, 4), ("data", "model"), ("model",), (16,)),
    ((2, 4), ("data", "model"), (None, "model", None), (3, 8, 5)),
    ((2, 4), ("data", "model"), (("data", "model"),), (16, 3)),
    ((2, 4), ("data", "model"), (("model", "data"), None), (8, 2)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model"),
     (8, 6)),
    ((2, 2, 2), ("pod", "data", "model"), ("model", None, "pod"),
     (4, 3, 2)),
    ((8,), ("data",), ("data",), (24, 7)),
    ((1, 4), ("data", "model"), ("model", "data", None), (8, 128, 64)),
]


@pytest.mark.parametrize("mesh_shape,axes,spec,shape", SHARD_CASES)
def test_shard_shape_equals_reference(mesh_shape, axes, spec, shape):
    want = JNamedSharding(AbstractMesh(mesh_shape, axes),
                          JP(*spec)).shard_shape(shape)
    sh = S.NamedSharding(make_small_mesh(mesh_shape, axes, devices="cpu"),
                         S.P(*spec))
    assert sh.shard_shape(shape) == tuple(want)


@pytest.mark.parametrize("shape", [(5, 32), (64, 30)])
def test_shard_shape_refuses_what_does_not_divide(shape):
    with pytest.raises(ValueError):
        JNamedSharding(AbstractMesh((2, 4), ("data", "model")),
                       JP("data", "model")).shard_shape(shape)
    sh = S.NamedSharding(make_small_mesh((2, 4), ("data", "model"),
                                         devices="cpu"),
                         S.P("data", "model"))
    with pytest.raises(ValueError):
        sh.shard_shape(shape)


@pytest.mark.parametrize("mesh_shape,axes,spec,shape", SHARD_CASES)
def test_device_put_blocks_are_views(mesh_shape, axes, spec, shape):
    """Every block on the source's device is a view of it (one storage),
    holds the slice its block index names (the first axis of a tuple
    entry major), and ``full`` gives the source back."""
    mesh = make_small_mesh(mesh_shape, axes, devices="cpu")
    sh = S.NamedSharding(mesh, S.P(*spec))
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    st = S.device_put(x, sh)
    names = mesh.axis_names
    sizes = mesh.shape
    n_pos = 0
    for pos in sh.positions():
        blk = st.block(pos)
        assert blk.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()
        assert tuple(blk.shape) == sh.shard_shape(shape)
        where = dict(zip(names, pos))
        sl = []
        for d, size in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            ax = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k = 0
            for a in ax:
                k = k * sizes[a] + where[a]
            n = size // int(np.prod([sizes[a] for a in ax]))
            sl.append(slice(k * n, (k + 1) * n))
        assert torch.equal(blk, x[tuple(sl)])
        n_pos += 1
    assert n_pos == mesh.size
    assert torch.equal(st.full(), x)
    assert st.dtype == x.dtype and st.shape == tuple(shape)


def test_restore_with_shardings(tmp_path, both_states):
    """A checkpoint written from one device restores placed on a (2, 4)
    logical mesh: the full logical values, one block per mesh position;
    a None sharding restores a plain tensor."""
    tree = {"w": torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32),
            "b": torch.ones((16,), dtype=torch.bfloat16),
            "n": {"c": torch.arange(6, dtype=torch.int32)}}
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, tree)
    mesh = make_small_mesh((2, 4), ("data", "model"), devices="cpu")
    like = {"w": torch.zeros((64, 32)), "b": torch.zeros((16,),
                                                          dtype=torch.bfloat16),
            "n": {"c": torch.zeros(6, dtype=torch.int32)}}
    sh = {"w": S.NamedSharding(mesh, S.P("data", "model")),
          "b": S.NamedSharding(mesh, S.P("model")), "n": None}
    out = ckpt.restore(d, 3, like, shardings=sh)
    assert isinstance(out["w"], S.ShardedTensor)
    assert torch.equal(out["w"].full(), tree["w"])
    assert torch.equal(out["b"].full(), tree["b"])
    assert out["b"].dtype == torch.bfloat16
    assert len(out["w"].sharding.positions()) == 8
    for pos in out["w"].sharding.positions():
        assert out["w"].block(pos).shape == (32, 8)
        assert out["b"].block(pos).shape == (4,)
    assert isinstance(out["n"]["c"], torch.Tensor)
    assert torch.equal(out["n"]["c"], tree["n"]["c"])
    plain = ckpt.restore(d, 3, like)
    assert torch.equal(plain["w"], tree["w"])


KINDS = ["train", "prefill", "decode"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, kind):
    for seq_len, batch in ((64, 2), (9, 3)):
        ref = JM.input_specs(JR.ARCHS[arch], seq_len, batch, kind)
        port = TM.input_specs(TR.ARCHS[arch], seq_len, batch, kind)
        assert set(ref) == set(port)
        for k in ref:
            assert tuple(port[k].shape) == tuple(ref[k].shape), k
            assert _tdtype(port[k]) == _jdtype(ref[k]), k
            assert port[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_specs_equal_reference(arch):
    ref = JM.decode_cache_specs(JR.ARCHS[arch], 2, 64)
    port = TM.decode_cache_specs(TR.ARCHS[arch], 2, 64)
    n = 0
    # caches: a list of stages, stacked in the reference, a list of
    # periods each in the port
    for r, p, stacked in _pairs({"stages": ref}, {"stages": port}):
        assert stacked
        assert tuple(p.shape) == tuple(r.shape[1:])
        assert _tdtype(p) == _jdtype(r)
        n += 1
    assert n == len(TM.leaves(port))


def _batch_like(specs, rng):
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32:
            out[k] = torch.as_tensor(rng.integers(1, 500, size=v.shape)
                                     .astype(np.int32))
        else:
            out[k] = torch.as_tensor(rng.normal(size=v.shape)
                                     .astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_specs_equal_port_prefill(arch):
    cfg = TR.reduced(TR.ARCHS[arch])
    seq_len, batch = 12, 2
    specs = TM.input_specs(cfg, seq_len, batch, "prefill")
    params = TM.init_params(cfg, seed=0, device="cpu")
    caches, _ = TM.prefill(params, cfg,
                           _batch_like(specs, np.random.default_rng(0)))
    want = TM.leaves(caches)
    got = TM.leaves(TM.decode_cache_specs(cfg, batch, seq_len))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
