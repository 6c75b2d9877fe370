"""repro_torch's mesh builders and backend selection (``launch/mesh.py``,
``launch/platform.py``) and the placement policy of
``core/distributed.py``, held against the reference's functions where it
has them. CPU only: logical meshes repeat one device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.distributed import choose_placement as jchoose
from repro.launch.mesh import largest_pow2_at_most as jpow2
from repro_torch.core import device as tdevice
from repro_torch.core.distributed import (_axis_devices, _matrix_mesh,
                                          choose_placement, same_device)
from repro_torch.launch import platform as tplatform
from repro_torch.launch.mesh import (Mesh, largest_pow2_at_most,
                                     make_batch_mesh, make_mesh,
                                     make_small_mesh)

CPU = torch.device("cpu")


def test_mesh_type_shape_and_hash():
    mesh = make_small_mesh((2, 4), ("data", "model"), devices="cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    assert list(mesh.shape) == ["data", "model"]
    assert mesh.axis_names == ("data", "model")
    assert mesh.size == 8 and mesh.flat_devices == (CPU,) * 8
    assert len(mesh.devices) == 2 and len(mesh.devices[0]) == 4
    same = make_mesh((2, 4), ("data", "model"), [CPU] * 8)
    assert same == mesh and hash(same) == hash(mesh)
    assert make_small_mesh((4, 2), ("data", "model"), "cpu") != mesh
    assert {mesh: 1}[same] == 1


@pytest.mark.parametrize("bad", [
    dict(devices=(), axis_names=("data",)),
    dict(devices=(CPU, CPU), axis_names=("data", "model")),
    dict(devices=((CPU,), (CPU,)), axis_names=("data", "data")),
    dict(devices=((CPU, CPU), (CPU,)), axis_names=("data", "model")),
    dict(devices=("cpu",), axis_names=("data",)),
])
def test_mesh_rejects_irregular_layouts(bad):
    with pytest.raises(ValueError):
        Mesh(**bad)


def test_make_mesh_device_forms():
    m = make_mesh((3,), ("data",), ["cpu", CPU, "cpu"])
    assert m.flat_devices == (CPU,) * 3
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh((4,), ("data",), ["cpu"] * 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "CPU-only rule: the default builders need CUDA")
def test_default_builders_raise_without_cuda():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_small_mesh((2,), ("data",))


@pytest.mark.parametrize("x", list(range(0, 70)) + [1023, 1024, 1025])
def test_largest_pow2_at_most_equals_reference(x):
    assert largest_pow2_at_most(x) == jpow2(x)


@pytest.mark.parametrize("count,asked,want", [
    (1, None, 1), (2, None, 2), (3, None, 2), (6, None, 4), (8, None, 8),
    (8, 3, 2), (8, 5, 4), (4, 16, 4), (5, 1, 1),
])
def test_make_batch_mesh_power_of_two_prefix(monkeypatch, count, asked,
                                             want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    mesh = make_batch_mesh(asked, axis="batch")
    assert mesh.axis_names == ("batch",)
    assert mesh.shape == {"batch": want}
    assert mesh.flat_devices == tuple(torch.device("cuda", i)
                                      for i in range(want))


def test_set_platform(monkeypatch):
    monkeypatch.setattr(tdevice, "_default", "cuda")
    with pytest.raises(ValueError, match="no TPU backend"):
        tplatform.set_platform("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tplatform.set_platform("gpu")
        assert tdevice._default == "cuda"
    tplatform.set_platform("cpu")
    assert tdevice.resolve_device(None) == CPU
    assert tdevice.resolve_device("cpu") == CPU
    mesh = make_batch_mesh()
    assert mesh.flat_devices == (CPU,) and mesh.axis_names == ("data",)
    with pytest.raises(ValueError):
        tdevice.pin_default_device("tpu")


GRID = [(b, m, n, d) for b in (1, 2, 3, 4, 8, 16) for m in (16, 127, 128,
        512) for n in (64, 128, 300) for d in (1, 2, 4, 8)]


@pytest.mark.parametrize("chunk", range(4))
def test_choose_placement_equals_reference(chunk):
    part = GRID[chunk::4]
    assert [choose_placement(*g) for g in part] == [jchoose(*g) for g in part]
    assert choose_placement(2, 512, 512, 4, matrix_min_size=1024) == "batch"
    assert jchoose(2, 512, 512, 4, matrix_min_size=1024) == "batch"


@pytest.mark.parametrize("d,shape", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)),
                                     (8, (2, 4)), (16, (4, 4))])
def test_matrix_mesh_folds_to_the_squarest_grid(d, shape):
    mesh = make_small_mesh((d,), ("data",), devices="cpu")
    m2, row, col = _matrix_mesh(mesh)
    assert (row, col) == ("data", "model")
    assert (m2.shape[row], m2.shape[col]) == shape
    two_d = make_small_mesh((2, 2), ("x", "y"), devices="cpu")
    assert _matrix_mesh(two_d) == (two_d, "x", "y")


def test_axis_devices_and_same_device():
    devs = [torch.device("cpu")] * 2 + [torch.device("meta")] * 2
    mesh = make_mesh((2, 2), ("data", "model"), devs)
    assert _axis_devices(mesh, "data") == (CPU, torch.device("meta"))
    assert _axis_devices(mesh, "model") == (CPU, CPU)
    with pytest.raises(ValueError, match="no axis"):
        _axis_devices(mesh, "pod")
    assert same_device("cpu", CPU) and not same_device("cpu", "meta")
    assert np.all([same_device(d, d) for d in devs])


def test_sync_counts_are_exact_under_threads(monkeypatch):
    """Mesh shards read their flags from worker threads: more threads
    than cores and a short switch interval, so a lost read-modify-write
    of a count would show."""
    import sys
    import threading

    monkeypatch.setattr(tdevice, "sync_counts",
                        {"round": 0, "chunk": 0, "sinkhorn": 0})

    def work():
        for _ in range(1000):
            tdevice.count_sync("round")

    threads = [threading.Thread(target=work) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tdevice.sync_counts["round"] == 16000
    tdevice.reset_sync_counts()
    assert set(tdevice.sync_counts.values()) == {0}
