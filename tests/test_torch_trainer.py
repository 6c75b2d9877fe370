"""repro_torch's data pipeline, checkpoints and ``Trainer`` on the CPU.

``synthetic_batch`` against the reference's: tokens byte-equal for
several (seed, step, kind) and every input mode; frames and patches
equal to the reference's bf16 values (exactly: both round float32 to
nearest even). Checkpoints: bf16 and int32 round trips, a corrupted
newest checkpoint skipped, ``retain`` honoured, no ``.tmp_`` directory
left, an async save of a tree that is then updated in place restores the
values it had when ``save`` returned, and a tree of another shape is
refused. The ``Trainer``: the reference's loss-decrease and kill/resume
cases at reduced size, the resumed losses equal to the uninterrupted
run's bit for bit (deterministic data, CRC-checked checkpoints and a
deterministic step on the CPU).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.registry import ARCHS, reduced
from repro_torch.data import pipeline as TD
from repro_torch.optim.optimizer import adafactor_init, adamw_init
from repro_torch.train.trainer import Trainer

CFG = reduced(ARCHS["llama3.2-3b"]).with_(num_layers=2, remat=False)


@pytest.fixture(autouse=True)
def one_thread():
    """The reduced model's ops are tiny: one intra-op thread runs them
    faster than a pool, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- data ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
@pytest.mark.parametrize("seed,step,kind", [(0, 0, "train"),
                                            (1, 17, "train"),
                                            (7, 123456, "prefill"),
                                            (2**31 - 1, 5, "train")])
def test_synthetic_batch_equals_reference(arch, seed, step, kind):
    jc = jreg.reduced(jreg.ARCHS[arch])
    tc = reduced(ARCHS[arch])
    want = JD.synthetic_batch(jc, 24, 3, seed=seed, step=step, kind=kind)
    got = TD.synthetic_batch(tc, 24, 3, seed=seed, step=step, kind=kind)
    assert sorted(got) == sorted(want)
    assert got["tokens"].dtype == np.int32
    assert got["tokens"].tobytes() == want["tokens"].tobytes()
    for k in ("frames", "patches"):
        if k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k],
                                          want[k].astype(np.float32))


def test_data_pipeline_deterministic():
    a = TD.synthetic_batch(CFG, 32, 4, seed=1, step=17)
    b = TD.synthetic_batch(CFG, 32, 4, seed=1, step=17)
    c = TD.synthetic_batch(CFG, 32, 4, seed=1, step=18)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_prefetcher_yields_steps_in_order_and_closes():
    pf = TD.Prefetcher(CFG, 16, 2, seed=3, start_step=5, depth=2)
    try:
        it = iter(pf)
        for want in (5, 6, 7):
            step, b = next(it)
            assert step == want
            np.testing.assert_array_equal(
                b["tokens"],
                TD.synthetic_batch(CFG, 16, 2, seed=3, step=want)["tokens"])
    finally:
        pf.close()
    pf._t.join(timeout=5)
    assert not pf._t.is_alive()


# -- checkpoints -------------------------------------------------------------

def test_checkpoint_roundtrip_preserves_dtypes(tmp_path):
    d = str(tmp_path / "d")
    tree = {
        "a": torch.randn((3, 4)).to(torch.bfloat16),
        "b": {"c": torch.arange(5, dtype=torch.int32)},
        "s": torch.tensor(7, dtype=torch.int32),
    }
    ckpt.save(d, 7, tree)
    out = ckpt.restore(d, 7, tree)
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.int32
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.arange(5))
    assert out["s"].shape == () and int(out["s"]) == 7
    with open(os.path.join(d, "step_0000000007", "manifest.json")) as f:
        man = json.load(f)
    assert man["paths"] == ["a", "b/c", "s"]
    assert man["dtypes"] == ["bfloat16", "int32", "int32"]


@pytest.mark.parametrize("init", [adamw_init, adafactor_init])
def test_checkpoint_roundtrip_of_optimizer_state(tmp_path, init):
    params = {"w": torch.randn(4, 3), "b": [torch.randn(3)]}
    tree = {"params": params, "opt": init(params)}
    ckpt.save(str(tmp_path), 1, tree)
    out = ckpt.restore(str(tmp_path), 1, tree)
    assert type(out["opt"]) is type(tree["opt"])
    for a, b in zip(ckpt._flatten(out), ckpt._flatten(tree)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


def test_corrupt_checkpoint_is_skipped(tmp_path):
    d = str(tmp_path / "c")
    tree = {"x": torch.arange(10, dtype=torch.float32)}
    ckpt.save(d, 1, tree)
    ckpt.save(d, 2, tree)
    with open(os.path.join(d, "step_0000000002", "arrays.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 32)
    assert ckpt.latest_step(d) == 1
    with pytest.raises(IOError):
        ckpt.restore(d, 2, tree)


def test_retain_keeps_the_newest_and_no_tmp_is_left(tmp_path):
    d = str(tmp_path / "r")
    for s in range(1, 6):
        ckpt.save(d, s, {"x": torch.full((3,), float(s))}, retain=2)
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000005"]
    assert ckpt.latest_step(d) == 5


def test_async_save_keeps_the_values_it_was_given(tmp_path):
    """The optimizer updates in place: a save that returned has its host
    copy, so a later update does not reach the checkpoint."""
    d = str(tmp_path / "a")
    x = torch.zeros(1000)
    t = ckpt.save(d, 3, {"x": x}, async_=True)
    x.add_(1.0)
    t.join(timeout=30)
    assert not t.is_alive()
    out = ckpt.restore(d, 3, {"x": x})
    assert float(out["x"].abs().max()) == 0.0
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]


def test_restore_refuses_another_tree(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"y": torch.zeros(2)})


# -- the Trainer -------------------------------------------------------------

def test_loss_decreases(tmp_path):
    tr = Trainer(CFG, str(tmp_path / "w"), seq_len=32, batch_size=4,
                 lr=2e-3, warmup=5, ckpt_every=1000, device="cpu")
    hist = tr.run(40)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)
    with open(tr.metrics_log) as f:
        assert len(f.readlines()) == 40


def test_kill_and_resume_bitwise(tmp_path):
    w1, w2 = str(tmp_path / "a"), str(tmp_path / "b")
    t_full = Trainer(CFG, w1, seq_len=16, batch_size=2, ckpt_every=4,
                     device="cpu")
    h_full = t_full.run(8)
    t_half = Trainer(CFG, w2, seq_len=16, batch_size=2, ckpt_every=4,
                     device="cpu")
    t_half.run(4)
    del t_half
    t_resumed = Trainer(CFG, w2, seq_len=16, batch_size=2, ckpt_every=4,
                        device="cpu")
    assert t_resumed.step == 4
    h_rest = t_resumed.run(4)
    assert [h["loss"] for h in h_full[4:]] == [h["loss"] for h in h_rest]
    for a, b in zip(ckpt._flatten(t_full.params),
                    ckpt._flatten(t_resumed.params)):
        assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("optimizer,mesh_shape", [("adamw", (2, 4)),
                                                  ("adamw", (1, 2)),
                                                  ("adafactor", (2, 4))])
def test_resume_under_shardings_equals_plain_resume(tmp_path, optimizer,
                                                    mesh_shape):
    """A checkpoint written by ``Trainer()`` resumes under
    ``Trainer(shardings=param_shardings(...))`` on a CPU mesh: the leaves
    come back assembled on the trainer's device, and the losses after the
    resume are bit-equal to an unsharded resume's."""
    import shutil

    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding

    cfg = CFG.with_(optimizer=optimizer)
    kw = dict(seq_len=16, batch_size=2, ckpt_every=2, device="cpu")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    Trainer(cfg, a, **kw).run(2)
    shutil.copytree(a, b)
    plain = Trainer(cfg, a, **kw)
    saved = dict(sharding._STATE)
    try:
        sharding.set_mesh(make_small_mesh(mesh_shape, devices="cpu"))
        shardings = sharding.param_shardings(M.abstract_params(cfg))
        placed = Trainer(cfg, b, shardings=shardings, **kw)
    finally:
        sharding._STATE.clear()
        sharding._STATE.update(saved)
    assert plain.step == placed.step == 2
    for (pa, x), (pb, y) in zip(ckpt._flatten(plain.opt_state),
                                ckpt._flatten(placed.opt_state)):
        assert pa == pb and type(y) is torch.Tensor and torch.equal(x, y)
    for (_, x), (_, y) in zip(ckpt._flatten(plain.params),
                              ckpt._flatten(placed.params)):
        assert type(y) is torch.Tensor and torch.equal(x, y)
    want = [h["loss"] for h in plain.run(3)]
    assert [h["loss"] for h in placed.run(3)] == want
