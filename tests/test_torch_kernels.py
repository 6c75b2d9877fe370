"""repro_torch kernels: plain versions held against the JAX Pallas kernels
(interpret mode on the CPU, as tests/test_kernels.py runs them), and the
port's import boundary. The CUDA kernels against their plain versions:
tests/test_torch_cuda.py.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.costs import build_cost_matrix as jax_build_cost_matrix
from repro.kernels import ops as jops
from repro_torch.core.costs import build_cost_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.cost_matrix import tolerance

REPO = Path(__file__).resolve().parents[1]


def _propose_inputs(seed, b, m, n):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 6, size=(b, m, n)).astype(np.int32)
    y_b = rng.integers(0, 4, size=(b, m)).astype(np.int32)
    y_a = -rng.integers(0, 4, size=(b, n)).astype(np.int32)
    avail = rng.uniform(size=(b, n)) < 0.6
    active = rng.uniform(size=(b, m)) < 0.75
    salt = np.array([0, 12345, 2**31 - 1, 77][:b], np.int32)
    return c, y_b, y_a, avail, active, salt


@pytest.mark.parametrize("m,n", [(7, 9), (40, 64), (64, 33)])
def test_slack_propose_plain_equals_pallas_batched(m, n):
    """Per-lane salts; on active rows the plain version's (col, key) equal
    the Pallas batched kernel's, and inactive rows propose nothing."""
    c, y_b, y_a, avail, active, salt = _propose_inputs(m + n, 4, m, n)
    col, key = ops.slack_propose_batched(
        *(torch.as_tensor(a) for a in (c, y_b, y_a, avail, salt)),
        active_b=torch.as_tensor(active))
    rcol, rkey = jops.slack_propose_batched(
        jnp.asarray(c), jnp.asarray(y_b), jnp.asarray(y_a),
        jnp.asarray(avail), jnp.asarray(salt))
    rcol, rkey = np.asarray(rcol), np.asarray(rkey).astype(np.int64)
    np.testing.assert_array_equal(col.numpy()[active], rcol[active])
    np.testing.assert_array_equal(key.numpy()[active], rkey[active])
    assert (col.numpy()[~active] == -1).all()
    assert (key.numpy()[~active] == 0xFFFFFFFF).all()


def test_slack_propose_unbatched_is_batch_of_one():
    c, y_b, y_a, avail, _, _ = _propose_inputs(3, 1, 30, 50)
    args = [torch.as_tensor(a[0]) for a in (c, y_b, y_a, avail)]
    col, key = ops.slack_propose(*args, 12345)
    rcol, rkey = jops.slack_propose(*(jnp.asarray(a[0]) for a in
                                      (c, y_b, y_a, avail)), 12345)
    np.testing.assert_array_equal(col.numpy(), np.asarray(rcol))
    np.testing.assert_array_equal(key.numpy(), np.asarray(rkey))


def test_plain_wrappers_count_no_launch():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    before = dict(ops.launches)
    c, y_b, y_a, avail, active, salt = _propose_inputs(4, 2, 8, 8)
    ops.slack_propose_batched(*(torch.as_tensor(a) for a in
                                (c, y_b, y_a, avail, salt)))
    ops.cost_matrix(torch.zeros(3, 2), torch.ones(4, 2), "l1")
    assert ops.launches == before


def _cost_tol(metric, d):
    rtol, atol = tolerance(metric, d)
    return dict(rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
@pytest.mark.parametrize("b,m,n,d", [(1, 5, 7, 2), (3, 40, 64, 3),
                                     (2, 16, 24, 784)])
def test_cost_matrix_plain_vs_pallas(metric, b, m, n, d):
    rng = np.random.default_rng(d + m)
    x = rng.uniform(size=(b, m, d)).astype(np.float32)
    y = rng.uniform(size=(b, n, d)).astype(np.float32)
    got = ops.cost_matrix_batched(torch.as_tensor(x), torch.as_tensor(y),
                                  metric)
    ref = jops.cost_matrix_batched(jnp.asarray(x), jnp.asarray(y), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **_cost_tol(metric, d))
    one = ops.cost_matrix(torch.as_tensor(x[0]), torch.as_tensor(y[0]),
                          metric)
    # the CPU's batched matmul may block a batch of one differently
    np.testing.assert_allclose(one.numpy(), got[0].numpy(),
                               **_cost_tol(metric, d))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
def test_build_cost_matrix_vs_reference(metric):
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(20, 2))
    y = rng.uniform(size=(30, 2))
    got = build_cost_matrix(x, y, metric, device="cpu")
    ref = jax_build_cost_matrix(x, y, metric)
    assert got.dtype == torch.float32 and got.shape == (20, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **_cost_tol(metric, 2))


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """The default device is CUDA; without it the port raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cost_matrix(np.zeros((2, 2)), np.zeros((2, 2)))


@pytest.mark.parametrize("entry", [
    "solve", "dispatch", "solve_assignment_batched", "solve_ot_batched",
    "solve_assignment_batched_compacting", "solve_ot_batched_compacting",
    "solve_assignment", "solve_ot"])
def test_solver_entry_points_refuse_cpu_tensors_without_device(
        monkeypatch, entry):
    """A CPU tensor is no request for the CPU: without device='cpu' every
    solver entry point resolves CUDA, and raises when it is missing."""
    from repro_torch.core import (api, batched, compaction, pushrelabel,
                                  transport)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = torch.rand(2, 4, 4)
    nu = mu = torch.full((2, 4), 0.25)
    calls = {
        "solve": lambda: api.solve(api.ASSIGNMENT, {"c": c}, 0.1),
        "dispatch": lambda: api.dispatch(
            api.OT, {"c": c, "nu": nu, "mu": mu}, 0.1),
        "solve_assignment_batched":
            lambda: batched.solve_assignment_batched(c, 0.1),
        "solve_ot_batched":
            lambda: batched.solve_ot_batched(c, nu, mu, 0.1),
        "solve_assignment_batched_compacting":
            lambda: compaction.solve_assignment_batched_compacting(c, 0.1),
        "solve_ot_batched_compacting":
            lambda: compaction.solve_ot_batched_compacting(c, nu, mu, 0.1),
        "solve_assignment": lambda: pushrelabel.solve_assignment(c[0], 0.1),
        "solve_ot": lambda: transport.solve_ot(c[0], nu[0], mu[0], 0.1),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_library_name_covers_included_headers(tmp_path):
    """A kernel's shared library is named by the hash of its source and
    of the headers it includes, so an edited header rebuilds every
    kernel that includes it (directly or through another header)."""
    import shutil

    csrc = REPO / "src" / "repro_torch" / "csrc"
    for f in csrc.iterdir():
        shutil.copy(f, tmp_path / f.name)
    sources = [tmp_path / source for source, _, _ in ops._ENTRY.values()]
    before = {s.name: ops.source_digest(s) for s in sources}
    assert before == {s.name: ops.source_digest(csrc / s.name)
                      for s in sources}
    hdr = tmp_path / "hash.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {s.name: ops.source_digest(s) for s in sources}
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"slack_propose.cu", "fused_assignment.cu",
                       "fused_ot.cu"}


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("*.py"))]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
