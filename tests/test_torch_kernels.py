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

from _propose_hash import umax_salt
from _torch_wrappers import wrapper_calls as _wrapper_calls

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


_M32 = 0xFFFFFFFF


def _packed_columns(c, y_b, y_a, avail, salt):
    """What csrc/slack_propose.cu's warps reduce: per (lane, row, column)
    the packed value (key << 32) | col as uint64 (key 0xFFFFFFFF where the
    column is not admissible), and the admissible mask."""
    from repro_torch.kernels.slack_propose import UMAX, proposal_keys

    b, m, n = c.shape
    adm = ((torch.as_tensor(y_b)[:, :, None] + torch.as_tensor(y_a)[:, None]
            == torch.as_tensor(c) + 1) & torch.as_tensor(avail)[:, None])
    keys = torch.where(adm, proposal_keys(m, n, torch.as_tensor(salt)), UMAX)
    packed = (keys.numpy().astype(np.uint64) << np.uint64(32)) | np.arange(
        n, dtype=np.uint64)
    return packed, adm.numpy()


def _decode(best, any_adm):
    col = np.where(any_adm, (best & np.uint64(_M32)).astype(np.int64), -1)
    return col, (best >> np.uint64(32)).astype(np.int64)


@pytest.mark.parametrize("n,parts", [(9, 2), (64, 5), (1000, 32),
                                     (1001, 7)])
def test_packed_minimum_over_any_split_is_first_minimum(n, parts):
    """The premise of slack_propose.cu's column parts: cut each row's
    columns anywhere into parts, reduce each part to its packed minimum
    and admissible flag, merge the parts in any order, and (col, key)
    decoded from the result is the plain version's first minimum."""
    from repro_torch.kernels.slack_propose import slack_propose_ref

    rng = np.random.default_rng(n * 100 + parts)
    c, y_b, y_a, avail, _, salt = _propose_inputs(n + parts, 4, 24, n)
    rcol, rkey = slack_propose_ref(*(torch.as_tensor(a) for a in
                                     (c, y_b, y_a, avail, salt)))
    packed, adm = _packed_columns(c, y_b, y_a, avail, salt)
    cuts = np.sort(rng.choice(np.arange(1, n), parts - 1, replace=False))
    best = np.full(packed.shape[:2], np.uint64(2**64 - 1))
    any_adm = np.zeros(packed.shape[:2], bool)
    for p in rng.permutation(parts):
        best = np.minimum(best, np.split(packed, cuts, axis=2)[p].min(2))
        any_adm |= np.split(adm, cuts, axis=2)[p].any(2)
    col, key = _decode(best, any_adm)
    np.testing.assert_array_equal(col, rcol.numpy())
    np.testing.assert_array_equal(key, rkey.numpy())
    assert (rcol.numpy() == -1).any()    # rows with no admissible column


@pytest.mark.parametrize("i,j", [(0, 0), (3, 17), (5, 63)])
def test_any_flag_is_not_in_the_packed_minimum(i, j):
    """Why slack_propose.cu merges the admissible flag beside the packed
    minimum: a row whose only admissible column hashes to 0xFFFFFFFF and
    a row with no admissible column have the same packed minimum, yet the
    first proposes (column 0, the first minimum of the masked keys, as the
    reference's argmin gives it) and the second does not."""
    from repro.core.matching import _propose_dense
    from repro_torch.kernels.slack_propose import proposal_keys

    m, n = 8, 64
    salt = umax_salt(i, j)
    assert int(proposal_keys(m, n, torch.tensor(salt))[i, j]) == _M32
    c = np.full((1, m, n), 5, np.int32)          # nothing admissible...
    c[0, i, j] = 0                                # ...but (i, j)
    y_b = np.ones((1, m), np.int32)
    y_a = np.zeros((1, n), np.int32)
    avail = np.ones((1, n), bool)
    salt_b = np.array([salt], np.int32)
    col, key = ops.slack_propose_batched(
        *(torch.as_tensor(a) for a in (c, y_b, y_a, avail, salt_b)))
    packed, adm = _packed_columns(c, y_b, y_a, avail, salt_b)
    best = packed.min(2)[0]
    other = (i + 1) % m
    assert best[i] == best[other]
    assert adm[0, i].any() and not adm[0, other].any()
    assert (int(col[0, i]), int(key[0, i])) == (0, _M32)
    assert (int(col[0, other]), int(key[0, other])) == (-1, _M32)
    ref = np.asarray(_propose_dense(
        jnp.asarray(c[0]), jnp.asarray(y_b[0]), jnp.asarray(y_a[0]),
        jnp.ones(m, bool), jnp.asarray(avail[0]), jnp.asarray(salt_b[0])))
    np.testing.assert_array_equal(col[0].numpy(), ref)


def _live_rows_per_block(rows, grid, active):
    """slack_propose.cu's split of a round, in its integers: passes of
    16 384 rows, and the live row of global rank q goes to block q mod G.
    Returns the live rows each block holds, per pass ((passes, G))."""
    chunk = 16 * 1024
    out, carry = [], 0
    for base in range(0, rows, chunk):
        live = int(active[base:base + chunk].sum())
        out.append(np.bincount((carry + np.arange(live)) % grid,
                               minlength=grid))
        carry += live
    return np.array(out)


@pytest.mark.parametrize("rows,grid,live", [
    (10_000, 132, 169), (10_000, 132, 9_500), (16_384, 132, 15_565),
    (40_000, 132, 20_000), (100, 64, 30), (37, 37, 37)])
def test_propose_split_fits_its_slots(rows, grid, live):
    """The premise of slack_propose.cu's persistent grid: in every pass
    the blocks hold live rows that differ by at most one, and none holds
    more than the ``cap`` slots the launcher sizes its shared memory for
    (ceil(min(rows, 16 384) / G))."""
    rng = np.random.default_rng(rows + live)
    active = np.zeros(rows, bool)
    active[rng.choice(rows, live, replace=False)] = True
    held = _live_rows_per_block(rows, grid, active)
    assert held.sum() == live
    assert (held.max(1) - held.min(1) <= 1).all()
    assert held.max() <= -(-min(rows, 16 * 1024) // grid)


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


def test_build_kernels_compiles_each_source_once_under_threads(
        monkeypatch, tmp_path):
    """Two threads reach first use together: with ``nvcc`` and the loader
    stubbed, every source is compiled exactly once, each build writes its
    own temporary file, and both threads find every kernel loaded."""
    import threading
    import time

    compiled, tmps = [], []

    class FakeProc:
        def __init__(self, argv, **kw):
            out = Path(argv[argv.index("-o") + 1])
            compiled.append(Path(argv[-1]).name)
            tmps.append(out.name)
            time.sleep(0.05)            # hold the build open for the race
            out.write_bytes(b"")
            self.returncode = 0

        def communicate(self):
            return "ptxas info: stub", None

        def poll(self):
            return 0

    class FakeLib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ops, "_libs", {})
    monkeypatch.setattr(ops, "_workspace_fns", {})
    monkeypatch.setattr(ops, "build_log", {})
    monkeypatch.setattr(ops, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ops.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(ops.ctypes, "CDLL", lambda path: FakeLib())
    go = threading.Barrier(2)
    errors = []

    def first_use():
        try:
            go.wait(timeout=10)
            ops.build_kernels()
            assert set(ops._libs) == set(ops._ENTRY)
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    sources = sorted(src for src, _, _ in ops._ENTRY.values())
    assert sorted(compiled) == sources          # each exactly once
    assert len(set(tmps)) == len(tmps)
    assert ops.build_kernels() == 0.0           # loaded: no second build
    assert sorted(compiled) == sources


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """More threads than cores and a short switch interval: a lost
    read-modify-write of a count would show."""
    import sys
    import threading

    monkeypatch.setattr(ops, "launches", dict.fromkeys(ops._ENTRY, 0))
    monkeypatch.setattr(ops, "_libs", {n: (lambda *a: 0)
                                       for n in ops._ENTRY})

    def work():
        for _ in range(1000):
            ops._launch("cost_matrix")

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
    assert ops.launches["cost_matrix"] == 16000
    ops.reset_launches()
    assert set(ops.launches.values()) == {0}


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
def test_cost_matrix_plain_keeps_nan_like_reference(metric):
    """The plain version (and so the kernel, held to it on the card)
    poisons a NaN point's row like the reference's jnp cost; the serving
    layers' admission check relies on it."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(9, 2)).astype(np.float32)
    y = rng.uniform(size=(7, 2)).astype(np.float32)
    x[4, 1] = np.nan
    got = build_cost_matrix(x, y, metric, device="cpu").numpy()
    ref = np.asarray(jax_build_cost_matrix(x, y, metric))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[4]).all() and not np.isnan(np.delete(got, 4, 0)).any()


@pytest.mark.parametrize("name", sorted(ops._ENTRY))
def test_each_wrapper_launches_under_its_tensors_device(monkeypatch, name):
    """Every wrapper makes its tensors' device current around the
    launcher and the workspace query (the ``.cu`` launchers size and
    launch on ``cudaGetDevice``'s device). Here the tensors lie on the
    CPU and ``_on_cuda`` is patched to say they do not: the recorder
    stands in for ``torch.cuda.device`` and the launchers."""
    cpu = torch.device("cpu")
    entered, seen = [], []

    class Current:
        def __init__(self, d):
            self.d = torch.device(d)

        def __enter__(self):
            entered.append(self.d)

        def __exit__(self, *exc):
            entered.pop()

    def launcher(kernel):
        return lambda *a: seen.append((kernel, tuple(entered))) or 0

    def workspace(kernel):
        return lambda *a: seen.append((kernel + ":ws", tuple(entered))) or 16

    calls = _wrapper_calls(cpu)
    monkeypatch.setattr(torch.cuda, "device", Current)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(ops, "build_kernels", lambda: 0.0)
    monkeypatch.setattr(ops, "launches", dict.fromkeys(ops._ENTRY, 0))
    monkeypatch.setattr(ops, "_libs", {k: launcher(k) for k in ops._ENTRY})
    monkeypatch.setattr(ops, "_workspace_fns",
                        {k: workspace(k) for k in ops._WORKSPACE})
    # the assignment kernel's grid path, the one that takes a workspace
    monkeypatch.setattr(ops, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(ops, "fused_assignment_route",
                        lambda *a: ops.Route("grid", 0))
    calls[name]()
    want = [(name, (cpu,))]
    if name in ops._WORKSPACE:
        want = [(name + ":ws", (cpu,))] + want
    assert seen == want
    assert ops.launches[name] == 1 and not entered
