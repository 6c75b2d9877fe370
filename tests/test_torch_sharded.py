"""repro_torch's matrix placement (``core/sharded.py``) on logical CPU
grids, held against the reference's single-device solves.

The port's block schedule runs the unchanged propose step on every
(row, col) block with an offset salt, merges the column blocks and
grants, strips and collapses on block-local flows. The integer state is
compared bit for bit with the reference's ``solve_assignment_int`` /
``solve_ot_int`` on the same integer instance, and the end-to-end
results with the reference's single-device solves (floats to ``F32``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from repro.core import api as japi
from repro.core.matching import proposal_keys as jkeys
from repro.core.pushrelabel import solve_assignment as jsolve_assignment
from repro.core.pushrelabel import solve_assignment_int as jsolve_int
from repro.core.transport import ot_phase_cap as jot_cap
from repro.core.transport import solve_ot as jsolve_ot
from repro.core.transport import solve_ot_int as jsolve_ot_int
from repro_torch.core import api as tapi
from repro_torch.core import sharded as S
from repro_torch.core.interop import state_from_numpy, state_to_numpy
from repro_torch.core.pushrelabel import round_costs, solve_assignment
from repro_torch.core.transport import ot_prologue
from repro_torch.kernels.slack_propose import (proposal_keys,
                                               slack_propose_ref)
from repro_torch.launch.mesh import make_small_mesh

from _propose_hash import umax_salt

F32 = dict(rtol=1e-6, atol=1e-6)
GRIDS = [(1, 1), (1, 2), (2, 2), (2, 4)]


def _grid_mesh(shape):
    return make_small_mesh(shape, ("data", "model"), devices="cpu")


@pytest.mark.parametrize("salt", [0, 7, -5, 2**31 - 1, -2**31, 123456789])
@pytest.mark.parametrize("r0,c0", [(0, 0), (4, 10), (12, 3), (1000, 77)])
def test_block_salt_gives_global_keys(salt, r0, c0):
    """The kernel's hash at block offset (r0, c0) under the offset salt
    equals the global hash: the (r0:r0+4, c0:c0+10) block of the
    reference's keys."""
    s2 = S.block_salt(salt, r0, c0)
    assert -2**31 <= s2 < 2**31
    assert S.block_salt(torch.tensor([salt], dtype=torch.int32), r0,
                        c0).item() == s2
    local = proposal_keys(4, 10, torch.tensor(s2, dtype=torch.int32))
    whole = np.asarray(jkeys(r0 + 4, c0 + 10, jnp.int32(salt)),
                       np.int64)[r0:, c0:]
    np.testing.assert_array_equal(local.numpy(), whole)


def _random_round(rng, m, n, dense=0.3):
    c = rng.integers(0, 5, size=(1, m, n)).astype(np.int32)
    y_b = rng.integers(0, 4, size=(1, m)).astype(np.int32)
    y_a = rng.integers(-2, 2, size=(1, n)).astype(np.int32)
    adm = rng.uniform(size=(1, m, n)) < dense
    c = np.where(adm, y_b[:, :, None] + y_a[:, None, :] - 1, c + 7)
    avail = rng.uniform(size=(1, n)) < 0.8
    active = rng.uniform(size=(1, m)) < 0.7
    return [torch.as_tensor(a) for a in (c, y_b, y_a, avail, active)]


@pytest.mark.parametrize("shape", GRIDS)
def test_block_propose_equals_whole_matrix(shape):
    """Random rounds, a row whose only admissible key is 0xFFFFFFFF (it
    still proposes the first minimum over all columns), rows with no
    admissible column."""
    rng = np.random.default_rng(3)
    m, n = 8, 16
    grid = S.BlockGrid(_grid_mesh(shape), "data", "model", m, n)
    for trial in range(6):
        c, y_b, y_a, avail, active = _random_round(rng, m, n,
                                                   dense=0.05 * trial)
        salt = torch.tensor([rng.integers(-2**31, 2**31)],
                            dtype=torch.int32)
        if trial == 5:
            # row 3's one admissible column (col 11) hashes to UMAX
            salt = torch.tensor([umax_salt(3, 11)], dtype=torch.int32)
            c[0, 3] = y_b[0, 3] + y_a[0] + 5
            c[0, 3, 11] = y_b[0, 3] + y_a[0, 11] - 1
            avail[0, 11] = True
            active[0, 3] = True
        got = grid.propose(grid.split(c), y_b, y_a, avail, salt, active)
        want = slack_propose_ref(c, y_b, y_a, avail, salt, active)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        has = want[0] >= 0
        torch.testing.assert_close(got[1][has], want[1][has], rtol=0,
                                   atol=0)
        if trial == 5:
            assert want[0][0, 3].item() == 0 and got[0][0, 3].item() == 0


def _ref_int_state(c_int, eps, m_valid=None, threshold=None):
    st = jsolve_int(jnp.asarray(c_int), eps, m_valid=m_valid,
                    threshold=threshold)
    return {f: np.asarray(v) for f, v in st._asdict().items()}


@pytest.mark.parametrize("shape", GRIDS)
def test_assignment_blocks_equal_reference_int_state(shape):
    """The block schedule's integer state equals the reference's
    ``solve_assignment_int`` on the same integer costs, field for field,
    unpadded and padded (m_valid with the host threshold)."""
    rng = np.random.default_rng(11)
    m, n, eps = 16, 24, 0.1
    c = torch.as_tensor(rng.uniform(size=(m, n)).astype(np.float32))
    c_int = round_costs(c / c.max(), eps)
    grid = S.BlockGrid(_grid_mesh(shape), "data", "model", m, n)
    got = S._solve_assignment_blocks(grid, grid.split(c_int[None]), eps,
                                     int(eps * m))
    ref = _ref_int_state(c_int.numpy(), eps)
    for f, v in ref.items():
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), v,
                                      err_msg=f)
    # padded: rows >= 13 and columns >= 21 are padding
    pad = c_int.clone()
    pad[13:] = 1 << 26
    pad[:, 21:] = 1 << 26
    thr = int(eps * 13)
    got = S._solve_assignment_blocks(grid, grid.split(pad[None]), eps, thr,
                                     m_valid=13)
    ref = _ref_int_state(pad.numpy(), eps, m_valid=jnp.int32(13),
                         threshold=jnp.int32(thr))
    for f, v in ref.items():
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), v,
                                      err_msg=f)


@pytest.mark.parametrize("shape", GRIDS)
def test_solve_assignment_sharded_and_shardmap_equal_reference(shape):
    rng = np.random.default_rng(4)
    m, n, eps = 24, 32, 0.05
    c = rng.uniform(size=(m, n)).astype(np.float32)
    mesh = _grid_mesh(shape)
    ref = jsolve_assignment(jnp.asarray(c), eps)
    for got in (S.solve_assignment_sharded(c, eps, mesh),
                S.solve_assignment_shardmap(c, eps, mesh)):
        np.testing.assert_array_equal(got.matching[0].numpy(),
                                      np.asarray(ref.matching))
        for f in ("phases", "rounds", "matched_before_completion"):
            assert int(getattr(got, f)[0]) == int(getattr(ref, f)), f
        for f in ("cost", "y_b", "y_a"):
            np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                       np.asarray(getattr(ref, f)), **F32)
    assert int(S.solve_assignment_shardmap(c, eps, mesh).sum_ni[0]) == -1
    assert int(S.solve_assignment_sharded(c, eps, mesh).sum_ni[0]) == \
        int(ref.sum_ni)


@pytest.mark.parametrize("shape", GRIDS)
def test_solve_assignment_sharded_padded_equals_unpadded(shape):
    """An instance padded to mesh-divisible dims (m_valid / n_valid)
    solves to the unpadded instance's result."""
    rng = np.random.default_rng(8)
    mi, ni, eps = 13, 21, 0.1
    c = rng.uniform(size=(mi, ni)).astype(np.float32)
    r, cc = shape
    mp, np_ = -(-mi // r) * r, -(-ni // cc) * cc + cc
    cp = np.zeros((mp, np_), np.float32)
    cp[:mi, :ni] = c
    got = S.solve_assignment_sharded(cp, eps, _grid_mesh(shape),
                                     m_valid=mi, n_valid=ni)
    ref = japi.solve(japi.ASSIGNMENT, {"c": c[None]}, eps,
                     japi.DispatchPolicy(mode="compact"))[0]
    np.testing.assert_array_equal(got.matching[0, :mi].numpy(),
                                  np.asarray(ref.matching[0]))
    assert (got.matching[0, mi:] == -1).all()
    for f in ("phases", "rounds"):
        assert int(getattr(got, f)[0]) == int(getattr(ref, f)[0]), f
    np.testing.assert_allclose(float(got.cost[0]), float(ref.cost[0]),
                               **F32)


@pytest.mark.parametrize("shape", GRIDS)
def test_ot_blocks_equal_reference_int_state(shape):
    """The OT block schedule's integer state (flows joined) equals the
    reference's ``solve_ot_int`` on the same integer instance."""
    rng = np.random.default_rng(12)
    nb, na, eps = 16, 24, 0.1
    c = torch.as_tensor(rng.uniform(size=(1, nb, na)).astype(np.float32))
    nu = torch.as_tensor(rng.dirichlet(np.ones(nb))[None].astype(
        np.float32))
    mu = torch.as_tensor(rng.dirichlet(np.ones(na))[None].astype(
        np.float32))
    theta = torch.tensor([4.0 * na / eps], dtype=torch.float32)
    c_int, s_int, d_int, _ = ot_prologue(c, nu, mu, theta,
                                         torch.tensor([eps]))
    thr = int(eps * int(s_int.sum()))
    grid = S.BlockGrid(_grid_mesh(shape), "data", "model", nb, na)
    got = S._solve_ot_blocks(grid, grid.split(c_int), s_int, d_int, thr,
                             jot_cap(eps), nb + na + 2)
    ref = jsolve_ot_int(jnp.asarray(c_int[0].numpy()),
                        jnp.asarray(s_int[0].numpy()),
                        jnp.asarray(d_int[0].numpy()), eps, jot_cap(eps),
                        nb + na + 2, threshold=jnp.int32(thr))
    for f, v in ref._asdict().items():
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(v), err_msg=f)
    assert int(got.phases[0]) > 1


@pytest.mark.parametrize("shape", GRIDS)
def test_solve_ot_sharded_equals_reference(shape):
    """End to end against the reference's eager ``solve_ot``: the integer
    state bit for bit, plan and cost to F32. Costs on a dyadic grid, so
    both packages round them to the same integers."""
    rng = np.random.default_rng(13)
    nb, na, eps = 16, 24, 0.1
    c = (rng.integers(1, 64, size=(nb, na)) / 64).astype(np.float32)
    nu = rng.dirichlet(np.ones(nb)).astype(np.float32)
    mu = rng.dirichlet(np.ones(na)).astype(np.float32)
    got = S.solve_ot_sharded(c, nu, mu, eps, _grid_mesh(shape))
    ref = jsolve_ot(jnp.asarray(c), jnp.asarray(nu), jnp.asarray(mu), eps)
    for f, v in ref.state._asdict().items():
        np.testing.assert_array_equal(getattr(got.state, f)[0].numpy(),
                                      np.asarray(v), err_msg=f)
    np.testing.assert_allclose(got.plan[0].numpy(), np.asarray(ref.plan),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got.cost[0]), float(ref.cost), **F32)
    assert float(got.theta[0]) == float(np.float32(ref.theta))


def _padded_batch(spec_name, seed):
    rng = np.random.default_rng(seed)
    b, m, n = 3, 21, 26
    sizes = np.array([[21, 26], [17, 23], [19, 19]], np.int32)
    c = np.zeros((b, m, n), np.float32)
    nu = np.zeros((b, m), np.float32)
    mu = np.zeros((b, n), np.float32)
    for i, (mi, ni) in enumerate(sizes):
        c[i, :mi, :ni] = rng.integers(1, 64, size=(mi, ni)) / 64
        nu[i, :mi] = rng.dirichlet(np.ones(mi))
        mu[i, :ni] = rng.dirichlet(np.ones(ni))
    inputs = {"c": c} if spec_name == "assignment" else {"c": c, "nu": nu,
                                                        "mu": mu}
    return inputs, sizes


@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_solve_matrix_placement_equals_reference_compact(spec_name, d):
    """``solve`` with placement="matrix" on a logical d-device mesh (folded
    into (1, 2), (2, 2), (2, 4) grids): every instance's valid block
    equals the reference's single-device compact solve (integer state
    bit for bit, floats to F32)."""
    inputs, sizes = _padded_batch(spec_name, 20 + d)
    mesh = make_small_mesh((d,), ("data",), devices="cpu")
    pol = tapi.DispatchPolicy(mode="mesh", mesh=mesh, placement="matrix",
                              chunk=4)
    spec = getattr(tapi, spec_name.upper())
    r, st = tapi.solve(spec, inputs, 0.1, pol, sizes=sizes)
    assert (st.placement, st.devices) == ("matrix", d)
    jr, _ = japi.solve(getattr(japi, spec_name.upper()), inputs, 0.1,
                       japi.DispatchPolicy(mode="compact", chunk=4),
                       sizes=sizes, keep_state=spec_name == "ot")
    np.testing.assert_allclose(r.cost.numpy(), np.asarray(jr.cost), **F32)
    np.testing.assert_array_equal(r.phases.numpy(), np.asarray(jr.phases))
    np.testing.assert_array_equal(r.rounds.numpy(), np.asarray(jr.rounds))
    for i, (mi, ni) in enumerate(sizes):
        if spec_name == "assignment":
            np.testing.assert_array_equal(r.matching[i, :mi].numpy(),
                                          np.asarray(jr.matching[i, :mi]))
            continue
        for f, v in jr.state._asdict().items():
            v = np.asarray(v)[i]
            g = getattr(r.state, f)[i].numpy()
            if v.ndim == 2:
                v, g = v[:mi, :ni], g[:mi, :ni]
            elif v.ndim == 1:
                k = mi if f in ("y_b", "free_b") else ni
                v, g = v[:k], g[:k]
            np.testing.assert_array_equal(g, v, err_msg=f)
    sol = tapi.solve(spec, inputs, 0.1, pol, sizes=sizes, want=("cost",))
    assert sol.stats.mode == "mesh" and sol.stats.placement == "matrix"
    np.testing.assert_allclose(sol.cost(), np.asarray(jr.cost), **F32)


def test_matrix_placement_keep_state_rules():
    inputs, sizes = _padded_batch("assignment", 1)
    mesh = make_small_mesh((4,), ("data",), devices="cpu")
    pol = tapi.DispatchPolicy(mode="mesh", mesh=mesh, placement="matrix")
    with pytest.raises(ValueError, match="keep_state=True requires batch"):
        tapi.solve(tapi.ASSIGNMENT, inputs, 0.1, pol, sizes=sizes,
                   keep_state=True)
    ot_in, ot_sizes = _padded_batch("ot", 1)
    r, st = tapi.solve(tapi.OT, ot_in, 0.1, pol, sizes=ot_sizes,
                       keep_state=True)
    assert st.placement == "matrix" and r.state.f_hi.shape == (3, 21, 26)
    # the stacked matrix-placement state crosses packages like any other
    d = state_to_numpy(r.state)
    back = state_from_numpy(d, device="cpu")
    for f in d:
        assert torch.equal(getattr(back, f), getattr(r.state, f)), f
    rows = [state_to_numpy(type(r.state)(*(a[i:i + 1] for a in r.state)))
            for i in range(3)]
    stacked = state_from_numpy(rows, device="cpu")
    for f in d:
        assert torch.equal(getattr(stacked, f), getattr(r.state, f)), f


def test_grid_rejects_indivisible_shapes():
    with pytest.raises(ValueError, match="pad it first"):
        S.BlockGrid(_grid_mesh((2, 4)), "data", "model", 9, 16)
    with pytest.raises(ValueError, match="pad it first"):
        S.solve_assignment_shardmap(np.ones((8, 10), np.float32), 0.1,
                                    _grid_mesh((2, 4)))


@pytest.mark.parametrize("host_threshold", [True, False])
def test_integer_solvers_equal_reference(host_threshold):
    """``solve_assignment_int`` and ``solve_ot_int`` (``repro_torch.core``)
    on one integer instance equal the reference's, field for field; OT
    also with the device f32 threshold fallback."""
    from repro_torch.core import solve_assignment_int, solve_ot_int

    rng = np.random.default_rng(14)
    nb, na, eps = 14, 18, 0.1
    c_int = rng.integers(0, 12, size=(nb, na)).astype(np.int32)
    got = solve_assignment_int(torch.as_tensor(c_int), eps)
    for f, v in _ref_int_state(c_int, eps).items():
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), v,
                                      err_msg=f)
    s_int = rng.integers(0, 9, size=nb).astype(np.int32)
    d_int = rng.integers(0, 9, size=na).astype(np.int32)
    d_int[0] += max(0, int(s_int.sum()) - int(d_int.sum()))
    thr = int(eps * int(s_int.sum())) if host_threshold else None
    got = solve_ot_int(torch.as_tensor(c_int), torch.as_tensor(s_int),
                       torch.as_tensor(d_int), eps, jot_cap(eps),
                       nb + na + 2, threshold=thr)
    ref = jsolve_ot_int(jnp.asarray(c_int), jnp.asarray(s_int),
                        jnp.asarray(d_int), eps, jot_cap(eps), nb + na + 2,
                        threshold=None if thr is None else jnp.int32(thr))
    for f, v in ref._asdict().items():
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(v), err_msg=f)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_lower_sharded_solver_blocks_equal_the_solve(shape, monkeypatch):
    """The plan's blocks are the blocks ``solve_assignment_sharded``
    launches ``slack_propose`` on (shape and device), one launch a block
    a round."""
    n, eps = 32, 0.1
    mesh = _grid_mesh(shape)
    plan = S.lower_sharded_solver(n, eps, mesh)
    seen = []
    orig = S.ops.slack_propose_batched

    def spy(c_int, *a, **kw):
        seen.append((tuple(c_int.shape), str(c_int.device)))
        return orig(c_int, *a, **kw)
    monkeypatch.setattr(S.ops, "slack_propose_batched", spy)
    rng = np.random.default_rng(sum(shape))
    c = rng.uniform(size=(n, n)).astype(np.float32)
    got = S.solve_assignment_sharded(c, eps, mesh)
    launched = list(seen)   # the single-device solve below launches too
    single = solve_assignment(c, eps, device="cpu")
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    per_round = plan.per_round["slack_propose_launches"]
    assert per_round == shape[0] * shape[1] == len(plan.blocks)
    assert len(launched) % per_round == 0 and launched
    want = [(tuple(b["shape"]), b["device"]) for b in plan.blocks]
    for r in range(len(launched) // per_round):
        assert launched[r * per_round:(r + 1) * per_round] == want
    assert sum(b["bytes"] for b in plan.blocks) == 4 * n * n
    rows = [b["rows"] for b in plan.blocks]
    grid = S.BlockGrid(mesh, "data", "model", n, n)
    assert sorted(set(rows)) == grid.rows


def test_lower_sharded_solver_plan_records_and_cpu_compile():
    plan = S.lower_sharded_solver(64, 0.05, _grid_mesh((2, 2)))
    recs = plan.per_round["records"]
    # each block: its 5 inputs and its 2 results; one scatter-min
    assert len(recs) == 4 * 7 + 1
    merge = [r for r in recs if "merge" in r["what"]]
    assert {(r["dtype"], tuple(r["shape"])) for r in merge} == {
        ("s32", (1, 32)), ("s64", (1, 32))}
    assert recs[-1]["shape"] == [1, 64] and recs[-1]["dtype"] == "s32"
    assert plan.per_round["bytes_crossing_devices"] == 0   # one device
    out = plan.compile()
    assert out["built"] is False and out["devices"] == ["cpu"]
    with pytest.raises(ValueError, match="pad it first"):
        S.lower_sharded_solver(30, 0.05, _grid_mesh((2, 4)))
    meta = S.lower_sharded_solver(1 << 20, 0.05, make_small_mesh(
        (2, 2), devices="meta"))
    assert meta.blocks[0]["bytes"] == 4 * (1 << 19) ** 2
