"""repro_torch's CUDA kernels against their plain versions, and the main
path on the card against the CPU. Needs an NVIDIA GPU; every test skips
without one (imports neither jax nor repro, so it runs on a machine that
has only torch)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.api import ASSIGNMENT, OT, solve
from repro_torch.kernels import ops
from repro_torch.kernels.cost_matrix import cost_matrix_ref, tolerance
from repro_torch.kernels.slack_propose import slack_propose_ref

from _propose_hash import umax_salt


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _propose_inputs(seed, b, m, n, dev):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.integers(0, 6, size=(b, m, n)).astype(np.int32),
        rng.integers(0, 4, size=(b, m)).astype(np.int32),
        -rng.integers(0, 4, size=(b, n)).astype(np.int32),
        rng.uniform(size=(b, n)) < 0.6,
        rng.integers(0, 2**31 - 1, size=b).astype(np.int32),
        rng.uniform(size=(b, m)) < 0.75,
    )
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n", [(1, 300, 1000), (3, 257, 130),
                                   (2, 64, 301)])
def test_slack_propose_kernel_equals_plain(dev, b, m, n):
    c, y_b, y_a, avail, salt, active = _propose_inputs(b * m + n, b, m, n,
                                                       dev)
    before = ops.launches["slack_propose"]
    col, key = ops.slack_propose_batched(c, y_b, y_a, avail, salt,
                                         active_b=active)
    rcol, rkey = slack_propose_ref(c, y_b, y_a, avail, salt, active)
    torch.cuda.synchronize()
    assert ops.launches["slack_propose"] == before + 1
    assert torch.equal(col, rcol) and torch.equal(key, rkey)


@pytest.mark.cuda
def test_slack_propose_misaligned_rows_take_scalar_path(dev):
    """A contiguous view that starts off a 16-byte boundary still gives
    the plain version's answer."""
    c, y_b, y_a, avail, salt, active = _propose_inputs(1, 2, 17, 64, dev)
    c1 = torch.cat([c.flatten(), c.flatten()[:1]])[1:].view(2, 17, 64)
    col, key = ops.slack_propose_batched(c1, y_b, y_a, avail, salt,
                                         active_b=active)
    rcol, rkey = slack_propose_ref(c1, y_b, y_a, avail, salt, active)
    assert torch.equal(col, rcol) and torch.equal(key, rkey)


def _propose_live(seed, b, m, n, live, dev):
    """``_propose_inputs`` with exactly ``live`` active rows per lane, at
    random places, each with y_b >= 1 (a row with y_b = 0 has no
    admissible column there), so about 2.5 % of their columns are
    admissible."""
    c, y_b, y_a, avail, salt, _ = _propose_inputs(seed, b, m, n, dev)
    rng = np.random.default_rng(seed + 1)
    active = np.zeros((b, m), bool)
    for lane in range(b):
        active[lane, rng.choice(m, live, replace=False)] = True
    active = torch.as_tensor(active, device=dev)
    y_b = torch.where(active, y_b.clamp(min=1), y_b)
    return c, y_b, y_a, avail, salt, active


def _assert_propose_equals_plain(c, y_b, y_a, avail, salt, active):
    before = ops.launches["slack_propose"]
    col, key = ops.slack_propose_batched(c, y_b, y_a, avail, salt,
                                         active_b=active)
    rcol, rkey = slack_propose_ref(c, y_b, y_a, avail, salt, active)
    torch.cuda.synchronize()
    assert ops.launches["slack_propose"] == before + 1
    assert torch.equal(col, rcol) and torch.equal(key, rkey)
    return col


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,live", [
    (1, 10_000, 10_000, 1), (1, 10_000, 10_000, 17),
    (1, 10_000, 10_000, 169), (16, 1024, 1024, 1), (16, 1024, 1024, 0)])
def test_slack_propose_few_live_rows(dev, b, m, n, live):
    """The late rounds the stepped route runs: a live row spread over up
    to 32 warps, one live row per lane, none at all."""
    args = _propose_live(live + n, b, m, n, live, dev)
    col = _assert_propose_equals_plain(*args)
    assert int((col >= 0).sum()) == b * live


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,live,offset", [
    (3000, 10_001, 1, 0), (3000, 10_001, 169, 0), (2000, 10_000, 17, 1),
    (500, 1027, 9, 0)])
def test_slack_propose_scalar_path_few_live_rows(dev, m, n, live, offset):
    """n not a multiple of 4, or a view of c_int that starts off a 16-byte
    boundary: the 4-byte loads, with rows cut into parts."""
    c, y_b, y_a, avail, salt, active = _propose_live(n + live, 1, m, n,
                                                     live, dev)
    if offset:
        flat = c.flatten()
        c = torch.cat([flat, flat[:offset]])[offset:].view(1, m, n)
        assert c.data_ptr() % 16 != 0
    _assert_propose_equals_plain(c, y_b, y_a, avail, salt, active)


@pytest.mark.cuda
@pytest.mark.parametrize("live", [1, 2, 169])
def test_slack_propose_only_admissible_column_is_the_last(dev, live):
    """Each live row's one admissible column is its last, in the last part
    of a split row; half the live rows have none at all."""
    m, n = 2000, 10_000
    c, y_b, y_a, avail, salt, active = _propose_live(live, 1, m, n, live,
                                                     dev)
    c = (y_b[:, :, None] + y_a[:, None, :]).to(torch.int32)  # none
    rows = torch.nonzero(active[0]).flatten()
    c[0, rows[::2], n - 1] -= 1                              # but the last
    avail[0, n - 1] = True
    col = _assert_propose_equals_plain(c, y_b, y_a, avail, salt, active)
    assert torch.equal(col[0, rows[::2]],
                       torch.full_like(rows[::2], n - 1, dtype=torch.int32))
    assert (col[0, rows[1::2]] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("live", [2, 169])
def test_slack_propose_key_umax_still_proposes(dev, live):
    """A row whose only admissible column hashes to 0xFFFFFFFF proposes
    (column 0, the first minimum of the masked keys), a row with no
    admissible column does not: the merged admissible flag, not the
    packed minimum, tells them apart."""
    m, n = 2000, 10_000
    i, j = 0, 7777
    c, y_b, y_a, _, _, active = _propose_live(live, 1, m, n, live, dev)
    c = (y_b[:, :, None] + y_a[:, None, :]).to(torch.int32)  # none
    c[0, i, j] -= 1
    active[0, i] = active[0, i + 1] = True
    avail = torch.ones((1, n), dtype=torch.bool, device=dev)
    salt = torch.tensor([umax_salt(i, j)], dtype=torch.int32, device=dev)
    col = _assert_propose_equals_plain(c, y_b, y_a, avail, salt, active)
    assert int(col[0, i]) == 0 and int(col[0, i + 1]) == -1


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(dev):
    c, y_b, y_a, avail, salt, _ = _propose_inputs(2, 1, 8, 8, dev)
    with pytest.raises(TypeError):
        ops.slack_propose_batched(c.to(torch.int64), y_b, y_a, avail, salt)
    with pytest.raises(ValueError):
        ops.slack_propose_batched(c.transpose(1, 2), y_b, y_a, avail, salt)
    with pytest.raises(ValueError):
        ops.cost_matrix_batched(torch.zeros(1, 4, 2, device=dev),
                                torch.zeros(1, 4, 3, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
@pytest.mark.parametrize("b,m,n,d", [(1, 1000, 999, 2), (4, 70, 130, 33),
                                     (1, 256, 300, 784)])
def test_cost_matrix_kernel_vs_plain(dev, metric, b, m, n, d):
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.uniform(size=(b, m, d)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.uniform(size=(b, n, d)).astype(np.float32),
                        device=dev)
    got = ops.cost_matrix_batched(x, y, metric)
    ref = cost_matrix_ref(x, y, metric)
    rtol, atol = tolerance(metric, d)
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_solve_on_card_equals_cpu(dev, name):
    """The same float costs solved on the card (through the kernels) and
    on the CPU (plain versions) give the same integer state."""
    rng = np.random.default_rng(3)
    insts = []
    for n in (20, 45, 64):
        c = rng.uniform(size=(n, n)).astype(np.float32)
        insts.append(c if name == "assignment" else (
            c, rng.dirichlet(np.ones(n)).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32)))
    spec = ASSIGNMENT if name == "assignment" else OT
    before = ops.launches["slack_propose"]
    card = solve(spec, insts, 0.05, want=("cost", "state"), device=dev)
    assert ops.launches["slack_propose"] > before
    cpu = solve(spec, insts, 0.05, want=("cost", "state"), device="cpu")
    for a, b in zip(card, cpu):
        sa, sb = a.state(), b.state()
        for f in sa._fields:
            assert torch.equal(getattr(sa, f).cpu(), getattr(sb, f)), f


def _fused_assignment_inputs(dev, b, m, n, seed, eps=(0.03, 0.06, 0.1)):
    """``b`` lanes at eps cycling through ``eps`` (so they stop at
    different phases) and ragged ``m_valid``; rows beyond it are padding."""
    from repro_torch.core.pushrelabel import PAD_COST, _max_phases

    rng = np.random.default_rng(seed)
    eps = np.resize(np.asarray(eps), b)
    mv = np.maximum(m - (np.arange(b) % 3) * (m // 5), 1).astype(np.int32)
    c_int = np.floor(rng.uniform(size=(b, m, n))
                     / eps[:, None, None]).astype(np.int32)
    for i in range(b):
        c_int[i, mv[i]:] = PAD_COST
    thr = np.array([int(e * v) for e, v in zip(eps, mv)], np.int32)
    cap = np.array([_max_phases(e, m) for e in eps], np.int32)
    return [torch.as_tensor(a, device=dev) for a in (c_int, thr, cap, mv)]


def _fused_ot_inputs(dev, b, nb, na, seed, eps=(0.05, 0.1, 0.08)):
    from repro_torch.core.transport import init_ot_state, ot_phase_cap

    rng = np.random.default_rng(seed)
    eps = np.resize(np.asarray(eps), b)
    theta = (4.0 * max(nb, na) / eps).astype(np.float32)
    c_int = np.floor(rng.uniform(size=(b, nb, na))
                     / eps[:, None, None]).astype(np.int32)
    s_int = np.floor(rng.dirichlet(np.ones(nb), b) * theta[:, None])
    d_int = np.ceil(rng.dirichlet(np.ones(na), b) * theta[:, None])
    thr = np.array([int(e * s.sum()) for e, s in zip(eps, s_int)], np.int32)
    cap = np.array([ot_phase_cap(e) for e in eps], np.int32)
    state = init_ot_state(torch.as_tensor(s_int.astype(np.int32), device=dev),
                          torch.as_tensor(d_int.astype(np.int32), device=dev))
    return [torch.as_tensor(a, device=dev) for a in (c_int, thr, cap)], state


def _states_equal(a, b):
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in a._fields)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n,k", [(3, 24, 24, 3), (5, 33, 47, 8),
                                     (4, 300, 256, 2), (1, 700, 800, 5)])
def test_fused_assignment_kernel_equals_plain(dev, b, m, n, k):
    """Chunk by chunk on the card, ragged m_valid, lanes that stop at
    different phases, odd and 16-byte-aligned widths."""
    from repro_torch.core.pushrelabel import init_assignment_state
    from repro_torch.kernels.fused_phase import fused_assignment_phases_ref

    c, thr, cap, mv = _fused_assignment_inputs(dev, b, m, n, b * m + n)
    got = ref = init_assignment_state(b, m, n, dev)
    for _ in range(6):
        before = ops.launches["fused_assignment_phases"]
        got = ops.fused_run_assignment_phases(c, got, thr, cap, k,
                                              m_valid=mv)
        assert ops.launches["fused_assignment_phases"] == before + 1
        ref = type(ref)(*fused_assignment_phases_ref(c, *ref, thr, cap, mv,
                                                     k=k))
        torch.cuda.synchronize()
        assert _states_equal(got, ref)


# (b, m, n, k, chunks, oracle): what the one-barrier-per-round design
# with candidate lists can get wrong. "plain" holds the kernel against
# fused_assignment_phases_ref, "stepped" against run_assignment_phases on
# the card (the plain version is too slow at 4096^2).
FUSED_ASSIGNMENT_CASES = {
    # eps 0.03 / 0.06 / 0.1 lanes: their matchings end in different rounds
    "lanes_end_in_different_rounds": (6, 96, 96, 4, 5, "plain"),
    # lane 0's threshold is already met: it takes no phase
    "lane_below_threshold": (3, 64, 64, 3, 4, "plain"),
    "m_above_n": (3, 120, 72, 4, 4, "plain"),
    "n_above_m": (3, 72, 120, 4, 4, "plain"),
    # k above every lane's phase cap: each lane stops on its own
    "k_above_cap": (3, 20, 24, 0, 1, "plain"),
    # n % 4 != 0: the 4-byte scan
    "unaligned_n": (4, 64, 47, 5, 4, "plain"),
    # 32 768 rows of B' in the first rounds: more candidates than
    # resident warps, one warp per row
    "long_list_warp_per_row": (8, 4096, 4096, 8, 2, "stepped"),
    # at most 300 candidates: one block per row throughout
    "short_list_block_per_row": (1, 300, 320, 8, 4, "plain"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUSED_ASSIGNMENT_CASES))
def test_fused_assignment_kernel_design_cases(dev, case):
    from repro_torch.core.pushrelabel import (init_assignment_state,
                                              run_assignment_phases)
    from repro_torch.kernels.fused_phase import fused_assignment_phases_ref

    b, m, n, k, chunks, oracle = FUSED_ASSIGNMENT_CASES[case]
    c, thr, cap, mv = _fused_assignment_inputs(dev, b, m, n, b * m + n)
    if case == "lane_below_threshold":
        thr[0] = m
    k = k or int(cap.max()) + 1
    got = ref = init_assignment_state(b, m, n, dev)
    for _ in range(chunks):
        got = ops.fused_run_assignment_phases(c, got, thr, cap, k,
                                              m_valid=mv)
        if oracle == "plain":
            ref = type(ref)(*fused_assignment_phases_ref(c, *ref, thr, cap,
                                                         mv, k=k))
        else:
            ref = run_assignment_phases(c, ref, thr, cap, k, m_valid=mv)
        torch.cuda.synchronize()
        assert _states_equal(got, ref)
    phases = got.phases.tolist()
    if case == "lane_below_threshold":
        assert phases[0] == 0 and max(phases) > 0
    if case == "lanes_end_in_different_rounds":
        assert len(set(got.rounds.tolist())) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,nb,na,k", [(3, 16, 16, 3), (4, 21, 13, 8),
                                       (2, 300, 290, 2), (1, 512, 512, 4)])
def test_fused_ot_kernel_equals_plain(dev, b, nb, na, k):
    from repro_torch.kernels.fused_phase import fused_ot_phases_ref

    (c, thr, cap), got = _fused_ot_inputs(dev, b, nb, na, b * nb + na)
    ref = got
    for _ in range(4):
        before = ops.launches["fused_ot_phases"]
        got = ops.fused_run_ot_phases(c, got, thr, cap, k, nb + na + 2)
        assert ops.launches["fused_ot_phases"] == before + 1
        ref = type(ref)(*fused_ot_phases_ref(c, *ref, thr, cap, k=k,
                                             max_rounds=nb + na + 2))
        torch.cuda.synchronize()
        assert _states_equal(got, ref)


# (b, nb, na, k, chunks, oracle): what the redesigned fused_ot.cu (lists
# of live proposers, end-of-phase work limited to the column groups that
# granted, strips over row tiles of 64) can get wrong. "plain" holds the
# kernel against fused_ot_phases_ref, "stepped" against run_ot_phases on
# the card (the plain version is too slow at 4096^2).
FUSED_OT_CASES = {
    # eps 0.05 / 0.1 / 0.08 lanes: they end in different phases and rounds
    "lanes_end_in_different_phases": (6, 96, 96, 4, 5, "plain"),
    # lane 0's threshold is already met: it takes no phase
    "lane_below_threshold": (3, 64, 64, 3, 4, "plain"),
    "nb_above_na": (3, 120, 72, 4, 4, "plain"),
    "na_above_nb": (3, 72, 120, 4, 4, "plain"),
    # na % 4 != 0: the 4-byte scan
    "unaligned_na": (4, 64, 47, 5, 4, "plain"),
    # 24 row tiles, more rows than a grant tile of 1024, two column
    # groups: strips reach above the bottom tile
    "strip_across_row_tiles": (2, 1500, 40, 8, 3, "plain"),
    # emptied hi clusters collapse (ya_hi falls)
    "columns_collapse": (3, 64, 64, 4, 6, "plain"),
    # k above every lane's phase cap: each lane stops on its own
    "k_above_cap": (3, 20, 24, 0, 1, "plain"),
    # the OT cell's width
    "full_width": (1, 4096, 4096, 8, 1, "stepped"),
}


def _check_fused_ot_case(dev, case, kernel):
    """Runs FUSED_OT_CASES[case] chunk by chunk through ``kernel`` (the
    signature of ``ops.fused_run_ot_phases``) against its oracle and
    asserts that the case exercised what it names."""
    from repro_torch.core.transport import run_ot_phases
    from repro_torch.kernels.fused_phase import fused_ot_phases_ref

    b, nb, na, k, chunks, oracle = FUSED_OT_CASES[case]
    (c, thr, cap), got = _fused_ot_inputs(dev, b, nb, na, b * nb + na)
    if case == "lane_below_threshold":
        thr[0] = int(got.free_b[0].sum())
    k = k or int(cap.max()) + 1
    mr = nb + na + 2
    ref = got
    strips_above = 0
    for _ in range(chunks):
        before = got
        got = kernel(c, got, thr, cap, k, mr)
        if oracle == "plain":
            ref = type(ref)(*fused_ot_phases_ref(c, *ref, thr, cap, k=k,
                                                 max_rounds=mr))
        else:
            ref = run_ot_phases(c, ref, thr, cap, k, mr)
        assert _states_equal(got, ref)
        # f_hi fell above the bottom row tile in a column that kept its
        # level: a strip crossed a tile boundary
        kept = (got.ya_hi == before.ya_hi)[:, None, :]
        fell = (got.f_hi < before.f_hi) & kept
        strips_above += int(fell[:, :nb - 64].sum())
    phases = got.phases.tolist()
    assert max(phases) > 0
    if case == "lanes_end_in_different_phases":
        assert len(set(phases)) > 1 and len(set(got.rounds.tolist())) > 1
    if case == "lane_below_threshold":
        assert phases[0] == 0 and max(phases[1:]) > 0
    if case == "k_above_cap":
        assert all(p < k for p in phases)
    if case == "columns_collapse":
        assert bool((got.ya_hi < 0).any())
    if case == "strip_across_row_tiles":
        assert strips_above > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUSED_OT_CASES))
def test_fused_ot_kernel_design_cases(dev, case):
    _check_fused_ot_case(dev, case, ops.fused_run_ot_phases)


@pytest.mark.cuda
def test_fused_wrappers_refuse_bad_operands(dev):
    from repro_torch.core.pushrelabel import init_assignment_state

    c, thr, cap, mv = _fused_assignment_inputs(dev, 2, 8, 8, 1)
    state = init_assignment_state(2, 8, 8, dev)
    with pytest.raises(TypeError):
        ops.fused_run_assignment_phases(c.to(torch.int64), state, thr, cap,
                                        2, m_valid=mv)
    with pytest.raises(ValueError):
        ops.fused_run_assignment_phases(c, state, thr[:1], cap, 2,
                                        m_valid=mv)
    with pytest.raises(ValueError):
        ops.fused_run_assignment_phases(c.transpose(1, 2), state, thr, cap,
                                        2, m_valid=mv)
    with pytest.raises(ValueError):
        ops.fused_run_assignment_phases(c, state._replace(
            y_b=state.y_b.cpu()), thr, cap, 2, m_valid=mv)
    (oc, othr, ocap), ostate = _fused_ot_inputs(dev, 2, 8, 8, 1)
    with pytest.raises(ValueError):
        ops.fused_run_ot_phases(oc, ostate._replace(
            f_hi=ostate.f_hi[:, :4]), othr, ocap, 2, 18)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lockstep", "compact"])
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_fused_solve_on_card_equals_stepped_cpu(dev, name, mode):
    """The fused route on the card launches only the fused kernel and
    reads no round flag, and gives the stepped CPU route's state."""
    from repro_torch.core import device as rdev
    from repro_torch.core.api import DispatchPolicy

    rng = np.random.default_rng(4)
    insts = []
    for n in (20, 45, 64):
        c = rng.uniform(size=(n, n)).astype(np.float32)
        insts.append(c if name == "assignment" else (
            c, rng.dirichlet(np.ones(n)).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32)))
    spec = ASSIGNMENT if name == "assignment" else OT
    ops.reset_launches()
    rdev.reset_sync_counts()
    card = solve(spec, insts, 0.05, DispatchPolicy(mode=mode, fused=True),
                 want=("cost", "state"), device=dev)
    assert ops.launches[f"fused_{name}_phases"] > 0
    assert ops.launches["slack_propose"] == 0
    assert rdev.sync_counts["round"] == 0
    cpu = solve(spec, insts, 0.05, DispatchPolicy(mode=mode),
                want=("cost", "state"), device="cpu")
    for a, b in zip(card, cpu):
        assert _states_equal(a.state(), b.state())


def _sinkhorn_row_inputs(dev, b, m, n, seed):
    """Per-lane reg from eps in {0.3, 0.1, 0.05, 0.03}, ragged valid blocks
    (cost 0 and zero mass outside), the last lane with zero mass."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(size=(b, m, n)).astype(np.float32)
    nu = rng.dirichlet(np.ones(m), b).astype(np.float32)
    g = rng.normal(0.0, 0.2, (b, n)).astype(np.float32)
    for i in range(b):
        mi, ni = max(m - 7 * i, 1), max(n - 11 * i, 1)
        c[i, mi:], c[i, :, ni:], nu[i, mi:] = 0.0, 0.0, 0.0
    nu[-1] = 0.0
    nu_hat = nu / np.maximum(nu.sum(1, keepdims=True), 1e-30)
    log_nu = np.log(np.maximum(nu_hat, 1e-30)).astype(np.float32)
    eps = np.resize([0.3, 0.1, 0.05, 0.03], b)
    reg = (eps / (4 * np.log(max(m, n)))).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (c, g, log_nu, reg)]


def _assert_rows_close(got, ref):
    """The kernel and the plain version sum the same terms in another
    order (and with the card's expf): rtol 1e-5, atol 1e-5 * max|f|."""
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n", [(1, 300, 1000), (3, 257, 130),
                                   (8, 64, 1000), (2, 5, 3)])
def test_sinkhorn_row_kernel_equals_plain(dev, b, m, n):
    """16-byte and scalar paths (n % 4 != 0), B > 1 with per-lane reg, a
    zero-mass lane; with ``active_b`` the marked-off lanes keep ``f``."""
    from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref

    c, g, log_nu, reg = _sinkhorn_row_inputs(dev, b, m, n, b * m + n)
    before = ops.launches["sinkhorn_row_update"]
    got = ops.sinkhorn_row_update(c, g, log_nu, reg)
    assert ops.launches["sinkhorn_row_update"] == before + 1
    ref = sinkhorn_row_ref(c, g, log_nu, reg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_rows_close(got, ref)
    active = torch.arange(b, device=dev) % 2 == 0
    f_old = torch.full((b, m), 7.0, device=dev)
    masked = ops.sinkhorn_row_update(c, g, log_nu, reg, active_b=active,
                                     f=f_old)
    torch.cuda.synchronize()
    assert torch.equal(masked[~active], f_old[~active])
    _assert_rows_close(masked[active], ref[active])


@pytest.mark.cuda
def test_sinkhorn_row_misaligned_view_takes_scalar_path(dev):
    from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref

    c, g, log_nu, reg = _sinkhorn_row_inputs(dev, 2, 17, 64, 9)
    c1 = torch.cat([c.flatten(), c.flatten()[:1]])[1:].view(2, 17, 64)
    _assert_rows_close(ops.sinkhorn_row_update(c1, g, log_nu, reg),
                       sinkhorn_row_ref(c1, g, log_nu, reg))


@pytest.mark.cuda
def test_sinkhorn_row_wrapper_refuses_bad_operands(dev):
    c, g, log_nu, reg = _sinkhorn_row_inputs(dev, 2, 8, 12, 1)
    with pytest.raises(TypeError):
        ops.sinkhorn_row_update(c.double(), g, log_nu, reg)
    with pytest.raises(ValueError):
        ops.sinkhorn_row_update(c.transpose(1, 2).contiguous(), g, log_nu,
                                reg)
    with pytest.raises(ValueError):
        ops.sinkhorn_row_update(c, g, log_nu, reg.cpu())
    with pytest.raises(ValueError):
        ops.sinkhorn_row_update(c[:, :, ::2], g[:, ::2], log_nu, reg)
    with pytest.raises(ValueError):
        ops.sinkhorn_row_update(c, g, log_nu, reg[:1])
    with pytest.raises(ValueError):
        ops.sinkhorn_row_update(c, g, log_nu, reg,
                                active_b=torch.ones(2, dtype=torch.bool,
                                                    device=dev))


# (B, m, n): the route's row lengths, long rows (8192, 12 000), the
# 4-byte path for each n % 4, B m not a multiple of a block's rows, blocks
# whose rows cross lanes, fewer rows than SMs
SINKHORN_ROW_CASES = {
    "n1000_b8": (8, 1024, 1000),
    "n4096": (1, 600, 4096),
    "n8192_two_segments": (2, 40, 8192),
    "n12000_g_in_stages": (2, 40, 12_000),
    "n_mod4_1": (3, 77, 1001),
    "n_mod4_2": (3, 77, 1002),
    "n_mod4_3": (3, 77, 1003),
    "ragged_grid": (3, 1000, 64),
    "lanes_inside_a_block": (600, 3, 1000),
    "fewer_rows_than_sms": (1, 5, 4096),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SINKHORN_ROW_CASES))
def test_sinkhorn_row_kernel_design_cases(dev, case):
    """Each case against the plain version (per-lane reg, ragged valid
    blocks, a zero-mass lane); then with ``active_b`` marking off every
    third lane, several inside one block where m is small: those rows
    bit-equal to ``f``, the others bit-equal to the unmasked run."""
    from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref

    b, m, n = SINKHORN_ROW_CASES[case]
    c, g, log_nu, reg = _sinkhorn_row_inputs(dev, b, m, n, b + m + n)
    before = ops.launches["sinkhorn_row_update"]
    got = ops.sinkhorn_row_update(c, g, log_nu, reg)
    assert ops.launches["sinkhorn_row_update"] == before + 1
    ref = sinkhorn_row_ref(c, g, log_nu, reg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_rows_close(got, ref)
    active = torch.arange(b, device=dev) % 3 != 1
    f_old = torch.randn((b, m), device=dev)
    masked = ops.sinkhorn_row_update(c, g, log_nu, reg, active_b=active,
                                     f=f_old)
    torch.cuda.synchronize()
    assert torch.equal(masked[~active], f_old[~active])
    assert torch.equal(masked[active], got[active])


@pytest.mark.cuda
def test_sinkhorn_row_no_lane_active_reads_nothing(dev):
    c, g, log_nu, reg = _sinkhorn_row_inputs(dev, 4, 300, 1000, 4)
    f_old = torch.randn((4, 300), device=dev)
    out = ops.sinkhorn_row_update(c, g, log_nu, reg,
                                  active_b=torch.zeros(4, dtype=torch.bool,
                                                       device=dev),
                                  f=f_old)
    torch.cuda.synchronize()
    assert torch.equal(out, f_old)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["c", "g"])
def test_sinkhorn_row_misaligned_operand_takes_scalar_path(dev, which):
    """n % 4 == 0 but c (or g) starts off a 16-byte boundary: the 16-byte
    loads cannot take it, so the wrapper picks the 4-byte path."""
    from repro_torch.kernels.sinkhorn_step import sinkhorn_row_ref

    c, g, log_nu, reg = _sinkhorn_row_inputs(dev, 3, 50, 1000, 11)
    if which == "c":
        flat = c.flatten()
        c = torch.cat([flat, flat[:1]])[1:].view(3, 50, 1000)
        assert c.data_ptr() % 16 != 0
    else:
        flat = g.flatten()
        g = torch.cat([flat, flat[:1]])[1:].view(3, 1000)
        assert g.data_ptr() % 16 != 0
    _assert_rows_close(ops.sinkhorn_row_update(c, g, log_nu, reg),
                       sinkhorn_row_ref(c, g, log_nu, reg))


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n", [(1, 131, 257), (16, 70, 130),
                                   (1, 200, 1027)])
@pytest.mark.parametrize("d", [1, 2, 3, 16, 17, 784, 785])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
def test_cost_matrix_instances_vs_plain(dev, metric, d, b, m, n):
    """Both instances (points d <= 16, images d > 16; 16-byte copies at
    d = 784, 4-byte at 17 and 785) on m, n off the 128 tile and
    n % 4 in {1, 2, 3} (scalar stores), B = 1 and B = 16, within the
    metric's tolerance."""
    rng = np.random.default_rng(d * 1000 + m)
    x = torch.as_tensor(rng.uniform(size=(b, m, d)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.uniform(size=(b, n, d)).astype(np.float32),
                        device=dev)
    before = ops.launches["cost_matrix"]
    got = ops.cost_matrix_batched(x, y, metric)
    assert ops.launches["cost_matrix"] == before + 1
    ref = cost_matrix_ref(x, y, metric)
    rtol, atol = tolerance(metric, d)
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
@pytest.mark.parametrize("d", [2, 784])
def test_cost_matrix_misaligned_view(dev, metric, d):
    """x starting off a 16-byte boundary: the images instance copies in
    4-byte pieces; the points instance reads it as it is."""
    rng = np.random.default_rng(d)
    flat = torch.as_tensor(rng.uniform(size=300 * d + 1).astype(np.float32),
                           device=dev)
    x = flat[1:].view(1, 300, d)
    assert x.data_ptr() % 16 != 0
    y = torch.as_tensor(rng.uniform(size=(1, 260, d)).astype(np.float32),
                        device=dev)
    rtol, atol = tolerance(metric, d)
    torch.testing.assert_close(ops.cost_matrix_batched(x, y, metric),
                               cost_matrix_ref(x, y, metric), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_sinkhorn_solve_on_card_equals_cpu(dev, fused):
    """solve(..., solver="sinkhorn") on the card against the CPU: the
    card's exp, logsumexp and sums run in another order over hundreds of
    iterations, which the contraction of the iteration keeps small: costs
    and duals within rtol 1e-4, atol 1e-5 * scale, iteration counts equal
    or one apart where the error crossed tol within f32 noise. With
    ``fused=True`` every f-update launches the row kernel."""
    from repro_torch.core.api import DispatchPolicy
    from repro_torch.portfolio import sinkhorn_spec

    rng = np.random.default_rng(5)
    insts = []
    for n in (20, 45, 64):
        insts.append((rng.uniform(size=(n, n)).astype(np.float32),
                      rng.dirichlet(np.ones(n)).astype(np.float32),
                      rng.dirichlet(np.ones(n)).astype(np.float32)))
    policy = DispatchPolicy(solver="sinkhorn", fused=fused)
    ops.reset_launches()
    sinkhorn_spec.reset_counts()
    card = solve(OT, insts, 0.1, policy, want=("cost", "duals"), device=dev)
    launched = ops.launches["sinkhorn_row_update"]
    assert launched == (sinkhorn_spec.counts["f_updates"] if fused else 0)
    cpu = solve(OT, insts, 0.1, policy, want=("cost", "duals"), device="cpu")
    for a, b in zip(card, cpu):
        assert abs(a.phases - b.phases) <= 1
        assert a.dual_feasible() and a.additive_gap() <= \
            a.additive_gap_bound()
        if a.phases != b.phases:
            continue
        scale = float(np.abs(b.duals()[0]).max())
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-4)
        for x, y in zip(a.duals(), b.duals()):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.cuda
def test_scheduler_round_trip_on_card_launches_kernels(dev):
    """AsyncOTScheduler on the card: every bucket builds its costs with
    the cost_matrix kernel and proposes with slack_propose, every request
    resolves at ladder level 0, and each bucket's integer state equals a
    direct solve() of the same padded costs on the card and on the CPU."""
    from repro_torch.core.api import DispatchPolicy
    from repro_torch.serve.scheduler import AsyncOTScheduler

    rng = np.random.default_rng(19)
    reqs = []
    for i in range(6):
        m, n = int(rng.integers(100, 300)), int(rng.integers(100, 300))
        x = rng.uniform(size=(m, 2)).astype(np.float32)
        y = rng.uniform(size=(n, 2)).astype(np.float32)
        if i % 2:
            reqs.append((x, y, rng.dirichlet(np.ones(m)).astype(np.float32),
                         rng.dirichlet(np.ones(n)).astype(np.float32)))
        else:
            reqs.append((x, y, None, None))
    policy = DispatchPolicy(mode="compact")
    items = []
    ops.reset_launches()
    with AsyncOTScheduler(eps=0.1, linger_ms=20, want=("cost", "state"),
                          device=dev, join_timeout_s=5,
                          policy=policy) as s:
        solve_bucket = s._solve_with_ladder

        def recorded(item, dspan=None):
            out = solve_bucket(item, dspan)
            items.append((item, out[0]))
            return out

        s._solve_with_ladder = recorded
        futs = [s.submit(x, y, nu, mu) for x, y, nu, mu in reqs]
        assert s.flush(timeout=300)
        sols = [f.result(timeout=60) for f in futs]
        assert s.stats_dict()["degraded"] == 0
    launched = dict(ops.launches)
    assert launched["cost_matrix"] == len(items) >= 2   # one per bucket
    assert launched["slack_propose"] > 0
    for sol in sols:
        assert (sol.stats.ladder_level, sol.stats.attempts) == (0, 1)
        assert not sol.degraded
    for item, batch in items:
        spec = OT if item.has_mass else ASSIGNMENT
        ins = {"c": item.c}
        if item.has_mass:
            ins.update(nu=item.nu, mu=item.mu)
        for where in (dev, "cpu"):
            direct = solve(spec, {k: v.to(where) for k, v in ins.items()},
                           item.eps, policy, sizes=item.sizes,
                           want=("state",), device=where)
            for f in batch.state()._fields:
                assert torch.equal(getattr(batch.state(), f).cpu(),
                                   getattr(direct.state(), f).cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
@pytest.mark.parametrize("d", [2, 784])
def test_cost_matrix_keeps_nan_like_plain(dev, metric, d):
    """A NaN point poisons its row and column on the card as in the plain
    version (the admission check looks for it); the finite costs equal
    the plain version within the stated tolerance."""
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.uniform(size=(2, 40, d)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.uniform(size=(2, 36, d)).astype(np.float32),
                        device=dev)
    x[0, 3, 0] = float("nan")
    y[1, 5, d - 1] = float("nan")
    got = ops.cost_matrix_batched(x, y, metric)
    ref = cost_matrix_ref(x, y, metric)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert bool(torch.isnan(got[0, 3]).all() and torch.isnan(got[1, :, 5])
                .all())
    rtol, atol = tolerance(metric, d)
    ok = ~torch.isnan(ref)
    torch.testing.assert_close(got[ok], ref[ok], rtol=rtol, atol=atol)
