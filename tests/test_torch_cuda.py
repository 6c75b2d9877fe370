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
    """The same float costs solved on the card on the stepped route
    (through ``slack_propose``) and on the CPU (plain versions) give the
    same integer state."""
    from repro_torch.core.api import DispatchPolicy

    rng = np.random.default_rng(3)
    insts = []
    for n in (20, 45, 64):
        c = rng.uniform(size=(n, n)).astype(np.float32)
        insts.append(c if name == "assignment" else (
            c, rng.dirichlet(np.ones(n)).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32)))
    spec = ASSIGNMENT if name == "assignment" else OT
    before = ops.launches["slack_propose"]
    card = solve(spec, insts, 0.05, DispatchPolicy(fused=False),
                 want=("cost", "state"), device=dev)
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
    # at most 300 candidates: one block per row throughout (on the
    # per-lane path: the warps of a block split over the few rows)
    "short_list_block_per_row": (1, 300, 320, 8, 4, "plain"),
    # more lanes than clusters can be resident: a cluster runs several
    # lanes in turn
    "more_lanes_than_clusters": (1200, 16, 16, 0, 1, "plain"),
    # k = 8 chunks whose states chain, as the driver's chunk=8 loop runs
    "chunk8_chain": (16, 256, 256, 8, 6, "plain"),
}

# How a case reaches each path of the kernel: through the wrapper's
# internal launch with the route filled in. "lane" is the rule's per-lane
# route where it takes one (else clusters of 8), "lane_c1" clusters of a
# single block.
FUSED_ASSIGNMENT_PATHS = ("grid", "lane", "lane_c1")


def _assignment_route(path, b, m, n, dev):
    if path == "grid":
        return ops.Route("grid", 0)
    if path == "lane_c1":
        return ops.Route("lane", 1)
    r = ops.fused_assignment_route(b, m, n, ops._sm_count(dev))
    return r if r.path == "lane" else ops.Route("lane", 8)


@pytest.mark.cuda
@pytest.mark.parametrize("path", FUSED_ASSIGNMENT_PATHS)
@pytest.mark.parametrize("case", list(FUSED_ASSIGNMENT_CASES))
def test_fused_assignment_kernel_design_cases(dev, case, path):
    from repro_torch.core.pushrelabel import (init_assignment_state,
                                              run_assignment_phases)
    from repro_torch.kernels.fused_phase import fused_assignment_phases_ref
    from repro_torch.obs import tracing

    b, m, n, k, chunks, oracle = FUSED_ASSIGNMENT_CASES[case]
    c, thr, cap, mv = _fused_assignment_inputs(dev, b, m, n, b * m + n)
    if case == "lane_below_threshold":
        thr[0] = m
    k = k or int(cap.max()) + 1
    route = _assignment_route(path, b, m, n, dev)
    if case == "more_lanes_than_clusters" and route.path == "lane":
        # at most 2048 threads, so 4 blocks of the per-lane kernel, an SM
        assert b > 4 * ops._sm_count(dev) // route.cluster
    got = ref = init_assignment_state(b, m, n, dev)
    tracing.clear()
    tracing.record(True)
    try:
        for _ in range(chunks):
            before = ops.launches["fused_assignment_phases"]
            with tracing.root("solve"):
                got = ops._fused_assignment_launch(c, got, thr, cap, k, mv,
                                                   route)
            assert ops.launches["fused_assignment_phases"] == before + 1
            if oracle == "plain":
                ref = type(ref)(*fused_assignment_phases_ref(
                    c, *ref, thr, cap, mv, k=k))
            else:
                ref = run_assignment_phases(c, ref, thr, cap, k, m_valid=mv)
            torch.cuda.synchronize()
            assert _states_equal(got, ref)
        lane = [s["fused_assignment"]["lane_path"]
                for s in tracing.recorded() if s["name"] == "solve"]
    finally:
        tracing.record(None)
        tracing.clear()
    assert lane == [int(route.path == "lane")] * chunks
    phases = got.phases.tolist()
    if case == "lane_below_threshold":
        assert phases[0] == 0 and max(phases) > 0
    if case == "lanes_end_in_different_rounds":
        assert len(set(got.rounds.tolist())) > 1


def _assignment_lib():
    import ctypes

    ops.build_kernels()
    src = ops._CSRC / "fused_assignment.cu"
    so = ops.BUILD_DIR / (f"libfused_assignment_phases-"
                          f"{ops.source_digest(src)}.so")
    lib = ctypes.CDLL(str(so))
    for f, args in (("fused_assignment_lane_smem", [ctypes.c_int] * 3),
                    ("fused_assignment_lane_smem_max", [])):
        getattr(lib, f).argtypes = args
        getattr(lib, f).restype = ctypes.c_longlong
    return lib


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,c", [(1024, 1024, 8), (1024, 1024, 1),
                                   (10_000, 10_000, 8), (7, 5, 4),
                                   (4096, 4096, 2), (300, 320, 8)])
def test_lane_shared_memory_is_the_kernel_layout_on_card(dev, m, n, c):
    """``ops.lane_smem_bytes`` is the kernel's own layout, and the rule's
    budget ``ops.LANE_SMEM_BYTES`` is within what a block of the per-lane
    kernel may take on this card, by at most 1 KB: the rule sends the
    launcher no lane it refuses, and turns away none that it takes."""
    lib = _assignment_lib()
    assert ops.lane_smem_bytes(m, n, c) == lib.fused_assignment_lane_smem(
        m, n, c)
    most = lib.fused_assignment_lane_smem_max()
    assert 0 <= most - ops.LANE_SMEM_BYTES <= 1024


@pytest.mark.cuda
def test_lane_path_refuses_a_non_portable_cluster(dev):
    """The per-lane launcher takes clusters of at most the portable 8."""
    b, m, n = 2, 64, 64
    c, thr, cap, mv = _fused_assignment_inputs(dev, b, m, n, 5)
    from repro_torch.core.pushrelabel import init_assignment_state
    state = init_assignment_state(b, m, n, dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops._fused_assignment_launch(c, state, thr, cap, 4, mv,
                                     ops.Route("lane", 16))


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


def _host_artifacts(sol, spec):
    """Every artifact of a SolutionBatch as host arrays, by name."""
    import dataclasses

    out = {}
    for name in spec.artifacts:
        if name == "stats":
            continue
        a = getattr(sol, name)()
        if dataclasses.is_dataclass(a):
            a = dataclasses.astuple(a)
        elif name == "state":
            a = tuple(t.cpu() for t in a)
        out[name] = tuple(np.asarray(v) for v in
                          (a if isinstance(a, tuple) else (a,)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_default_policy_on_card_is_fused_and_equals_stepped(dev, name):
    """``DispatchPolicy()`` on the card runs every chunk as a fused launch
    (the root span counts no ``slack_propose`` and takes the fused route)
    and gives the stepped route's integer state and every artifact bit
    for bit, at no higher peak memory: B = 16 Fig. 1 instances of 1024
    points a side, and one OT instance of 512."""
    from repro_torch.core.api import DispatchPolicy
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.obs import tracing

    rng = np.random.default_rng(30)
    b, n, eps = (16, 1024, 0.01) if name == "assignment" else (1, 512, 0.05)
    x = rng.uniform(size=(b, n, 2)).astype(np.float32)
    y = rng.uniform(size=(b, n, 2)).astype(np.float32)
    inputs = {"c": build_cost_matrix(x, y, "euclidean", device=dev)}
    if name == "ot":
        for k in ("nu", "mu"):
            inputs[k] = torch.as_tensor(rng.dirichlet(
                np.ones(n), size=b).astype(np.float32), device=dev)
    spec = ASSIGNMENT if name == "assignment" else OT
    want = tuple(a for a in spec.artifacts if a != "stats")

    def run(policy):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tracing.clear()
        tracing.record(True)
        try:
            sol = solve(spec, inputs, eps, policy, want=want, device=dev)
            arts = _host_artifacts(sol, spec)
            del sol
            torch.cuda.synchronize(dev)
            (root,) = [s for s in tracing.recorded() if s["name"] == "solve"]
        finally:
            tracing.record(None)
            tracing.clear()
        return arts, root, torch.cuda.max_memory_allocated(dev)

    solve(spec, inputs, eps, DispatchPolicy(), device=dev)    # builds
    stepped, sroot, speak = run(DispatchPolicy(fused=False))
    fused, froot, fpeak = run(DispatchPolicy())
    kernel = f"fused_{name}_phases"
    assert froot["route"] == "fused" and sroot["route"] == "stepped"
    assert froot["launches"].get("slack_propose", 0) == 0
    assert froot["launches"][kernel] == froot["chunks"] > 0
    assert sroot["launches"]["slack_propose"] > 0
    assert kernel not in sroot["launches"]
    assert set(fused) == set(stepped) == set(want)
    for art in want:
        for a, s in zip(fused[art], stepped[art]):
            np.testing.assert_array_equal(a, s, err_msg=art)
    assert fpeak <= speak


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 8], ids=["default", "chunk8"])
def test_default_policy_runs_the_fig1_bucket_out_in_one_launch(dev, chunk):
    """``DispatchPolicy()`` on the card with no deadline runs the B = 16
    Fig. 1 bucket (1024 points a side, eps 0.01) as one run-out chunk:
    one ``fused_assignment_phases`` launch and one ``chunk`` read, with
    k above every lane's phase cap, and every artifact bit-equal to the
    stepped route's. With ``chunk=8`` the same bucket runs the chunk loop
    with lane retirement: one launch and one read per chunk, k = 8, the
    bucket narrower at the end than at the start, no run-out, and the
    same artifacts."""
    from repro_torch.core import device as rdev
    from repro_torch.core.api import DispatchPolicy
    from repro_torch.core.costs import build_cost_matrix
    from repro_torch.core.pushrelabel import _max_phases
    from repro_torch.obs import tracing

    rng = np.random.default_rng(33)
    b, n, eps = 16, 1024, 0.01
    x = rng.uniform(size=(b, n, 2)).astype(np.float32)
    y = rng.uniform(size=(b, n, 2)).astype(np.float32)
    inputs = {"c": build_cost_matrix(x, y, "euclidean", device=dev)}
    want = tuple(a for a in ASSIGNMENT.artifacts if a != "stats")
    solve(ASSIGNMENT, inputs, eps, DispatchPolicy(), device=dev)  # builds

    def run(policy):
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        rdev.reset_sync_counts()
        tracing.clear()
        tracing.record(True)
        try:
            sol = solve(ASSIGNMENT, inputs, eps, policy, want=want,
                        device=dev)
            torch.cuda.synchronize(dev)
            launches = ops.launches["fused_assignment_phases"]
            reads = rdev.sync_counts["chunk"]
            arts = _host_artifacts(sol, ASSIGNMENT)
            (root,) = [s for s in tracing.recorded() if s["name"] == "solve"]
            chunks = [s for s in tracing.recorded()
                      if s["name"] == "driver.chunk"]
        finally:
            tracing.record(None)
            tracing.clear()
        return arts, root, chunks, launches, reads

    stepped, _, _, _, _ = run(DispatchPolicy(fused=False))
    fused, root, chunks, launches, reads = run(DispatchPolicy(chunk=chunk))
    assert root["route"] == "fused"
    if chunk is None:
        assert launches == 1 and reads == 1
        assert root["runouts"] == root["chunks"] == 1
        (span,) = chunks
        assert span["live"] == 0 and span["k"] == _max_phases(eps, n) + 1
    else:
        assert launches == reads == root["chunks"] == len(chunks) > 1
        assert root.get("runouts", 0) == 0
        assert all(s["k"] == chunk for s in chunks)
        assert chunks[0]["bucket"] == b and chunks[-1]["bucket"] < b
        assert chunks[-1]["live"] == 0
    for art in want:
        for a, s in zip(fused[art], stepped[art]):
            np.testing.assert_array_equal(a, s, err_msg=art)


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
    the cost_matrix kernel and runs its chunks on the fused kernels (the
    default route on the card), every request resolves at ladder level 0,
    and each bucket's integer state equals a direct solve() of the same
    padded costs on the card and on the CPU (the stepped route)."""
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
    assert launched["slack_propose"] == 0
    assert launched["fused_assignment_phases"] > 0
    assert launched["fused_ot_phases"] > 0
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


def _record_launch_devices(monkeypatch):
    """Wrap every loaded launcher to record the current device at the
    moment of launch, and ``torch.cuda.device`` to record the devices the
    wrappers enter. Returns the two logs."""
    ops.build_kernels()
    at_launch, entered = [], []
    real_device = torch.cuda.device

    class Recorded(real_device):
        def __init__(self, d):
            entered.append(torch.device(d))
            super().__init__(d)

    def wrap(name, fn):
        def launch(*args):
            at_launch.append((name, torch.cuda.current_device()))
            return fn(*args)
        return launch

    monkeypatch.setattr(torch.cuda, "device", Recorded)
    monkeypatch.setattr(ops, "_libs", {n: wrap(n, f)
                                       for n, f in ops._libs.items()})
    return at_launch, entered


def _launch_from_worker(dev, current):
    """Run every wrapper from a new thread whose current device is
    ``current``; returns the outputs (moved to the CPU) by kernel name."""
    import threading

    from _torch_wrappers import wrapper_calls

    out, errors = {}, []

    def work():
        try:
            torch.cuda.set_device(current)
            for name, call in wrapper_calls(dev).items():
                res = call()
                res = res if isinstance(res, tuple) else (res,)
                out[name] = [r.cpu() for r in res]
        except Exception as e:      # re-raised in the caller
            errors.append(e)
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not errors, errors
    return out


@pytest.mark.cuda
def test_wrappers_launch_on_the_tensors_device_from_a_worker(dev,
                                                             monkeypatch):
    """From a worker thread (a new thread starts on device 0), every
    wrapper enters its tensors' device and the launcher runs with it
    current. One card: the recorders show the device entered and current
    at launch; the kernels' outputs equal their plain versions."""
    from _torch_wrappers import wrapper_calls

    card = torch.device("cuda", torch.cuda.current_device())
    at_launch, entered = _record_launch_devices(monkeypatch)
    got = _launch_from_worker(card, card)
    assert sorted(n for n, _ in at_launch) == sorted(ops._ENTRY)
    assert {d for _, d in at_launch} == {card.index}
    assert card in entered
    want = {n: call() for n, call in wrapper_calls("cpu").items()}
    for n, res in want.items():
        res = res if isinstance(res, tuple) else (res,)
        for g, w in zip(got[n], res):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_wrappers_launch_on_a_second_card(dev, monkeypatch):
    """Two cards: tensors on cuda:1, launched from a worker whose current
    device is cuda:0; every launch happens with cuda:1 current and the
    outputs equal the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the tensors must lie on a "
                    "card other than the thread's current one")
    from _torch_wrappers import wrapper_calls

    at_launch, _ = _record_launch_devices(monkeypatch)
    got = _launch_from_worker(torch.device("cuda", 1), 0)
    assert {d for _, d in at_launch} == {1}
    want = {n: call() for n, call in wrapper_calls("cpu").items()}
    for n, res in want.items():
        res = res if isinstance(res, tuple) else (res,)
        for g, w in zip(got[n], res):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
@pytest.mark.parametrize("placement,fused", [("batch", False),
                                             ("batch", True),
                                             ("matrix", False)])
def test_mesh_logical_shards_on_card_equal_compact(dev, spec_name,
                                                   placement, fused):
    """Logical shards of the card (separate streams, worker threads):
    batch placement at D = 4 (stepped and fused) and matrix placement on
    a (2, 2) grid give the compact solve's integer state on the card."""
    from repro_torch.core.api import DispatchPolicy
    from repro_torch.launch.mesh import make_small_mesh

    rng = np.random.default_rng(31)
    b, n = 4, 384
    c = torch.as_tensor(rng.uniform(size=(b, n, n)).astype(np.float32),
                        device=dev)
    inputs = {"c": c}
    if spec_name == "ot":
        for k in ("nu", "mu"):
            inputs[k] = torch.as_tensor(rng.dirichlet(
                np.ones(n), size=b).astype(np.float32), device=dev)
    spec = ASSIGNMENT if spec_name == "assignment" else OT
    if placement == "matrix":
        inputs = {k: v[:1] for k, v in inputs.items()}
        mesh = make_small_mesh((2, 2), ("data", "model"), devices=dev)
    else:
        mesh = make_small_mesh((4,), ("data",), devices=dev)
    keep = placement == "batch" or spec_name == "ot"
    ref, rst = solve(spec, inputs, 0.05, DispatchPolicy(mode="compact"),
                     keep_state=keep, device=dev)
    ops.reset_launches()
    got, st = solve(spec, inputs, 0.05,
                    DispatchPolicy(mode="mesh", mesh=mesh,
                                   placement=placement, fused=fused),
                    keep_state=keep, device=dev)
    torch.cuda.synchronize()
    assert st.placement == placement and st.devices == 4
    kernel = ("slack_propose" if not fused else
              f"fused_{'assignment' if spec_name == 'assignment' else 'ot'}"
              "_phases")
    assert ops.launches[kernel] > 0
    if placement == "batch":
        for f in rst.final_state._fields:
            assert torch.equal(getattr(st.final_state, f),
                               getattr(rst.final_state, f)), f
    elif spec_name == "ot":
        for f in rst.final_state._fields:
            assert torch.equal(getattr(got.state, f),
                               getattr(rst.final_state, f)), f
    else:
        for f in ("matching", "phases", "rounds", "y_b", "y_a"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f


# -- the model-serving path: the pushrelabel router, the Engine ------------

# (T, E, k): deepseek-moe-16b's router at chip_smoke's prefill (4 x 512
# tokens) and decode (4) shapes, an odd prefill, the reduced model's
ROUTER_SHAPES = [(2048, 64, 6), (4, 64, 6), (300, 64, 6), (48, 8, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k", ROUTER_SHAPES)
def test_router_kernel_equals_plain(dev, t, e, k):
    """``pushrelabel_assign`` on the card is one ``fused_ot_phases``
    launch (24 phases, threshold -1) whose flow equals the plain
    version's on the CPU bit for bit."""
    from repro_torch.core import device as rdev
    from repro_torch.models import moe

    lg = np.random.default_rng(t + e).normal(size=(t, e)).astype(np.float32)
    cap = -(-t * k // e)
    before = ops.launches["fused_ot_phases"]
    rdev.reset_sync_counts()
    got = moe.pushrelabel_assign(torch.as_tensor(lg, device=dev), k, cap,
                                 phases=24)
    torch.cuda.synchronize()
    assert ops.launches["fused_ot_phases"] == before + 1
    assert sum(rdev.sync_counts.values()) == 0
    ref = moe.pushrelabel_assign(torch.as_tensor(lg), k, cap, phases=24)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,router", [("qwen3-4b", None),
                                         ("deepseek-moe-16b", "pushrelabel"),
                                         ("jamba-1.5-large-398b", None)])
def test_engine_on_card_equals_cpu(dev, arch, router, monkeypatch):
    """The reduced model served by ``Engine`` on the card and on the CPU
    from the same float32 weights, float32 compute: the same
    completions; one router launch per MoE layer per forward pass."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models import model as M
    from repro_torch.models.transformer import build_stages
    from repro_torch.serve.engine import Engine, Request

    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)
    cfg = reduced(ARCHS[arch])
    if router:
        cfg = cfg.with_(router=router)
    params = M.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 500, size=n).astype(np.int32), m)
            for n, m in ((7, 5), (12, 0), (3, 6))]
    out = {}
    for where in ("cpu", dev):
        engine = Engine(cfg, params, max_len=32, device=where)
        for p, m in reqs:
            engine.submit(Request(prompt=p, max_new_tokens=m))
        ops.reset_launches()
        out[str(where)] = engine.run_batch()
    # one prefill, then a decode step before every token but the first
    passes = max(c.decode_steps for c in out[str(dev)])
    n_moe = sum(n * sum(ffn == "moe" for _, ffn in spec)
                for spec, n in build_stages(cfg))
    want = n_moe * passes if cfg.router == "pushrelabel" else 0
    assert ops.launches["fused_ot_phases"] == want
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert a.prefill_len == b.prefill_len
        assert a.decode_steps == b.decode_steps
        np.testing.assert_array_equal(a.tokens, b.tokens)


# -- the training path: loss_fn, make_train_step, the Trainer ----------------

def _train_setup(arch, router, seed=0):
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.models import model as M

    cfg = reduced(ARCHS[arch])
    if router:
        cfg = cfg.with_(router=router)
    return cfg, M.init_params(cfg, seed=seed, device="cpu")


def _train_steps(cfg, params, where, n, lr=1e-3):
    """``n`` steps of ``make_train_step`` on the pipeline's batches on
    ``where``, from a copy of ``params``: the parameters and each step's
    (loss, grad_norm)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_train_step

    init, step_fn = make_train_step(cfg, lr=lr, warmup=1)
    p = M.map_params(lambda t: t.to(where, copy=True), params)
    opt, hist = init(p), []
    for s in range(n):
        b = {k: torch.as_tensor(v, device=where) for k, v in
             synthetic_batch(cfg, 16, 2, seed=1, step=s).items()}
        p, opt, m = step_fn(p, opt, b)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return p, hist


@pytest.mark.cuda
@pytest.mark.parametrize("arch,router", [("llama3.2-3b", None),
                                         ("deepseek-moe-16b",
                                          "pushrelabel")])
def test_train_step_on_card_equals_cpu(dev, arch, router, monkeypatch):
    """Two reduced training steps in float32 compute on the card and on
    the CPU from the same parameters: loss and grad_norm within rtol =
    atol = 1e-3."""
    from repro_torch.models import model as M

    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)
    cfg, params = _train_setup(arch, router)
    _, on_cpu = _train_steps(cfg, params, "cpu", 2)
    _, on_card = _train_steps(cfg, params, dev, 2)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_train_step_launches_router_twice_a_moe_layer_under_remat(dev):
    """A training step of the reduced MoE model under ``pushrelabel``
    launches ``fused_ot_phases`` twice a MoE layer (the forward and the
    recompute of remat), once without remat, and reads nothing back."""
    from repro_torch.core import device as rdev

    cfg, params = _train_setup("deepseek-moe-16b", "pushrelabel")
    n_moe = cfg.num_layers - cfg.first_dense_layers
    for remat, per_layer in ((True, 2), (False, 1)):
        ops.reset_launches()
        rdev.reset_sync_counts()
        _train_steps(cfg.with_(remat=remat), params, dev, 1)
        assert ops.launches["fused_ot_phases"] == per_layer * n_moe
        assert sum(rdev.sync_counts.values()) == 0


@pytest.mark.cuda
def test_train_runs_on_card_are_bit_equal(dev):
    """Two runs of three steps from the same parameters on the card give
    bit-equal metrics and parameters (the gathers' backward sums
    duplicate indices by a sorting index_put_)."""
    from repro_torch.models import model as M

    cfg, params = _train_setup("deepseek-moe-16b", "pushrelabel")
    a, ha = _train_steps(cfg, params, dev, 3)
    b, hb = _train_steps(cfg, params, dev, 3)
    assert ha == hb
    for x, y in zip(M.leaves(a), M.leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_trainer_resumes_on_card(dev, tmp_path):
    """The ``Trainer`` on the card: 8 steps against 4, a dropped object
    and a resumed ``Trainer`` for 4 more; the last 4 losses equal."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.train.trainer import Trainer

    cfg = reduced(ARCHS["deepseek-moe-16b"]).with_(router="pushrelabel")
    kw = dict(seq_len=16, batch_size=2, ckpt_every=4, device=dev)
    full = Trainer(cfg, str(tmp_path / "a"), **kw).run(8)
    half = Trainer(cfg, str(tmp_path / "b"), **kw)
    half.run(4)
    del half
    resumed = Trainer(cfg, str(tmp_path / "b"), **kw)
    assert resumed.step == 4
    rest = resumed.run(4)
    assert [h["loss"] for h in full[4:]] == [h["loss"] for h in rest]


# -- expert parallelism: the mesh branch of apply_moe on one card ------------

def _ep_layer(dev, router, seed=0):
    """Reduced deepseek-moe-16b's first MoE layer on ``dev`` and a (2, 4)
    ('data', 'model') mesh of logical shards of it."""
    from repro_torch.configs.registry import ARCHS, reduced
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import model as M

    cfg = reduced(ARCHS["deepseek-moe-16b"]).with_(router=router)
    params = M.init_params(cfg, seed=seed, device=dev)
    mesh = make_small_mesh((2, 4), ("data", "model"), devices=dev)
    return cfg, params["stages"][1][0]["l0"]["moe"], mesh


@pytest.fixture
def ep_state(monkeypatch):
    """No mesh after the test; 'dp' / 'tp' as before it."""
    from repro_torch.models import sharding

    monkeypatch.setattr(sharding, "_STATE", dict(sharding._STATE))
    yield sharding
    sharding.set_mesh(None)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 3])
def test_mesh_branch_on_card_flows_equal_plain(dev, ep_state, b,
                                               monkeypatch):
    """Under a (2, 4) mesh of the card: one ``fused_ot_phases`` launch a
    'dp' shard (one for the whole batch when B = 3 does not divide) at
    the shard's T x E, each launch's flow bit-equal to the plain version
    on the same affinity on the card; the output within 1e-5 of the
    single-device branch on each shard in float32."""
    from repro_torch.kernels.fused_phase import fused_ot_phases_ref
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg, layer, mesh = _ep_layer(dev, "pushrelabel")
    x = torch.randn(b, 16, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    seen = []
    orig = moe.pushrelabel_assign

    def tapped(affinity, k, capacity, **kw):
        flow = orig(affinity, k, capacity, **kw)
        seen.append((affinity.clone(), k, capacity, flow.clone(), kw))
        return flow
    monkeypatch.setattr(moe, "pushrelabel_assign", tapped)
    ep_state.set_mesh(mesh)
    ops.reset_launches()
    got = T.apply_moe(layer, cfg, x)
    torch.cuda.synchronize()
    ep_state.set_mesh(None)
    dp = 2 if b % 2 == 0 else 1
    assert ops.launches["fused_ot_phases"] == dp == len(seen)
    for aff, k, capacity, flow, kw in seen:
        assert aff.shape == (b * 16 // dp, cfg.num_experts)
        t, e = aff.shape
        c_int = moe.router_costs(aff)[None].contiguous()
        s0 = moe.router_state(t, e, k, capacity, aff.device)
        never = torch.full((1,), -1, dtype=torch.int32, device=dev)
        cap = torch.full((1,), 24, dtype=torch.int32, device=dev)
        ref = type(s0)(*fused_ot_phases_ref(c_int, *s0, never, cap, k=24,
                                            max_rounds=8))
        assert torch.equal(flow, (ref.f_hi + ref.f_lo)[0])
    monkeypatch.setattr(moe, "pushrelabel_assign", orig)
    want = torch.cat([T.apply_moe(layer, cfg, xs)
                      for xs in torch.chunk(x, dp)])
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)


@pytest.mark.cuda
def test_mesh_branch_on_card_copies_no_expert(dev, ep_state):
    """Every expert block of a mesh of logical shards of the card is a
    view of the weight (one storage), and a forward under the mesh
    allocates no more than a copy-free one would: the peak stays within
    the weights' bytes of the single-device branch's."""
    from repro_torch.models import transformer as T

    cfg, layer, mesh = _ep_layer(dev, "topk")
    for name in ("w_gate", "w_up", "w_down"):
        w = layer[name]
        placed = T._expert_blocks(w, mesh, "model")
        for pos in placed.sharding.positions():
            blk = placed.block(pos)
            assert blk.device == w.device
            assert blk.untyped_storage().data_ptr() == \
                w.untyped_storage().data_ptr()
    x = torch.randn(4, 64, cfg.d_model, device=dev)
    expert_bytes = sum(layer[k].numel() * layer[k].element_size()
                       for k in ("w_gate", "w_up", "w_down"))
    peaks = {}
    for where in ("single", "mesh"):
        if where == "mesh":
            ep_state.set_mesh(mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        T.apply_moe(layer, cfg, x)
        torch.cuda.synchronize()
        peaks[where] = torch.cuda.max_memory_allocated() - base
        ep_state.set_mesh(None)
    assert peaks["mesh"] < peaks["single"] + expert_bytes


# -- the dry-run's plan against the card (chip_smoke phase 14 (b), smaller) --

@pytest.mark.cuda
def test_plan_of_a_training_step_against_the_card(dev):
    """deepseek-moe-16b at full width cut to 2 layers (the dense layer and
    one MoE layer), float32, AdamW, ``pushrelabel``, B = 2 x S = 256,
    planned on a (1, 1) mesh of the card and run there: the plan's
    argument bytes within the allocator's rounding of the growth of
    ``memory_allocated`` (512 B a tensor, up to 1 MiB more for a tensor of
    1 MiB or more), its argument + temp bytes within 0.9-1.15 of the
    step's memory peak over the memory before the arguments (a band: the
    allocator's blocks, cuBLAS and the router's workspace are not in the
    plan; phase 12's configuration measured 1.0018 in chip_smoke phase
    14), its FLOPs equal to
    ``FlopCounterMode`` over the real step, and one ``fused_ot_phases``
    launch per custom call of the plan."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.dryrun import plan_step
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_train_step

    cfg = ARCHS["deepseek-moe-16b"].with_(num_layers=2, router="pushrelabel")
    shape = ShapeConfig("step", 256, 2, "train")
    plan = plan_step(cfg, shape, make_small_mesh((1, 1), devices=dev))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=0, device=dev)
    init, step_fn = make_train_step(cfg)
    opt = init(params)

    def batch(step):
        return {k: torch.as_tensor(v, device=dev) for k, v in
                synthetic_batch(cfg, 256, 2, seed=0, step=step).items()}
    b0 = batch(0)
    torch.cuda.synchronize()
    args = [t for t in M.leaves(params) + M.leaves(opt) + [b0["tokens"]]
            if t is not None]
    grown = torch.cuda.memory_allocated() - m0
    arg_b = plan["memory"]["argument_bytes"]
    slack = sum(512 if t.numel() * t.element_size() < 1 << 20
                else 512 + (1 << 20) for t in args)
    assert 0 <= grown - arg_b <= slack
    step_fn(params, opt, b0)                  # warm-up (workspaces)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    step_fn(params, opt, batch(1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - m0
    ratio = peak / (arg_b + plan["memory"]["temp_bytes"])
    assert 0.9 <= ratio <= 1.15, ratio
    assert ops.launches["fused_ot_phases"] == len(
        plan["plan"]["custom_calls"]) == 2
    with FlopCounterMode(display=False) as fc:
        step_fn(params, opt, batch(2))
    assert plan["plan"]["flops_dp_shard"] == fc.get_total_flops()
