"""repro_torch's fused route held against the reference: the plain fused
versions against the JAX Pallas kernels (interpret mode on the CPU, lane by
lane, as tests/test_fused_phase.py runs them), against the port's stepped
cores, and ``solve(..., DispatchPolicy(fused=True))`` against the
reference's ``solve`` with ``fused=True``. The CUDA kernels against their
plain versions: tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import api as japi
from repro.core.pushrelabel import PushRelabelState as JAssignState
from repro.core.transport import OTState as JOTState
from repro.kernels import ops as jops
from repro_torch.core import api as tapi
from repro_torch.core import device as tdevice
from repro_torch.core import problem as tproblem
from repro_torch.core.pushrelabel import (
    PAD_COST,
    PushRelabelState,
    _max_phases,
    init_assignment_state,
    run_assignment_phases,
)
from repro_torch.core.transport import (
    init_ot_state,
    ot_phase_cap,
    run_ot_phases,
)
from repro_torch.kernels import ops

# float outputs of the epilogue: f32 sums in another order than XLA's
COST = dict(rtol=1e-5, atol=1e-6)


def _assignment_batch(m, n, m_valid, seed):
    """Three lanes at eps 0.05 / 0.1 / 0.08, so they stop at different
    phases; rows at and beyond ``m_valid`` are padding (PAD_COST)."""
    rng = np.random.default_rng(seed)
    eps = np.array([0.05, 0.1, 0.08])
    mv = m if m_valid is None else m_valid
    c = rng.uniform(size=(3, m, n))
    c_int = np.floor(c / eps[:, None, None]).astype(np.int32)
    c_int[:, mv:, :] = PAD_COST
    thr = np.array([int(e * mv) for e in eps], np.int32)
    cap = np.array([_max_phases(e, m) for e in eps], np.int32)
    return c_int, thr, cap, np.full(3, mv, np.int32)


def _ot_batch(nb, na, seed):
    """Three lanes at eps 0.05 / 0.1 / 0.08 with Dirichlet masses."""
    rng = np.random.default_rng(seed)
    eps = np.array([0.05, 0.1, 0.08])
    theta = (4.0 * max(nb, na) / eps).astype(np.float32)
    c = rng.uniform(size=(3, nb, na))
    c_int = np.floor(c / eps[:, None, None]).astype(np.int32)
    nu = rng.dirichlet(np.ones(nb), 3).astype(np.float32)
    mu = rng.dirichlet(np.ones(na), 3).astype(np.float32)
    s_int = np.floor(nu * theta[:, None]).astype(np.int32)
    d_int = np.ceil(mu * theta[:, None]).astype(np.int32)
    thr = np.array([int(e * int(s.sum())) for e, s in zip(eps, s_int)],
                   np.int32)
    cap = np.array([ot_phase_cap(e) for e in eps], np.int32)
    return c_int, s_int, d_int, thr, cap


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _lane(state, i, cls):
    return cls(**{f: jnp.asarray(getattr(state, f)[i].numpy())
                  for f in state._fields})


def _assert_lane_equal(jstate, tstate, i, where):
    for f in tstate._fields:
        np.testing.assert_array_equal(
            getattr(tstate, f)[i].numpy(), np.asarray(getattr(jstate, f)),
            err_msg=f"{where}: lane {i} field {f}")


def _assert_equal(a, b, where):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{where}: {f}"


ASSIGN_SHAPES = [(24, 24, None), (33, 47, None), (40, 28, 31)]
OT_SHAPES = [(16, 16), (21, 13), (9, 30)]
# k = 0 stands for "above every lane's phase cap"
KS = [1, 3, 8, 0]
# chunks compared per case: through convergence, or this many
CHUNKS = 40


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m,n,m_valid", ASSIGN_SHAPES)
def test_plain_fused_assignment_equals_pallas(m, n, m_valid, k):
    """The port's plain fused version on a 3-lane batch equals the Pallas
    kernel run lane by lane, field by field at every chunk boundary, for
    CHUNKS chunks or through convergence."""
    c_int, thr, cap, mv = _assignment_batch(m, n, m_valid, m * n + k)
    k = k or int(cap.max()) + 1
    tc, tthr, tcap, tmv = _t(c_int, thr, cap, mv)
    tstate = init_assignment_state(3, m, n)
    jstates = [_lane(tstate, i, JAssignState) for i in range(3)]
    for chunk in range(CHUNKS):
        tstate = ops.fused_run_assignment_phases(tc, tstate, tthr, tcap, k,
                                                 m_valid=tmv)
        jstates = [jops.fused_run_assignment_phases(
            jnp.asarray(c_int[i]), jstates[i], jnp.int32(thr[i]),
            jnp.int32(cap[i]), k, m_valid=jnp.int32(mv[i]))
            for i in range(3)]
        for i in range(3):
            _assert_lane_equal(jstates[i], tstate, i, f"chunk {chunk}")
        free = ((tstate.match_ba < 0)
                & (torch.arange(m)[None] < tmv[:, None])).sum(1)
        if bool(((free <= tthr) | (tstate.phases >= tcap)).all()):
            break
    # the lanes stopped (or stand) at different phases
    assert len(set(tstate.phases.tolist())) > 1


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nb,na", OT_SHAPES)
def test_plain_fused_ot_equals_pallas(nb, na, k):
    c_int, s_int, d_int, thr, cap = _ot_batch(nb, na, nb * na + k)
    k = k or int(cap.max()) + 1
    mr = nb + na + 2
    tc, tthr, tcap = _t(c_int, thr, cap)
    tstate = init_ot_state(*_t(s_int, d_int))
    jstates = [_lane(tstate, i, JOTState) for i in range(3)]
    for chunk in range(CHUNKS):
        tstate = ops.fused_run_ot_phases(tc, tstate, tthr, tcap, k, mr)
        jstates = [jops.fused_run_ot_phases(
            jnp.asarray(c_int[i]), jstates[i], jnp.int32(thr[i]),
            jnp.int32(cap[i]), k, mr) for i in range(3)]
        for i in range(3):
            _assert_lane_equal(jstates[i], tstate, i, f"chunk {chunk}")
        if bool(((tstate.free_b.sum(1) <= tthr)
                 | (tstate.phases >= tcap)).all()):
            break
    assert len(set(tstate.phases.tolist())) > 1


@pytest.mark.parametrize("m,n,m_valid", ASSIGN_SHAPES)
def test_plain_fused_assignment_equals_stepped(m, n, m_valid):
    """Plain fused chunks == the stepped core's chunks (k = 3), and one
    k = 8 chunk == four k = 2 chunks."""
    c_int, thr, cap, mv = _assignment_batch(m, n, m_valid, 5)
    tc, tthr, tcap, tmv = _t(c_int, thr, cap, mv)
    fused = stepped = init_assignment_state(3, m, n)
    for _ in range(CHUNKS):
        fused = ops.fused_run_assignment_phases(tc, fused, tthr, tcap, 3,
                                                m_valid=tmv)
        stepped = run_assignment_phases(tc, stepped, tthr, tcap, 3,
                                        m_valid=tmv)
        _assert_equal(fused, stepped, "fused vs stepped")
    assert len(set(fused.phases.tolist())) > 1
    one = ops.fused_run_assignment_phases(
        tc, init_assignment_state(3, m, n), tthr, tcap, 8, m_valid=tmv)
    many = init_assignment_state(3, m, n)
    for _ in range(4):
        many = ops.fused_run_assignment_phases(tc, many, tthr, tcap, 2,
                                               m_valid=tmv)
    _assert_equal(one, many, "k=8 vs 4 x k=2")


@pytest.mark.parametrize("nb,na", OT_SHAPES)
def test_plain_fused_ot_equals_stepped(nb, na):
    c_int, s_int, d_int, thr, cap = _ot_batch(nb, na, 6)
    tc, tthr, tcap = _t(c_int, thr, cap)
    mr = nb + na + 2
    fused = stepped = init_ot_state(*_t(s_int, d_int))
    for _ in range(CHUNKS):
        fused = ops.fused_run_ot_phases(tc, fused, tthr, tcap, 3, mr)
        stepped = run_ot_phases(tc, stepped, tthr, tcap, 3, mr)
        _assert_equal(fused, stepped, "fused vs stepped")
    one = ops.fused_run_ot_phases(tc, init_ot_state(*_t(s_int, d_int)),
                                  tthr, tcap, 8, mr)
    many = init_ot_state(*_t(s_int, d_int))
    for _ in range(4):
        many = ops.fused_run_ot_phases(tc, many, tthr, tcap, 2, mr)
    _assert_equal(one, many, "k=8 vs 4 x k=2")


def _ragged(name, seed):
    rng = np.random.default_rng(seed)
    out = []
    for m, n in [(10, 12), (20, 20), (16, 30), (7, 7), (18, 20)]:
        x, y = rng.uniform(size=(m, 2)), rng.uniform(size=(n, 2))
        c = np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1)).astype(np.float32)
        out.append(c if name == "assignment" else (
            c, rng.dirichlet(np.ones(m)).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32)))
    return out


@pytest.mark.parametrize("mode", ["lockstep", "compact"])
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_fused_solve_equals_reference(name, mode):
    """A ragged batch with mixed per-instance eps through ``solve`` with
    ``fused=True``: integer state equal to the reference's fused solve,
    floats within COST."""
    insts = _ragged(name, 11)
    eps = [0.1, 0.2, 0.15, 0.1, 0.25]
    jspec, tspec = getattr(japi, name.upper()), getattr(tapi, name.upper())
    ref = japi.solve(jspec, insts, eps, japi.DispatchPolicy(
        mode=mode, chunk=3, fused=True), keep_state=True)
    got = tapi.solve(tspec, insts, eps, tapi.DispatchPolicy(
        mode=mode, chunk=3, fused=True), keep_state=True, device="cpu")
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for f in r["state"]._fields:
            np.testing.assert_array_equal(
                getattr(g["state"], f).numpy(),
                np.asarray(getattr(r["state"], f)), err_msg=f)
        for key, rv in r.items():
            if key in ("cost", "y_b", "y_a", "plan"):
                np.testing.assert_allclose(np.asarray(g[key]),
                                           np.asarray(rv), **COST,
                                           err_msg=key)
            elif key != "state":
                np.testing.assert_array_equal(np.asarray(g[key]),
                                              np.asarray(rv), err_msg=key)


@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_fused_dict_form_equals_stepped(name):
    """The pre-batched form under ``fused=True`` gives the stepped route's
    integer state and results, in both modes, with one fused launch per
    chunk dispatch and no propose round read back to the host."""
    rng = np.random.default_rng(2)
    b, m, n = 3, 20, 24
    sizes = np.array([[20, 24], [15, 22], [20, 20]], np.int32)
    inputs = {"c": rng.uniform(size=(b, m, n)).astype(np.float32)}
    if name == "ot":
        inputs["nu"] = rng.dirichlet(np.ones(m), b).astype(np.float32)
        inputs["mu"] = rng.dirichlet(np.ones(n), b).astype(np.float32)
    spec = getattr(tapi, name.upper())
    kernel = f"fused_{name}_phases"
    for mode in ("lockstep", "compact"):
        rs, ss = tapi.solve(spec, inputs, 0.1, tapi.DispatchPolicy(
            mode=mode, chunk=2), sizes=sizes, keep_state=True, device="cpu")
        ops.reset_launches()
        tdevice.reset_sync_counts()
        rf, sf = tapi.solve(spec, inputs, 0.1, tapi.DispatchPolicy(
            mode=mode, chunk=2, fused=True), sizes=sizes, keep_state=True,
            device="cpu")
        _assert_equal(ss.final_state, sf.final_state, mode)
        # the CPU runs the plain versions: no kernel launch is counted
        assert ops.launches[kernel] == 0
        assert tdevice.sync_counts["round"] == 0
        assert tdevice.sync_counts["chunk"] == sf.dispatches
        if mode == "lockstep":
            assert sf.dispatches == 1
        for f in rs._fields:
            a, c = getattr(rs, f), getattr(rf, f)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, c), f
        assert sf.dispatches >= 1


def test_fused_variant_mapping():
    p = tproblem
    assert p.fused_variant(p.ASSIGNMENT) is p.FUSED_ASSIGNMENT
    assert p.fused_variant(p.OT) is p.FUSED_OT
    assert p.fused_variant(p.FUSED_ASSIGNMENT) is p.FUSED_ASSIGNMENT
    assert p.fused_variant(p.FUSED_OT) is p.FUSED_OT
    assert p.FUSED_ASSIGNMENT.stepped is p.ASSIGNMENT
    assert p.FUSED_OT.stepped is p.OT
    assert p.FUSED_ASSIGNMENT.name == "assignment"
    assert p.FUSED_OT.name == "ot"
    assert not p.ASSIGNMENT.fused and p.FUSED_OT.fused
    with pytest.raises(ValueError, match="no fused variant"):
        p.fused_variant(object())


def test_fused_lockstep_k_is_above_every_cap():
    """The fused specs' lockstep runs the driver's run-out chunk: k one
    above every lane's phase cap (``compaction.chunk_for``)."""
    from repro_torch.core.compaction import chunk_for

    eps = np.array([0.1, 0.05])
    rng = np.random.default_rng(0)
    c = rng.uniform(size=(2, 30, 30)).astype(np.float32)
    w = np.full((2, 30), 1.0 / 30, np.float32)
    for spec, inputs, cap in (
            (tproblem.FUSED_ASSIGNMENT, {"c": c},
             lambda e: _max_phases(e, 30)),
            (tproblem.FUSED_OT, {"c": c, "nu": w, "mu": w}, ot_phase_cap)):
        p = spec.prepare(spec.canonicalize(inputs, "cpu"), eps)
        assert chunk_for(spec, None, None, p.phase_cap) == (
            max(cap(e) for e in eps) + 1, True)


def test_plain_fused_leaves_inputs_unchanged():
    c_int, thr, cap, mv = _assignment_batch(12, 14, None, 3)
    tc, tthr, tcap, tmv = _t(c_int, thr, cap, mv)
    s0 = init_assignment_state(3, 12, 14)
    keep = PushRelabelState(*(t.clone() for t in s0))
    out = ops.fused_run_assignment_phases(tc, s0, tthr, tcap, 4,
                                          m_valid=tmv)
    _assert_equal(s0, keep, "input state")
    assert int(out.phases.max()) == 4


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m,n,m_valid", ASSIGN_SHAPES)
def test_round_proposers_only_shrink(monkeypatch, m, n, m_valid, seed):
    """The premise of the CUDA kernel's candidate lists: within a phase,
    the rows that propose in round r + 1 are among those that proposed in
    round r and did not win there. Recorded from the stepped core's
    propose calls on a 3-lane batch with mixed eps and ragged m_valid."""
    from repro_torch.core import pushrelabel

    c_int, thr, cap, mv = _assignment_batch(m, n, m_valid, 17 * seed + m)
    tc, tthr, tcap, tmv = _t(c_int, thr, cap, mv)
    phases = []
    orig_mm = pushrelabel.greedy_maximal_matching
    orig_propose = ops.slack_propose_batched

    def matching(*a, **kw):
        phases.append([])
        return orig_mm(*a, **kw)

    def propose(c, *a, active_b=None):
        col, key = orig_propose(c, *a, active_b=active_b)
        phases[-1].append(col.clone())
        return col, key

    monkeypatch.setattr(pushrelabel, "greedy_maximal_matching", matching)
    monkeypatch.setattr(ops, "slack_propose_batched", propose)
    run_assignment_phases(tc, init_assignment_state(3, m, n), tthr, tcap,
                          int(cap.max()) + 1, m_valid=tmv)
    rows = torch.arange(m)[None, :].expand(3, m)
    checked = 0
    for cols in phases:
        for before, after in zip(cols, cols[1:]):
            proposed = before >= 0
            # per column, the lowest proposing row wins
            tgt = torch.where(proposed, before, n).long()
            low = torch.full((3, n + 1), m).scatter_reduce(
                1, tgt, torch.where(proposed, rows, m), reduce="amin")
            won = proposed & (low.gather(1, tgt) == rows)
            again = after >= 0
            assert not bool((again & ~(proposed & ~won)).any())
            checked += int(again.sum())
    # some row did propose again after losing a round
    assert checked > 0


def _ot_phase_log(monkeypatch, nb, na, seed):
    """The stepped OT core run one phase per call (k = 1 chains to the
    same trajectory) on a 3-lane batch with mixed eps. Returns, per call,
    ``(state before, state after, rounds)`` where ``rounds`` holds each
    propose round's ``(tgt (B, nb), grant (B, nb))`` (``tgt == na``: the
    row did not propose)."""
    from repro_torch.core import transport

    c_int, s_int, d_int, thr, cap = _ot_batch(nb, na, seed)
    tc, tthr, tcap = _t(c_int, thr, cap)
    rounds = []
    orig = transport._grant_round

    def grant_round(*a):
        tgt, grant, any_prop = orig(*a)
        rounds.append((tgt.clone(), grant.clone()))
        return tgt, grant, any_prop

    monkeypatch.setattr(transport, "_grant_round", grant_round)
    log = []
    state = init_ot_state(*_t(s_int, d_int))
    for _ in range(int(cap.max()) + 1):
        rounds.clear()
        after = run_ot_phases(tc, state, tthr, tcap, 1, nb + na + 2)
        if torch.equal(after.phases, state.phases):
            break
        log.append((state, after, list(rounds)))
        state = after
    assert len(log) > 2
    return log


def _granted(rounds, b, nb, na):
    """(B, na) units each column granted over a phase's rounds."""
    g_a = torch.zeros((b, na + 1), dtype=torch.int64)
    for tgt, grant in rounds:
        g_a.scatter_add_(1, tgt.long(), grant.long())
    return g_a[:, :na]


@pytest.mark.parametrize("nb,na", OT_SHAPES)
def test_ot_round_proposers_only_shrink(monkeypatch, nb, na):
    """The premise of fused_ot.cu's lists of live proposers: within a
    phase, the rows that propose in round r + 1 are among those that
    proposed in round r (y_b and ya_hi are fixed in a phase, the supply
    left and the capacity only fall)."""
    checked = 0
    for _, _, rounds in _ot_phase_log(monkeypatch, nb, na, 31 * nb + na):
        for (before, _), (after, _) in zip(rounds, rounds[1:]):
            again = after < na
            assert not bool((again & (before >= na)).any())
            checked += int(again.sum())
    assert checked > 0


@pytest.mark.parametrize("nb,na", OT_SHAPES)
def test_ot_ungranted_columns_unchanged(monkeypatch, nb, na):
    """The premise of limiting the end-of-phase work to the columns that
    granted: a column with no grant in a phase keeps its f_hi and f_lo
    columns, ya_hi and free_a."""
    checked = 0
    for s0, s1, rounds in _ot_phase_log(monkeypatch, nb, na, 37 * nb + na):
        idle = _granted(rounds, 3, nb, na) == 0
        for f in ("f_hi", "f_lo"):
            same = (getattr(s0, f) == getattr(s1, f)).all(dim=1)
            assert bool(same[idle].all()), f
        for f in ("ya_hi", "free_a"):
            assert torch.equal(getattr(s0, f)[idle], getattr(s1, f)[idle]), f
        checked += int(idle.sum())
    assert checked > 0


@pytest.mark.parametrize("nb,na", OT_SHAPES)
def test_ot_strip_closed_form_column_sum(monkeypatch, nb, na):
    """The closed form fused_ot.cu writes for a column that does not
    collapse: its new f_hi sum is fsum - min(max(disp, 0), fsum), with
    disp the granted units beyond the free hi-cluster demand; and some
    strips take flow."""
    stripped = 0
    for s0, s1, rounds in _ot_phase_log(monkeypatch, nb, na, 41 * nb + na):
        g_a = _granted(rounds, 3, nb, na)
        hi_free = torch.where(s0.ya_hi == 0, s0.free_a, 0).long()
        disp = g_a - torch.minimum(g_a, hi_free)
        fsum = s0.f_hi.sum(dim=1).long()
        kept = s1.ya_hi == s0.ya_hi
        want = fsum - torch.minimum(disp.clamp_min(0), fsum)
        got = s1.f_hi.sum(dim=1).long()
        assert torch.equal(got[kept], want[kept])
        stripped += int((kept & (want < fsum)).sum())
    assert stripped > 0


@pytest.mark.parametrize("nb,na", OT_SHAPES)
def test_ot_grant_cells_bounded_by_proposals(monkeypatch, nb, na):
    """fused_ot.cu folds each grant into f_lo as it is made: a row gets
    at most one grant per round, so the cells it writes in a phase are at
    most the phase's proposals; and the grants of a phase are what f_lo
    and f_hi gained in the cells, summed with the stripped flow."""
    for s0, s1, rounds in _ot_phase_log(monkeypatch, nb, na, 43 * nb + na):
        proposals = sum(int((tgt < na).sum()) for tgt, _ in rounds)
        cells = torch.zeros((3, nb, na + 1), dtype=torch.bool)
        for tgt, grant in rounds:
            cells |= (torch.nn.functional.one_hot(tgt.long(), na + 1).bool()
                      & (grant > 0)[:, :, None])
        assert int(cells[:, :, :na].sum()) <= proposals
        # flow conservation per lane: granted units are new flow, the
        # stripped units went back to free supply
        flow0 = (s0.f_hi + s0.f_lo).sum(dim=(1, 2)).long()
        flow1 = (s1.f_hi + s1.f_lo).sum(dim=(1, 2)).long()
        granted = _granted(rounds, 3, nb, na).sum(dim=1)
        freed = (s1.free_b.sum(1) - s0.free_b.sum(1)).long() + granted
        ran = s1.phases > s0.phases
        assert torch.equal((flow1 - flow0)[ran], (granted - freed)[ran])
