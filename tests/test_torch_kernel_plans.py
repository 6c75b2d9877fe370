"""The premises of the two ``cost_matrix`` instances
(``src/repro_torch/csrc/cost_matrix.cu``) and of the staged redesign of
``sinkhorn_row_update`` that was measured and not shipped
(``tools/row_designs/staged.cu``, timed by
``tools/row_kernel_designs.py``), checked on the CPU with Python models of
what the CUDA sources do: the row ranges of the persistent grid, the ring
of stages and g slots under mbarrier phase parity, the points instance's
tiling, the images instance's shared-memory layout, and chip_smoke's bound
and ptxas reader. The shipped kernels run against their plain versions in
tests/test_torch_cuda.py, on the card."""
import random
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import chip_smoke  # noqa: E402
import row_kernel_designs as rkd  # noqa: E402

STAGED = REPO / "tools" / "row_designs" / "staged.cu"


def _constexpr(name: str) -> int:
    """A ``constexpr int`` of staged.cu."""
    text = STAGED.read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    return int(eval(expr, {}))  # e.g. "227 * 1024"


CONSUMER_WARPS = _constexpr("kConsumerWarps")
PARTS = _constexpr("kParts")


def test_row_plan_constants_match_the_kernel():
    """row_kernel_designs.staged_plan lays out the shared memory that the
    kernel addresses: both must agree on the ring's limit, the parts and
    the barrier area, and the plan must fit the kernel's shared-memory
    limit."""
    assert rkd.MAX_STAGES == _constexpr("kMaxStages")
    assert rkd.PARTS == PARTS and CONSUMER_WARPS % PARTS == 0
    assert rkd.BARRIER_BYTES == _constexpr("kBarrierBytes")
    # full and empty barriers of every stage and two g full and two g
    # empty ones (8 bytes each), then an item word a stage (8 bytes), then
    # two (max, sum) slots a warp, in that order inside the barrier area
    items = _constexpr("kItemOffset")
    slots = _constexpr("kSlotOffset")
    assert 16 * rkd.MAX_STAGES + 32 <= items
    assert items + 8 * rkd.MAX_STAGES <= slots
    assert slots + 2 * 8 * CONSUMER_WARPS <= rkd.BARRIER_BYTES
    assert rkd.SMEM <= _constexpr("kSmemLimit")


@pytest.mark.parametrize("n", [4, 12, 1000, 1024, 2048, 4092, 4096, 4100,
                               8192, 8196, 12_000, 100_000])
def test_row_plan_units_cover_a_row(n):
    """A unit is PARTS whole rows (where they fit UNIT_FLOATS), one
    row, or one segment of a longer row; segments are multiples of 4 floats
    (a bulk copy moves multiples of 16 bytes from 16-byte aligned
    addresses) and cover the row with a non-empty last one; a warp's share
    fits its registers; the ring fits its limit and holds every stage the
    kernel addresses."""
    p = rkd.staged_plan(n)
    assert p.seg % 4 == 0 and 0 < p.seg <= rkd.UNIT_FLOATS
    assert (p.nseg - 1) * p.seg < n <= p.nseg * p.seg
    assert (n - (p.nseg - 1) * p.seg) % 4 == 0
    if n <= rkd.UNIT_FLOATS:
        assert p.nseg == 1 and p.seg == n
        # a row for each warp of the group where PARTS rows fit a unit
        want = rkd.PARTS if n * rkd.PARTS <= rkd.UNIT_FLOATS else 1
        assert p.rows == want
    else:
        assert p.rows == 1
    # a warp's share of a unit is at most kSpan float4 a lane
    share = n if p.rows > 1 else -(-p.seg // rkd.PARTS)
    assert share <= 4 * 32 * _constexpr("kSpan")
    assert 2 <= p.stages <= rkd.MAX_STAGES
    assert p.stage_bytes % 128 == 0 and p.g_slot_bytes % 128 == 0
    if n <= rkd.G_WHOLE_MAX:
        assert p.g_slot_bytes >= 4 * n
        assert p.stage_bytes >= 4 * p.seg * p.rows
    else:
        assert p.g_slot_bytes == 0 and p.stage_bytes >= 8 * p.seg
    assert p.smem == (rkd.BARRIER_BYTES + 2 * p.g_slot_bytes
                      + p.stages * p.stage_bytes) <= rkd.SMEM
    if n >= 1000:
        # at least ~40 KB in flight an SM: 3.35 TB/s x 1.5 us / 132
        assert p.stages * 4 * p.seg * p.rows >= 40_000


def _block_rows(k, rows, grid):
    """The rows block k owns (sinkhorn_row_staged_kernel: r0, r1)."""
    return rows * k // grid, rows * (k + 1) // grid


def _lanes_walked(k, b, m, grid):
    """(lane, lo, hi) for every lane block k's range enters, as the
    producer and the consumers walk them."""
    r0, r1 = _block_rows(k, b * m, grid)
    if r0 >= r1:
        return []
    return [(lane, max(r0, lane * m), min(r1, (lane + 1) * m))
            for lane in range(r0 // m, (r1 - 1) // m + 1)]


@pytest.mark.parametrize("b,m,grid", [(8, 1024, 132), (1, 4096, 132),
                                      (3, 1000, 132), (600, 3, 132),
                                      (1, 5, 5), (7, 13, 11), (2, 1, 2)])
def test_row_ranges_cover_every_lane_row_once(b, m, grid):
    """Every (lane, row) falls in exactly one block's walk, in the lane
    it belongs to, for B m rows that the grid does not divide."""
    grid = min(grid, b * m)  # the launcher never starts more blocks
    seen = {}
    for k in range(grid):
        r0, r1 = _block_rows(k, b * m, grid)
        assert r1 - r0 in (b * m // grid, -(-b * m // grid))
        for lane, lo, hi in _lanes_walked(k, b, m, grid):
            assert lane * m <= lo < hi <= (lane + 1) * m
            for row in range(lo, hi):
                assert row not in seen
                seen[row] = (k, lane)
    assert sorted(seen) == list(range(b * m))
    assert all(lane == row // m for row, (_, lane) in seen.items())


class _MBar:
    """An mbarrier: ``count`` arrivals and the announced bytes complete a
    phase; a parity wait passes iff the current phase's parity differs
    (so it cannot tell a phase from the one two later)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self):
        self.pending -= 1
        self._check()

    def expect_tx(self, nbytes):
        self.tx += nbytes
        self.arrive()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        assert self.tx >= 0
        self._check()

    def passed(self, parity):
        return (self.phase & 1) != parity


def _simulate_block(b, m, grid, k, nseg, rows, stages, warps, parts,
                    g_whole, active, seed, issue_guard=True):
    """Run block k of the staged kernel as Python actors under a random
    schedule: the producer thread, ``warps`` consumer warps in groups of
    ``parts`` and the bulk copies in flight (each lands at a random later
    step). A group takes every (warps / parts)-th unit of ``rows`` rows
    (several only when nseg == 1); its warps share the unit by rows
    (rows > 1) or by columns, meeting at a group barrier at the end of a
    row to merge their parts from double-buffered slots. Asserts that a
    copy never lands in a stage or g slot that a consumer may still read,
    that every read sees the segment or lane it expects, that a merge
    reads the parts of its own row, and that the run ends. Returns {row:
    warp that wrote f}. ``issue_guard``: a consumer waits for its item in
    the stage's item word (published by the producer after each issue)
    before the parity wait, as the kernel does."""
    rnd = random.Random(seed)
    groups = warps // parts
    full = [_MBar(1) for _ in range(stages)]
    empty = [_MBar(parts) for _ in range(stages)]
    gfull = [_MBar(1) for _ in range(2)]
    gempty = [_MBar(warps) for _ in range(2)]
    stage_data = [None] * stages
    stage_item = [-1] * stages
    stage_readers = [0] * stages
    g_data = [None, None]
    g_readers = [0, 0]
    part_slots = [[[None] * parts for _ in range(2)] for _ in range(groups)]
    bar = [[0, 0] for _ in range(groups)]  # (arrived, generation)
    copies = []
    reduced = {}
    lanes = _lanes_walked(k, b, m, grid)

    def land(kind, idx, payload, mbar, nbytes):
        if kind == "c":
            assert stage_readers[idx] == 0, "stage overwritten while read"
            stage_data[idx] = payload
        else:
            assert g_readers[idx] == 0, "g slot overwritten while read"
            g_data[idx] = payload
        mbar.complete_tx(nbytes)

    def producer():
        t, q = 0, 0
        for lane, lo, hi in lanes:
            if not active[lane]:
                continue
            if g_whole:
                slot = q & 1
                while not gempty[slot].passed(((q >> 1) & 1) ^ 1):
                    yield
                gfull[slot].expect_tx(1)
                copies.append(("g", slot, lane, gfull[slot], 1))
            for row in range(lo, hi, rows):
                for sg in range(nseg):
                    st, par = t % stages, (t // stages) & 1
                    while not empty[st].passed(par ^ 1):
                        yield
                    full[st].expect_tx(1)
                    copies.append(("c", st, (row, sg), full[st], 1))
                    stage_item[st] = t
                    t += 1
                    yield
            q += 1

    def group_barrier(group):
        gen = bar[group][1]
        bar[group][0] += 1
        if bar[group][0] == parts:
            bar[group] = [0, gen + 1]
        while bar[group][1] == gen:
            yield

    def consumer(w):
        group, part = divmod(w, parts)
        aunit, q, rpar = 0, 0, 0
        for lane, lo, hi in lanes:
            if not active[lane]:
                continue
            slot = q & 1
            if g_whole:
                while not gfull[slot].passed((q >> 1) & 1):
                    yield
                g_readers[slot] += 1
            units = -(-(hi - lo) // rows)
            for u in range((group - aunit % groups) % groups, units,
                           groups):
                row0 = lo + u * rows
                for sg in range(nseg):
                    t = (aunit + u) * nseg + sg
                    st = t % stages
                    while issue_guard and stage_item[st] != t:
                        yield
                    while not full[st].passed((t // stages) & 1):
                        yield
                    stage_readers[st] += 1
                    assert stage_data[st] == (row0, sg)
                    if g_whole:
                        assert g_data[slot] == lane
                    yield  # the warp reads while others run
                    assert stage_data[st] == (row0, sg)
                    stage_readers[st] -= 1
                    empty[st].arrive()
                if rows > 1:
                    assert rows == parts  # a row for each warp
                    if row0 + part < hi:
                        assert row0 + part not in reduced
                        reduced[row0 + part] = w
                else:
                    part_slots[group][rpar][part] = row0
                    yield from group_barrier(group)
                    if part == 0:
                        assert part_slots[group][rpar] == [row0] * parts
                        assert row0 not in reduced
                        reduced[row0] = w
                    rpar ^= 1
            if g_whole:
                assert g_data[slot] == lane
                g_readers[slot] -= 1
                gempty[slot].arrive()
            aunit += units
            q += 1

    actors = [producer()] + [consumer(w) for w in range(warps)]
    for _ in range(2_000_000):
        if not actors and not copies:
            return reduced
        if copies and (not actors or rnd.random() < 0.3):
            land(*copies.pop(rnd.randrange(len(copies))))
            continue
        actor = rnd.choice(actors)
        try:
            next(actor)
        except StopIteration:
            actors.remove(actor)
    raise AssertionError("the ring deadlocked")


@pytest.mark.parametrize(
    "b,m,grid,nseg,rows,stages,warps,parts,g_whole,off", [
        (3, 50, 2, 1, 1, 2, CONSUMER_WARPS, PARTS, True, ()),
        (3, 50, 2, 1, 4, 32, CONSUMER_WARPS, PARTS, True, (1,)),
        (3, 50, 2, 1, PARTS, 2, CONSUMER_WARPS, PARTS, True, ()),
        (20, 3, 1, 2, 1, 3, CONSUMER_WARPS, PARTS, True, (0, 4, 5, 19)),
        (20, 3, 2, 1, 2, 2, 4, 2, True, (2, 3, 7)),
        (4, 9, 3, 3, 1, 6, CONSUMER_WARPS, PARTS, False, (1,)),
        (5, 7, 1, 3, 1, 2, 2, 1, False, ()),
        (6, 4, 1, 1, 4, 4, CONSUMER_WARPS, PARTS, True, (0, 1, 2, 3, 4, 5)),
    ])
def test_ring_never_reuses_a_stage_before_release(b, m, grid, nseg, rows,
                                                   stages, warps, parts,
                                                   g_whole, off):
    """The stage and parity sequence of the ring (stage t mod S, parity
    (t / S) & 1), the two g slots (lane ordinal q: slot q & 1, parity
    (q >> 1) & 1) and the groups' part slots: under random schedules no
    copy lands where a consumer may still read, every read sees its own
    segment and lane, every merge its own row's parts, and every row of an
    active lane gets its f once."""
    active = [lane not in off for lane in range(b)]
    for k in range(grid):
        for seed in range(4):
            reduced = _simulate_block(b, m, grid, k, nseg, rows, stages,
                                      warps, parts, g_whole, active, seed)
            want = [row for lane, lo, hi in _lanes_walked(k, b, m, grid)
                    if active[lane] for row in range(lo, hi)]
            assert sorted(reduced) == want


def test_ring_without_the_issue_guard_reads_a_stale_stage():
    """Why the item word: a warp that skips the other warps' rows can wait
    on a stage that is still a phase short of the one it awaits, and the
    parity wait then passes on the earlier phase."""
    with pytest.raises(AssertionError, match="assert"):
        _simulate_block(3, 50, 2, 0, 1, 1, 2, CONSUMER_WARPS, PARTS, True,
                        [True] * 3, 0, issue_guard=False)


def _points_rows_per_block(b, m, n, slots):
    """csrc/cost_matrix.cu ``points_rows_per_block``."""
    tiles = -(-(-(-n // 4)) // 128) * b
    row_blocks = min(max(slots // tiles, 1), m)
    return -(-m // row_blocks)


@pytest.mark.parametrize("b,m,n", [(1, 10_000, 10_000), (16, 1024, 1024),
                                   (1, 131, 257), (16, 70, 130),
                                   (1, 200, 1027), (3, 1, 5), (2, 5, 1)])
@pytest.mark.parametrize("slots", [132 * 16, 132 * 5, 3])
def test_points_tiling_covers_every_output_once(b, m, n, slots):
    """Grid (column tiles, row ranges, lanes), 128 column quads a block,
    rows_per_block rows a block. The axes are independent, so every
    (b, i, j) is written once iff every column and every row is: checked
    axis by axis. No more blocks than the card holds at once unless the
    tiles alone exceed it."""
    rows = _points_rows_per_block(b, m, n, slots)
    quads = -(-n // 4)
    grid = (-(-quads // 128), -(-m // rows), b)
    col_hits = [0] * n
    for bx in range(grid[0]):
        for thread in range(128):
            j0 = 4 * (bx * 128 + thread)
            for q in range(4):
                if j0 < n and j0 + q < n:  # the kernel returns at j0 >= n
                    col_hits[j0 + q] += 1
    row_hits = [0] * m
    for by in range(grid[1]):
        i0, i1 = by * rows, min(m, by * rows + rows)
        assert i0 < i1  # no empty block
        for i in range(i0, i1):
            row_hits[i] += 1
    assert col_hits == [1] * n and row_hits == [1] * m
    if grid[0] * b <= slots:
        assert grid[0] * grid[1] * grid[2] <= slots


def _unit(r, u):
    """csrc/cost_matrix.cu ``unit``: the 16-byte unit of (row, unit)."""
    return 4 * r + (u ^ ((r >> 1) & 3))


def test_images_tile_layout_is_conflict_free():
    """Each chunk holds 128 rows x 4 units once. A quarter-warp's 16-byte
    copies (thread v: row v >> 2, unit v & 3) and 16-byte reads of eight
    neighbouring columns (tx + 16 j, one unit) hit eight distinct bank
    groups; a warp's 4-byte copies (row v >> 4, feature v & 15) hit 32
    distinct banks."""
    cells = {_unit(r, u) for r in range(128) for u in range(4)}
    assert cells == set(range(512))
    for v0 in range(0, 512, 8):  # quarter-warps of the 16-byte copies
        groups = {_unit(v >> 2, v & 3) % 8 for v in range(v0, v0 + 8)}
        assert len(groups) == 8
    for j in range(8):
        for tx0 in (0, 8):
            for u in range(4):
                groups = {_unit(tx + 16 * j, u) % 8
                          for tx in range(tx0, tx0 + 8)}
                assert len(groups) == 8
    for v0 in range(0, 2048, 32):  # warps of the 4-byte copies
        banks = {(4 * _unit(v >> 4, (v & 15) >> 2) + (v & 3)) % 32
                 for v in range(v0, v0 + 32)}
        assert len(banks) == 32


@pytest.mark.parametrize("metric,b,m,n,d,ms,by", [
    ("euclidean", 1, 10_000, 10_000, 2, 0.1194507, "bytes"),
    ("l1", 1, 10_000, 10_000, 2, 0.1194507, "bytes"),
    ("l1", 1, 2048, 2048, 784, 0.1963185, "operations"),
    ("sqeuclidean", 1, 2048, 2048, 784, 0.0981592, "operations"),
    ("euclidean", 16, 1024, 1024, 2, 0.02011075, "bytes"),
])
def test_cost_bound_counts_l1_as_two_instructions(metric, b, m, n, d, ms,
                                                   by):
    """An l1 term is two FP32 instructions at half the flop rate, an FFMA
    two flops at the flop rate; bytes: x, y read and the output written
    once."""
    bound_ms, bound_by = chip_smoke.cost_bound(metric, b, m, n, d)
    assert bound_by == by
    assert bound_ms == pytest.approx(ms, rel=1e-6)
    if metric == "l1" and by == "operations":
        flops = 2 * b * m * n * d
        assert bound_ms == pytest.approx(
            2e3 * flops / chip_smoke.FP32_FLOP_PER_S)


def test_ptxas_summary_reads_each_entry():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'
ptxas info    : Function properties for _Z1bPf
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 33792 bytes smem, \
384 bytes cmem[0]
"""
    assert chip_smoke.ptxas_summary(text) == {
        "_Z1aPf": {"registers": 38, "smem": 0, "spill_stores": 0,
                   "spill_loads": 0},
        "_Z1bPf": {"registers": 128, "smem": 33792, "spill_stores": 12,
                   "spill_loads": 16}}
