"""Matrix placement: one instance's cost matrix sharded by (row, col)
blocks over a 2-D mesh.

Port of ``repro.core.sharded``. Block (i, j) of ``c_int`` (rows of row
block i, columns of column block j) lives on the mesh device at (i, j)
and never moves; the O(m + n) solver vectors (duals, matchings, masses,
capacities) live on the home device, the mesh's first. The port's mesh
is one process driving the devices (``launch/mesh.py``), so a reference
collective becomes a tensor op over per-block vectors brought to the
home device. Per propose round:

  propose : every block runs the unchanged ``slack_propose`` kernel on
            its block, with a salt that makes the kernel's hash equal the
            global one (:func:`block_salt`); the per-row (key, column)
            results of the column blocks merge lexicographically: least
            key, then least global column;
  accept  : per column, the least proposing global row wins (the
            reference's per-column-block scatter-min followed by a min
            across row blocks; on the home device both are one
            scatter-min over the n columns).

For OT, each block keeps its own slice of the flow matrices (``f_hi``,
``f_lo``) and of the phase's grants. The FIFO grant needs only O(nb + na)
vectors on the home device; a block learns its rows' targets and grants
and adds them to its slice. The end-of-phase strip needs each column's
``f_hi`` below the block's rows (the column sums of the blocks below),
and the column and row totals (``hi_left``, ``g_a``, ``freed_b``) are
sums of per-block sums. Cross-device traffic is O(m + n) ints a round and
a phase; the m x n work stays in the blocks. Every round reads one flag
from the host, as the single-device stepped route does; the blocks'
kernels are launched before it, so blocks on distinct cards run together.

All arithmetic is integer, so the state equals the single-device solve
bit for bit. The propose follows the single-device rule exactly (a row
whose admissible keys all hash to 0xFFFFFFFF still proposes the first
minimum over all n columns), where the reference's ``shard_map`` version
decides "none" by ``key == 0xFFFFFFFF``.

The fused kernels are whole-instance programs, so matrix placement runs
the stepped route, as the reference's does. ``lower_sharded_solver``
(the reference's AOT artifact for the dry-run) returns the plan of this
placement for an (n, n) matrix without allocating it: each block's shape,
bytes and device, the launches and cross-block traffic of a propose
round, and ``.compile()``, which builds the kernel library for the mesh's
devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.slack_propose import _H1, _H2, _H3, UMAX
from .device import as_f32, host_flags, host_numpy
from .pushrelabel import (
    AssignmentResult,
    assignment_epilogue,
    assignment_prologue,
    complete_matching,
    round_costs,
    solve_assignment_int,
)
from .transport import (
    OTResult,
    OTState,
    _cumsum32,
    _grant_round,
    ot_epilogue,
    ot_phase_cap,
    ot_prologue,
    ot_termination_threshold,
)

_M32 = 0xFFFFFFFF
_H3_INV = pow(_H3, -1, 1 << 32)


def block_salt(salt, r0: int, c0: int):
    """The salt that makes ``slack_propose`` on the block at global offset
    (r0, c0) hash each (row, col) as the global matrix does: the key is
    ``mix(i*H1 + j*H2 + s*H3) mod 2**32`` and H3 is odd, so
    ``s' = s + (r0*H1 + c0*H2) * H3^-1 (mod 2**32)`` turns the block's
    local (i, j) into the global (r0 + i, c0 + j). ``salt``: an int or an
    int32 tensor; returns the same kind, wrapped to int32."""
    off = ((r0 * _H1 + c0 * _H2) * _H3_INV) & _M32
    if isinstance(salt, torch.Tensor):
        s = (salt.to(torch.int64) + off) & _M32
        return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)
    s = (int(salt) + off) & _M32
    return s - (1 << 32) if s >= 1 << 31 else s


def block_device(mesh, row_axis: str, col_axis: str, i: int,
                 j: int) -> torch.device:
    """The device of block (i, j): index i on ``row_axis``, j on
    ``col_axis``, 0 on any other axis of ``mesh``."""
    names = mesh.axis_names
    at = [0] * len(names)
    at[names.index(row_axis)] = i
    at[names.index(col_axis)] = j
    level = mesh.devices
    for k in at:
        level = level[k]
    return level


class BlockGrid:
    """The (row, col) blocks of one (m, n) instance on ``mesh``: row block
    i spans ``rows[i]``, column block j ``cols[j]``, and lives on
    ``device(i, j)``. ``home`` (block (0, 0)'s device) holds the vectors.
    """

    def __init__(self, mesh, row_axis: str, col_axis: str, m: int, n: int):
        shape = mesh.shape
        self.mesh, self.row_axis, self.col_axis = mesh, row_axis, col_axis
        self.r, self.c = int(shape[row_axis]), int(shape[col_axis])
        if m % self.r or n % self.c:
            raise ValueError(
                f"a ({m}, {n}) matrix does not divide into the mesh's "
                f"({self.r}, {self.c}) blocks; pad it first")
        ml, nl = m // self.r, n // self.c
        self.m, self.n = m, n
        self.rows = [(i * ml, (i + 1) * ml) for i in range(self.r)]
        self.cols = [(j * nl, (j + 1) * nl) for j in range(self.c)]
        self.home = self.device(0, 0)

    def device(self, i: int, j: int) -> torch.device:
        return block_device(self.mesh, self.row_axis, self.col_axis, i, j)

    def split(self, full: torch.Tensor) -> List[List[torch.Tensor]]:
        """The (1, m_loc, n_loc) blocks of a (1, m, n) tensor, each
        contiguous on its device."""
        return [[full[:, r0:r1, c0:c1].to(self.device(i, j)).contiguous()
                 for j, (c0, c1) in enumerate(self.cols)]
                for i, (r0, r1) in enumerate(self.rows)]

    def join(self, blocks) -> torch.Tensor:
        """The (1, m, n) tensor on the home device from its blocks."""
        return torch.cat([torch.cat([b.to(self.home) for b in row], dim=2)
                          for row in blocks], dim=1)

    def col_sums(self, blocks) -> torch.Tensor:
        """(R, 1, n) on the home device: row block i's column sums."""
        return torch.stack([
            torch.cat([b.sum(dim=1, dtype=torch.int32).to(self.home)
                       for b in row], dim=1) for row in blocks])

    def row_sums(self, blocks) -> torch.Tensor:
        """(1, m) on the home device: the row sums over all blocks."""
        per_row = []
        for row in blocks:
            parts = [b.sum(dim=2, dtype=torch.int32).to(self.home)
                     for b in row]
            per_row.append(torch.stack(parts).sum(dim=0, dtype=torch.int32))
        return torch.cat(per_row, dim=1)

    def to_block(self, v: torch.Tensor, i: int, j: int, axis: str):
        """The slice of a (1, m) ("row") or (1, n) ("col") home vector that
        block (i, j) reads, on its device."""
        lo, hi = (self.rows[i] if axis == "row" else self.cols[j])
        return v[:, lo:hi].to(self.device(i, j)).contiguous()

    def propose(self, blocks, y_b, y_a, avail_a, salt, active_b):
        """The block schedule of one propose round: ``slack_propose`` on
        every block, then the lexicographic merge across column blocks.
        Same contract as ``ops.slack_propose_batched`` on the whole (1, m,
        n) matrix: returns ``(col (1, m) int32, key (1, m) int64)`` on the
        home device, equal to the single-device kernel's."""
        # every block's launch goes out before any result is read, so
        # blocks on distinct devices run together
        outs = []
        for i, (r0, _) in enumerate(self.rows):
            for j, (c0, _) in enumerate(self.cols):
                col, key = ops.slack_propose_batched(
                    blocks[i][j], self.to_block(y_b, i, j, "row"),
                    self.to_block(y_a, i, j, "col"),
                    self.to_block(avail_a, i, j, "col"),
                    block_salt(salt, r0, c0).to(self.device(i, j)),
                    active_b=self.to_block(active_b, i, j, "row"))
                outs.append((i, j, col, key))
        n = self.n
        merged_col, merged_key = [], []
        for i in range(self.r):
            cands, anys = [], []
            for (bi, j, col, key) in outs:
                if bi != i:
                    continue
                col, key = col.to(self.home), key.to(self.home)
                has = col >= 0
                # a block without an admissible column holds UMAX at its
                # first column, as the masked keys of the dense rule do
                gcol = self.cols[j][0] + torch.where(has, col, 0)
                cands.append(torch.where(has, key, UMAX) * n + gcol)
                anys.append(has)
            best = torch.stack(cands).amin(dim=0)
            any_adm = torch.stack(anys).any(dim=0)
            merged_col.append(torch.where(any_adm, best % n, -1)
                              .to(torch.int32))
            merged_key.append(best // n)
        return torch.cat(merged_col, dim=1), torch.cat(merged_key, dim=1)


@dataclass(frozen=True)
class ShardedSolverPlan:
    """Matrix placement of one (n, n) int32 assignment instance on a
    mesh, planned without allocating it. ``blocks``: one dict a block
    (``block`` (i, j), ``device``, global ``rows`` / ``cols`` ranges,
    the ``shape`` (1, m_loc, n_loc) the block's ``slack_propose`` launch
    reads, ``bytes``). ``per_round``: ``slack_propose_launches`` (one a
    block) and ``records``, the round's cross-block traffic: each block's
    inputs sent from the home device (its rows of ``y_b`` and ``active``,
    its columns of ``y_a`` and ``avail``, the salt), each block's
    (column, key) results brought to the home device for the
    lexicographic merge over column blocks, and the accept's scatter-min
    over the n columns on the home device. A record's ``crosses_device``
    says whether its bytes leave a device."""
    n: int
    eps: float
    mesh: object
    row_axis: str
    col_axis: str
    home: str
    blocks: Tuple[Dict, ...]
    per_round: Dict

    def compile(self) -> Dict:
        """Build the ``slack_propose`` library (``ops.build_kernels``, with
        the port's other kernels) for the mesh's CUDA devices; on CPU or
        meta devices build nothing and say so."""
        kinds = {torch.device(b["device"]).type for b in self.blocks}
        if kinds != {"cuda"}:
            return {"built": False, "devices": sorted(kinds),
                    "reason": "no CUDA device in the mesh: on the CPU the "
                              "plain version of slack_propose runs"}
        return {"built": True, "devices": ["cuda"],
                "build_s": ops.build_kernels(), "kernel": "slack_propose"}


def lower_sharded_solver(n: int, eps: float, mesh, row_axis: str = "data",
                         col_axis: str = "model") -> ShardedSolverPlan:
    """The plan of ``solve_assignment_sharded`` for an (n, n) cost matrix
    on ``mesh``, without allocating it (the reference lowers the sharded
    phase loop for the same purpose). Raises as the solve does when n
    does not divide into the mesh's blocks."""
    grid = BlockGrid(mesh, row_axis, col_axis, n, n)
    home = grid.home
    blocks, records = [], []

    def rec(what, dtype, size, where, dev):
        records.append({"what": what, "dtype": dtype, "shape": [1, size],
                        "bytes": size * (8 if dtype == "s64" else 4
                                         if dtype == "s32" else 1),
                        "where": where, "crosses_device": dev != home})
    for i, (r0, r1) in enumerate(grid.rows):
        for j, (c0, c1) in enumerate(grid.cols):
            dev = grid.device(i, j)
            m_loc, n_loc = r1 - r0, c1 - c0
            blocks.append({"block": (i, j), "device": str(dev),
                           "rows": (r0, r1), "cols": (c0, c1),
                           "shape": (1, m_loc, n_loc),
                           "bytes": 4 * m_loc * n_loc})
            where = f"block ({i}, {j})"
            rec("y_b rows to the block", "s32", m_loc, where, dev)
            rec("active rows to the block", "pred", m_loc, where, dev)
            rec("y_a columns to the block", "s32", n_loc, where, dev)
            rec("avail columns to the block", "pred", n_loc, where, dev)
            rec("salt to the block", "s32", 1, where, dev)
            rec("propose column to home (merge over column blocks)", "s32",
                m_loc, where, dev)
            rec("propose key to home (merge over column blocks)", "s64",
                m_loc, where, dev)
    records.append({"what": "accept: scatter-min of the proposing rows over "
                            "the columns", "dtype": "s32", "shape": [1, n],
                    "bytes": 4 * n, "where": "home",
                    "crosses_device": False})
    return ShardedSolverPlan(
        n=n, eps=eps, mesh=mesh, row_axis=row_axis, col_axis=col_axis,
        home=str(home), blocks=tuple(blocks),
        per_round={"slack_propose_launches": len(blocks),
                   "records": records,
                   "bytes_crossing_devices": sum(
                       r["bytes"] for r in records if r["crosses_device"])})


def _stand_in(grid: BlockGrid) -> torch.Tensor:
    """A (1, m, n) int32 tensor without storage: the stepped cores read
    only its shape and device when the propose step is the block
    schedule."""
    return torch.zeros((1, 1, 1), dtype=torch.int32,
                       device=grid.home).expand(1, grid.m, grid.n)


# --------------------------------------------------------------------------
# Assignment
# --------------------------------------------------------------------------

def _solve_assignment_blocks(grid: BlockGrid, blocks, eps: float,
                             threshold: int, m_valid=None):
    """``solve_assignment_int`` with the block propose: rounds, accept,
    push and relabel are the stepped core's own on the home device's
    vectors. Returns the state (batch axis 1)."""
    def propose_fn(c_int, y_b, y_a, active_b, avail_a, salt):
        return grid.propose(blocks, y_b, y_a, avail_a, salt, active_b)[0]
    return solve_assignment_int(_stand_in(grid)[0], eps,
                                propose_fn=propose_fn, m_valid=m_valid,
                                threshold=threshold)


def solve_assignment_sharded(c, eps: float, mesh, *, row_axis: str = "data",
                             col_axis: str = "model",
                             guaranteed: bool = False, m_valid=None,
                             n_valid=None) -> AssignmentResult:
    """Assignment solve with the cost matrix sharded across ``mesh``; the
    result (leading batch axis 1, on the home device) equals the
    single-device ``solve_assignment``'s bit for bit.

    ``m_valid``/``n_valid`` mark the input as padded: only the leading
    (m_valid, n_valid) block is the instance (padded edges get the
    batched solver's pad cost and masked completion, so the result
    equals the unpadded solve's). The distributed matrix placement pads
    instances up to mesh-divisible shapes this way."""
    c = as_f32(c, block_device(mesh, row_axis, col_axis, 0, 0))
    if guaranteed:
        eps = eps / 3.0
    m, n = c.shape
    grid = BlockGrid(mesh, row_axis, col_axis, m, n)
    c = c[None]
    eps_t = torch.tensor([eps], dtype=torch.float32, device=grid.home)
    if m_valid is None:
        cm, c_int, scale, row_ok, col_ok = assignment_prologue(c, eps_t)
        threshold = int(eps * m)
        mv = None
    else:
        mv, nv = (torch.tensor([int(v)], dtype=torch.int32,
                               device=grid.home) for v in (m_valid, n_valid))
        cm, c_int, scale, row_ok, col_ok = assignment_prologue(c, eps_t, mv,
                                                               nv)
        threshold = int(eps * int(m_valid))
    state = _solve_assignment_blocks(grid, grid.split(c_int), eps, threshold,
                                     None if mv is None else int(m_valid))
    return assignment_epilogue(cm, scale, state, eps_t, row_ok, col_ok)


def solve_assignment_shardmap(c, eps: float, mesh, *,
                              row_axis: str = "data",
                              col_axis: str = "model") -> AssignmentResult:
    """The reference's hand-placed schedule entry point: costs rounded as
    the reference's eager solve rounds them (``round_costs(c / scale,
    eps)``), the same block schedule, and ``sum_ni`` reported as -1 (not
    tracked there). ``m`` and ``n`` must divide into the mesh's blocks."""
    c = as_f32(c, block_device(mesh, row_axis, col_axis, 0, 0))
    m, n = c.shape
    grid = BlockGrid(mesh, row_axis, col_axis, m, n)
    scale = c.amax().clamp_min(1e-30)
    c_int = round_costs(c / scale, eps)
    state = _solve_assignment_blocks(grid, grid.split(c_int[None]), eps,
                                     int(eps * m))
    matching = complete_matching(state.match_ba, state.match_ab)
    valid = matching >= 0
    picked = c[None].gather(2, matching.clamp(0, n - 1).to(torch.int64)
                            [:, :, None])[:, :, 0]
    e = torch.tensor([[eps]], dtype=torch.float32, device=grid.home)
    return AssignmentResult(
        matching=matching, cost=torch.where(valid, picked, 0.0).sum(dim=1),
        y_b=state.y_b.to(torch.float32) * e * scale,
        y_a=state.y_a.to(torch.float32) * e * scale,
        phases=state.phases, rounds=state.rounds,
        sum_ni=torch.full_like(state.sum_ni, -1),
        matched_before_completion=(state.match_ba >= 0).sum(
            dim=1, dtype=torch.int32))


# --------------------------------------------------------------------------
# General OT
# --------------------------------------------------------------------------

def _ot_phase_blocks(grid: BlockGrid, blocks, s: OTState, f_hi, f_lo,
                     max_rounds: int, running: torch.Tensor):
    """One phase of ``transport._phase`` with the flows in blocks.
    ``s`` holds the home vectors (its ``f_hi``/``f_lo`` are unused);
    ``running`` is the (1,) lane mask. Returns ``(state, f_hi, f_lo,
    ran)``."""
    home = grid.home
    stand = _stand_in(grid)
    na = grid.n
    free_b0 = torch.where(running[:, None], s.free_b, 0)
    free_a0 = s.free_a
    hi_free = torch.where(s.ya_hi == 0, free_a0, 0)
    colsum = grid.col_sums(f_hi)                       # (R, 1, n)
    cap_a = hi_free + colsum.sum(dim=0, dtype=torch.int32)
    rem_b = free_b0
    granted = [[torch.zeros_like(b) for b in row] for row in f_hi]
    rounds = torch.zeros((1,), dtype=torch.int32, device=home)
    done = ~running
    ran = True

    def propose(c_int, y_b, y_a, avail_a, salt, active_b):
        return grid.propose(blocks, y_b, y_a, avail_a, salt, active_b)

    for r in range(max_rounds):
        run = ~done
        salt = (s.phases * 7919 + rounds).contiguous()
        tgt, grant, any_prop = _grant_round(
            stand, s.y_b, s.ya_hi, torch.where(run[:, None], rem_b, 0),
            cap_a, salt, propose=propose)
        # each block adds the grants of its rows that landed in its
        # columns
        for i, (r0, r1) in enumerate(grid.rows):
            for j, (c0, c1) in enumerate(grid.cols):
                dev = grid.device(i, j)
                t = tgt[:, r0:r1].to(dev) - c0
                mine = (t >= 0) & (t < c1 - c0)
                g = grant[:, r0:r1].to(dev)
                granted[i][j].view(r1 - r0, c1 - c0).scatter_add_(
                    1, torch.where(mine, t, 0).view(-1, 1),
                    torch.where(mine, g, 0).view(-1, 1))
        tgt_c = tgt.clamp(max=na - 1)
        cap_a = cap_a.scatter_add(1, tgt_c, -grant)
        rem_b = rem_b - grant
        rounds = rounds + run.to(torch.int32)
        done = done | ~any_prop
        if r == 0:
            stop, ran = host_flags("round", done.all(), running.any())
        else:
            stop, = host_flags("round", done.all())
        if stop:
            break
    if not ran:
        return s, f_hi, f_lo, False

    g_a = grid.col_sums(granted).sum(dim=0, dtype=torch.int32)
    use_free = torch.minimum(g_a, hi_free)
    disp = g_a - use_free
    # f_hi below each row block, per column: the column sums of the
    # blocks under it
    below = colsum.flip(0).cumsum(0, dtype=torch.int32).flip(0) - colsum
    take = []
    for i, row in enumerate(f_hi):
        trow = []
        for j, blk in enumerate(row):
            below_ij = grid.to_block(below[i], i, j, "col")
            suffix = (_cumsum32(blk.flip(1), 1).flip(1) - blk
                      + below_ij[:, None, :])
            disp_j = grid.to_block(disp, i, j, "col")
            trow.append(torch.minimum(
                (disp_j[:, None, :] - suffix).clamp_min(0), blk))
        take.append(trow)
    freed_b = grid.row_sums(take)
    f_hi = [[b - t for b, t in zip(brow, trow)]
            for brow, trow in zip(f_hi, take)]
    del take
    free_a = free_a0 - use_free
    hi_left = (torch.where(s.ya_hi == 0, free_a, 0)
               + grid.col_sums(f_hi).sum(dim=0, dtype=torch.int32))
    collapse = (hi_left == 0) & (g_a > 0)
    ya_hi = torch.where(collapse, s.ya_hi - 1, s.ya_hi)
    new_hi, new_lo = [], []
    for i, (hrow, lrow, grow) in enumerate(zip(f_hi, f_lo, granted)):
        hr, lr = [], []
        for j, (h, lo, g) in enumerate(zip(hrow, lrow, grow)):
            col_j = grid.to_block(collapse, i, j, "col")[:, None, :]
            lo = g.add_(lo)
            hr.append(torch.where(col_j, lo, h))
            lr.append(torch.where(col_j, 0, lo))
        new_hi.append(hr)
        new_lo.append(lr)
    y_b = s.y_b + ((free_b0 > 0) & (rem_b > 0)).to(torch.int32)
    free_b = torch.where(running[:, None], rem_b + freed_b, s.free_b)
    out = s._replace(y_b=y_b, ya_hi=ya_hi, free_b=free_b, free_a=free_a,
                     phases=s.phases + running.to(torch.int32),
                     rounds=s.rounds + rounds)
    return out, new_hi, new_lo, True


def _solve_ot_blocks(grid: BlockGrid, blocks, s_int, d_int, threshold: int,
                     max_phases: int, max_rounds: int) -> OTState:
    """``solve_ot_int``'s phase loop with the flows in blocks; returns the
    state (batch axis 1) with the flows joined on the home device."""
    home = grid.home

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=home)
    # init_ot_state without the (1, nb, na) flows: those live in blocks
    vec = OTState(y_b=torch.ones_like(s_int), ya_hi=zeros(1, grid.n),
                  free_b=s_int.to(torch.int32, copy=True),
                  free_a=d_int.to(torch.int32, copy=True), f_hi=None,
                  f_lo=None, phases=zeros(1), rounds=zeros(1))
    f_hi = [[torch.zeros_like(b) for b in row] for row in blocks]
    f_lo = [[torch.zeros_like(b) for b in row] for row in blocks]
    thr = torch.tensor([int(threshold)], dtype=torch.int32, device=home)
    # one iteration more than phases, as run_ot_phases's k = cap + 1: the
    # last reads that no lane runs
    for _ in range(int(max_phases) + 1):
        running = ((vec.free_b.sum(dim=1, dtype=torch.int32) > thr)
                   & (vec.phases < int(max_phases)))
        vec, f_hi, f_lo, ran = _ot_phase_blocks(grid, blocks, vec, f_hi,
                                                f_lo, max_rounds, running)
        if not ran:
            break
    return vec._replace(f_hi=grid.join(f_hi), f_lo=grid.join(f_lo))


def solve_ot_sharded(c, nu, mu, eps: float, mesh, *, row_axis: str = "data",
                     col_axis: str = "model", theta=None,
                     guaranteed: bool = False) -> OTResult:
    """General-OT solve with the cost matrix and both flow matrices
    sharded across ``mesh``. The integer state equals the single-device
    ``solve_ot``'s bit for bit; the float epilogue runs on the joined
    state on the home device with the same ops as ``solve_ot``. Returns
    an OTResult with a leading batch axis of 1."""
    home = block_device(mesh, row_axis, col_axis, 0, 0)
    if guaranteed:
        eps = eps / 3.0
    c = as_f32(c, home)
    nb, na = c.shape
    grid = BlockGrid(mesh, row_axis, col_axis, nb, na)
    nu = as_f32(nu, home)
    mu = as_f32(mu, home)
    if theta is None:
        theta = 4.0 * max(nb, na) / eps
    threshold = ot_termination_threshold(host_numpy("prepare", nu),
                                         np.float32(theta), eps)
    theta_t = torch.tensor([theta], dtype=torch.float32, device=home)
    eps_t = torch.tensor([eps], dtype=torch.float32, device=home)
    c, nu, mu = c[None], nu[None], mu[None]
    c_int, s_int, d_int, scale = ot_prologue(c, nu, mu, theta_t, eps_t)
    state = _solve_ot_blocks(grid, grid.split(c_int), s_int, d_int,
                             threshold, ot_phase_cap(eps), nb + na + 2)
    return ot_epilogue(c, nu, mu, theta_t, eps_t, scale, s_int, d_int,
                       state)
