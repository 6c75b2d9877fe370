"""Mesh-distributed convergence-compacting batch dispatch, generic over a
ProblemSpec (``core/problem.py``).

Port of ``repro.core.distributed``. The paper's bound is parallel time
O(log n / eps^2); the reference carries it across devices in two
placements, and so does the port:

  * batch placement: a fleet of instances is split along the batch axis
    of a 1-D mesh; each shard runs the spec's k-phase chunk on its own
    lanes, and the compacting driver retires converged instances across
    the whole batch between chunks;
  * matrix placement (``core/sharded.py``): one large instance's cost
    matrix is split into (row, col) blocks, with O(m + n) cross-device
    traffic a round. ``choose_placement`` picks per bucket.

The port's mesh is one process driving a set of ``torch.device``s
(``launch/mesh.py``), not a ``torch.distributed`` process group, so
every caller of ``solve()`` and of the serving layers stays a library
call, as in the reference. Devices may repeat: D logical shards on one
device run the same schedule as D cards.

The shards of a chunk are in flight together. The stepped route reads a
flag from the host every propose round, so a host loop over the shards
would run them one after another; instead each shard's chunk runs in a
worker thread with the shard's device current and its own stream (on
one card, logical shards run on separate streams), and the driver joins
them before it reads the converged mask. The fused kernels are
cooperative launches that need the whole card, so under a fused spec the
shards that share a card share its stream too. Each worker synchronizes
its stream before it returns; the driver synchronizes every device
after its own set-up and re-bucketing work, so a shard's stream never
reads a buffer the driver is still writing, and no buffer is reused
while another stream reads it.

Driver semantics are the reference's:

  * the dispatched batch starts at ``max(pow2(B), D)``, so the batch axis
    divides among the D shards;
  * ONE converged-mask read per chunk for the whole mesh (``"chunk"`` in
    ``core.device.sync_counts``, +1 a chunk);
  * once occupancy has halved, all lanes are flushed to the full-size
    result buffer and the survivors re-bucketed into the next power of
    two, split again over the mesh;
  * when the next bucket would drop below the device count
    (``pow2(live) < D``), the survivors collapse onto the first device
    (``collapsed_at``) and the descent goes on as the single-device
    driver's;
  * a batch below the mesh floor from the start runs the single-device
    driver;
  * ``slot_phases`` counts per-device lockstep slots (each shard runs its
    lanes for its local max phase delta);
  * ``deadline`` cuts the chunk loop with best-so-far semantics;
  * ``obs`` gets one ``"chunk"`` event per dispatch carrying ``devices``.

Under batch placement per-lane results are bit-equal to the single-device
compacting driver (lanes never interact; the hash keys depend only on the
within-instance (row, col, phase, round)). Under matrix placement each
instance solves at its own mesh-divisible padded shape: the integer state
is bit-equal, and the float epilogue may differ by reassociation.

The sanitizer (``repro_torch.analysis.checked``) applies to the
single-device compacting driver only, as in the reference: a mesh
dispatch stays plain under ``REPRO_DEBUG_CHECKS=1``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh, make_mesh
from ..obs import tracing as _tracing
from ..obs.metrics import now as _now
from .compaction import (
    DEFAULT_CHUNK,
    CompactionStats,
    _flush,
    _gather,
    _route,
    chunk_for,
    max_chunk_dispatches,
    record_phases,
    solve_compacting,
    spec_fns,
)
from .device import host_numpy
from .problem import (
    ASSIGNMENT,
    OT,
    _sizes_arrays,
    eps_array,
    pow2_at_least,
    tree_map,
)


@dataclass
class DistributedStats(CompactionStats):
    """CompactionStats plus mesh/placement accounting.

    ``slot_phases`` counts PER-DEVICE lockstep slots (each shard runs its
    local lanes for the local max phase delta), so it is directly
    comparable with the single-device driver's number."""
    devices: int = 1
    batch_axis: str = "data"
    placement: str = "batch"
    collapsed_at: Optional[int] = None      # bucket size at 1-device collapse
    devices_per_dispatch: List[int] = field(default_factory=list)

    def as_dict(self) -> dict:
        d = super().as_dict()
        d.update({
            "devices": self.devices,
            "batch_axis": self.batch_axis,
            "placement": self.placement,
            "collapsed_at": self.collapsed_at,
            "devices_per_dispatch": list(self.devices_per_dispatch),
        })
        return d


def choose_placement(b: int, m: int, n: int, n_devices: int,
                     *, matrix_min_size: int = 128) -> str:
    """Placement of one bucket: ``"batch"`` (split the batch axis) or
    ``"matrix"`` (split each cost matrix into blocks, core/sharded.py).
    Batch wins when there are enough instances to occupy the mesh
    (b >= devices) or the instances are too small for per-matrix traffic
    to pay off; matrix wins for a few large instances."""
    if n_devices <= 1 or b >= n_devices:
        return "batch"
    if min(m, n) >= matrix_min_size:
        return "matrix"
    return "batch"


def _require_pow2(d: int) -> None:
    if d & (d - 1):
        raise ValueError(
            f"batch-axis device count must be a power of two (got {d}); "
            "build the mesh with launch.mesh.make_batch_mesh")


def _matrix_mesh(mesh: Mesh) -> Tuple[Mesh, str, str]:
    """(mesh, row_axis, col_axis) for matrix placement: a 2-D mesh's
    leading axes, or a 1-D mesh folded into the squarest (r, c) grid
    (d = 2 -> (1, 2), 4 -> (2, 2), 8 -> (2, 4))."""
    if len(mesh.axis_names) >= 2:
        return mesh, mesh.axis_names[0], mesh.axis_names[1]
    devs = mesh.flat_devices
    d = len(devs)
    r = 1
    while r * 2 * r * 2 <= d:
        r *= 2
    return make_mesh((r, d // r), ("data", "model"), devs), "data", "model"


def _axis_devices(mesh: Mesh, axis: str) -> Tuple[torch.device, ...]:
    """The devices along ``axis`` (index 0 on every other axis)."""
    names = mesh.axis_names
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    out = []
    for a in range(mesh.shape[axis]):
        level = mesh.devices
        for name in names:
            level = level[a if name == axis else 0]
        out.append(level)
    return tuple(out)


def same_device(a, b) -> bool:
    """Whether two device specs name one device ("cuda" means the current
    card)."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device()
                                if torch.cuda.is_available() else 0)
        return d
    return norm(a) == norm(b)


def _synchronize(devices) -> None:
    """Wait for every stream of every distinct CUDA device in
    ``devices``."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class _Shards:
    """One worker thread per shard; each call runs with the shard's
    device current and its stream, and synchronizes that stream before
    it returns. ``share_streams``: shards on one device share one
    stream."""

    def __init__(self, devices, share_streams: bool):
        self.devices = tuple(devices)
        streams, by_dev = [], {}
        for d in self.devices:
            if d.type != "cuda":
                streams.append(None)
            elif share_streams:
                streams.append(by_dev.setdefault(d, torch.cuda.Stream(d)))
            else:
                streams.append(torch.cuda.Stream(d))
        self.streams = streams
        self.pool = ThreadPoolExecutor(max_workers=len(self.devices),
                                       thread_name_prefix="mesh-shard")

    def _run(self, i, fn, item):
        dev, st = self.devices[i], self.streams[i]
        if st is None:
            return fn(item)
        with torch.cuda.device(dev), torch.cuda.stream(st):
            out = fn(item)
            st.synchronize()
            return out

    def map(self, fn, items) -> list:
        """``fn`` on every shard's item, all in flight together; joins
        them all, then raises the first shard's error if any failed."""
        futs = [self.pool.submit(self._run, i, fn, it)
                for i, it in enumerate(items)]
        wait(futs)
        errors = [f.exception() for f in futs if f.exception() is not None]
        if errors:
            raise errors[0]
        return [f.result() for f in futs]

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def _split(tree, devices, bb: int):
    """Contiguous lane ranges of a ``bb``-lane tree, one per device."""
    per = bb // len(devices)
    return [tree_map(lambda a, lo=i * per, d=d: a[lo:lo + per].to(d), tree)
            for i, d in enumerate(devices)]


def _cat(parts, dev0):
    """The full-bucket state on ``dev0`` from its shards' states."""
    return type(parts[0])(*(torch.cat([p[f].to(dev0) for p in parts])
                            for f in range(len(parts[0]))))


def _shard_chunk(run_fn, conv_fn, part):
    """One shard's chunk: its new state and its stacked ((b,) converged,
    (b,) phases), which the driver gathers into its one read."""
    d, s = part
    s = run_fn(d, s)
    conv, ph = conv_fn(d, s)
    return s, torch.stack([conv.to(torch.int32), ph.to(torch.int32)])


def _drive_distributed(data, state, run_fn, conv_fn, max_chunks: int,
                       stats: DistributedStats, devices, *,
                       share_streams: bool = False,
                       deadline: Optional[float] = None, obs=None):
    """Mesh counterpart of ``compaction._drive``. ``data``/``state`` hold
    the full bucket on ``devices[0]``; each chunk runs
    ``run_fn(data, state)`` on every shard's lanes and ``conv_fn`` gives
    its ((b,) converged, (b,) phases). Returns the full-size state on
    ``devices[0]`` with every lane terminated (or cut), in original batch
    order."""
    d0 = len(devices)
    dev0 = devices[0]
    idx = np.arange(stats.dispatched_batch)
    buf = None
    cur_d, cur_s = data, state
    sharded = d0 > 1
    shards = _Shards(devices, share_streams) if sharded else None
    parts = None

    def chunk(part):
        return _shard_chunk(run_fn, conv_fn, part)

    def shard_out():
        # the driver's set-up of these lanes must be done before the
        # shards' streams read them
        out = list(zip(_split(cur_d, devices, len(idx)),
                       _split(cur_s, devices, len(idx))))
        _synchronize(devices)
        return out

    def full_state():
        return _cat([s for _, s in parts], dev0) if sharded else cur_s

    try:
        if sharded:
            parts = shard_out()
        ph_prev = np.zeros((stats.dispatched_batch,), np.int64)
        ph_last = np.zeros((stats.dispatched_batch,), np.int64)
        for _ in range(max_chunks):
            with _tracing.span("driver.chunk") as sp:
                t_chunk = _now()
                if sharded:
                    outs = shards.map(chunk, parts)
                    parts = [(d, s) for (d, _), (s, _) in zip(parts, outs)]
                    stacked = torch.cat([o.to(dev0) for _, o in outs], dim=1)
                else:
                    cur_s, stacked = chunk((cur_d, cur_s))
                stats.dispatches += 1
                both = host_numpy("chunk", stacked)
                conv, ph = both[0].astype(bool), both[1].astype(np.int64)
                t_chunk = _now() - t_chunk
                bb = int(conv.shape[0])
                d_now = d0 if sharded else 1
                stats.devices_per_dispatch.append(d_now)
                per_dev = (ph - ph_prev).reshape(d_now, bb // d_now)
                stats.slot_phases += int(
                    (per_dev.max(axis=1) * (bb // d_now)).sum())
                ph_prev = ph
                ph_last[idx] = ph
                live = int((~conv).sum())
                stats.occupancy.append((bb, live))
                dph = int(per_dev.max(initial=0))
                if sp is not None:
                    sp.attrs.update(bucket=bb, live=live, phases=dph,
                                    devices=d_now, k=stats.chunk)
                    _tracing.add("chunks")
                if obs is not None:
                    obs.event("chunk", bucket=bb, live=live,
                              chunk_s=t_chunk, phases=dph, devices=d_now)
                if live == 0:
                    buf = _flush(buf, full_state(), idx)
                    break
                if deadline is not None and _now() + t_chunk >= deadline:
                    stats.deadline_hit = True
                    un = np.zeros((stats.dispatched_batch,), bool)
                    un[idx[~conv]] = True
                    stats.unconverged = un
                    if obs is not None:
                        obs.event("deadline-cut", bucket=bb, live=live)
                    buf = _flush(buf, full_state(), idx)
                    break
                nb = pow2_at_least(live)
                if nb <= bb // 2:
                    cur_s = full_state()
                    buf = _flush(buf, cur_s, idx)
                    surv = np.flatnonzero(~conv)
                    fill = np.flatnonzero(conv)[:1]
                    sel = np.concatenate([surv, np.repeat(fill, nb - live)])
                    sel_t = torch.as_tensor(sel, device=dev0)
                    cur_d = _gather(cur_d, sel_t)
                    cur_s = _gather(cur_s, sel_t)
                    idx = idx[sel]
                    ph_prev = ph[sel]
                    if sharded and nb < d0:
                        # below the mesh floor: the survivors go on on the
                        # first device alone
                        sharded = False
                        stats.collapsed_at = nb
                        _synchronize(devices)
                    elif sharded:
                        parts = shard_out()
        else:
            buf = _flush(buf, full_state(), idx)
        record_phases(stats, ph_last)
    finally:
        if shards is not None:
            shards.close()
            # no buffer of a shard's stream is reused while the driver's
            # stream may still read it
            _synchronize(devices)
    return buf


def _resolve_mesh(mesh, batch_axis):
    if mesh is None:
        from ..launch.mesh import make_batch_mesh

        mesh = make_batch_mesh(axis=batch_axis)
    d = int(mesh.shape[batch_axis]) if batch_axis in mesh.axis_names else 0
    if d == 0:
        raise ValueError(f"mesh has no axis {batch_axis!r} "
                         f"(axes {mesh.axis_names})")
    _require_pow2(d)
    return mesh, d


def solve_mesh(spec, inputs, eps, mesh: Optional[Mesh] = None, *,
               sizes=None, k: Optional[int] = None,
               guaranteed: bool = False,
               batch_axis: str = "data", placement: str = "auto",
               keep_state: bool = False, deadline: Optional[float] = None,
               obs=None, device=None, **prep_kw):
    """Mesh-distributed counterpart of ``compaction.solve_compacting``:
    same contract (spec + batched input dict, scalar or (B,) eps), same
    per-instance results, with the batch axis split across ``mesh``
    (``launch.mesh.make_batch_mesh()`` when None). The mesh decides the
    devices: inputs move to its first device, where the result comes
    back; a ``device`` that is not that device raises.

    ``placement``: "auto" (``choose_placement``), "batch" or "matrix".
    ``keep_state`` keeps the pre-completion integer state on the stats
    (batch placement, or a spec whose result carries its state: OT);
    the assignment matrix path consumes its state, so the combination
    raises. ``deadline`` cuts the batch placement's chunk loop; matrix
    placement solves instance by instance with no chunk loop to cut and
    ignores it. ``obs`` gets the driver's per-chunk events (batch
    placement). ``k`` None: batch placement resolves it as the
    single-device driver does (``compaction.chunk_for``: a fused spec
    with no deadline runs each shard to termination in one launch), and
    matrix placement, which is stepped, takes ``DEFAULT_CHUNK``.
    Returns ``(result, DistributedStats)``."""
    if placement not in ("auto", "batch", "matrix"):
        raise ValueError(f"unknown placement {placement!r}; expected "
                         "'auto', 'batch' or 'matrix'")
    mesh, d = _resolve_mesh(mesh, batch_axis)
    devices = _axis_devices(mesh, batch_axis)
    dev0 = mesh.flat_devices[0]
    if device is not None and not same_device(device, dev0):
        raise ValueError(f"device={device!r} disagrees with the mesh, whose "
                         f"first device is {dev0}; the mesh decides where "
                         "a mesh dispatch runs")
    inputs = spec.canonicalize(inputs, dev0)
    b, m, n = spec.batch_shape(inputs)
    mode = (choose_placement(b, m, n, d) if placement == "auto"
            else placement)
    if mode == "matrix" and b > 0:
        if keep_state and not getattr(spec, "state_on_result", False):
            raise ValueError("keep_state=True requires batch placement "
                             "(pass placement='batch')")
        # stepped: no run-out
        return _solve_matrix(spec, inputs, eps, mesh, sizes, guaranteed,
                             chunk_for(spec, k, deadline)[0], batch_axis,
                             **prep_kw)
    if b == 0 or pow2_at_least(b) < d:
        # below the mesh floor from the start: single-device dispatch
        out, cst = solve_compacting(
            spec, inputs, eps, sizes=sizes, k=k, guaranteed=guaranteed,
            keep_state=keep_state, deadline=deadline, obs=obs, device=dev0,
            **prep_kw)
        return out, _wrap_stats(cst, d, batch_axis,
                                collapsed_at=cst.dispatched_batch or None)
    with _tracing.span("solve.prepare"):
        p = spec.prepare(inputs, eps, sizes=sizes, guaranteed=guaranteed,
                         min_batch=d, **prep_kw)
    with _tracing.span("solve.prologue"):
        data, ctx = spec.prologue(p.ops)
        ctx = {**ctx, **{kk: p.ops[kk] for kk in spec.ctx_ops}}
        state0 = spec.init_state(data, ctx)
    k, runout = chunk_for(spec, k, deadline, p.phase_cap)
    if runout:
        _tracing.add("runouts")
    stats = DistributedStats(batch=b, dispatched_batch=p.bp, chunk=k,
                             devices=d, batch_axis=batch_axis,
                             placement="batch")
    _, _, run_fn, conv_fn, _ = spec_fns(spec, k)
    _tracing.note("route", _route(spec))
    final = _drive_distributed(
        data, state0, run_fn, conv_fn,
        max_chunk_dispatches(p.phase_cap, k), stats, devices,
        share_streams=bool(getattr(spec, "fused", False)),
        deadline=deadline, obs=obs)
    with _tracing.span("solve.epilogue"):
        r = spec.epilogue(ctx, final)
        if keep_state:
            stats.final_state = tree_map(lambda a: a[:b], final)
        return spec.trim(r, b), stats


def _wrap_stats(cst: CompactionStats, devices: int, batch_axis: str,
                collapsed_at=None) -> DistributedStats:
    """A single-device CompactionStats as DistributedStats (the whole
    solve ran below the mesh floor)."""
    return DistributedStats(
        batch=cst.batch, dispatched_batch=cst.dispatched_batch,
        chunk=cst.chunk, dispatches=cst.dispatches,
        occupancy=cst.occupancy, slot_phases=cst.slot_phases,
        phases_needed=cst.phases_needed,
        lockstep_slot_phases=cst.lockstep_slot_phases,
        final_state=cst.final_state,
        deadline_hit=cst.deadline_hit, unconverged=cst.unconverged,
        devices=devices, batch_axis=batch_axis, placement="batch",
        collapsed_at=collapsed_at,
        devices_per_dispatch=[1] * cst.dispatches)


def _solve_matrix(spec, inputs, eps, mesh, sizes, guaranteed, k,
                  batch_axis, **prep_kw):
    """Matrix placement: each instance padded up to mesh-divisible dims
    and solved block-sharded (``core/sharded.py``) through
    ``spec.matrix_instance``; ``spec.matrix_stack`` reassembles the
    batched result on the mesh's first device."""
    b, m, n = spec.batch_shape(inputs)
    m_valid, n_valid = _sizes_arrays(sizes, b, m, n)
    eps_arr = eps_array(eps, b, guaranteed)
    mesh2, row_axis, col_axis = _matrix_mesh(mesh)
    _tracing.note("route", "stepped")   # the block-sharded stepped solver
    rdiv = int(mesh2.shape[row_axis])
    cdiv = int(mesh2.shape[col_axis])
    rows = []
    for i in range(b):
        mi, ni = int(m_valid[i]), int(n_valid[i])
        mp = -(-mi // rdiv) * rdiv
        np_ = -(-ni // cdiv) * cdiv
        rows.append(spec.matrix_instance(
            inputs, i, mi, ni, mp, np_, float(eps_arr[i]), mesh2,
            row_axis, col_axis, **prep_kw))
    out = spec.matrix_stack(rows, m_valid, n_valid, m, n)
    stats = DistributedStats(
        batch=b, dispatched_batch=b, chunk=k, devices=mesh2.size,
        batch_axis=batch_axis, placement="matrix", dispatches=b)
    record_phases(stats, host_numpy("epilogue", out.phases))
    return out, stats


def solve_assignment_distributed(c, eps, mesh: Optional[Mesh] = None, *,
                                 sizes=None, k: int = DEFAULT_CHUNK,
                                 guaranteed: bool = False,
                                 batch_axis: str = "data",
                                 placement: str = "auto",
                                 keep_state: bool = False):
    """Mesh-distributed counterpart of
    ``solve_assignment_batched_compacting``; binds ``ASSIGNMENT`` to
    :func:`solve_mesh`. Returns ``(BatchedAssignmentResult,
    DistributedStats)``."""
    return solve_mesh(ASSIGNMENT, {"c": c}, eps, mesh, sizes=sizes, k=k,
                      guaranteed=guaranteed, batch_axis=batch_axis,
                      placement=placement, keep_state=keep_state)


def solve_ot_distributed(c, nu, mu, eps, mesh: Optional[Mesh] = None, *,
                         sizes=None, theta=None, k: int = DEFAULT_CHUNK,
                         guaranteed: bool = False, batch_axis: str = "data",
                         placement: str = "auto"):
    """Mesh-distributed counterpart of ``solve_ot_batched_compacting``;
    binds ``OT`` to :func:`solve_mesh`. Returns ``(OTResult with leading
    batch axes, DistributedStats)``."""
    return solve_mesh(OT, {"c": c, "nu": nu, "mu": mu}, eps, mesh,
                      sizes=sizes, k=k, guaranteed=guaranteed,
                      batch_axis=batch_axis, placement=placement,
                      theta=theta)


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the mesh chunk dispatch (what
# `_drive_distributed` re-issues per bucket while sharded), recorded on a
# logical CPU mesh whose two devices are the one CPU.
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _trace_mesh_chunk(spec_name: str):
    from ..launch.mesh import make_small_mesh
    from .compaction import _tiny_batch

    devices = _axis_devices(make_small_mesh((2,), ("data",), devices="cpu"),
                            "data")
    chunk, conv, data, state = _tiny_batch(spec_name)
    bb = int(state.phases.shape[0])

    def mesh_chunk(data, state):
        # the shards run in the recording thread: a dispatch mode sees one
        # thread's ops, and _Shards' workers would escape it
        outs = [_shard_chunk(chunk, conv, part)
                for part in zip(_split(data, devices, bb),
                                _split(state, devices, bb))]
        return _cat([s for s, _ in outs], devices[0])

    return _audit.trace_entry(
        name=f"core.distributed.mesh_chunk[{spec_name}]",
        fn=mesh_chunk,
        args={"data": data, "state": state},
        donated={"state"},
        tags={"mesh-dispatch", spec_name},
        source=__name__,
    )


_audit.register("core.distributed.mesh_chunk[assignment]",
                lambda: _trace_mesh_chunk("assignment"), source=__name__)
_audit.register("core.distributed.mesh_chunk[ot]",
                lambda: _trace_mesh_chunk("ot"), source=__name__)
