"""The mesh: the compacting driver's runner for batch placement, and
matrix placement, generic over a ProblemSpec (``core/problem.py``).

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

Batch placement is the one compacting driver (``compaction._drive``,
through ``solve_compacting``: one read a chunk for the whole mesh, the
same retirement and deadline cut) with :class:`_MeshRunner` as its
runner. What the mesh adds is the reference's:

  * the dispatched batch starts at ``max(pow2(B), D)``, so the batch axis
    divides among the D shards; each re-bucketing splits it again;
  * when the next bucket would drop below the device count
    (``pow2(live) < D``), the survivors collapse onto the first device
    (``collapsed_at``) and the descent goes on there;
  * a batch below the mesh floor from the start runs on the first
    device alone;
  * ``slot_phases`` counts per-device lockstep slots (each shard runs its
    lanes for its local max phase delta);
  * ``obs`` gets one ``"chunk"`` event per dispatch carrying ``devices``.

Under batch placement per-lane results are bit-equal to the single-device
solve (lanes never interact; the hash keys depend only on the
within-instance (row, col, phase, round)). Under matrix placement each
instance solves at its own mesh-divisible padded shape: the integer state
is bit-equal, and the float epilogue may differ by reassociation.

The sanitizer (``repro_torch.analysis.checked``) applies to a bucket
that starts on one device, as in the reference: a sharded mesh solve
stays plain under ``REPRO_DEBUG_CHECKS=1``, and a solve below the mesh
floor is checked.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh, make_mesh
from ..obs import tracing as _tracing
from .compaction import (
    DEFAULT_CHUNK,
    CompactionStats,
    OneDevice,
    _chunk,
    chunk_for,
    record_phases,
    solve_compacting,
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


def _split(tree, devices, bb: int):
    """Contiguous lane ranges of a ``bb``-lane tree, one per device."""
    per = bb // len(devices)
    return [tree_map(lambda a, lo=i * per, d=d: a[lo:lo + per].to(d), tree)
            for i, d in enumerate(devices)]


def _cat(parts, dev0):
    """The full-bucket state on ``dev0`` from its shards' states."""
    return type(parts[0])(*(torch.cat([p[f].to(dev0) for p in parts])
                            for f in range(len(parts[0]))))


class _MeshRunner(OneDevice):
    """The mesh's runner of ``compaction._drive``: each chunk runs on
    every shard's contiguous lanes at once, and the driver reads their
    stacked results in one fetch on the first device. ``below``: the
    bucket starts under the mesh floor, so the whole solve runs on the
    first device; a retirement to fewer lanes than shards collapses onto
    it (``collapsed_at``). On one device it is :class:`OneDevice`."""

    def __init__(self, devices, *, below: bool, share_streams: bool,
                 batch_axis: str):
        self.devices = tuple(devices)
        self.shards = 1 if below else len(self.devices)
        self.below, self.share_streams = below, share_streams
        self.batch_axis = batch_axis
        self.pool = None

    def stats(self, **kw) -> DistributedStats:
        return DistributedStats(
            **kw, devices=len(self.devices), batch_axis=self.batch_axis,
            placement="batch",
            collapsed_at=(kw["dispatched_batch"] or None) if self.below
            else None)

    def load(self, data, state, run_fn, conv_fn, stats) -> None:
        super().load(data, state, run_fn, conv_fn, stats)
        self.driver_stats = stats
        if self.shards == 1:
            return
        streams, by_dev = [], {}
        for d in self.devices:
            if d.type != "cuda":
                streams.append(None)
            elif self.share_streams:
                streams.append(by_dev.setdefault(d, torch.cuda.Stream(d)))
            else:
                streams.append(torch.cuda.Stream(d))
        self.streams = streams
        self.pool = ThreadPoolExecutor(max_workers=len(self.devices),
                                       thread_name_prefix="mesh-shard")
        self._shard_out()

    def _shard_out(self) -> None:
        bb = len(self.full[0])
        self.parts = list(zip(_split(self.data, self.devices, bb),
                              _split(self.full, self.devices, bb)))
        # the driver's set-up of these lanes must be done before the
        # shards' streams read them
        _synchronize(self.devices)

    def _shard_chunk(self, i: int):
        """Shard ``i``'s chunk, with its device current and its stream,
        which it synchronizes before it returns."""
        (data, state), st = self.parts[i], self.streams[i]
        if st is None:
            return _chunk(self.run_fn, self.conv_fn, data, state)
        with torch.cuda.device(self.devices[i]), torch.cuda.stream(st):
            out = _chunk(self.run_fn, self.conv_fn, data, state)
            st.synchronize()
            return out

    def run(self) -> torch.Tensor:
        self.driver_stats.devices_per_dispatch.append(self.shards)
        if self.shards == 1:
            return super().run()
        # every shard in flight together; all are joined before the first
        # shard's error, if any, is raised
        futs = [self.pool.submit(self._shard_chunk, i)
                for i in range(self.shards)]
        wait(futs)
        errors = [f.exception() for f in futs if f.exception() is not None]
        if errors:
            raise errors[0]
        outs = [f.result() for f in futs]
        self.parts = [(d, s) for (d, _), (s, _) in zip(self.parts, outs)]
        return torch.cat([o.to(self.devices[0]) for _, o in outs], dim=1)

    def state(self):
        if self.shards > 1:
            self.full = _cat([s for _, s in self.parts], self.devices[0])
        return self.full

    def retire(self, sel: np.ndarray) -> None:
        super().retire(sel)
        if self.shards == 1:
            return
        if len(sel) < self.shards:
            # below the mesh floor: the survivors go on on the first
            # device alone
            self.shards = 1
            self.driver_stats.collapsed_at = len(sel)
            _synchronize(self.devices)
        else:
            self._shard_out()

    def fields(self) -> dict:
        return {"devices": self.shards}

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True)
            # no buffer of a shard's stream is reused while the driver's
            # stream may still read it
            _synchronize(self.devices)


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
    """A bucket solved over ``mesh`` (``launch.mesh.make_batch_mesh()``
    when None): the contract of ``compaction.solve_compacting`` (spec +
    batched input dict, scalar or (B,) eps) and its per-instance
    results. Batch placement IS ``solve_compacting``, given the mesh's
    runner (:class:`_MeshRunner`), which splits the batch axis over the
    mesh's devices. The mesh decides the devices: inputs move to its
    first device, where the result comes back; a ``device`` that is not
    that device raises.

    ``placement``: "auto" (``choose_placement``), "batch" or "matrix".
    ``keep_state`` keeps the pre-completion integer state on the stats
    (batch placement, or a spec whose result carries its state: OT);
    the assignment matrix path consumes its state, so the combination
    raises. ``deadline`` cuts the batch placement's chunk loop; matrix
    placement solves instance by instance with no chunk loop to cut and
    ignores it. ``obs`` gets the driver's per-chunk events (batch
    placement). ``k`` None: batch placement resolves it as every solve
    of the driver does (``compaction.chunk_for``: a fused spec with no
    deadline runs each shard to termination in one launch), and matrix
    placement, which is stepped, takes ``DEFAULT_CHUNK``.
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
    # below the mesh floor from the start: the first device alone
    below = pow2_at_least(b) < d
    runner = _MeshRunner(devices, below=below,
                         share_streams=bool(getattr(spec, "fused", False)),
                         batch_axis=batch_axis)
    return solve_compacting(
        spec, inputs, eps, sizes=sizes, k=k, guaranteed=guaranteed,
        keep_state=keep_state, deadline=deadline, obs=obs, device=dev0,
        runner=runner, min_batch=1 if below else d, **prep_kw)


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
# repro_torch.analysis registration: the mesh chunk dispatch (what the
# mesh runner re-issues per bucket while sharded), recorded on a logical
# CPU mesh whose two devices are the one CPU.
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
        # thread's ops, and the runner's workers would escape it
        outs = [_chunk(chunk, conv, *part)
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
