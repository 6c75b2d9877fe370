"""Mesh builders: FUNCTIONS, so importing never touches device state.

Port of ``repro.launch.mesh``. The port's mesh is one process driving a
set of ``torch.device``s (``core/distributed.py`` runs each shard from a
worker thread of that process), not a ``torch.distributed`` process
group: every caller of ``solve()`` and of the serving layers stays a
plain library call. A :class:`Mesh` is a nested tuple of devices shaped
like the mesh plus its axis names.

Devices may repeat. D logical shards on one physical device run the
same schedule as D cards (each shard on its own stream), which is how
the CPU tests and a one-card machine reach D > 1 (``make_small_mesh``
with one device). ``models/sharding.py`` reads a mesh set with its
``set_mesh`` for the expert-parallel branch of the MoE layer.
``make_production_mesh`` builds the reference's 256- and 512-device
meshes for the dry-run (``launch/dryrun.py``), which plans a step on
them and runs nothing: by default its devices are ``meta``, so it needs
no card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch


def _nest(flat: Sequence[torch.device], shape: Tuple[int, ...]) -> tuple:
    if len(shape) == 1:
        return tuple(flat)
    step = len(flat) // shape[0]
    return tuple(_nest(flat[i * step:(i + 1) * step], shape[1:])
                 for i in range(shape[0]))


@dataclass(frozen=True)
class Mesh:
    """Devices laid out on named axes. ``devices`` is a nested tuple shaped
    like the mesh (``devices[i][j]`` on a 2-D mesh); ``axis_names`` names
    its axes in order. Hashable, so per-mesh work can be cached."""
    devices: tuple
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        shape, level = [], self.devices
        while isinstance(level, tuple):
            if not level:
                raise ValueError("a mesh needs at least one device")
            shape.append(len(level))
            level = level[0]
        if len(shape) != len(self.axis_names):
            raise ValueError(f"devices nested {len(shape)} deep for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        flat = self.flat_devices
        if len(flat) != math.prod(shape) or not all(
                isinstance(d, torch.device) for d in flat):
            raise ValueError("devices must be a regular nested tuple of "
                             "torch.device")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        out, level = {}, self.devices
        for name in self.axis_names:
            out[name] = len(level)
            level = level[0]
        return out

    @property
    def flat_devices(self) -> Tuple[torch.device, ...]:
        """The devices in row-major order (repeats kept)."""
        def walk(level):
            if isinstance(level, tuple):
                for x in level:
                    yield from walk(x)
            else:
                yield level
        return tuple(walk(self.devices))

    @property
    def size(self) -> int:
        return len(self.flat_devices)


def _as_devices(devices, n: int) -> Tuple[torch.device, ...]:
    """``n`` devices from one device (repeated: logical shards) or a
    sequence of ``n``."""
    if isinstance(devices, (str, torch.device)):
        return (_named(torch.device(devices)),) * n
    devs = tuple(_named(torch.device(d)) for d in devices)
    if len(devs) != n:
        raise ValueError(f"need {n} devices for the mesh, got {len(devs)}")
    return devs


def _named(dev: torch.device) -> torch.device:
    """A CUDA device with its index spelled out (a worker thread's
    current device must not decide where a shard runs)."""
    if dev.type == "cuda" and dev.index is None:
        from ..core.device import resolve_device

        resolve_device(dev)
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices) -> Mesh:
    """A mesh of ``shape`` over ``axes`` from ``devices`` (one device,
    repeated, or a sequence of ``prod(shape)``)."""
    shape = tuple(int(s) for s in shape)
    devs = _as_devices(devices, math.prod(shape))
    return Mesh(devices=_nest(devs, shape), axis_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices="meta"
                         ) -> Mesh:
    """The reference's production mesh: (16, 16) over ('data', 'model'),
    or (2, 16, 16) over ('pod', 'data', 'model') with ``multi_pod``.
    ``devices``: one device repeated (by default ``meta``: a plan's
    placeholder) or a sequence of 256 / 512."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), devices)
    return make_mesh((16, 16), ("data", "model"), devices)


def make_small_mesh(shape=(2, 4), axes=("data", "model"), devices=None
                    ) -> Mesh:
    """Test-scale mesh. ``devices``: one device (``"cpu"``, ``"cuda:0"``)
    repeated ``prod(shape)`` times, which gives logical shards; a sequence
    of ``prod(shape)`` devices; or None for the first ``prod(shape)``
    cards (raising when there are fewer)."""
    n = math.prod(shape)
    if devices is None:
        avail = _cuda_count()
        if avail < n:
            raise RuntimeError(
                f"need {n} CUDA devices for a {tuple(shape)} mesh, have "
                f"{avail}; pass devices= (one device gives {n} logical "
                f"shards on it)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return make_mesh(shape, axes, devices)


def largest_pow2_at_most(x: int) -> int:
    """Largest power of two <= max(x, 1)."""
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def _cuda_count() -> int:
    from ..core.device import resolve_device

    resolve_device("cuda")
    return torch.cuda.device_count()


def _pinned_cpu() -> bool:
    from ..core.device import resolve_device

    return resolve_device(None).type == "cpu"


def make_batch_mesh(n_devices: int | None = None, axis: str = "data"
                    ) -> Mesh:
    """1-D mesh for batch-axis sharding (``core/distributed.py``): the
    largest power-of-two prefix of the cards (at most ``n_devices``).
    The distributed driver keeps its buckets divisible by the device
    count, and its power-of-two bucket descent stays divisible only
    when that count is a power of two. Raises without CUDA, as the
    entry points do, unless ``launch.platform.set_platform("cpu")``
    pinned the CPU: then it is a one-device CPU mesh."""
    if _pinned_cpu():
        return make_mesh((1,), (axis,), "cpu")
    avail = _cuda_count()
    n = avail if n_devices is None else min(int(n_devices), avail)
    p = largest_pow2_at_most(n)
    return make_mesh((p,), (axis,),
                     [torch.device("cuda", i) for i in range(p)])
