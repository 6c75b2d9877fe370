"""Logical-axis sharding helpers.

Port of ``repro.models.sharding``. Logical axes: 'dp' (batch / FSDP
shard axis -> physical ('pod', 'data')), 'tp' (tensor/expert parallel ->
physical 'model'). Models only speak logical axes; this module resolves
them against the active mesh configuration, and every helper degrades to
a no-op when no mesh is configured (single-device use).

The mesh is the port's ``launch.mesh.Mesh``: one process driving a set
of devices, which may repeat (logical shards of one card), with no
``torch.distributed`` process group. ``PartitionSpec`` and
``NamedSharding`` are the port's own: a spec is a tuple of axis entries
(None, an axis name or a tuple of names) per dimension, and a sharding
says which block of a global tensor each mesh position holds.
``device_put`` places a tensor by a sharding as a ``ShardedTensor``.
There is no partitioner: the only parallel model code is the
expert-parallel branch of ``transformer.apply_moe``, which reads the
mesh from here, and ``constrain`` is the identity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh

_STATE = {"mesh": None, "dp": ("pod", "data"), "tp": "model"}


def set_mesh(mesh: Optional[Mesh], dp=None, tp=None) -> None:
    _STATE["mesh"] = mesh
    if mesh is not None:
        names = mesh.axis_names
        if dp is None:
            dp = tuple(n for n in names if n != "model")
        if tp is None:
            tp = "model" if "model" in names else None
        _STATE["dp"] = tuple(dp) if isinstance(dp, (list, tuple)) else (dp,)
        _STATE["tp"] = tp


def get_mesh() -> Optional[Mesh]:
    return _STATE["mesh"]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading dimension,
    None (replicated), an axis name, or a tuple of axis names (the
    dimension split over their product, the first axis major). Missing
    trailing entries are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


def _resolve(axis):
    if axis is None:
        return None
    if axis == "dp":
        dp = _STATE["dp"]
        return dp if len(dp) > 1 else dp[0]
    if axis == "tp":
        return _STATE["tp"]
    return axis


def pspec(*axes) -> P:
    return P(*[_resolve(a) for a in axes])


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` on logical axes. It
    changes no value there, and the port has no partitioner to hint, so
    this returns ``x`` with or without a mesh."""
    return x


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which block of a global tensor each mesh
    position holds. Positions are index tuples in the mesh's axis
    order."""
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        names = self.mesh.axis_names
        used = [a for e in self.spec for a in _entry_axes(e)]
        for a in used:
            if a not in names:
                raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                 f"not one of the mesh's {names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} uses an axis twice")

    def _dims(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than the rank "
                             f"{ndim} of the tensor")
        return [_entry_axes(self.spec[i]) if i < len(self.spec) else ()
                for i in range(ndim)]

    def num_blocks(self, ndim: int) -> Tuple[int, ...]:
        """Blocks along each dimension."""
        shape = self.mesh.shape
        return tuple(math.prod(shape[a] for a in axes)
                     for axes in self._dims(ndim))

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The shape of every block (``jax.sharding.NamedSharding``'s
        ``shard_shape``); raises when a dimension does not divide."""
        global_shape = tuple(int(s) for s in global_shape)
        out = []
        for size, n in zip(global_shape, self.num_blocks(len(global_shape))):
            if size % n:
                raise ValueError(f"dimension of size {size} does not "
                                 f"divide into {n} blocks (spec "
                                 f"{self.spec}, mesh {self.mesh.shape})")
            out.append(size // n)
        return tuple(out)

    def positions(self):
        """Every mesh position, row-major."""
        return list(np.ndindex(*self.mesh.shape.values()))

    def device_at(self, pos) -> torch.device:
        level = self.mesh.devices
        for i in pos:
            level = level[i]
        return level

    def block_index(self, pos, ndim: int) -> Tuple[int, ...]:
        """Which block along each dimension the position ``pos`` holds."""
        index = dict(zip(self.mesh.axis_names, pos))
        shape = self.mesh.shape
        out = []
        for axes in self._dims(ndim):
            k = 0
            for a in axes:
                k = k * shape[a] + index[a]
            out.append(k)
        return tuple(out)

    def block_slices(self, pos, global_shape) -> Tuple[slice, ...]:
        """The global index ranges of the block at ``pos``."""
        block = self.shard_shape(global_shape)
        idx = self.block_index(pos, len(block))
        return tuple(slice(i * b, (i + 1) * b) for i, b in zip(idx, block))


def _nest(flat, shape):
    if len(shape) == 1:
        return tuple(flat)
    step = len(flat) // shape[0]
    return tuple(_nest(flat[i * step:(i + 1) * step], shape[1:])
                 for i in range(shape[0]))


@dataclass(frozen=True)
class ShardedTensor:
    """A global tensor placed on a mesh: ``blocks`` nested like the mesh
    (``blocks[i][j]`` on a 2-D mesh), each on its position's device.
    The counterpart of a ``jax.Array`` with a ``NamedSharding``."""
    blocks: tuple
    sharding: NamedSharding
    shape: Tuple[int, ...]

    def block(self, pos) -> torch.Tensor:
        level = self.blocks
        for i in pos:
            level = level[i]
        return level

    @property
    def dtype(self) -> torch.dtype:
        return self.block((0,) * len(self.sharding.mesh.axis_names)).dtype

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (by default the first mesh
        position's), assembled from one block of each index."""
        sh = self.sharding
        dev = sh.device_at(sh.positions()[0]) if device is None \
            else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for pos in sh.positions():
            idx = sh.block_index(pos, len(self.shape))
            if idx in done:
                continue
            done.add(idx)
            out[sh.block_slices(pos, self.shape)] = self.block(pos).to(dev)
        return out


def device_put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``jax.device_put(x, sharding)``: the block of each mesh position
    on its device. A block whose device is ``x``'s device is a view of
    ``x`` (basic slicing), not a copy, so logical shards of one card
    share the source's storage; a block bound for another device is
    copied there (``Tensor.to``, which autograd carries back)."""
    shape = tuple(x.shape)
    flat = []
    for pos in sharding.positions():
        dev = sharding.device_at(pos)
        block = x[sharding.block_slices(pos, shape)]
        flat.append(block if dev == x.device else block.to(dev))
    return ShardedTensor(blocks=_nest(flat, tuple(sharding.mesh.shape
                                                   .values())),
                         sharding=sharding, shape=shape)


def named(*axes) -> Optional[NamedSharding]:
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return NamedSharding(mesh, pspec(*axes))


def expert_grid(mesh: Mesh, tp: str) -> Tuple[Tuple[tuple, ...], ...]:
    """``grid[i][t]``: the mesh position (an index tuple) that serves
    batch shard ``i`` (over the 'dp' axes present in ``mesh``, the first
    one major) and expert block ``t`` (along ``tp``): the first such
    position, where other axes replicate."""
    dp = [a for a in _STATE["dp"] if a in mesh.axis_names and a != tp]
    shape = mesh.shape
    sh = NamedSharding(mesh, P(tuple(dp) or None, tp))
    grid = [[None] * shape[tp] for _ in range(math.prod(shape[a]
                                                         for a in dp))]
    for pos in sh.positions():
        i, t = sh.block_index(pos, 2)
        if grid[i][t] is None:
            grid[i][t] = pos
    return tuple(tuple(row) for row in grid)


# --------------------------------------------------------------------------
# Parameter sharding rules (FSDP over 'dp' + tensor/expert parallel on 'tp')
# --------------------------------------------------------------------------

_RULES = {
    # (parent, name) or name -> logical axes for the *unstacked* leaf
    "embed": ("tp", "dp"),
    "lm_head": ("dp", "tp"),
    "final_norm": (None,),
    "wq": ("dp", "tp"), "wk": ("dp", "tp"), "wv": ("dp", "tp"),
    "wo": ("tp", "dp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "q_norm": (None,), "k_norm": (None,),
    "ln1": (None,), "ln2": (None,), "ln_x": (None,),
    "w_gate": ("dp", "tp"), "w_up": ("dp", "tp"), "w_down": ("tp", "dp"),
    ("moe", "router"): ("dp", None),
    ("moe", "w_gate"): ("tp", "dp", None),
    ("moe", "w_up"): ("tp", "dp", None),
    ("moe", "w_down"): ("tp", None, "dp"),
    "in_z": ("dp", "tp"), "in_x": ("dp", "tp"), "in_dt": ("dp", "tp"),
    "in_b": ("dp", None), "in_c": ("dp", None),
    "conv_x": (None, "tp"), "conv_b": (None, None), "conv_c": (None, None),
    "conv_bias_x": ("tp",), "conv_bias_b": (None,), "conv_bias_c": (None,),
    "a_log": ("tp",), "d_skip": ("tp",), "dt_bias": ("tp",),
    "norm_w": ("tp",), "out_proj": ("tp", "dp"),
}


def _leaf_rule(keys, leaf) -> P:
    """``keys``: the dict keys on the way to the leaf (list indices, the
    port's periods, are not keys, as the reference's stacked period axis
    is not)."""
    name = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) >= 2 else ""
    rule = _RULES.get((parent, name), _RULES.get(name))
    if rule is None:
        rule = (None,) * leaf.ndim
    pad = leaf.ndim - len(rule)
    rule = (None,) * pad + tuple(rule)
    return pspec(*rule)


def _map_with_keys(fn, tree, keys=()):
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, keys) for v in tree)
    return fn(keys, tree)


def param_pspecs(params):
    """PartitionSpec tree matching a (possibly abstract) param tree: the
    reference's spec of each leaf, less its leading None on a stage leaf
    (the port keeps one dict a period instead of a period axis)."""
    return _map_with_keys(_leaf_rule, params)


def param_shardings(params):
    mesh = _STATE["mesh"]
    assert mesh is not None
    return _map_with_keys(
        lambda k, leaf: NamedSharding(mesh, _leaf_rule(k, leaf)), params)
