"""Shape buckets for ragged batches, and the lockstep fixed-shape solve.

Port of ``repro.core.batched``. Ragged input is padded up to shape buckets
(next table size; shapes beyond the table mint a ceil-pow2 bucket); padded
rows get zero mass or leave the free set, padded columns get zero capacity
(OT) or ``PAD_COST`` (assignment), so a padded instance walks the same
admissible subgraph with the same hash keys as its unpadded original.

The lockstep solve is the compacting driver asked for its run-out
(``compaction.solve_compacting(..., lockstep=True)``): every lane of one
bucket runs until it has terminated, in a single chunk of k = max phase
cap + 1 phases; per lane the trajectory is the unbatched solver's.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .compaction import solve_compacting
from .problem import ASSIGNMENT, OT, pow2_at_least

DEFAULT_BUCKETS: tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048)


def next_bucket(k: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= k; beyond the table, a ceil-power-of-two."""
    for b in buckets:
        if b >= k:
            return b
    return pow2_at_least(int(k))


class _Bucketed(NamedTuple):
    key: tuple            # bucket shape key (M, N)
    indices: list         # original instance positions
    sizes: np.ndarray     # (Bg, 2)


def bucket_instances(shapes, buckets: Sequence[int] = DEFAULT_BUCKETS):
    """Group instance shapes [(m_i, n_i)] into shape buckets, sorted by
    key; every instance lands in exactly one group."""
    groups: dict = {}
    for i, (mi, ni) in enumerate(shapes):
        key = (next_bucket(int(mi), buckets), next_bucket(int(ni), buckets))
        groups.setdefault(key, []).append(i)
    out = []
    for key, idx in sorted(groups.items()):
        sizes = np.asarray([shapes[i] for i in idx], np.int32)
        out.append(_Bucketed(key=key, indices=idx, sizes=sizes))
    return out


def pad_stack(arrays, shape) -> torch.Tensor:
    """Zero-pad each array up to ``shape`` and stack on a new batch axis,
    float32. Tensors stay on their device (the first one's); arrays
    become CPU tensors, which the specs move to the solve's device."""
    out = []
    for a in arrays:
        t = (a if isinstance(a, torch.Tensor)
             else torch.as_tensor(np.asarray(a, np.float32)))
        t = t.to(dtype=torch.float32,
                 device=out[0].device if out else t.device)
        pad = []
        for s, d in reversed(list(zip(shape, t.shape))):
            pad += [0, s - d]
        out.append(F.pad(t, pad))
    return torch.stack(out)


def take_lanes(t: torch.Tensor, idx) -> torch.Tensor:
    """The lanes ``idx`` (host indices) of a batched tensor, on its
    device."""
    return t.index_select(0, torch.as_tensor(idx, device=t.device))


def solve_assignment_batched(c, eps: float, *, sizes=None,
                             guaranteed: bool = False,
                             keep_state: bool = False, device=None):
    """B assignment instances stacked as one (B, M, N) cost tensor,
    lockstep on ``device`` (None: CUDA). ``sizes`` (B, 2) gives the true
    shapes. Returns the result, or ``(result, state)`` with
    ``keep_state``."""
    r, st = solve_compacting(ASSIGNMENT, {"c": c}, eps, sizes=sizes,
                             guaranteed=guaranteed, keep_state=keep_state,
                             device=device, lockstep=True)
    return (r, st.final_state) if keep_state else r


def solve_ot_batched(c, nu, mu, eps: float, *, sizes=None, theta=None,
                     guaranteed: bool = False, device=None):
    """B OT instances stacked as (B, M, N) costs and (B, M) / (B, N)
    masses, lockstep on ``device`` (None: CUDA). Returns an OTResult with
    leading batch axes."""
    return solve_compacting(OT, {"c": c, "nu": nu, "mu": mu}, eps,
                            sizes=sizes, guaranteed=guaranteed, theta=theta,
                            device=device, lockstep=True)[0]


def _ragged_policy(compact: bool, chunk, mesh, buckets, guaranteed: bool):
    """Map the legacy ragged keyword surface onto a DispatchPolicy."""
    from .api import DispatchPolicy

    return DispatchPolicy.from_legacy(compact, mesh, chunk=chunk,
                                      buckets=buckets,
                                      guaranteed=guaranteed)


def solve_ot_ragged(instances, eps, *,
                    buckets: Sequence[int] = DEFAULT_BUCKETS,
                    guaranteed: bool = False, compact: bool = True,
                    chunk: int | None = None, mesh=None, device=None):
    """Solve a ragged list of ``(c, nu, mu)`` OT instances by bucketed
    batched dispatch on ``device`` (None: CUDA). Returns per-instance
    dicts in input order. ``compact=True`` (default) runs each bucket on
    the compacting driver (``eps`` may then be per instance);
    ``compact=False`` runs lockstep, sub-grouped by eps. ``mesh`` (a
    ``launch.mesh.Mesh``, with ``compact=True``) runs every bucket on the
    compacting driver over the mesh, whose first device then replaces
    ``device``. A thin wrapper over ``core/api.solve(OT, ...)``."""
    from .api import solve

    return solve(OT, instances, eps,
                 _ragged_policy(compact, chunk, mesh, buckets, guaranteed),
                 device=device)


def solve_assignment_ragged(cs, eps, *,
                            buckets: Sequence[int] = DEFAULT_BUCKETS,
                            guaranteed: bool = False, compact: bool = True,
                            chunk: int | None = None, mesh=None,
                            device=None):
    """Solve a ragged list of assignment cost matrices by bucketed batched
    dispatch on ``device`` (None: CUDA); per-instance dicts in input
    order. ``compact`` and ``mesh`` as in :func:`solve_ot_ragged`."""
    from .api import solve

    return solve(ASSIGNMENT, cs, eps,
                 _ragged_policy(compact, chunk, mesh, buckets, guaranteed),
                 device=device)
