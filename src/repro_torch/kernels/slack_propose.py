"""``slack_propose``: fused slack + admissibility + hash-keyed argmin.

The n^2 step of every propose round of both solvers. For each row i of
instance b, over the columns j that are admissible
(``y_b[i] + y_a[j] == c[i, j] + 1`` and ``avail[j]``), it picks the column
with the smallest uint32 key ``_mix(i*H1 + j*H2 + salt*H3)``.

It reproduces ``repro.core.matching._propose_dense`` exactly: the choice
is the FIRST minimum over all n masked keys, where a non-admissible column
holds 0xFFFFFFFF, and a row proposes iff it is active and has at least one
admissible column. (The Pallas adapter in ``repro/kernels/ops.py`` instead
decides "none" by ``key != 0xFFFFFFFF``; the two rules differ only when all
of a row's admissible keys hash to 0xFFFFFFFF, and the port follows the
main path's rule.)

This module holds the plain PyTorch version (``slack_propose_ref``, used on
CPU tensors and as the oracle on the card) and the hash. The CUDA kernel is
``csrc/slack_propose.cu``; ``kernels/ops.py`` launches it.

torch has no ``>>``, ``<``, ``min`` or ``argmin`` for uint32 on the CPU, so
the hash runs in int64 with every product reduced mod 2**32 (see
:func:`_mul32`). Returned keys are int64 holding the uint32 value.
"""
from __future__ import annotations

import torch

_H1 = 2654435761
_H2 = 2246822519
_H3 = 3266489917
_M32 = 0xFFFFFFFF
UMAX = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, split in 16-bit halves so no intermediate passes 2**49
    (int64 overflow would be undefined)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """The uint32 finalizer of ``repro.core.matching._mix``, on int64."""
    h = h ^ (h >> 15)
    h = _mul32(h, _H2)
    h = h ^ (h >> 13)
    h = _mul32(h, _H3)
    return h ^ (h >> 16)


def proposal_keys(m: int, n: int, salt) -> torch.Tensor:
    """Hash key per (row, col): ``salt.shape + (m, n)`` int64 in
    [0, 2**32). ``salt`` is an int tensor (any shape; () for one instance,
    (B,) per lane); negative salts wrap mod 2**32 as uint32 does."""
    salt = torch.as_tensor(salt)
    dev = salt.device
    rows = torch.arange(m, dtype=torch.int64, device=dev)
    cols = torch.arange(n, dtype=torch.int64, device=dev)
    s = _mul32(salt.to(torch.int64) & _M32, _H3)[..., None, None]
    h = (_mul32(rows, _H1)[:, None] + _mul32(cols, _H2)[None, :]) & _M32
    return _mix((h + s) & _M32)


def slack_propose_ref(c_int, y_b, y_a, avail_a, salt, active_b=None):
    """Plain version of the kernel on a (B, m, n) batch.

    Args: ``c_int`` (B, m, n) int32, ``y_b`` (B, m) int32, ``y_a`` (B, n)
    int32, ``avail_a`` (B, n) bool, ``salt`` (B,) int32, ``active_b``
    (B, m) bool or None (all rows active).

    Returns ``(col (B, m) int32, key (B, m) int64)``: ``col`` is the
    proposed column or -1; ``key`` is the row's minimum masked key
    (0xFFFFFFFF where the row has no admissible column or is inactive).
    """
    b, m, n = c_int.shape
    adm = ((y_b[:, :, None] + y_a[:, None, :] == c_int + 1)
           & avail_a[:, None, :])
    keys = torch.where(adm, proposal_keys(m, n, salt), UMAX)
    # first minimum over columns, exactly: pack (key, col) as key * n + col
    # (< 2**32 * n, no int64 overflow) and take the plain minimum
    cols = torch.arange(n, dtype=torch.int64, device=c_int.device)
    best = (keys * n + cols).amin(dim=2)
    prop = adm.any(dim=2)
    if active_b is not None:
        prop = prop & active_b
    col = torch.where(prop, best % n, -1).to(torch.int32)
    key = best // n
    if active_b is not None:
        key = torch.where(active_b, key, UMAX)
    return col, key
