"""``sinkhorn_row_update``: the log-domain Sinkhorn f-update, batched.

For every lane b and row i it computes

    f[b, i] = reg[b] * (log_nu[b, i] - LSE_j((g[b, j] - c[b, i, j]) / reg[b]))

reading each cost once and never materialising the (B, m, n) scaled
matrix: a running (max, sum) pair rides along the columns (online
logsumexp), as in the Pallas kernel it replaces
(``repro/kernels/sinkhorn_step.py``). ``reg`` is a (B,) tensor operand,
one value per lane, so every accuracy shares one kernel.

This module holds the plain PyTorch version, ``sinkhorn_row_ref``, used on
CPU tensors and as the oracle on the card. It walks the columns in tiles
of ``_TILE`` with the Pallas kernel's running (max, sum) update, its
``isfinite`` guard on the correction and a floor under the final sum. The
floor is ``_SUM_FLOOR = 1e-30``, a normal f32: the Pallas kernel's
``1e-38`` is subnormal and flushes to zero where the arithmetic flushes
subnormals. The CUDA kernel is ``csrc/sinkhorn_row.cu``; ``kernels/ops.py``
launches it.

No +inf appears in a lane: columns outside a lane's valid block hold cost
0 after the Sinkhorn spec's ``prepare`` masks them, and this version needs
no padding of its own.
"""
from __future__ import annotations

import torch

_TILE = 128
_SUM_FLOOR = 1e-30


def sinkhorn_row_ref(c, g, log_nu, reg):
    """``c`` (B, m, n) f32, ``g`` (B, n), ``log_nu`` (B, m), ``reg`` (B,)
    -> ``f`` (B, m) f32, by an online logsumexp over column tiles."""
    inv_reg = (1.0 / reg)[:, None, None]
    b, m, n = c.shape
    m_acc = torch.full((b, m), float("-inf"), dtype=torch.float32,
                       device=c.device)
    s_acc = torch.zeros((b, m), dtype=torch.float32, device=c.device)
    for j0 in range(0, n, _TILE):
        z = (g[:, None, j0:j0 + _TILE] - c[:, :, j0:j0 + _TILE]) * inv_reg
        m_new = torch.maximum(m_acc, z.amax(dim=2))
        # guard exp(-inf - -inf)
        corr = torch.where(torch.isfinite(m_acc), torch.exp(m_acc - m_new),
                           0.0)
        s_acc = s_acc * corr + torch.exp(z - m_new[:, :, None]).sum(dim=2)
        m_acc = m_new
    lse = m_acc + torch.log(s_acc.clamp_min(_SUM_FLOOR))
    return reg[:, None] * (log_nu - lse)
