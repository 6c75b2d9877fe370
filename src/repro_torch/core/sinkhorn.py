"""Log-domain Sinkhorn baseline (Cuturi 2013 / Altschuler et al. 2017).

Port of ``repro.core.sinkhorn``. The paper benchmarks against POT's
Sinkhorn. ``sinkhorn`` runs the numerically stabilized log-domain variant;
to target an additive error of ~eps on costs scaled to [0, 1], use reg =
eps / (4 log n) (``reg_for_additive_eps``) and iterate until the marginal
violation is below ``sinkhorn_marginal_tolerance(eps)``. The plain
kernel-matrix variant (``use_log=False``) is what POT runs by default and
shows the small-eps underflow the paper points out.

One instance, on the CUDA device unless ``device="cpu"`` is passed. The
loop updates the iterate only while ``err > tol`` and reads that flag
from the device once every ``_CHECK_EVERY`` iterations, so it stops at
the same iteration as a loop that reads it every time.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .device import as_f32, host_flags, resolve_device

# iterations between two reads of the "still running" flag (also the
# Sinkhorn spec's): a read after every iteration leaves the card idle while
# the host waits
_CHECK_EVERY = 8
# the reference's floor under the masses and the kernel-matrix sums
_FLOOR = 1e-38


class SinkhornResult(NamedTuple):
    plan: torch.Tensor
    cost: torch.Tensor
    f: torch.Tensor          # row potentials (log-domain)
    g: torch.Tensor          # column potentials
    iters: torch.Tensor
    marginal_err: torch.Tensor


def sinkhorn(c, nu, mu, reg: float, max_iters: int = 10_000,
             tol=1e-9, use_log: bool = True, *,
             device=None) -> SinkhornResult:
    """Entropy-regularized OT of one instance: rows = nu (supply), cols =
    mu (demand). ``tol`` is a runtime operand (a float or a 0-d tensor):
    derive it on the host with ``sinkhorn_marginal_tolerance``."""
    dev = resolve_device(device)
    c, nu, mu = as_f32(c, dev), as_f32(nu, dev), as_f32(mu, dev)
    tol = torch.as_tensor(tol, dtype=torch.float32, device=dev)
    log_nu = torch.log(nu.clamp_min(_FLOOR))
    log_mu = torch.log(mu.clamp_min(_FLOOR))
    m, n = c.shape

    if use_log:
        def step(f, g):
            # row update: f_i = reg*(log nu_i - lse_j((g_j - c_ij)/reg))
            f = reg * (log_nu - torch.logsumexp((g[None, :] - c) / reg,
                                                dim=1))
            g = reg * (log_mu - torch.logsumexp((f[:, None] - c) / reg,
                                                dim=0))
            row = torch.exp((f[:, None] + g[None, :] - c) / reg).sum(dim=1)
            return f, g, (row - nu).abs().sum()

        a = torch.zeros((m,), dtype=torch.float32, device=dev)
        b = torch.zeros((n,), dtype=torch.float32, device=dev)
    else:
        # POT-style kernel-matrix iteration (fast but underflows at small
        # reg)
        k = torch.exp(-c / reg)

        def step(u, v):
            u = nu / (k @ v).clamp_min(_FLOOR)
            v = mu / (k.T @ u).clamp_min(_FLOOR)
            row = u * (k @ v)
            return u, v, (row - nu).abs().sum()

        a = torch.ones((m,), dtype=torch.float32, device=dev)
        b = torch.ones((n,), dtype=torch.float32, device=dev)

    it = torch.zeros((), dtype=torch.int32, device=dev)
    err = torch.tensor(float("inf"), device=dev)
    for i in range(max_iters):
        run = err > tol
        if (i and i % _CHECK_EVERY == 0
                and not host_flags("sinkhorn", run)[0]):
            break
        a_new, b_new, err_new = step(a, b)
        a = torch.where(run, a_new, a)
        b = torch.where(run, b_new, b)
        err = torch.where(run, err_new, err)
        it = it + run.to(torch.int32)

    if use_log:
        f, g = a, b
        plan = torch.exp((f[:, None] + g[None, :] - c) / reg)
    else:
        plan = a[:, None] * k * b[None, :]
        f = reg * torch.log(a.clamp_min(_FLOOR))
        g = reg * torch.log(b.clamp_min(_FLOOR))
    cost = (plan * c).sum()
    return SinkhornResult(plan=plan, cost=cost, f=f, g=g, iters=it,
                          marginal_err=err)


def reg_for_additive_eps(eps: float, n: int) -> float:
    """Altschuler-et-al. style regularization for additive error
    ~eps*max(c)."""
    return max(eps / (4.0 * math.log(max(n, 2))), 1e-6)


def sinkhorn_marginal_tolerance(eps, mass: float = 1.0) -> float:
    """Host-float64 L1 marginal-violation threshold for an additive-eps
    target: eps/8 * total mass (the AWR stopping rule), handed to
    ``sinkhorn`` as its runtime ``tol`` operand."""
    return float(np.float64(eps) / 8.0 * np.float64(mass))


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the baseline solver. Its stopping
# tolerance must arrive as a tensor (derived on the host in float64 by
# sinkhorn_marginal_tolerance): a Python float would be rounded through
# the f32 comparison in the arithmetic's dtype instead.
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _trace_sinkhorn():
    n = 8

    def run(c, nu, mu, tol):
        r = sinkhorn(c, nu, mu, reg=0.05, max_iters=16, tol=tol,
                     device="cpu")
        return {"plan": r.plan, "cost": r.cost, "f": r.f, "g": r.g,
                "iters": r.iters, "marginal_err": r.marginal_err}

    return _audit.trace_entry(
        name="core.sinkhorn.sinkhorn",
        fn=run,
        args={
            "c": torch.zeros((n, n), dtype=torch.float32),
            "nu": torch.full((n,), 1.0 / n, dtype=torch.float32),
            "mu": torch.full((n,), 1.0 / n, dtype=torch.float32),
            "tol": torch.tensor(1e-6, dtype=torch.float32),
        },
        must_trace={"tol"},
        tags={"sinkhorn", "baseline"},
        source=__name__,
    )


_audit.register("core.sinkhorn.sinkhorn", _trace_sinkhorn, source=__name__)
