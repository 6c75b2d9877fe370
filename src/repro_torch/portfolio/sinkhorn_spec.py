"""SINKHORN: the log-domain Sinkhorn loop as a third ProblemSpec.

Port of ``repro.portfolio.sinkhorn_spec``. The paper compares the
push-relabel solver against Sinkhorn; this module makes that comparison a
per-request dispatch choice by wrapping Sinkhorn in the stepped-core
contract of ``core/problem.py``, so the compacting driver runs it
unchanged, lockstep (its run-out) included.

The additive-eps contract comes from Altschuler-Weed-Rigollet
(arXiv:1705.09634): with reg = eps/(4 log n) and the iterates stopped at
L1 marginal violation eps/8, rounding the entropic plan onto the
transport polytope (their Algorithm 2) gives cost <= OPT + eps * scale.
reg, tol and the AWR iteration cap 2 + 128 (log n)^2 / eps^2 are derived
on the host in float64 per lane, then shipped as f32 operands.

Mapping to the protocol (every function takes the batch axis directly):

  ``prepare``      host-f64 per-lane reg/tol/iteration cap, padding masks,
                   power-of-two batch padding (padded lanes get cap 0:
                   born converged).
  ``prologue``     c_hat = c/max(c), masses normalized to 1, log marginals
                   floor-clamped.
  ``init_state``   f = g = 0, err = +inf.
  ``run_phases``   at most k Sinkhorn iterations on the lanes still
                   running (f-update, g-update, then the row-marginal L1
                   violation); chaining calls equals one call for any k.
  ``converged``    err <= tol, or the AWR cap hit.
  ``epilogue``     AWR Algorithm 2 rounding, pricing against the float
                   costs, duals y = f*scale / g*scale.

``SINKHORN_KERNEL`` runs every f-update through the CUDA row kernel
(``ops.sinkhorn_row_update``, ``csrc/sinkhorn_row.cu``); it is the spec
``fused_variant`` resolves for ``DispatchPolicy(fused=True)``, and
``stepped`` points back at ``SINKHORN``. The g-update, the error and the
epilogue are PyTorch ops on both, as they are plain jnp in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import host_flags
from ..core.problem import (
    OTSpec,
    PreparedBatch,
    _pad_lanes,
    _sizes_arrays,
    eps_array,
    pow2_at_least,
)
from ..core.sinkhorn import _CHECK_EVERY
from ..core.transport import northwest_corner
from ..kernels import ops

# Sinkhorn state floor: normalized masses are clamped here before the
# log, so empty (padded) marginals stay finite and inert. A NORMAL f32
# (min normal ~1.18e-38): a subnormal floor flushes to zero where the
# arithmetic flushes subnormals, turning the clamp into log(0) = -inf.
_LOG_FLOOR = 1e-30
# reg floor: below this the f32 exp/log arithmetic is pure noise anyway.
_REG_FLOOR = 1e-6

# batched f-updates made by run_sinkhorn_phases since the last reset: one
# per loop iteration, whichever lanes it updated (chip_smoke.py holds the
# row kernel's launches on the fused route to this count)
counts = {"f_updates": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


class SinkhornState(NamedTuple):
    """Batched Sinkhorn iterate. ``phases`` counts full (f, g) sweeps, the
    field the compaction driver reads."""
    f: torch.Tensor       # (B, m) f32 row potentials, normalized domain
    g: torch.Tensor       # (B, n) f32 column potentials
    err: torch.Tensor     # (B,) f32 L1 row-marginal violation
    phases: torch.Tensor  # (B,) int32 iterations done


class SinkhornOTResult(NamedTuple):
    """Epilogue output; mirrors OTResult's artifacts (no theta) plus the
    schedule (reg, final marginal err)."""
    plan: torch.Tensor    # (B, m, n) f32, marginals (nu, mu) up to f32
    cost: torch.Tensor    # (B,) f32 <plan, c>
    y_b: torch.Tensor     # (B, m) f32 feasible duals (f * scale)
    y_a: torch.Tensor     # (B, n) f32 feasible duals (g * scale)
    phases: torch.Tensor  # (B,) int32
    rounds: torch.Tensor  # (B,) int32 == phases (one sweep per phase)
    err: torch.Tensor     # (B,) f32 marginal violation at termination
    reg: torch.Tensor     # (B,) f32 entropic regularization used


def sinkhorn_schedule(eps_arr, m_valid, n_valid, max_iters=None):
    """Host-float64 AWR schedule per lane: (reg, tol, cap).

    reg = eps/(4 log n) and tol = eps/8 make the rounded entropic plan
    eps-additive (AWR Thm 1 + Alg. 2); cap = 2 + 128 (log n)^2 / eps^2 is
    their iteration bound at that (reg, tol). Computed in float64 on the
    host and only then cast for the device."""
    eps_arr = np.asarray(eps_arr, np.float64)
    logn = np.log(np.maximum(np.maximum(m_valid, n_valid), 2)
                  .astype(np.float64))
    reg = np.maximum(eps_arr / (4.0 * logn), _REG_FLOOR)
    tol = eps_arr / 8.0
    cap = 2.0 + np.ceil(128.0 * logn ** 2 / eps_arr ** 2)
    if max_iters is not None:
        cap = np.minimum(cap, float(int(max_iters)))
    cap = np.minimum(cap, np.float64(np.iinfo(np.int32).max))
    return reg, tol, cap.astype(np.int32)


def _row_update_torch(c_hat, g, log_nu, reg):
    """The stepped spec's f-update (the reference's ``_row_update_jnp``):
    ``reg * (log_nu - logsumexp((g - c_hat) / reg))`` over the columns."""
    return reg[:, None] * (log_nu - torch.logsumexp(
        (g[:, None, :] - c_hat) / reg[:, None, None], dim=2))


def run_sinkhorn_phases(c_hat, log_nu, log_mu, nu_hat, reg, tol, phase_cap,
                        state: SinkhornState, k: int,
                        kernel: bool = False) -> SinkhornState:
    """At most k Sinkhorn iterations per lane from ``state``. Each is one
    f-update, one g-update, then the L1 row-marginal violation measured
    after the g-update (where the column marginals are exact by
    construction). A lane runs while ``err > tol`` and ``phases <
    phase_cap``; the others keep their state, so chaining calls equals
    one call for any k. The loop ends after k iterations, or at the first
    check (every ``_CHECK_EVERY`` iterations, one host read) that finds no
    lane running: a k above the AWR cap, as lockstep passes, never runs
    k iterations blindly. ``kernel=True`` runs the f-update through
    ``ops.sinkhorn_row_update`` (the CUDA kernel on a CUDA tensor)."""
    f, g, err, phases = state
    r3 = reg[:, None, None]
    for it in range(k):
        run = (err > tol) & (phases < phase_cap)
        if (it and it % _CHECK_EVERY == 0
                and not host_flags("sinkhorn", run.any())[0]):
            break
        if kernel:
            f = ops.sinkhorn_row_update(c_hat, g, log_nu, reg, active_b=run,
                                        f=f)
        else:
            f = torch.where(run[:, None],
                            _row_update_torch(c_hat, g, log_nu, reg), f)
        counts["f_updates"] += 1
        g_new = reg[:, None] * (log_mu - torch.logsumexp(
            (f[:, :, None] - c_hat) / r3, dim=1))
        row = torch.exp((f[:, :, None] + g_new[:, None, :] - c_hat)
                        / r3).sum(dim=2)
        err_new = (row - nu_hat).abs().sum(dim=1)
        g = torch.where(run[:, None], g_new, g)
        err = torch.where(run, err_new, err)
        phases = phases + run.to(torch.int32)
    return SinkhornState(f=f, g=g, err=err, phases=phases)


def sinkhorn_epilogue(c, nu, mu, reg, scale, mass_nu,
                      state: SinkhornState) -> SinkhornOTResult:
    """AWR Algorithm 2 over a batch: round the entropic plan onto the
    transport polytope of (nu, mu), then price. Row and column marginals
    are scaled DOWN to never exceed their targets, then the leftover mass
    (<= the tol violation) is filled with a northwest-corner plan of the
    residuals, as ``ot_epilogue`` completes its plans."""
    c_hat = c / scale[:, None, None]
    plan = torch.exp((state.f[:, :, None] + state.g[:, None, :] - c_hat)
                     / reg[:, None, None])
    plan = plan * mass_nu[:, None, None]  # normalized rows -> mass units
    rs = torch.clamp_max(nu / plan.sum(dim=2).clamp_min(_LOG_FLOOR), 1.0)
    plan = plan * rs[:, :, None]
    cs = torch.clamp_max(mu / plan.sum(dim=1).clamp_min(_LOG_FLOOR), 1.0)
    plan = plan * cs[:, None, :]
    r = (nu - plan.sum(dim=2)).clamp_min(0.0)
    cc = (mu - plan.sum(dim=1)).clamp_min(0.0)
    sr, sc = r.sum(dim=1), cc.sum(dim=1)
    tot = torch.minimum(sr, sc)
    r = r * (tot / sr.clamp_min(_LOG_FLOOR))[:, None]
    cc = cc * (tot / sc.clamp_min(_LOG_FLOOR))[:, None]
    plan = plan + northwest_corner(r, cc)
    cost = (plan * c).sum(dim=(1, 2))
    return SinkhornOTResult(
        plan=plan, cost=cost,
        y_b=state.f * scale[:, None], y_a=state.g * scale[:, None],
        phases=state.phases, rounds=state.phases, err=state.err, reg=reg)


class SinkhornSpec(OTSpec):
    """ProblemSpec for log-domain Sinkhorn over the same (c, nu, mu)
    inputs as ``OT``. Subclasses OTSpec for the input-shaping glue
    (canonicalize, pad_group, plan artifacts); every algorithmic method
    is overridden. Batch placement only: the iteration is a
    whole-instance program, so mesh matrix placement raises."""

    name = "sinkhorn"
    fused = False

    def prepare(self, inputs, eps, *, sizes=None, guaranteed: bool = False,
                min_batch: int = 1, max_iters=None) -> PreparedBatch:
        c, nu, mu = inputs["c"], inputs["nu"], inputs["mu"]
        b, m, n = c.shape
        dev = c.device
        m_valid, n_valid = _sizes_arrays(sizes, b, m, n)
        eps_arr = eps_array(eps, b, guaranteed)
        reg, tol, cap = sinkhorn_schedule(eps_arr, m_valid, n_valid,
                                          max_iters)
        # zero mass/cost outside each instance's valid block (inert: the
        # clamped log marginals make padded rows/cols carry ~0 plan mass)
        rok = torch.as_tensor(np.arange(m)[None, :] < m_valid[:, None],
                              device=dev)
        cok = torch.as_tensor(np.arange(n)[None, :] < n_valid[:, None],
                              device=dev)
        c = torch.where(rok[:, :, None] & cok[:, None, :], c, 0.0)
        nu = torch.where(rok, nu, 0.0)
        mu = torch.where(cok, mu, 0.0)
        bp = max(pow2_at_least(b), pow2_at_least(min_batch))
        # padded lanes: cap 0 -> born converged; reg/tol pads stay
        # nonzero so the prologue/phase divisions remain finite
        ops_ = _pad_lanes(bp, b, {
            "c": c, "nu": nu, "mu": mu,
            "reg": reg.astype(np.float32), "tol": tol.astype(np.float32),
            "phase_cap": cap,
        }, dev, fills={"reg": float(np.float32(reg[0])),
                       "tol": float(np.float32(tol[0]))})
        return PreparedBatch(
            ops=ops_, threshold=np.zeros((bp,), np.int32),
            phase_cap=np.concatenate([cap, np.zeros(bp - b, np.int32)]),
            bp=bp)

    # epilogue operands taken verbatim from ops
    ctx_ops = ("c", "nu", "mu", "reg")

    def prologue(self, ops_):
        c, nu, mu = ops_["c"], ops_["nu"], ops_["mu"]
        scale = c.amax(dim=(1, 2)).clamp_min(1e-30)  # == ot_prologue's
        mass_nu = nu.sum(dim=1).clamp_min(_LOG_FLOOR)
        mass_mu = mu.sum(dim=1).clamp_min(_LOG_FLOOR)
        nu_hat = nu / mass_nu[:, None]
        data = {
            "c_hat": c / scale[:, None, None],
            "log_nu": torch.log(nu_hat.clamp_min(_LOG_FLOOR)),
            "log_mu": torch.log((mu / mass_mu[:, None])
                                .clamp_min(_LOG_FLOOR)),
            "nu_hat": nu_hat,
            "reg": ops_["reg"], "tol": ops_["tol"],
            "phase_cap": ops_["phase_cap"],
        }
        ctx = {"scale": scale, "mass_nu": mass_nu}
        return data, ctx

    def init_state(self, data, ctx) -> SinkhornState:
        b, m, n = data["c_hat"].shape
        dev = data["c_hat"].device
        return SinkhornState(
            f=torch.zeros((b, m), dtype=torch.float32, device=dev),
            g=torch.zeros((b, n), dtype=torch.float32, device=dev),
            err=torch.full((b,), float("inf"), dtype=torch.float32,
                           device=dev),
            phases=torch.zeros((b,), dtype=torch.int32, device=dev))

    def run_phases(self, data, state, k: int):
        return run_sinkhorn_phases(
            data["c_hat"], data["log_nu"], data["log_mu"], data["nu_hat"],
            data["reg"], data["tol"], data["phase_cap"], state, k)

    def converged(self, data, state):
        return (state.err <= data["tol"]) | (state.phases
                                             >= data["phase_cap"])

    def epilogue(self, ctx, state):
        return sinkhorn_epilogue(ctx["c"], ctx["nu"], ctx["mu"], ctx["reg"],
                                 ctx["scale"], ctx["mass_nu"], state)

    # -- result shaping ------------------------------------------------

    def empty_result(self, m: int, n: int, device=None):
        def zf(*s):
            return torch.zeros(s, dtype=torch.float32, device=device)

        def zi(*s):
            return torch.zeros(s, dtype=torch.int32, device=device)
        return SinkhornOTResult(plan=zf(0, m, n), cost=zf(0), y_b=zf(0, m),
                                y_a=zf(0, n), phases=zi(0), rounds=zi(0),
                                err=zf(0), reg=zf(0))

    # trim: OTSpec's slice of every field works on SinkhornOTResult

    # -- per-artifact producers ----------------------------------------

    artifacts = ("cost", "duals", "plan", "plan_sparse", "state", "stats")
    state_on_result = False

    def artifact_device(self, name, r, state):
        if name == "cost":
            return {"cost": r.cost}
        if name == "scalars":
            # no theta: Sinkhorn has no integer scaling parameter
            return {"phases": r.phases, "rounds": r.rounds}
        if name == "duals":
            return {"y_b": r.y_b, "y_a": r.y_a}
        if name == "plan":
            return {"plan": r.plan}
        raise KeyError(name)

    def artifact_state(self, r, state):
        # SinkhornOTResult carries no state: it exists only when the
        # dispatch retained it (keep_state / want=("state",))
        return state

    def legacy_instance_dict(self, sol):
        return {"plan": sol.plan(), "cost": sol.cost, "phases": sol.phases,
                "rounds": sol.rounds}

    def matrix_instance(self, inputs, i, mi, ni, mp, np_, eps_i, mesh2,
                        row_axis, col_axis, **kw):
        raise NotImplementedError(
            "the sinkhorn spec supports batch placement only; use "
            "placement='batch' (or the push-relabel specs) for "
            "row/col-sharded single instances")

    def matrix_stack(self, rows, m_valid, n_valid, m: int, n: int):
        raise NotImplementedError(
            "the sinkhorn spec supports batch placement only")


class KernelSinkhornSpec(SinkhornSpec):
    """SinkhornSpec whose f-update is the CUDA row kernel
    (``ops.sinkhorn_row_update``); on CPU tensors the wrapper runs the
    kernel's plain version. It evaluates the same logsumexp as the stepped
    spec in another order: f32 reassociation noise, ~1e-7 * |f|."""

    fused = True

    def run_phases(self, data, state, k: int):
        return run_sinkhorn_phases(
            data["c_hat"], data["log_nu"], data["log_mu"], data["nu_hat"],
            data["reg"], data["tol"], data["phase_cap"], state, k,
            kernel=True)


SINKHORN = SinkhornSpec()
SINKHORN_KERNEL = KernelSinkhornSpec()
KernelSinkhornSpec.stepped = SINKHORN
# fused_variant() hook (core/problem.py): DispatchPolicy(fused=True)
# resolves SINKHORN -> SINKHORN_KERNEL without core importing portfolio
SinkhornSpec.fused_spec = SINKHORN_KERNEL


# --------------------------------------------------------------------------
# repro_torch.analysis registration: the Sinkhorn spec's stepped core,
# chunk and converged-mask dispatches and its state-init chain, as for
# the push-relabel specs (core/compaction.py, core/problem.py).
# --------------------------------------------------------------------------

from ..analysis import registry as _audit  # noqa: E402


def _tiny_sinkhorn_batch():
    """A deterministic (2, 4, 4) prepared batch on the CPU: ``(chunk,
    conv, data, state)`` for recording dispatches."""
    from ..core.compaction import spec_fns

    b, mn = 2, 4
    c = np.linspace(0.0, 1.0, b * mn * mn, dtype=np.float32)
    inputs = {"c": c.reshape(b, mn, mn),
              "nu": np.full((b, mn), 1.0 / mn, np.float32),
              "mu": np.full((b, mn), 1.0 / mn, np.float32)}
    p = SINKHORN.prepare(SINKHORN.canonicalize(inputs, "cpu"), 0.25)
    prologue, init, chunk, conv, _ = spec_fns(SINKHORN, 2)
    data, ctx = prologue(p.ops)
    state = init(data, ctx)
    return chunk, conv, data, state


def _trace_sinkhorn_chunk():
    chunk, _, data, state = _tiny_sinkhorn_batch()
    return _audit.trace_entry(
        name="portfolio.sinkhorn.chunk[sinkhorn]",
        fn=chunk,
        args={"data": data, "state": state},
        donated={"state"},
        tags={"chunk-dispatch", "sinkhorn"},
        source=__name__,
    )


def _trace_sinkhorn_conv():
    _, conv, data, state = _tiny_sinkhorn_batch()
    return _audit.trace_entry(
        name="portfolio.sinkhorn.conv[sinkhorn]",
        fn=conv,
        args={"data": data, "state": state},
        tags={"conv-dispatch", "sinkhorn"},
        source=__name__,
    )


def _trace_sinkhorn_state_chain():
    m = n = 8

    def chain(c, nu, mu, reg, tol):
        data, ctx = SINKHORN.prologue({
            "c": c, "nu": nu, "mu": mu, "reg": reg, "tol": tol,
            "phase_cap": torch.tensor([64], dtype=torch.int32)})
        state = SINKHORN.init_state(data, ctx)
        return {"state": state,
                "retained": {"c_hat": data["c_hat"],
                             "log_nu": data["log_nu"],
                             "nu_hat": data["nu_hat"],
                             "scale": ctx["scale"]}}

    return _audit.trace_entry(
        name="portfolio.sinkhorn.state_chain",
        fn=chain,
        args={
            "c": torch.zeros((1, m, n), dtype=torch.float32),
            "nu": torch.full((1, m), 1.0 / m, dtype=torch.float32),
            "mu": torch.full((1, n), 1.0 / n, dtype=torch.float32),
            "reg": torch.tensor([0.02], dtype=torch.float32),
            "tol": torch.tensor([0.01], dtype=torch.float32),
        },
        retained={"c", "nu", "mu"},
        tags={"state-init-chain", "sinkhorn"},
        source=__name__,
    )


def _trace_run_phases():
    """The stepped core itself: the host-f64 schedule (reg / tol /
    phase_cap) must arrive as tensors."""
    m = n = 8
    state = SinkhornState(
        f=torch.zeros((1, m), dtype=torch.float32),
        g=torch.zeros((1, n), dtype=torch.float32),
        err=torch.full((1,), float("inf"), dtype=torch.float32),
        phases=torch.zeros((1,), dtype=torch.int32))

    def run(c_hat, log_nu, log_mu, nu_hat, reg, tol, phase_cap, state):
        return run_sinkhorn_phases(c_hat, log_nu, log_mu, nu_hat, reg,
                                   tol, phase_cap, state, 3)

    return _audit.trace_entry(
        name="portfolio.sinkhorn.run_sinkhorn_phases",
        fn=run,
        args={
            "c_hat": torch.zeros((1, m, n), dtype=torch.float32),
            "log_nu": torch.full((1, m), -float(np.log(m)),
                                 dtype=torch.float32),
            "log_mu": torch.full((1, n), -float(np.log(n)),
                                 dtype=torch.float32),
            "nu_hat": torch.full((1, m), 1.0 / m, dtype=torch.float32),
            "reg": torch.tensor([0.02], dtype=torch.float32),
            "tol": torch.tensor([0.01], dtype=torch.float32),
            "phase_cap": torch.tensor([64], dtype=torch.int32),
            "state": state,
        },
        donated={"state"},
        must_trace={"reg", "tol", "phase_cap"},
        tags={"stepped-core", "sinkhorn"},
        source=__name__,
    )


_audit.register("portfolio.sinkhorn.run_sinkhorn_phases",
                _trace_run_phases, source=__name__)
_audit.register("portfolio.sinkhorn.chunk[sinkhorn]",
                _trace_sinkhorn_chunk, source=__name__)
_audit.register("portfolio.sinkhorn.conv[sinkhorn]",
                _trace_sinkhorn_conv, source=__name__)
_audit.register("portfolio.sinkhorn.state_chain",
                _trace_sinkhorn_state_chain, source=__name__)
