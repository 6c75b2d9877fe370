"""Shared harness of the repro_torch parity tests: one batch, two packages,
integer state compared at every k-phase chunk boundary.

Not a test module itself (no ``test_`` prefix); the test files import it.
"""
import numpy as np
import jax.numpy as jnp
import torch

from repro.core import problem as jproblem
from repro.core.compaction import spec_fns
from repro_torch.core import problem as tproblem
from repro_torch.core.interop import state_from_numpy, state_to_numpy

# one bucket shape for every case, so each k compiles one JAX program
B, M, N = 4, 24, 32
SIZES = np.array([[24, 32], [20, 29], [17, 32], [24, 25]], np.int32)


def cases():
    """(name, sizes, eps, guaranteed): full, ragged with per-instance eps,
    ragged with the guaranteed (eps/3) bound."""
    return [
        ("full", None, 0.1, False),
        ("ragged", SIZES, np.array([0.1, 0.2, 0.15, 0.1]), False),
        ("guaranteed", SIZES, 0.2, True),
    ]


def batch(spec_name: str, seed: int, sizes):
    """Costs of 2-D point clouds (and Dirichlet masses for OT), zero
    outside each instance's block."""
    rng = np.random.default_rng(seed)
    sizes = np.tile([M, N], (B, 1)) if sizes is None else sizes
    c = np.zeros((B, M, N), np.float32)
    nu = np.zeros((B, M), np.float32)
    mu = np.zeros((B, N), np.float32)
    for i, (mi, ni) in enumerate(sizes):
        x, y = rng.uniform(size=(mi, 2)), rng.uniform(size=(ni, 2))
        c[i, :mi, :ni] = np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1))
        nu[i, :mi] = rng.dirichlet(np.ones(mi))
        mu[i, :ni] = rng.dirichlet(np.ones(ni))
    if spec_name == "assignment":
        return {"c": c}
    return {"c": c, "nu": nu, "mu": mu}


def _np(tree):
    return {f: np.asarray(v) for f, v in tree._asdict().items()}


def assert_states_equal(jstate, tstate, where: str):
    for f, v in _np(jstate).items():
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), v,
                                      err_msg=f"{where}: field {f}")


def chunk_parity(spec_name: str, inputs, eps, sizes, guaranteed: bool,
                 k: int, resume_at: int = 1):
    """Run the reference's vmapped k-phase chunk and the port's batched
    ``run_phases`` side by side from the same prepared batch; the integer
    state must be equal at every chunk boundary. At chunk ``resume_at``
    the port is restarted from the reference's state (through
    ``interop``). Returns the number of chunks run."""
    jspec = getattr(jproblem, spec_name.upper())
    tspec = getattr(tproblem, spec_name.upper())
    jin = jspec.canonicalize(inputs)
    p = jspec.prepare(jin, eps, sizes=sizes, guaranteed=guaranteed)
    prologue, init, chunk, conv, _ = spec_fns(jspec, k)
    jops = {kk: jnp.asarray(v) for kk, v in p.ops.items()}
    jdata, jctx = prologue(jops)
    jctx = {**jctx, **{kk: jops[kk] for kk in jspec.ctx_ops}}
    jstate = init(jdata, jctx)

    tin = tspec.canonicalize(inputs, "cpu")
    tp = tspec.prepare(tin, eps, sizes=sizes, guaranteed=guaranteed)
    np.testing.assert_array_equal(tp.threshold, p.threshold)
    np.testing.assert_array_equal(tp.phase_cap, p.phase_cap)
    tdata, tctx = tspec.prologue(tp.ops)
    np.testing.assert_array_equal(tdata["c_int"].numpy(),
                                  np.asarray(jdata["c_int"]))
    tctx = {**tctx, **{kk: tp.ops[kk] for kk in tspec.ctx_ops}}
    tstate = tspec.init_state(tdata, tctx)

    for i in range(10_000):
        assert_states_equal(jstate, tstate, f"chunk {i}")
        jconv, _ = conv(jdata, jstate)
        tconv = tspec.converged(tdata, tstate)
        np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
        if bool(np.asarray(jconv).all()):
            return i
        if i == resume_at:
            tstate = state_from_numpy(_np(jstate), device="cpu")
            assert state_to_numpy(tstate).keys() == _np(jstate).keys()
        jstate = chunk(jdata, jstate)   # donates the old jstate
        tstate = tspec.run_phases(tdata, tstate, k)
    raise AssertionError("no convergence")
