"""repro_torch's CUDA kernels against their plain versions, and the main
path on the card against the CPU. Needs an NVIDIA GPU; every test skips
without one (imports neither jax nor repro, so it runs on a machine that
has only torch)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.api import ASSIGNMENT, OT, solve
from repro_torch.kernels import ops
from repro_torch.kernels.cost_matrix import cost_matrix_ref, tolerance
from repro_torch.kernels.slack_propose import slack_propose_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _propose_inputs(seed, b, m, n, dev):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.integers(0, 6, size=(b, m, n)).astype(np.int32),
        rng.integers(0, 4, size=(b, m)).astype(np.int32),
        -rng.integers(0, 4, size=(b, n)).astype(np.int32),
        rng.uniform(size=(b, n)) < 0.6,
        rng.integers(0, 2**31 - 1, size=b).astype(np.int32),
        rng.uniform(size=(b, m)) < 0.75,
    )
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n", [(1, 300, 1000), (3, 257, 130),
                                   (2, 64, 301)])
def test_slack_propose_kernel_equals_plain(dev, b, m, n):
    c, y_b, y_a, avail, salt, active = _propose_inputs(b * m + n, b, m, n,
                                                       dev)
    before = ops.launches["slack_propose"]
    col, key = ops.slack_propose_batched(c, y_b, y_a, avail, salt,
                                         active_b=active)
    rcol, rkey = slack_propose_ref(c, y_b, y_a, avail, salt, active)
    torch.cuda.synchronize()
    assert ops.launches["slack_propose"] == before + 1
    assert torch.equal(col, rcol) and torch.equal(key, rkey)


@pytest.mark.cuda
def test_slack_propose_misaligned_rows_take_scalar_path(dev):
    """A contiguous view that starts off a 16-byte boundary still gives
    the plain version's answer."""
    c, y_b, y_a, avail, salt, active = _propose_inputs(1, 2, 17, 64, dev)
    c1 = torch.cat([c.flatten(), c.flatten()[:1]])[1:].view(2, 17, 64)
    col, key = ops.slack_propose_batched(c1, y_b, y_a, avail, salt,
                                         active_b=active)
    rcol, rkey = slack_propose_ref(c1, y_b, y_a, avail, salt, active)
    assert torch.equal(col, rcol) and torch.equal(key, rkey)


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(dev):
    c, y_b, y_a, avail, salt, _ = _propose_inputs(2, 1, 8, 8, dev)
    with pytest.raises(TypeError):
        ops.slack_propose_batched(c.to(torch.int64), y_b, y_a, avail, salt)
    with pytest.raises(ValueError):
        ops.slack_propose_batched(c.transpose(1, 2), y_b, y_a, avail, salt)
    with pytest.raises(ValueError):
        ops.cost_matrix_batched(torch.zeros(1, 4, 2, device=dev),
                                torch.zeros(1, 4, 3, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1"])
@pytest.mark.parametrize("b,m,n,d", [(1, 1000, 999, 2), (4, 70, 130, 33),
                                     (1, 256, 300, 784)])
def test_cost_matrix_kernel_vs_plain(dev, metric, b, m, n, d):
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.uniform(size=(b, m, d)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.uniform(size=(b, n, d)).astype(np.float32),
                        device=dev)
    got = ops.cost_matrix_batched(x, y, metric)
    ref = cost_matrix_ref(x, y, metric)
    rtol, atol = tolerance(metric, d)
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["assignment", "ot"])
def test_solve_on_card_equals_cpu(dev, name):
    """The same float costs solved on the card (through the kernels) and
    on the CPU (plain versions) give the same integer state."""
    rng = np.random.default_rng(3)
    insts = []
    for n in (20, 45, 64):
        c = rng.uniform(size=(n, n)).astype(np.float32)
        insts.append(c if name == "assignment" else (
            c, rng.dirichlet(np.ones(n)).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32)))
    spec = ASSIGNMENT if name == "assignment" else OT
    before = ops.launches["slack_propose"]
    card = solve(spec, insts, 0.05, want=("cost", "state"), device=dev)
    assert ops.launches["slack_propose"] > before
    cpu = solve(spec, insts, 0.05, want=("cost", "state"), device="cpu")
    for a, b in zip(card, cpu):
        sa, sb = a.state(), b.state()
        for f in sa._fields:
            assert torch.equal(getattr(sa, f).cpu(), getattr(sb, f)), f
