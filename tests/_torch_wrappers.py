"""One small call of each CUDA kernel wrapper of ``repro_torch.kernels.ops``
on a given device, for the tests of where the wrappers launch (imports
neither jax nor repro). Not a test module itself."""
import torch

from repro_torch.kernels import ops


def wrapper_calls(dev):
    """One small call of each kernel wrapper on ``dev``, by kernel name."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.int32, hi=4):
        return torch.randint(0, hi, shape, generator=g).to(dtype).to(dev)
    b, m, n = 2, 8, 12
    c = t(b, m, n)

    def state_a():
        from repro_torch.core.pushrelabel import init_assignment_state
        return init_assignment_state(b, m, n, dev)

    def state_o():
        from repro_torch.core.transport import init_ot_state
        return init_ot_state(t(b, m, hi=9), t(b, n, hi=9))
    vec = t(b, hi=3) + 3
    return {
        "slack_propose": lambda: ops.slack_propose_batched(
            c, t(b, m), -t(b, n), t(b, n, dtype=torch.bool, hi=2), vec),
        "cost_matrix": lambda: ops.cost_matrix_batched(
            t(b, m, 2, dtype=torch.float32), t(b, n, 2, dtype=torch.float32),
            "euclidean"),
        "fused_assignment_phases": lambda: ops.fused_run_assignment_phases(
            c, state_a(), vec * 0, vec, 2),
        "fused_ot_phases": lambda: ops.fused_run_ot_phases(
            c, state_o(), vec * 0, vec, 2, m + n + 2),
        "sinkhorn_row_update": lambda: ops.sinkhorn_row_update(
            t(b, m, n, dtype=torch.float32), t(b, n, dtype=torch.float32),
            t(b, m, dtype=torch.float32),
            torch.ones(b, device=dev)),
    }

