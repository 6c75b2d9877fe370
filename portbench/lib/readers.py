"""The arithmetic that metric files share, on a ``harness.Window``.
Each returns None where the window has nothing to read, never 0 for a
share it could not measure."""
from __future__ import annotations

from .bounds import solve_bound_s


def per_call(total, w):
    return total / w.calls_done if w.calls_done else None


def idle_share(w):
    """Percent of the traced window in which no device activity ran."""
    t = w.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernels_roofline(w):
    """Percent: the least time the traced calls' work needs
    (``bounds.solve_bound_s``) over the summed device time of every
    kernel that ran for them."""
    t = w.trace
    if t is None or t.kernel_s <= 0 or not w.traced_shapes:
        return None
    return 100.0 * sum(solve_bound_s(*s) for s in w.traced_shapes) / t.kernel_s


def peak_gib(w):
    return w.peak_bytes / 2 ** 30 if w.peak_bytes else None
