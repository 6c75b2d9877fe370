"""core.round_host_us.solo: host us a propose round takes: the summed
``core.rounds`` spans (one a phase's round loop) over the rounds they
ran, as the program recorded them in the traced part of the window. None
when it recorded no round.

Not among BENCHMARK.json's metrics: on the card every cell takes the
fused route, which records no ``core.rounds`` span, and its chunks are
read by driver.chunk_host_us.solo. Kept for solves on the stepped route
(``DispatchPolicy(fused=False)``) and for
tests/test_torch_solve_spans.py, which reads it."""
from portbench.lib.harness import load_file

_share = load_file("metrics", "driver.sync_wait_share.solo")


def read(w):
    loops = [s for s in _share.recorded() if s["name"] == "core.rounds"]
    rounds = sum(s.get("rounds", 0) for s in loops)
    if not rounds:
        return None
    return 1e6 * sum(s["dur_s"] for s in loops) / rounds
