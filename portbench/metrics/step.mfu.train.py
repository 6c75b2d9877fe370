"""step.mfu.train: percent of the H100's dense bf16 peak (989 TFLOP/s)
that the training steps reach: the model FLOPs of a step (the entry's
``notes["step_flops"]``, ``model_bounds.train_step_flops``: 6 x active
parameters x tokens plus the causal attention, no remat) times the
``train.step`` spans the program recorded (``repro_torch.obs.tracing``),
over their summed host time (each ends with the step's loss read, so it
covers the card's work). Steps under the profiler (from ``notes["profiled_from"]`` on) are left
out. None when the program recorded no step."""
from portbench.model_bounds import BF16_FLOP_PER_S


def read(w):
    from repro_torch.obs.tracing import recorded

    cut = w.notes.get("profiled_from", float("inf"))
    steps = [s for s in recorded()
             if s["name"] == "train.step" and s["t_start"] < cut]
    secs = sum(s["dur_s"] for s in steps)
    flops = w.notes.get("step_flops")
    if not steps or secs <= 0 or not flops:
        return None
    return 100.0 * flops * len(steps) / secs / BF16_FLOP_PER_S
