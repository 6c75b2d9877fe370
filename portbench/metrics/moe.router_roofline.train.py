"""moe.router_roofline.train: percent: the least time of the traced
window's router launches (each moves its (T, E) int32 costs and its
state, ``model_bounds.router_bytes``, at the HBM rate) over their device
time (torch.profiler). None without a trace or a router launch."""
from portbench.model_bounds import router_bound_s


def read(w):
    k = w.notes.get("router_kernel")
    if not k or not k["launches"] or k["device_s"] <= 0:
        return None
    bound = k["launches"] * router_bound_s(k["tokens"], k["experts"])
    return 100.0 * bound / k["device_s"]
