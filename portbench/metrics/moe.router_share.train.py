"""moe.router_share.train: percent of the traced window's kernel time
(the summed device time of every kernel) that the MoE router's
``fused_ot_phases`` launches (the device's ``fused_ot_kernel``) took
(torch.profiler; the entry's ``notes["router_kernel"]``). None without
a trace or a router launch."""


def read(w):
    k = w.notes.get("router_kernel")
    t = w.trace
    if not k or not k["launches"] or t is None or t.kernel_s <= 0:
        return None
    return 100.0 * k["device_s"] / t.kernel_s
