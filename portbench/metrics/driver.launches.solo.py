"""driver.launches.solo: kernels that ran on the device in the traced
part of the window, per solve traced (torch.profiler)."""


def read(w):
    t = w.trace
    if t is None or not w.traced_calls or not t.launches:
        return None
    return t.launches / w.traced_calls
