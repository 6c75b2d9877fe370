"""solve_s: the window's length over the calls completed in it (one
instance a call), host clock."""


def read(w):
    return w.elapsed_s / w.calls_done if w.calls_done else None
