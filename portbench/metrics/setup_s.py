"""setup_s: process start to the window's first call, host clock."""


def read(w):
    return w.setup_s
