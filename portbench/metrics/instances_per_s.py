"""instances_per_s: instances answered in the window over its length,
host clock."""


def read(w):
    return w.instances_done / w.elapsed_s if w.instances_done else None
