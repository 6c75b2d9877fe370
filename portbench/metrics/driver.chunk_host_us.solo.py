"""driver.chunk_host_us.solo: host us a chunk of the driver's loop takes
(a dispatch, its read and its retirement): the summed ``driver.chunk``
spans whose parent is a ``solve`` span, over their count, as the program
recorded them in the traced part of the window. None when it recorded
no such chunk."""
from portbench.lib.harness import load_file

_share = load_file("metrics", "driver.sync_wait_share.solo")


def read(w):
    spans = _share.recorded()
    solves = {s["span_id"] for s in spans if s["name"] == "solve"}
    chunks = [s["dur_s"] for s in spans if s["name"] == "driver.chunk"
              and s.get("parent_id") in solves]
    if not chunks:
        return None
    return 1e6 * sum(chunks) / len(chunks)
