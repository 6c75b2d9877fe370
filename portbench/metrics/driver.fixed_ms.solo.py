"""driver.fixed_ms.solo: host ms a solve spends outside its chunk loop:
each ``solve`` span less its ``driver.chunk`` children, plus the
``costs.build`` and ``solution.*`` spans, over the ``solve`` spans the
program recorded in the traced part of the window. None when it recorded
none."""
from portbench.lib.harness import load_file

_share = load_file("metrics", "driver.sync_wait_share.solo")


def read(w):
    spans = _share.recorded()
    top = _share.top_level(spans)
    solves = {s["span_id"] for s in top if s["name"] == "solve"}
    if not solves:
        return None
    chunks_s = sum(s["dur_s"] for s in spans
                   if s["name"] == "driver.chunk"
                   and s.get("parent_id") in solves)
    return 1e3 * (sum(s["dur_s"] for s in top) - chunks_s) / len(solves)
