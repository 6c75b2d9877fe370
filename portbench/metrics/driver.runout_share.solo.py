"""driver.runout_share.solo: percent of the driver's chunks that ran
their bucket out (a run-out chunk: k above every lane's phase cap, so
the bucket ran to termination in one launch and one read): the
``runouts`` over the ``chunks`` counted on the ``solve`` spans the
program recorded in the traced part of the window. 0 where no chunk ran
out, as in a program without the counter; None when it recorded no
``solve`` span (or no chunk), as a program without the recorder."""
from portbench.lib.harness import load_file

_share = load_file("metrics", "driver.sync_wait_share.solo")


def share(spans):
    """The percent over a list of recorded span events."""
    solves = [s for s in spans if s["name"] == "solve"]
    chunks = sum(s.get("chunks", 0) for s in solves)
    if not chunks:
        return None
    return 100.0 * sum(s.get("runouts", 0) for s in solves) / chunks


def read(w):
    return share(_share.recorded())
