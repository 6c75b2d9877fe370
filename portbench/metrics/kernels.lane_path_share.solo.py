"""kernels.lane_path_share.solo: percent of the program's
``fused_assignment_phases`` launches that took the kernel's per-lane path
(a thread-block cluster per lane) rather than its grid path: the
``fused_assignment.lane_path`` counts over the
``launches.fused_assignment_phases`` counts of the ``solve`` spans the
program recorded in the traced part of the window. None where no
``solve`` span counted a ``fused_assignment_phases`` launch, and where the
program counts no per-lane launches at all (a program without the
per-lane path)."""
from portbench.lib.harness import load_file

_share = load_file("metrics", "driver.sync_wait_share.solo")


def share(spans):
    """The percent over a list of recorded span events."""
    solves = [s for s in spans if s["name"] == "solve"]
    launches = sum(s.get("launches", {}).get("fused_assignment_phases", 0)
                   for s in solves)
    counted = [s["fused_assignment"]["lane_path"] for s in solves
               if "lane_path" in s.get("fused_assignment", {})]
    if not launches or not counted:
        return None
    return 100.0 * sum(counted) / launches


def read(w):
    return share(_share.recorded())
