"""driver.syncs.solo: device-to-host reads the port counts
(core.device.sync_counts, all kinds) over the window, per solve."""
from portbench.lib.readers import per_call


def read(w):
    return per_call(sum(w.sync_delta.values()), w) if w.sync_delta else None
