"""device.idle_share.train: percent of the traced window in which no
device activity ran (one minus the union of their intervals)."""
from portbench.lib.readers import idle_share as read  # noqa: F401
