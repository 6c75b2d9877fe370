"""kernels_roofline.batch: the least time of the traced solves' work
(each cost built once and read once, lib/bounds.py) over the summed
device time of every kernel that ran for them, percent."""
from portbench.lib.readers import kernels_roofline as read  # noqa: F401
