"""kernels.lane_path_share.batch: as kernels.lane_path_share.solo, over
the batched calls of the traced part of the window."""
from portbench.lib.harness import load_file

read = load_file("metrics", "kernels.lane_path_share.solo").read
