"""driver.runout_share.batch: as driver.runout_share.solo, over the
batched calls of the traced part of the window."""
from portbench.lib.harness import load_file

read = load_file("metrics", "driver.runout_share.solo").read
