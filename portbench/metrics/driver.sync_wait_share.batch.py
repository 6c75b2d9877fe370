"""driver.sync_wait_share.batch: as driver.sync_wait_share.solo, over
the batched calls of the traced part of the window."""
from portbench.lib.harness import load_file

read = load_file("metrics", "driver.sync_wait_share.solo").read
