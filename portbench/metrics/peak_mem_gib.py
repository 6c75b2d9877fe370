"""peak_mem_gib: torch.cuda.max_memory_allocated over the window, reset
when it opens, in GiB."""
from portbench.lib.readers import peak_gib as read  # noqa: F401
