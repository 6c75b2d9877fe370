"""Atomic CRC-checked checkpoints of the port
(``checkpoint.checkpointing``)."""
