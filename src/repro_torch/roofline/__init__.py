"""Roofline accounting of the port (``roofline.analysis``: the model
FLOPs of a configuration)."""
