"""Deterministic synthetic data of the port (``data.pipeline``)."""
