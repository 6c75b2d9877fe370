"""Sizes ``{"law": "fixed", "m": M, "n": N}``: every instance M x N."""
import numpy as np


def draw(law: dict, count: int, rng) -> np.ndarray:
    """(count, 2) sizes; draws nothing from ``rng``."""
    return np.tile(np.asarray([[law["m"], law["n"]]], np.int64), (count, 1))

