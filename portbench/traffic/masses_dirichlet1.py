"""Masses ``"dirichlet1"``: Dirichlet(1) on ``n`` points, float32 (the
masses of ``chip_smoke.py``'s OT phases)."""
import numpy as np


def draw(rng, n: int) -> np.ndarray:
    return rng.dirichlet(np.ones(n)).astype(np.float32)
