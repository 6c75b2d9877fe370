"""Points ``"uniform_unit_square"``: uniform in [0, 1]^2, float32 (a
copy of ``chip_smoke.py``'s ``_points``, Fig. 1's law)."""
import numpy as np


def draw(rng, n: int) -> np.ndarray:
    return rng.uniform(size=(n, 2)).astype(np.float32)
