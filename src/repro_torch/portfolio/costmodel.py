"""Measured cost model behind ``DispatchPolicy(solver="auto")``.

Port of ``repro.portfolio.costmodel``, with the same schema. The paper's
finding is a crossover: Sinkhorn wins at loose eps (few iterations, cheap
dense updates), push-relabel wins as eps tightens (Sinkhorn's 1/eps^2
iteration bound grows faster than push-relabel's ~1/eps). Where the
crossover sits depends on the hardware and n, so this module hard-codes
no rule: it fits per-(solver, n-bucket, eps-band) wall-time entries from a
calibration run and persists them as JSON with a ``mode`` label and the
``backend`` they were measured on; ``choose`` is then a table lookup,
deterministic for a loaded model.

The port's default table is its own file, ``costmodel_default.json``
beside this module, written on the card by::

    python3 tools/calibrate_portfolio.py

(``mode`` "cuda", ``backend`` the card's ``nvidia-smi`` name and power
limit). Without a table, ``choose`` routes every batch to push-relabel,
the solver with the paper's guarantee at every eps.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_SCHEMA = 1
_DEFAULT_PATH = os.path.join(os.path.dirname(__file__),
                             "costmodel_default.json")
# Solvers the table may price. "hybrid" rows are measured end-to-end
# (coarse Sinkhorn + warm-started push-relabel finish).
SOLVERS = ("pushrelabel", "sinkhorn", "hybrid")


def _log_nearest(value: float, grid: np.ndarray) -> float:
    """The grid point nearest in log-space (both strictly positive)."""
    grid = np.asarray(grid, np.float64)
    i = int(np.argmin(np.abs(np.log(grid) - np.log(max(value, 1e-30)))))
    return float(grid[i])


@dataclass(frozen=True)
class CostModel:
    """Per-(solver, n-bucket, eps-band) measured per-instance seconds.

    ``entries`` maps (solver, n_bucket, eps_band) -> seconds. Lookup
    snaps the query (n, eps) to the nearest measured bucket/band in
    log-space — wall time is roughly power-law in both — and never
    extrapolates a formula: an unmeasured solver is simply absent and
    ``choose`` falls back to push-relabel (the only solver with the
    paper's guarantee at every eps).
    """
    mode: str                      # how it was measured ("cuda" on the card)
    backend: str                   # where: nvidia-smi name, power limit
    entries: Dict[Tuple[str, int, float], float]
    n_buckets: Tuple[int, ...] = field(default_factory=tuple)
    eps_bands: Tuple[float, ...] = field(default_factory=tuple)

    def predict(self, solver: str, n: int, eps: float) -> Optional[float]:
        """Predicted per-instance seconds, or None if the solver has no
        measurement anywhere near (snapping is within the table only)."""
        if not self.n_buckets or not self.eps_bands:
            return None
        nb = int(_log_nearest(float(max(n, 1)),
                              np.asarray(self.n_buckets, np.float64)))
        eb = _log_nearest(float(eps), np.asarray(self.eps_bands,
                                                 np.float64))
        return self.entries.get((solver, nb, eb))

    def choose(self, n: int, eps: float,
               allowed: Tuple[str, ...] = SOLVERS
               ) -> Tuple[str, Optional[float]]:
        """(cheapest measured solver, its predicted seconds). Falls back
        to ("pushrelabel", its prediction or None) when nothing in
        ``allowed`` was measured."""
        best, best_s = None, None
        for s in allowed:
            p = self.predict(s, n, eps)
            if p is not None and (best_s is None or p < best_s):
                best, best_s = s, p
        if best is None:
            return "pushrelabel", self.predict("pushrelabel", n, eps)
        return best, best_s

    # -- persistence ---------------------------------------------------

    def as_dict(self) -> dict:
        return {
            "schema": _SCHEMA,
            "mode": self.mode,
            "backend": self.backend,
            "n_buckets": list(self.n_buckets),
            "eps_bands": list(self.eps_bands),
            "entries": [
                {"solver": s, "n_bucket": nb, "eps_band": eb,
                 "per_instance_s": sec}
                for (s, nb, eb), sec in sorted(self.entries.items())
            ],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=1, sort_keys=True)
            fh.write("\n")

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        if int(d.get("schema", -1)) != _SCHEMA:
            raise ValueError(
                f"cost-model schema {d.get('schema')!r} != {_SCHEMA}")
        entries = {
            (str(e["solver"]), int(e["n_bucket"]), float(e["eps_band"])):
                float(e["per_instance_s"])
            for e in d["entries"]
        }
        return cls(mode=str(d["mode"]), backend=str(d["backend"]),
                   entries=entries,
                   n_buckets=tuple(int(x) for x in d["n_buckets"]),
                   eps_bands=tuple(float(x) for x in d["eps_bands"]))

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def fit(measurements: List[dict], *, mode: str, backend: str) -> CostModel:
    """Fit a table from calibration records
    ``{"solver", "n", "eps", "per_instance_s"}``: bucket n to the
    nearest measured power of two, band eps to the measured grid, and
    take the MEDIAN per cell (robust to a single slow outlier dispatch;
    every cell typically holds repeat measurements)."""
    n_buckets = sorted({1 << int(round(np.log2(max(int(r["n"]), 1))))
                        for r in measurements})
    eps_bands = sorted({float(r["eps"]) for r in measurements})
    cells: Dict[Tuple[str, int, float], List[float]] = {}
    for r in measurements:
        nb = int(_log_nearest(float(r["n"]),
                              np.asarray(n_buckets, np.float64)))
        eb = _log_nearest(float(r["eps"]),
                          np.asarray(eps_bands, np.float64))
        cells.setdefault((str(r["solver"]), nb, eb), []).append(
            float(r["per_instance_s"]))
    entries = {k: float(np.median(v)) for k, v in cells.items()}
    return CostModel(mode=mode, backend=backend, entries=entries,
                     n_buckets=tuple(n_buckets),
                     eps_bands=tuple(eps_bands))


_ACTIVE: Optional[CostModel] = None
_DEFAULT_LOADED = False


def set_model(model: Optional[CostModel]) -> None:
    """Install ``model`` as the process-wide table ``solver="auto"``
    consults (None -> revert to the committed default)."""
    global _ACTIVE, _DEFAULT_LOADED
    _ACTIVE = model
    _DEFAULT_LOADED = model is not None


def get_model() -> Optional[CostModel]:
    """The active cost model: an installed one, else the committed
    default table (loaded lazily, once), else None."""
    global _ACTIVE, _DEFAULT_LOADED
    if not _DEFAULT_LOADED:
        _DEFAULT_LOADED = True
        if os.path.exists(_DEFAULT_PATH):
            try:
                _ACTIVE = CostModel.load(_DEFAULT_PATH)
            except (ValueError, KeyError, json.JSONDecodeError):
                _ACTIVE = None
    return _ACTIVE


def choose(n: int, eps: float,
           allowed: Tuple[str, ...] = SOLVERS
           ) -> Tuple[str, Optional[float]]:
    """Module-level convenience: route via the active model; with no
    model at all, push-relabel (the guaranteed solver) wins by default."""
    model = get_model()
    if model is None:
        return "pushrelabel", None
    return model.choose(n, eps, allowed)
