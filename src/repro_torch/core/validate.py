"""Pre-admission input validation: per-lane poison detection for
quarantine.

Port of ``repro.core.validate``. One masked reduction over a collated
bucket classifies each lane BEFORE dispatch, on the bucket's own device:

  ``NONFINITE_COST``   a NaN/inf cost inside the instance's valid block;
  ``NEGATIVE_MASS``    a negative or non-finite supply/demand weight;
  ``MASS_IMBALANCE``   ``|sum(nu) - sum(mu)|`` beyond a relative
                       tolerance (the OT rounding step assumes balanced
                       marginals).

Codes are a bitmask, so one lane can carry several reasons. The serving
layers (``serve/scheduler.py``, ``serve/engine.py``) call
:func:`admission_codes` per collated bucket and fail the offending lanes
with a per-request :class:`RequestRejected` while the rest of the bucket
proceeds: the batched solve is lane-independent, so dropping a lane never
changes a neighbour's result.

The masses are summed in fp32, as the reference does, but torch and XLA
sum in different orders: a lane whose imbalance lies within an ulp of
``tol * scale`` may be classified differently by the two packages. Away
from that edge the codes are equal.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import as_f32
from .problem import _sizes_arrays

__all__ = [
    "OK",
    "NONFINITE_COST",
    "NEGATIVE_MASS",
    "MASS_IMBALANCE",
    "DEFAULT_TOL",
    "RequestRejected",
    "describe",
    "admission_codes",
    "check_admission",
]

OK = 0
NONFINITE_COST = 1
NEGATIVE_MASS = 2
MASS_IMBALANCE = 4

#: Relative mass-imbalance tolerance: |sum(nu) - sum(mu)| may be at most
#: this fraction of max(total mass, 1).
DEFAULT_TOL = 1e-3

_REASONS = (
    (NONFINITE_COST, "non-finite cost"),
    (NEGATIVE_MASS, "negative or non-finite mass"),
    (MASS_IMBALANCE, "mass imbalance beyond tolerance"),
)


def describe(code: int) -> str:
    """Human-readable reason string for a bitmask admission code."""
    parts = [text for bit, text in _REASONS if code & bit]
    return " + ".join(parts) if parts else "ok"


class RequestRejected(RuntimeError):
    """A request refused admission (or quarantined mid-dispatch).

    Carries the machine-readable ``code`` bitmask alongside ``who`` (the
    tenant/request name the serving layer supplies) so a client can tell
    its own poisoned input from a neighbour's transient failure.
    """

    def __init__(self, who: str, code: int, reason: Optional[str] = None):
        self.who = str(who)
        self.code = int(code)
        self.reason = reason if reason is not None else describe(int(code))
        super().__init__(
            f"{self.who} rejected at admission: {self.reason} "
            f"(code {self.code})")


def _lane_masks(c: torch.Tensor, m_valid, n_valid):
    _, m, n = c.shape
    dev = c.device
    mv = torch.as_tensor(m_valid, dtype=torch.int32, device=dev)
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
    rok = torch.arange(m, device=dev)[None, :] < mv[:, None]
    cok = torch.arange(n, device=dev)[None, :] < nv[:, None]
    return rok, cok


def _bad_cost(c, rok, cok) -> torch.Tensor:
    mask = rok[:, :, None] & cok[:, None, :]
    return (~torch.isfinite(c) & mask).any(dim=2).any(dim=1)


def _admission_assignment(c, m_valid, n_valid) -> torch.Tensor:
    """(B,) int32 codes for assignment instances: cost finiteness over
    each instance's valid block (padding is exempt)."""
    rok, cok = _lane_masks(c, m_valid, n_valid)
    return torch.where(_bad_cost(c, rok, cok), NONFINITE_COST,
                       OK).to(torch.int32)


def _admission_ot(c, nu, mu, m_valid, n_valid, tol: float) -> torch.Tensor:
    """(B,) int32 bitmask codes for OT instances. The imbalance test is
    relative to ``max(total mass, 1)``, in fp32 as the reference's."""
    rok, cok = _lane_masks(c, m_valid, n_valid)
    bad_c = _bad_cost(c, rok, cok)
    bad_nu = ((~torch.isfinite(nu) | (nu < 0)) & rok).any(dim=1)
    bad_mu = ((~torch.isfinite(mu) | (mu < 0)) & cok).any(dim=1)
    s_nu = torch.where(rok, nu, 0.0).sum(dim=1)
    s_mu = torch.where(cok, mu, 0.0).sum(dim=1)
    scale = torch.maximum(torch.maximum(s_nu, s_mu),
                          torch.ones_like(s_nu))
    tol_t = torch.tensor(tol, dtype=torch.float32, device=c.device)
    imbalanced = (s_nu - s_mu).abs() > tol_t * scale
    return (torch.where(bad_c, NONFINITE_COST, OK)
            | torch.where(bad_nu | bad_mu, NEGATIVE_MASS, OK)
            | torch.where(imbalanced, MASS_IMBALANCE, OK)).to(torch.int32)


def admission_codes(inputs: Dict[str, Any], *,
                    sizes: Optional[np.ndarray] = None,
                    tol: float = DEFAULT_TOL) -> np.ndarray:
    """(B,) int32 admission codes for a batched input dict.

    ``inputs`` holds ``c`` (B, M, N) and, for OT, ``nu``/``mu``; tensors
    are reduced on their own device (arrays on the CPU), and only the
    (B,) codes cross to the host. ``sizes`` is the usual (B, 2) true-shape
    array (None: every lane fills the padded block). 0 means admitted;
    nonzero is a bitmask of rejection reasons (see :func:`describe`).
    """
    c = inputs["c"]
    dev = c.device if isinstance(c, torch.Tensor) else torch.device("cpu")
    c = as_f32(c, dev)
    b, m, n = (int(s) for s in c.shape)
    m_valid, n_valid = _sizes_arrays(sizes, b, m, n)
    if inputs.get("nu") is not None:
        codes = _admission_ot(c, as_f32(inputs["nu"], dev),
                              as_f32(inputs["mu"], dev), m_valid, n_valid,
                              float(tol))
    else:
        codes = _admission_assignment(c, m_valid, n_valid)
    return codes.cpu().numpy()


def check_admission(inputs: Dict[str, Any], *,
                    sizes: Optional[np.ndarray] = None,
                    tol: float = DEFAULT_TOL,
                    who: str = "instance") -> np.ndarray:
    """Run :func:`admission_codes` and raise :class:`RequestRejected`
    naming every offending lane; returns the (all-zero) codes when clean."""
    codes = admission_codes(inputs, sizes=sizes, tol=tol)
    bad = np.flatnonzero(codes)
    if bad.size:
        shown = ", ".join(
            f"{who} {int(j)}: {describe(int(codes[j]))}" for j in bad[:8])
        more = "" if bad.size <= 8 else f" (+{int(bad.size) - 8} more)"
        raise RequestRejected(
            f"{int(bad.size)}/{int(codes.size)} lane(s)",
            int(codes[bad[0]]), reason=shown + more)
    return codes
