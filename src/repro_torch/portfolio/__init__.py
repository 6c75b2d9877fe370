"""Solver portfolio: Sinkhorn as a ProblemSpec, a measured cost model for
``DispatchPolicy(solver="auto")``, and the hybrid Sinkhorn -> push-relabel
warm start. Port of ``repro.portfolio``; ``core/api`` imports it lazily
when a policy routes away from the default solver."""
from .costmodel import (  # noqa: F401
    SOLVERS,
    CostModel,
    choose,
    fit,
    get_model,
    set_model,
)
from .hybrid import WARM_OT, dispatch_hybrid, round_duals  # noqa: F401
from .sinkhorn_spec import (  # noqa: F401
    SINKHORN,
    SINKHORN_KERNEL,
    SinkhornSpec,
    sinkhorn_schedule,
)
