"""Solver core of the port: matching, the stepped push-relabel cores for
assignment and OT, the problem specs, the batch drivers and the ``solve``
front door. Every function works on a batch axis written out in front.

The public surface is the reference's (``repro.core``), multi-device
dispatch (``core/distributed.py``) included.
"""
from .pushrelabel import (solve_assignment, solve_assignment_int,
                          AssignmentResult)
from .transport import solve_ot, solve_ot_int, OTResult, northwest_corner
from .problem import (
    ASSIGNMENT,
    OT,
    AssignmentSpec,
    BatchedAssignmentResult,
    OTSpec,
    ProblemSpec,
)
from .api import DispatchPolicy, solve
from .solution import (
    ArtifactNotRequested,
    Solution,
    SolutionBatch,
    SolveStats,
    SparsePlan,
    SparsePlanBatch,
)
from .batched import (
    solve_assignment_batched,
    solve_assignment_ragged,
    solve_ot_batched,
    solve_ot_ragged,
)
from .compaction import (
    CompactionStats,
    solve_assignment_batched_compacting,
    solve_ot_batched_compacting,
)
from .distributed import (
    DistributedStats,
    choose_placement,
    solve_assignment_distributed,
    solve_ot_distributed,
)
from .costs import build_cost_matrix
from .sinkhorn import sinkhorn

__all__ = [
    "ASSIGNMENT", "OT", "AssignmentSpec", "OTSpec", "ProblemSpec",
    "DispatchPolicy", "solve",
    "ArtifactNotRequested", "Solution", "SolutionBatch", "SolveStats",
    "SparsePlan", "SparsePlanBatch",
    "solve_assignment", "solve_assignment_int", "AssignmentResult",
    "solve_ot", "solve_ot_int", "OTResult", "northwest_corner",
    "solve_assignment_batched", "solve_assignment_ragged",
    "solve_ot_batched", "solve_ot_ragged", "BatchedAssignmentResult",
    "CompactionStats", "solve_assignment_batched_compacting",
    "solve_ot_batched_compacting",
    "DistributedStats", "choose_placement",
    "solve_assignment_distributed", "solve_ot_distributed",
    "build_cost_matrix", "sinkhorn",
]
