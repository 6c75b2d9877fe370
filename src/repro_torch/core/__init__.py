"""Solver core of the port: matching, the stepped push-relabel cores for
assignment and OT, the problem specs, the batch drivers and the ``solve``
front door. Every function works on a batch axis written out in front.

The public surface is the reference's (``repro.core``), less what waits
for multi-device dispatch (ROADMAP.md Queue 1 item 11): the
``core/distributed.py`` names ``DistributedStats``, ``choose_placement``,
``solve_assignment_distributed`` and ``solve_ot_distributed``, and the
integer-input solvers ``solve_assignment_int`` and ``solve_ot_int``.
"""
from .pushrelabel import solve_assignment, AssignmentResult
from .transport import solve_ot, OTResult, northwest_corner
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
from .costs import build_cost_matrix
from .sinkhorn import sinkhorn

__all__ = [
    "ASSIGNMENT", "OT", "AssignmentSpec", "OTSpec", "ProblemSpec",
    "DispatchPolicy", "solve",
    "ArtifactNotRequested", "Solution", "SolutionBatch", "SolveStats",
    "SparsePlan", "SparsePlanBatch",
    "solve_assignment", "AssignmentResult",
    "solve_ot", "OTResult", "northwest_corner",
    "solve_assignment_batched", "solve_assignment_ragged",
    "solve_ot_batched", "solve_ot_ragged", "BatchedAssignmentResult",
    "CompactionStats", "solve_assignment_batched_compacting",
    "solve_ot_batched_compacting",
    # core/distributed.py and solve_assignment_int / solve_ot_int: item 11
    "build_cost_matrix", "sinkhorn",
]
