"""Legacy constraint-based entry points (paper §3.2, Eqs. 5-8).

The solver moved to ``repro.core.policies.constraint`` (registered as the
``constraints`` and ``brute-force`` policies); the functions below are thin
deprecation shims kept for the pre-Planner API.  ``feasible_assignment`` is
re-exported unchanged (it is the fixed-n feasibility primitive, not a
scheduling scheme).

Migration:

    schedule_via_constraints(q)  -> Planner(policy="constraints").schedule(q)
    brute_force_optimal(q)       -> Planner(policy="brute-force").schedule(q)
                                    (or policies.constraint.brute_force_search
                                    for the raw (n, sizes) tuple)
"""
from __future__ import annotations

from typing import Optional, Tuple

from ._deprecation import warn_deprecated
from .policies.constraint import (  # canonical implementations
    brute_force_search,
    feasible_assignment,
    plan_via_constraints,
)
from .types import Query, Schedule

__all__ = [
    "brute_force_optimal",
    "feasible_assignment",
    "schedule_via_constraints",
]


def schedule_via_constraints(query: Query, max_batches: int = 512) -> Schedule:
    """Deprecated shim for the ``constraints`` policy."""
    warn_deprecated(
        "schedule_via_constraints()", 'Planner(policy="constraints")'
    )
    return plan_via_constraints(query, max_batches)


def brute_force_optimal(
    query: Query, max_batches: int = 4
) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """Deprecated shim for the ``brute-force`` policy / search."""
    warn_deprecated(
        "brute_force_optimal()",
        'Planner(policy="brute-force") or policies.constraint.brute_force_search()',
    )
    return brute_force_search(query, max_batches)
