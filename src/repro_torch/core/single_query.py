"""Legacy single-query entry points (paper §3, Algorithm 1).

The algorithms moved to ``repro.core.policies.single`` (registered as the
``single`` / ``single-no-agg`` / ``single-agg`` policies) and the execution
loop to ``repro.core.runtime.execute_plan``; the ``schedule_*`` /
``execute_single`` functions below are thin deprecation shims kept for the
pre-Planner API.  ``plan_cost`` and ``validate_schedule`` moved to their
canonical home ``repro.core.plans`` and are re-exported here unchanged.

Migration:

    schedule_single(q)            -> Planner(policy="single").schedule(q)
    schedule_with_agg_cost(q)     -> Planner(policy="single-agg").schedule(q)
    schedule_without_agg_cost(q,d)-> Planner(policy="single-no-agg",
                                             deadline=d).schedule(q)
    execute_single(q, plan, truth)-> runtime.execute_plan(q, plan, truth=truth)
"""
from __future__ import annotations

from typing import Optional

from ._deprecation import warn_deprecated
from .plans import plan_cost, validate_schedule  # noqa: F401  (re-export)
from .policies.single import (  # canonical implementations
    plan_single,
    plan_with_agg_cost,
    plan_without_agg_cost,
)
from .types import ExecutionTrace, Query, Schedule


def schedule_without_agg_cost(query: Query, deadline: float) -> Schedule:
    """Deprecated shim for the ``single-no-agg`` policy."""
    warn_deprecated(
        "schedule_without_agg_cost()", 'Planner(policy="single-no-agg")'
    )
    return plan_without_agg_cost(query, deadline)


def schedule_with_agg_cost(query: Query) -> Schedule:
    """Deprecated shim for the ``single-agg`` policy."""
    warn_deprecated("schedule_with_agg_cost()", 'Planner(policy="single-agg")')
    return plan_with_agg_cost(query)


def schedule_single(query: Query) -> Schedule:
    """Deprecated shim for the ``single`` policy (Algorithm 1)."""
    warn_deprecated("schedule_single()", 'Planner(policy="single")')
    return plan_single(query)


def execute_single(
    query: Query, plan: Schedule, truth: Optional["ArrivalModel"] = None  # noqa: F821
) -> ExecutionTrace:
    """Deprecated shim for ``repro.core.runtime.execute_plan`` (Algorithm 1's
    execution loop, now shared by every executor)."""
    warn_deprecated("execute_single()", "repro.core.runtime.execute_plan()")
    from .runtime import execute_plan

    return execute_plan(query, plan, truth=truth)
