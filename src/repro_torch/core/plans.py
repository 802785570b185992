"""Plan utilities: cost accounting and invariant checking for Schedules.

These are not scheduling schemes — every policy's output (a ``Schedule``)
can be priced with ``plan_cost`` and vetted with ``validate_schedule``
before execution.  They historically lived in ``repro.core.single_query``
(now a deprecation-shim module for the legacy ``schedule_*`` API); this is
their canonical home, so canonical code never has to import through a shim
module.
"""
from __future__ import annotations

from .types import EPS as _EPS, Query, Schedule


def plan_cost(query: Query, plan: Schedule) -> float:
    """Total computation cost of a plan = batch costs + final agg (Eq. 1/4)."""
    cm = query.cost_model
    c = sum(cm.cost(b.num_tuples) for b in plan.batches)
    if plan.num_batches > 1:
        c += cm.agg_cost(plan.num_batches)
    return c


def validate_schedule(query: Query, plan: Schedule) -> None:
    """Assert the plan's invariants (used by tests and before execution):

    * covers all tuples exactly once,
    * batch k starts only after its tuples have arrived,
    * batches do not overlap in time,
    * last batch (+ final agg) completes by the deadline.
    """
    cm, arr = query.cost_model, query.arrival
    if plan.total_tuples != query.num_tuples_total:
        raise AssertionError(
            f"plan covers {plan.total_tuples} != {query.num_tuples_total}"
        )
    done = 0
    prev_end = float("-inf")
    for b in plan.batches:
        done += b.num_tuples
        avail = arr.input_time(done)
        if b.sched_time < avail - _EPS:
            raise AssertionError(
                f"batch at {b.sched_time} needs tuple #{done} available {avail}"
            )
        if b.sched_time < prev_end - _EPS:
            raise AssertionError("overlapping batches")
        prev_end = b.sched_time + cm.cost(b.num_tuples)
    finish = prev_end + (cm.agg_cost(plan.num_batches) if plan.num_batches > 1 else 0.0)
    if finish > query.deadline + 1e-6:
        raise AssertionError(f"finish {finish} > deadline {query.deadline}")
