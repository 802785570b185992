"""Constraint-based scheduling policies for LINEAR cost models (paper §3.2,
Eqs. 5-8) — canonical implementations (moved here from
``repro.core.constraints``, whose public functions are now deprecation
shims over these).

The paper formulates batch sizing as mixed-integer constraints and solves
them with Google OR-Tools, minimizing the number of batches (fewer batches
== less overhead == less cost under Eq. (1)).  OR-Tools is unavailable
offline, so this module solves the *same* constraint system exactly:

    (5)  sum_i x_i                         == N
    (6)  start_i + dur_i                   <= start_{i+1}        (no overlap)
    (7)  start_n + dur_n                   <= deadline
    (8)  rate * start_i                    >= sum_{j<=i} x_j     (availability)

For a fixed batch count ``n`` the system is a feasibility problem over the
x_i; because cost is affine and arrivals are (piecewise-)linear, the
*latest-start* assignment is extremal: computing it by backward substitution
over the constraint chain either yields a witness or proves infeasibility.
The ``constraints`` policy then takes the smallest feasible ``n`` — exactly
the OR-Tools objective.  The ``brute-force`` enumerator over integer
compositions is provided for cross-validation on small instances (tests
assert all three — Algorithm 1, this solver, brute force — agree, as §3.2
reports).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from ..api import register_policy
from ..cost_model import LinearCostModel
from ..types import Batch, InfeasibleDeadline, Query, Schedule
from .single import StaticPolicy

_EPS = 1e-9


def check_linear(query: Query) -> LinearCostModel:
    cm = query.cost_model
    if not isinstance(cm, LinearCostModel):
        raise TypeError(
            "constraint solver supports only LinearCostModel (paper §3.2); "
            "use Algorithm 1 (policy 'single') for arbitrary models"
        )
    return cm


def feasible_assignment(
    query: Query, n: int, deadline: Optional[float] = None
) -> Optional[Schedule]:
    """Latest-start witness for the Eq. (5)-(8) system with ``n`` batches,
    or None if the system is infeasible for this ``n``."""
    cm = check_linear(query)
    arr = query.arrival
    deadline = query.deadline if deadline is None else deadline
    if n > 1:
        deadline = deadline - cm.agg_cost(n)  # Eq. (4) allowance
    total = query.num_tuples_total

    # Backward substitution: batch i's deadline is start_{i+1} (constraint 6,
    # with start_{n+1} := deadline per constraint 7).  Constraint (8) says the
    # cumulative count through batch i — i.e. `pending` at this point of the
    # backward pass — must have arrived before batch i starts.  Maximizing
    # each batch's size is extremal for feasibility (exchange argument ==
    # the paper's §3.1 optimality proof), so greedy-max yields a witness iff
    # the system is feasible.
    sizes_rev: List[int] = []
    starts_rev: List[float] = []
    time_pt = deadline
    pending = total
    for i in range(n, 0, -1):
        if pending == 0:
            break
        avail = arr.input_time(pending)
        k = min(cm.tuples_processable(time_pt - avail), pending)
        if i == 1 and k < pending:
            return None  # the first batch must absorb everything left
        if k <= 0:
            return None
        start = time_pt - cm.cost(k)  # latest start; >= avail by construction
        if start < avail - _EPS:
            return None
        sizes_rev.append(k)
        starts_rev.append(start)
        pending -= k
        time_pt = start
    if pending > 0:
        return None
    batches = tuple(
        Batch(sched_time=s, num_tuples=x)
        for s, x in sorted(zip(starts_rev, sizes_rev))
    )
    return Schedule(batches=batches)


def plan_via_constraints(query: Query, max_batches: int = 512) -> Schedule:
    """Smallest-``n`` feasible solution of Eqs. (5)-(8) (the OR-Tools
    objective)."""
    check_linear(query)
    for n in range(1, max_batches + 1):
        plan = feasible_assignment(query, n)
        if plan is not None:
            return plan
    raise InfeasibleDeadline(
        f"{query.query_id}: no feasible plan with <= {max_batches} batches"
    )


def brute_force_search(
    query: Query, max_batches: int = 4
) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """Exhaustive ground truth for SMALL instances (tests only).

    Enumerates integer compositions of N into 1..max_batches parts, checks
    Eqs. (5)-(8) directly (with latest-feasible starts), and returns
    (min_num_batches, sizes) or None.
    """
    cm = check_linear(query)
    arr = query.arrival
    total = query.num_tuples_total
    for n in range(1, max_batches + 1):
        deadline = query.deadline - (cm.agg_cost(n) if n > 1 else 0.0)
        for cut in itertools.combinations(range(1, total), n - 1):
            sizes = [b - a for a, b in zip((0,) + cut, cut + (total,))]
            # Latest-start backward check of (6)-(8); (5) holds by
            # construction of the composition.  input_time(N) == wind_end, so
            # the last batch's availability bound is the window end.
            time_pt, done, ok = deadline, total, True
            for i in range(n - 1, -1, -1):
                start = time_pt - cm.cost(sizes[i])
                if start < arr.input_time(done) - _EPS:
                    ok = False
                    break
                time_pt, done = start, done - sizes[i]
            if ok:
                return n, tuple(sizes)
    return None


# ---------------------------------------------------------------------------
# Policy classes
# ---------------------------------------------------------------------------


@register_policy("constraints")
class ConstraintPolicy(StaticPolicy):
    """Smallest-n feasibility of the §3.2 constraint system (linear models)."""

    def __init__(self, max_batches: int = 512):
        self.max_batches = max_batches

    def plan_query(self, query: Query) -> Schedule:
        return plan_via_constraints(query, self.max_batches)


@register_policy("brute-force")
class BruteForcePolicy(StaticPolicy):
    """Exhaustive composition enumeration with latest-feasible starts.

    Exponential — ground truth for small instances only."""

    def __init__(self, max_batches: int = 4):
        self.max_batches = max_batches

    def plan_query(self, query: Query) -> Schedule:
        found = brute_force_search(query, self.max_batches)
        if found is None:
            raise InfeasibleDeadline(
                f"{query.query_id}: no feasible composition with "
                f"<= {self.max_batches} batches"
            )
        n, sizes = found
        cm = query.cost_model
        deadline = query.deadline - (cm.agg_cost(n) if n > 1 else 0.0)
        # Latest-start witness for the winning composition (same backward
        # pass the checker used to prove it feasible).
        starts: List[float] = []
        time_pt = deadline
        for size in reversed(sizes):
            time_pt -= cm.cost(size)
            starts.append(time_pt)
        starts.reverse()
        return Schedule(
            batches=tuple(
                Batch(sched_time=s, num_tuples=x)
                for s, x in zip(starts, sizes)
            )
        )
