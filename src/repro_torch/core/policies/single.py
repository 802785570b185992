"""Single-query scheduling policies under static scenarios (paper §3,
Algorithm 1) — the canonical implementations (moved here from
``repro.core.single_query``, whose public functions are now deprecation
shims over these).

Backward construction (function ``ScheduleWithoutAggCost`` in the paper):

    last batch:   fills [windEnd, deadline'] — capacity there decides how many
                  tuples can wait for the end of the window.
    earlier ones: pending tuples get deadline = start of the batch scheduled
                  after them; input availability (InputTime) lower-bounds each
                  batch's start; recurse until all tuples are placed.

``ScheduleWithAggCost`` iterates the assumed batch count until the final-
aggregation allowance is consistent with the produced plan (Eq. (4)).

Works for ANY monotone cost model (closing remark of §3.1) — only
``cost``/``tuples_processable``/``agg_cost`` are used.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from ..api import register_policy, as_queries
from ..cost_model import CostModelBase
from ..types import Batch, InfeasibleDeadline, Plan, PolicyDecision, Query, Schedule

_MAX_BATCHES = 10_000  # guard against degenerate cost models
_EPS = 1e-9


# ---------------------------------------------------------------------------
# Algorithm implementations
# ---------------------------------------------------------------------------


def plan_without_agg_cost(query: Query, deadline: float) -> Schedule:
    """Backward-greedy optimal plan ignoring final-aggregation cost.

    Returns batches sorted by sched_time (earliest first).
    Raises InfeasibleDeadline if no plan exists under the cost/arrival models.
    """
    cm, arr = query.cost_model, query.arrival
    total = query.num_tuples_total
    if total == 0:
        return Schedule(batches=())

    # Uniform backward recursion.  The first iteration is the paper's "last
    # batch" (its availability bound input_time(N) IS the window end); later
    # iterations are the pre-window batches.  One deliberate repair over the
    # paper's §3.1 prose: every batch — including the last — starts AS LATE AS
    # POSSIBLE (time_pt - cost(k)), the same principle as the paper's Eq. (3)
    # for the single-batch case.  Anchoring the last batch at windowEnd, as
    # the prose states, discards the slack between windEnd + cost(k_last) and
    # the deadline; with per-batch overheads that slack can buy the
    # predecessor batch more room, and hypothesis found instances where the
    # as-stated greedy needs one batch more than the paper's own §3.2
    # constraint solver.  With late starts the two methods agree everywhere
    # we test (as the paper reports for its experiments).  The paper's worked
    # Cases 1-4 are unchanged: their last-batch capacity binds exactly.
    batches_rev: List[Batch] = []
    pending = total
    time_pt = deadline
    while pending > 0:
        if len(batches_rev) >= _MAX_BATCHES:
            raise InfeasibleDeadline(
                f"{query.query_id}: exceeded {_MAX_BATCHES} batches"
            )
        ip_avail = arr.input_time(pending)  # when the last pending tuple lands
        dur = time_pt - ip_avail
        n_proc = min(cm.tuples_processable(dur), pending)
        if n_proc <= 0:
            raise InfeasibleDeadline(
                f"{query.query_id}: cannot place {pending} tuples before "
                f"t={time_pt:.6g} (available only from t={ip_avail:.6g})"
            )
        # Run as late as possible: start = time_pt - cost(n_proc) >= ip_avail.
        start = time_pt - cm.cost(n_proc)
        batches_rev.append(Batch(sched_time=start, num_tuples=n_proc))
        pending -= n_proc
        time_pt = start

    return Schedule(batches=tuple(reversed(batches_rev)))


def plan_with_agg_cost(query: Query) -> Schedule:
    """Fix the (#batches <-> agg-cost) circularity (paper function
    ScheduleWithAggCost, Eq. (4)).

    Assume ``i`` batches, shift the effective deadline earlier by
    ``agg_cost(i)``, plan, and repeat with a larger allowance while the plan
    needs more batches than assumed.
    """
    cm = query.cost_model
    i = 1
    while i <= _MAX_BATCHES:
        eff_deadline = query.deadline - cm.agg_cost(i)
        plan = plan_without_agg_cost(query, eff_deadline)
        if plan.num_batches <= i:
            if plan.num_batches < i:
                # Tighten: fewer batches need less agg allowance; replanning
                # with the exact count can only extend the last-batch window.
                tight = plan_without_agg_cost(
                    query, query.deadline - cm.agg_cost(plan.num_batches)
                )
                if tight.num_batches <= plan.num_batches:
                    return tight
            return plan
        i = max(i + 1, plan.num_batches)
    raise InfeasibleDeadline(f"{query.query_id}: agg-cost iteration diverged")


def plan_single(query: Query) -> Schedule:
    """Algorithm 1's planning phase (ScheduleSingleMain, lines 1-8)."""
    if query.slack_time >= -_EPS:
        # Cases 1-2: one batch, started as late as completion-by-deadline allows.
        return Schedule(
            batches=(
                Batch(
                    sched_time=query.deadline - query.min_comp_cost,
                    num_tuples=query.num_tuples_total,
                ),
            )
        )
    return plan_with_agg_cost(query)


# ---------------------------------------------------------------------------
# Policy classes
# ---------------------------------------------------------------------------


class StaticPolicy:
    """Base for policies that compute a full per-query Plan up front."""

    kind = "static"
    name = "static"

    def plan(
        self,
        queries: Union[Query, Sequence[Query]],
        cost_model: Optional[CostModelBase] = None,
        now: float = 0.0,
    ) -> Plan:
        schedules = {}
        for q in as_queries(queries):
            if cost_model is not None:
                q = dataclasses.replace(q, cost_model=cost_model)
            schedules[q.query_id] = self.plan_query(q)
        return Plan(schedules=schedules, policy=self.name)

    def plan_query(self, query: Query) -> Schedule:
        raise NotImplementedError

    def replan(self, event, state) -> PolicyDecision:
        raise NotImplementedError(
            f"{self.name!r} is a static policy: it plans up front; the "
            "runtime executes its Plan with Algorithm 1's triggers"
        )


@register_policy("single")
class SingleQueryPolicy(StaticPolicy):
    """Algorithm 1 (ScheduleSingleMain): the paper's headline single-query
    scheme — slack test, then backward construction under Eq. (4)."""

    def plan_query(self, query: Query) -> Schedule:
        return plan_single(query)


@register_policy("single-no-agg")
class NoAggCostPolicy(StaticPolicy):
    """Backward construction ignoring final-aggregation cost
    (ScheduleWithoutAggCost).  ``deadline`` overrides the query's own
    deadline when given (the paper calls it with tightened deadlines)."""

    def __init__(self, deadline: Optional[float] = None):
        self.deadline = deadline

    def plan_query(self, query: Query) -> Schedule:
        d = query.deadline if self.deadline is None else self.deadline
        return plan_without_agg_cost(query, d)


@register_policy("single-agg")
class AggCostPolicy(StaticPolicy):
    """The Eq. (4) agg-cost fixpoint (ScheduleWithAggCost), without
    Algorithm 1's positive-slack shortcut."""

    def plan_query(self, query: Query) -> Schedule:
        return plan_with_agg_cost(query)
