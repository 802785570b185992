"""Discrete-event comparison harness (paper §7 experiments).

Implements the baselines the paper compares against, in the same cost-model
time units the paper's figures use:

* ``micro_batch_trace``  — Spark-streaming analogue: a batch every ``interval``
                           time units over the window (Fig 5's batch intervals;
                           ``interval -> 0`` degenerates to tuple-by-tuple).
* ``one_shot_trace``     — Spark "trigger once": everything in one batch at
                           window end, regardless of the deadline (Fig 5 /
                           Table 2's OneShot row).
* ``batched_cost_curve`` — cost as a function of the number of batches
                           (Fig 4's normalized curves).
* ``MemoryModel``        — resident-set accounting that reproduces the paper's
                           out-of-memory observations for streaming joins
                           (§7.2: Q10 OOMs at window 4500s in streaming mode,
                           succeeds in batch mode).
* ``staggered_deadlines``— the §7.4 multi-query workload generator (delta-
                           staggered deadlines over a shared window).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from .types import BatchExecution, ExecutionTrace, Query, QueryOutcome


def micro_batch_trace(query: Query, interval: float) -> ExecutionTrace:
    """Process arrivals every ``interval`` time units (eager streaming).

    Each trigger processes whatever arrived since the last trigger; the final
    aggregation combines all micro-batch partials.  Triggers that find no new
    tuples are skipped (Spark schedules-but-noops them; their overhead is
    negligible next to non-empty batches and charging it would only flatter
    our method).
    """
    arr, cm = query.arrival, query.cost_model
    trace = ExecutionTrace()
    t = query.wind_start + interval
    processed = 0
    nb = 0
    now = None
    while processed < query.num_tuples_total:
        t = min(t, arr.wind_end)
        avail = arr.tuples_available(t) - processed
        start = t if now is None else max(t, now)
        if avail > 0:
            c = cm.cost(avail)
            trace.executions.append(
                BatchExecution(query.query_id, start, start + c, avail)
            )
            now = start + c
            processed += avail
            nb += 1
        if t >= arr.wind_end and processed >= query.num_tuples_total:
            break
        t += interval
    agg = cm.agg_cost(nb) if nb > 1 else 0.0
    if agg and now is not None:
        trace.executions.append(
            BatchExecution(query.query_id, now, now + agg, 0, kind="final_agg")
        )
        now += agg
    trace.outcomes.append(
        QueryOutcome(
            query_id=query.query_id,
            completion_time=now if now is not None else query.wind_start,
            deadline=query.deadline,
            total_cost=trace.total_cost,
            num_batches=nb,
        )
    )
    return trace


def one_shot_trace(query: Query) -> ExecutionTrace:
    """Everything in one batch at window end (Spark trigger-once)."""
    cm = query.cost_model
    c = cm.cost(query.num_tuples_total)
    trace = ExecutionTrace()
    trace.executions.append(
        BatchExecution(query.query_id, query.wind_end, query.wind_end + c,
                       query.num_tuples_total)
    )
    trace.outcomes.append(
        QueryOutcome(
            query_id=query.query_id,
            completion_time=query.wind_end + c,
            deadline=query.deadline,
            total_cost=c,
            num_batches=1,
        )
    )
    return trace


def batched_cost_curve(
    query: Query, batch_counts: Sequence[int]
) -> List[Tuple[int, float, float]]:
    """Fig 4: (num_batches, cost, cost normalised to single-batch baseline).

    Tuples are split as evenly as the count allows (the paper splits its 4500
    files into equal batches).
    """
    cm = query.cost_model
    base = cm.cost(query.num_tuples_total)
    out = []
    for nb in batch_counts:
        nb = max(1, min(nb, query.num_tuples_total))
        size = query.num_tuples_total // nb
        rem = query.num_tuples_total - size * nb
        c = sum(cm.cost(size + (1 if i < rem else 0)) for i in range(nb))
        if nb > 1:
            c += cm.agg_cost(nb)
        out.append((nb, c, c / base))
    return out


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Resident-set model for the §7.2 OOM analysis.

    Streaming mode must keep the whole in-flight window RESIDENT (Spark
    holds the input relations of a stream-stream join in executor memory —
    the state cannot spill), so its peak grows with the window and OOMs.
    Batch mode runs offline operators that SPILL (sort-merge/shuffle to
    disk; host buffers in our TPU executor): its resident set is bounded by
    the executor's working budget no matter the batch size — "allowing the
    use of algorithms that do not require the entire data to be memory
    resident" (paper §1).  That asymmetry is the paper's whole memory
    argument.
    """

    bytes_per_tuple: float
    capacity_bytes: float
    partial_bytes_per_batch: float = 0.0
    working_budget_frac: float = 0.8   # batch operators spill beyond this

    def streaming_peak(self, window_tuples: int) -> float:
        return window_tuples * self.bytes_per_tuple

    def batch_peak(self, max_batch_tuples: int, num_batches: int) -> float:
        resident = min(max_batch_tuples * self.bytes_per_tuple,
                       self.working_budget_frac * self.capacity_bytes)
        return resident + num_batches * self.partial_bytes_per_batch

    def streaming_oom(self, window_tuples: int) -> bool:
        return self.streaming_peak(window_tuples) > self.capacity_bytes

    def batch_oom(self, max_batch_tuples: int, num_batches: int) -> bool:
        return self.batch_peak(max_batch_tuples, num_batches) > self.capacity_bytes


def staggered_deadlines(
    queries: Sequence[Query],
    delta: float,
    c_max: float,
    seed: int = 0,
) -> List[Query]:
    """§7.4 workload generator: deadlines staggered so overlapping queries
    leave each other room::

        deadline_1 = windEnd_1 + delta * compCost_1 + C_max
        deadline_i = windEnd_i + delta * compCost_i + C_max      if windEnd_i > deadline_{i-1}
                     deadline_{i-1} + delta * compCost_i         otherwise

    ``delta`` scales slack (the paper sweeps 1.0 down to 0.1).  The first
    query is chosen by ``seed`` (the paper picks it randomly).
    """
    import dataclasses as _dc
    import random

    qs = list(queries)
    rng = random.Random(seed)
    rng.shuffle(qs)
    out: List[Query] = []
    prev_deadline: Optional[float] = None
    for q in qs:
        c1 = q.cost_model.cost(q.num_tuples_total)
        if prev_deadline is None or q.wind_end > prev_deadline:
            d = q.wind_end + delta * c1 + c_max
        else:
            d = prev_deadline + delta * c1
        out.append(_dc.replace(q, deadline=d))
        prev_deadline = d
    return out
