"""Dynamic multi-query scheduling policies (paper §4, Algorithm 2).

Non-idling, non-preemptive (NINP) time-shared executor: whenever the
executor is free, every active query whose MinBatch is ready (or which is
past its estimated readiness time — §4.4 jitter handling) competes under the
chosen strategy (LLF / EDF / SJF / RR); the winner runs ONE MinBatch to
completion.  Batch cost is bounded by C_max at MinBatch-sizing time, which
bounds the blocking period any newly arrived urgent query can suffer
(§4.2-4.3).

The event loop itself lives in ``repro.core.runtime`` (shared with the
static policies and every executor); these classes contribute exactly the
paper's per-decision-instant logic: MinBatch sizing at admission (§4.1,
Eq. 9) and the strategy's priority order (§4.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

from ..api import SchedulingEvent, as_queries, register_policy
from ..cost_model import CostModelBase
from ..minbatch import find_min_batch_size
from ..types import (
    Batch,
    BatchShard,
    Plan,
    PolicyDecision,
    Query,
    QueryTable,
    Schedule,
    Strategy,
)

# Ready sets smaller than this aren't worth the numpy packing overhead
# (measured crossover ~64 rows — see benchmarks/bench_scheduler_overhead);
# the winner is identical either way (see ``DynamicPolicy.select``).
_VECTOR_MIN = 64


def make_shards(
    state: "RuntimeState", take: int, ways: int, now: float  # noqa: F821
) -> Tuple[BatchShard, ...]:
    """Split ``take`` tuples into up to ``ways`` shards for one dispatch.

    Homogeneous pools (the default — every ``worker_weights`` entry equal,
    or no weights reported) get unnamed, evenly balanced shards via
    ``batch_shard_extents``; the loop assigns workers earliest-free, which
    keeps pre-refactor traces byte-identical.

    Heterogeneous pools (per-device calibration found real speed skew —
    ``repro.dist.mesh.MeshBackend`` reports measured throughput ratios) get
    NAMED shards cut by ``weighted_shard_extents`` so every worker finishes
    its shard at the same instant: the ``ways`` earliest-free workers are
    claimed in the loop's own (clock, declaration order) tie-break, then
    each gets tuples in proportion to its weight.  Zero-sized assignments
    (a worker far slower than its peers) are dropped."""
    weights = state.worker_weights
    if (
        len(weights) == len(state.worker_names)
        and len(weights) == len(state.worker_clocks)
        and len(set(weights)) > 1
    ):
        from ...dist.sharding import weighted_shard_extents

        order = sorted(
            range(len(state.worker_names)),
            key=lambda i: (state.worker_clocks[i], i),
        )[:ways]
        extents = weighted_shard_extents(take, [weights[i] for i in order])
        return tuple(
            BatchShard(num_tuples=size, worker=state.worker_names[i])
            for i, (_, size) in zip(order, extents)
            if size > 0
        )
    from ...dist.sharding import batch_shard_extents

    return tuple(
        BatchShard(num_tuples=size)
        for _, size in batch_shard_extents(take, ways)
    )


class DynamicPolicy:
    """Base for Algorithm-2 policies; subclasses fix the strategy order.

    ``shard_across=k`` (pool runs only) splits each winner's MinBatch into
    up to ``k`` per-worker shards (balanced via
    ``repro.dist.sharding.batch_shard_extents``), trading the extra
    per-batch overhead and final-aggregation partials for parallel wall
    time.  Only workers actually FREE at the decision instant
    (``state.free_workers(now)``) count toward the split — sharding onto a
    busy worker would serialize behind its running batch and finish LATER
    than not sharding.  With one (free) worker — or ``shard_across=1``, the
    default — decisions are exactly Algorithm 2's.
    """

    kind = "dynamic"
    name = "dynamic"
    strategy: Strategy

    def __init__(
        self,
        delta_rsf: float = 0.5,
        c_max: float = 30.0,
        shard_across: int = 1,
    ):
        if shard_across < 1:
            raise ValueError(f"shard_across must be >= 1, got {shard_across}")
        self.delta_rsf = delta_rsf
        self.c_max = c_max
        self.shard_across = shard_across

    # -- runtime hooks ---------------------------------------------------
    def on_admit(self, rt: "QueryRuntime", now: float) -> None:  # noqa: F821
        """FindMinBatchSize at admission (§4.1): Eq.-9 cost bound, C_max
        blocking cap, GROUP-BY floor.  The loop follows up with an
        ``"admission"`` SchedulingEvent at the same decision instant.

        Under pane sharing (the query's cost model is a ``SharedCostModel``)
        the MinBatch is additionally aligned to the stream's pane width, so
        dispatched batches are PANE batches — computed once and fanned out
        to every subscribed query — rather than arbitrary fragments."""
        rt.min_batch = self._pane_align(rt, find_min_batch_size(
            rt.est_total(now) or 1,
            rt.q.cost_model,
            self.delta_rsf,
            self.c_max,
            rt.spec.num_groups,
        ))

    def _pane_align(self, rt: "QueryRuntime", min_batch: int) -> int:  # noqa: F821
        """Round a MinBatch to the shared stream's pane grid.  Rounding UP
        preserves the Eq.-9 cost bound just computed (batched cost is
        non-increasing in batch size), so prefer the next multiple whenever
        it still respects C_max; only when C_max forbids the larger batch
        round DOWN (C_max has precedence over Eq. 9, exactly like the cap
        in ``find_min_batch_size``).  No-op for unshared queries (no
        ``pane_tuples`` on the cost model)."""
        cm = rt.q.cost_model
        pane = getattr(cm, "pane_tuples", 0)
        if not pane or pane <= 1:
            return min_batch
        total = max(rt.q.num_tuples_total, 1)
        up = -(-min_batch // pane) * pane  # ceil to the pane grid
        if cm.cost(min(up, total)) <= self.c_max + 1e-9:
            min_batch = up
        elif min_batch >= pane:
            min_batch = (min_batch // pane) * pane
        # else: even one pane blows C_max — keep the sub-pane MinBatch
        # (fragment batches share less but never violate the blocking bound)
        return max(1, min(min_batch, total))

    def on_withdraw(self, rt: "QueryRuntime", now: float) -> None:  # noqa: F821
        """Query deleted mid-run (§4: "queries may be added or removed at
        any point").  Nothing to unwind for Algorithm 2 — MinBatch state
        dies with the runtime — but custom policies with cross-query state
        override this."""

    def on_recalibrate(self, rt: "QueryRuntime", now: float) -> None:  # noqa: F821
        """Cost-model recalibration (a session detected drift and refitted,
        or a sharer left the stream and the amortized cost jumped): re-run
        MinBatch sizing so future batches of ``rt`` reflect the corrected
        costs.  Only affects batch SIZING going forward — the NINP invariant
        is untouched."""
        self.on_admit(rt, now)

    def on_shed(self, rt: "QueryRuntime", now: float) -> None:  # noqa: F821
        """Load shedding thinned ``rt``'s remaining stream
        (``repro.core.overload``): re-run MinBatch sizing against the new —
        smaller — total so batch sizes track the shed workload (Eq. 9 is
        relative to the single-batch cost of what will actually run)."""
        self.on_admit(rt, now)

    def priority(self, rt: "QueryRuntime", now: float) -> Tuple:  # noqa: F821
        """Sort key among ready queries; smallest wins the executor."""
        raise NotImplementedError

    def select(
        self, ready: Sequence["QueryRuntime"], now: float  # noqa: F821
    ) -> "QueryRuntime":  # noqa: F821
        """The winner among ``ready``: strict tiers, then the strategy's
        priority order.  Equal-key ties resolve to the earliest entry of
        ``ready`` — which the runtime cores pass in runtime-state order, so
        this equals the head of the old stable full sort.

        Large ready sets whose rows all carry a plain ``LinearCostModel``
        evaluate the priority math vectorized over a packed ``QueryTable``
        (argsort-based ordering); everything else — small sets, calibrating
        or shared or piecewise cost models, custom ``priority`` overrides —
        takes the per-query Python keys.  Both paths pick the same winner
        (the parity tests pin this)."""
        if len(ready) >= _VECTOR_MIN:
            i = _vector_select(self, ready, now)
            if i is not None:
                return ready[i]
        return min(ready, key=lambda r: (r.q.tier, *self.priority(r, now)))

    def replan(self, event: SchedulingEvent, state: "RuntimeState") -> PolicyDecision:  # noqa: F821
        """Algorithm 2's decision instant: pick the ready winner, or report
        when readiness can next change, or stop.

        Priority tiers (``Query.tier``, overload control) are STRICT: a
        ready query of a lower tier number always wins over any higher
        tier; the strategy's own order applies within a tier.  With every
        query on the default tier 0 the ordering — hence the trace — is
        byte-identical to the tierless sort.

        Cameo-style latency targets (``Query.latency_target``) slot into
        the strategy order WITHIN a tier: the deadline-flavoured key
        components use the effective target instant (``Query.target_time``)
        and target laxity instead of the raw deadline/laxity, so a query
        whose answer is wanted early outranks an equal-deadline peer.  For
        target-free queries both collapse to the deadline quantities —
        all-``None`` workloads sort, and trace, byte-identically.
        """
        now = event.now
        ready = [r for r in state.active() if r.ready(now)]
        if not ready:
            nxt = min(
                (r.next_ready_time(now) for r in state.unfinished()),
                default=math.inf,
            )
            if not math.isfinite(nxt):
                return PolicyDecision()  # stop: nothing will ever be ready
            return PolicyDecision(wake_at=nxt)
        rt = self.select(ready, now)
        take = min(rt.avail(now), rt.min_batch)
        ways = min(self.shard_across, state.free_workers(now), take)
        if ways > 1:
            return PolicyDecision(
                query_id=rt.q.query_id, num_tuples=take,
                shards=make_shards(state, take, ways, now),
            )
        return PolicyDecision(query_id=rt.q.query_id, num_tuples=take)

    # -- static projection ----------------------------------------------
    def plan(
        self,
        queries: Union[Query, Sequence[Query]],
        cost_model: Optional[CostModelBase] = None,
        now: float = 0.0,
    ) -> Plan:
        """Deterministic projection of the dynamic run under the PREDICTED
        arrival models: simulate and return the realized batches per query.

        Dynamic scheduling decides at runtime, so a static Plan only exists
        relative to an arrival assumption — this uses each query's own
        predicted model (truth == prediction), which is also what parity
        with the legacy ``schedule_dynamic`` means.
        """
        from ..runtime import DynamicQuerySpec, SimulatedExecutor, run

        qs = as_queries(queries)
        if cost_model is not None:
            qs = [dataclasses.replace(q, cost_model=cost_model) for q in qs]
        trace = run(self, [DynamicQuerySpec(query=q) for q in qs],
                    SimulatedExecutor())
        schedules = {
            q.query_id: Schedule(
                batches=tuple(
                    Batch(sched_time=e.start, num_tuples=e.num_tuples)
                    for e in trace.executions
                    if e.query_id == q.query_id and e.kind == "batch"
                )
            )
            for q in qs
        }
        return Plan(schedules=schedules, policy=self.name)


@register_policy("llf-dynamic")
class LLFPolicy(DynamicPolicy):
    """Least laxity first (Eq. 10) — the paper's preferred strategy.

    Laxity is measured to the EFFECTIVE target instant (deadline, tightened
    by any ``latency_target``), so latency-targeted queries gain urgency
    exactly by how much earlier their answer is wanted."""

    strategy = Strategy.LLF

    def priority(self, rt, now):
        return (rt.target_laxity(now), rt.q.target_time, rt.rr_seq)


@register_policy("edf-dynamic")
class EDFPolicy(DynamicPolicy):
    """Earliest deadline first (earliest effective TARGET first when
    latency targets are in play)."""

    strategy = Strategy.EDF

    def priority(self, rt, now):
        return (rt.q.target_time, rt.target_laxity(now), rt.rr_seq)


@register_policy("sjf-dynamic")
class SJFPolicy(DynamicPolicy):
    """Shortest (remaining) job first."""

    strategy = Strategy.SJF

    def priority(self, rt, now):
        return (rt.remaining_cost(now), rt.q.target_time, rt.rr_seq)


@register_policy("rr-dynamic")
class RRPolicy(DynamicPolicy):
    """Round-robin over ready queries (FIFO tickets, rotate-on-run)."""

    strategy = Strategy.RR

    def priority(self, rt, now):
        return (rt.rr_seq,)


# Per-strategy lexsort keys over a packed ``QueryTable``.  numpy's lexsort
# orders by the LAST key first, so each tuple lists the Python priority-key
# components reversed, with the strict tier appended as the primary key —
# exactly ``(tier, *priority)``.  Keyed by the (unbound) ``priority``
# function: a subclass overriding ``priority`` drops out of the map and
# falls back to the Python path automatically.
_VECTOR_PRIORITIES = {
    LLFPolicy.priority:
        lambda t, now: (t.rr_seq, t.target_time, t.target_laxity(now)),
    EDFPolicy.priority:
        lambda t, now: (t.rr_seq, t.target_laxity(now), t.target_time),
    SJFPolicy.priority:
        lambda t, now: (t.rr_seq, t.target_time, t.remaining_cost(now)),
    RRPolicy.priority:
        lambda t, now: (t.rr_seq,),
}


def _vector_select(
    policy: DynamicPolicy, ready: Sequence["QueryRuntime"], now: float  # noqa: F821
) -> Optional[int]:
    """Index of the winner via packed-array lexsort, or None to fall back
    (unknown priority override, or a row the ``QueryTable`` can't pack)."""
    keys_for = _VECTOR_PRIORITIES.get(type(policy).priority)
    if keys_for is None:
        return None
    table = QueryTable.pack(ready)
    if table is None:
        return None
    import numpy as np

    order = np.lexsort(keys_for(table, now) + (table.tier,))
    return int(order[0])


def policy_for_strategy(
    strategy: Strategy, delta_rsf: float = 0.5, c_max: float = 30.0
) -> DynamicPolicy:
    """The registered dynamic policy implementing ``strategy``."""
    from ..api import get_policy

    return get_policy(
        f"{strategy.value}-dynamic", delta_rsf=delta_rsf, c_max=c_max
    )
