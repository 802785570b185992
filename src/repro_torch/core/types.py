"""Core datatypes for intermittent-query scheduling.

Mirrors Table 1 of the paper (notation for query attributes). Times are floats
in *cost-model units* (the paper's experiments equate cost and time: "cost
refers to the total time required for processing the query", §1). Tuple counts
are ints.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# The ONE comparison tolerance for modelled time and tuple counts.
#
# Cost units == time units (§1) and both are O(1)-O(1e4) in every scenario the
# paper and the benchmarks exercise, so a single absolute epsilon serves all
# three historic uses: count-scale slop when inverting arrival rates
# (``ConstantRateArrival.tuples_available``), time-scale slop when bisecting
# arrival instants (``TraceArrival``), and decision-instant comparisons in the
# runtime loop.  A tuple that arrives exactly at instant t must count as
# available AT t: every comparison uses ``t + EPS`` / ``t - EPS`` in the
# direction that makes the boundary inclusive.
EPS = 1e-9

WINDOW_ID_SEP = "#w"  # per-window query ids: "<base_id>#w<index>"


class InfeasibleDeadline(Exception):
    """Raised when no batch schedule can meet the query deadline (§3.1)."""


class Strategy(enum.Enum):
    """Multi-query dispatch strategies (§4.2)."""

    LLF = "llf"
    EDF = "edf"
    SJF = "sjf"
    RR = "rr"


@dataclasses.dataclass(frozen=True)
class Batch:
    """One scheduled batch: process ``num_tuples`` starting at ``sched_time``."""

    sched_time: float
    num_tuples: int

    def __post_init__(self) -> None:
        if self.num_tuples < 0:
            raise ValueError(f"negative batch size {self.num_tuples}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Output of the single-query planners: Algorithm 1's (schPoints, schTuples)."""

    batches: Tuple[Batch, ...]

    @property
    def sch_points(self) -> List[float]:
        return [b.sched_time for b in self.batches]

    @property
    def sch_tuples(self) -> List[int]:
        return [b.num_tuples for b in self.batches]

    @property
    def num_batches(self) -> int:
        return len(self.batches)

    @property
    def total_tuples(self) -> int:
        return sum(b.num_tuples for b in self.batches)


@dataclasses.dataclass
class Query:
    """A deadline-bound intermittent query (Table 1).

    ``cost_model`` maps tuples->processing cost for one batch;
    ``arrival`` models the input stream rate (InputTime / tuples_available).

    ``stream``/``stream_offset`` place the query's window on a SHARED input
    stream: tuple ``i`` of this query is tuple ``stream_offset + i`` of
    stream ``stream``.  They are pure metadata until pane sharing is enabled
    (``repro.core.panes``): queries naming the same stream can then share
    pane partial aggregates across overlapping windows.  ``stream=None``
    (the default) means "private stream" — never shared.

    ``tier``/``shed`` are the overload-control knobs (``repro.core.overload``):
    ``tier`` is a STRICT priority tier (0 = highest) that the dynamic
    policies ALWAYS honor — they never run a ready tier-k query while a
    ready query with a smaller tier number exists; with every query on the
    default tier 0 (all ties) the ordering is byte-identical to the
    tierless runtime.  ``shed`` says whether this query's answer may be
    degraded to a uniformly sampled, scaled estimate under overload
    (``shed=False`` routes infeasible admissions to deadline renegotiation
    instead); it is inert until a session enables overload control AND the
    workload is actually infeasible.

    ``latency_target`` is a Cameo-style per-query RESPONSE latency target:
    the submitter wants the answer within ``latency_target`` time units of
    window close, possibly much tighter than the hard ``deadline``.  It is
    advisory, not a feasibility bound — dynamic policies order by the
    EFFECTIVE target instant ``target_time = min(deadline, wind_end +
    latency_target)`` within a tier (so a tight-target query wins ties
    against an equal-deadline one), and ``QueryOutcome`` reports whether
    the target was met.  With the default ``None`` the target instant IS
    the deadline and every ordering — and trace — is byte-identical to the
    targetless runtime.

    ``tenant`` names the principal the query belongs to
    (``repro.core.tenancy``): sessions configured with a ``TenancyConfig``
    arbitrate capacity ACROSS tenants with weighted max-min fairness and
    per-tenant quotas, sitting *above* the strict tiers — fairness decides
    how much capacity each tenant gets, tiers order queries within the
    tenant's share.  ``tenant=None`` (the default) keeps the query in the
    single-principal world of the paper: no tenancy machinery runs and
    every trace is byte-identical to the tenantless runtime.

    ``upstream`` declares a CASCADE dependency for session windows: the
    base id of another recurring spec in the same session whose windows
    produce this query's input (bronze→silver→gold rollups).  A session
    defers instantiating a window of this query until every upstream
    window covering its span has closed, and — when both name the same
    ``stream`` with pane sharing enabled — pre-subscribes the window's
    panes so the upstream windows' partials survive in the PaneStore for
    reuse.  Pure metadata outside sessions.
    """

    query_id: str
    wind_start: float
    wind_end: float
    deadline: float
    num_tuples_total: int
    cost_model: "CostModelBase"  # noqa: F821  (cost_model.py)
    arrival: "ArrivalModel"  # noqa: F821  (arrivals.py)
    # Optional distinct final-aggregation model; defaults to cost_model.agg_cost.
    submit_time: Optional[float] = None  # when the query enters the system (§4)
    stream: Optional[str] = None  # shared-stream name (pane sharing)
    stream_offset: int = 0  # window start as a global stream tuple index
    tier: int = 0  # strict priority tier (overload control; 0 = highest)
    shed: bool = True  # may this answer degrade to a sampled estimate?
    latency_target: Optional[float] = None  # desired answer latency past wind_end
    tenant: Optional[str] = None  # owning principal (multi-tenant arbitration)
    upstream: Optional[str] = None  # cascade: base id of the producing spec

    def __post_init__(self) -> None:
        if self.wind_end < self.wind_start:
            raise ValueError("wind_end < wind_start")
        if self.tier < 0:
            raise ValueError(f"tier must be >= 0, got {self.tier}")
        if self.latency_target is not None and self.latency_target < 0:
            raise ValueError(
                f"latency_target must be >= 0, got {self.latency_target}")
        if self.submit_time is None:
            self.submit_time = self.wind_start

    @property
    def min_comp_cost(self) -> float:
        """minCompCost: cost of processing all tuples in a single batch (Table 1)."""
        return self.cost_model.cost(self.num_tuples_total)

    @property
    def slack_time(self) -> float:
        """Eq. (2): slackTime = deadline - windEndTime - minCompCost."""
        return self.deadline - self.wind_end - self.min_comp_cost

    @property
    def target_time(self) -> float:
        """The instant the answer is WANTED by: ``wind_end +
        latency_target``, never later than the hard deadline; the deadline
        itself when no latency target is set."""
        if self.latency_target is None:
            return self.deadline
        return min(self.deadline, self.wind_end + self.latency_target)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Output of ``SchedulingPolicy.plan``: one static Schedule per query.

    For static policies this is the Algorithm-1/constraint plan verbatim; for
    dynamic policies it is the REALIZED batch sequence of a simulated run
    (dynamic scheduling decides at runtime — the Plan is its deterministic
    projection under the predicted arrival model).
    """

    schedules: Dict[str, Schedule]
    policy: str = ""

    def __getitem__(self, query_id: str) -> Schedule:
        return self.schedules[query_id]

    def __contains__(self, query_id: str) -> bool:
        return query_id in self.schedules

    @property
    def query_ids(self) -> List[str]:
        return list(self.schedules)

    @property
    def num_batches(self) -> int:
        return sum(s.num_batches for s in self.schedules.values())


@dataclasses.dataclass(frozen=True)
class PaneSpec:
    """One pane of a shared stream (pane/slice sharing for overlapping
    windows, after Li et al.'s panes and Cutty/Scotty slices).

    Streams are decomposed into fixed-width contiguous panes of
    ``num_tuples`` tuples; pane ``index`` covers global stream tuples
    ``[offset, offset + num_tuples)``.  When the pane width is the GCD of
    every subscribed query's window range and slide (in tuples), each
    query's window is an exact union of panes, so one pane partial
    aggregate — computed ONCE — serves every overlapping window at merge
    cost instead of scan cost (``repro.core.panes``).
    """

    stream: str
    index: int
    offset: int
    num_tuples: int

    def __post_init__(self) -> None:
        if self.num_tuples <= 0:
            raise ValueError(f"pane width must be positive, got {self.num_tuples}")
        if self.index < 0 or self.offset < 0:
            raise ValueError("pane index/offset must be non-negative")

    @property
    def end(self) -> int:
        """Global stream tuple index one past the pane's last tuple."""
        return self.offset + self.num_tuples

    @property
    def key(self) -> Tuple[str, int]:
        """Store key: (stream, pane index)."""
        return (self.stream, self.index)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """One shard of a logical batch, bound for one pool worker.

    ``worker`` names the target worker; ``None`` means "next earliest-free
    worker not yet claimed by an earlier shard of the same decision".
    """

    num_tuples: int
    worker: Optional[str] = None

    def __post_init__(self) -> None:
        if self.num_tuples <= 0:
            raise ValueError(f"shard size must be positive, got {self.num_tuples}")


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    """One dispatch decision of a dynamic policy (Algorithm 2's winner).

    Exactly one of the three forms:

    * run   — ``query_id`` set: run ``num_tuples`` of that query now;
    * wait  — ``wake_at`` set: nothing ready, idle until that instant;
    * stop  — neither set: no admissible work will ever become ready.

    Pool extensions (ignored by single-executor runs):

    * ``worker`` — dispatch the batch to this named ``ExecutorPool`` worker
      instead of the earliest-free one;
    * ``shards`` — split the logical batch into per-worker shards (sizes must
      sum to ``num_tuples``); each shard lands on its own worker and becomes
      its own offset-keyed partial, combined in ``finalize`` exactly like
      segagg partials.  Use ``repro.dist.sharding.batch_shard_extents`` to
      derive balanced shard sizes.
    """

    query_id: Optional[str] = None
    num_tuples: int = 0
    wake_at: Optional[float] = None
    worker: Optional[str] = None
    shards: Optional[Tuple[BatchShard, ...]] = None

    def __post_init__(self) -> None:
        if self.shards is not None:
            if self.worker is not None:
                raise ValueError("worker= and shards= are mutually exclusive")
            total = sum(s.num_tuples for s in self.shards)
            if total != self.num_tuples:
                raise ValueError(
                    f"shards sum to {total}, decision num_tuples is "
                    f"{self.num_tuples}"
                )

    @property
    def is_run(self) -> bool:
        return self.query_id is not None

    @property
    def is_wait(self) -> bool:
        return self.query_id is None and self.wake_at is not None

    @property
    def is_stop(self) -> bool:
        return self.query_id is None and self.wake_at is None


@dataclasses.dataclass(frozen=True)
class BatchExecution:
    """One executed batch in a trace (simulator / real executor).

    ``worker`` is the pool worker that ran the batch ("" outside a pool).
    It is excluded from equality: worker placement is an execution detail,
    so single-executor traces and W=1 pool traces compare identical.
    """

    query_id: str
    start: float
    end: float
    num_tuples: int
    kind: str = "batch"  # "batch" | "final_agg"
    worker: str = dataclasses.field(default="", compare=False)


@dataclasses.dataclass
class QueryOutcome:
    """Per-query result row.

    ``tuples_processed`` vs ``num_tuples_total`` records delivery: a truth
    arrival stream that under-delivers against the planned total leaves a
    shortfall, which used to be silently recorded as a normal completion.
    ``num_tuples_total < 0`` means "not recorded" (hand-built outcomes in the
    comparison harness); such outcomes report ``complete == True``.

    ``shed_fraction``/``error_bound`` record DELIBERATE degradation under
    overload control (``repro.core.overload``): the fraction of the window's
    tuples dropped by load shedding, and the reported relative error bound
    of the resulting scaled-sample aggregate estimate.  Both stay 0.0 — and
    the answer exact — whenever overload control never shed this query.
    Shed tuples are not a shortfall: the query completed, by design, on a
    uniform sample.

    ``latency_target``/``target_time`` mirror the query's Cameo-style
    response-latency target (``Query.latency_target``): ``target_time`` is
    the absolute instant the answer was wanted by and ``met_target`` the
    verdict against it.  Both stay ``None`` — and ``met_target`` reports
    the plain deadline verdict — for queries without a target.

    ``tenant`` carries the owning principal through to the trace so
    per-tenant SLO rollups (``repro.core.tenancy.tenant_summary``) need no
    side table; ``None`` for single-principal queries.
    """

    query_id: str
    completion_time: float
    deadline: float
    total_cost: float
    num_batches: int
    tuples_processed: int = -1
    num_tuples_total: int = -1
    shed_fraction: float = 0.0
    error_bound: float = 0.0
    latency_target: Optional[float] = None
    target_time: Optional[float] = None
    tenant: Optional[str] = None

    @property
    def met_deadline(self) -> bool:
        # Allow tiny float slop from accumulated arithmetic.
        return self.completion_time <= self.deadline + EPS

    @property
    def met_target(self) -> bool:
        """Completion against the latency-target instant (the deadline
        verdict when the query carried no target)."""
        if self.target_time is None:
            return self.met_deadline
        return self.completion_time <= self.target_time + EPS

    @property
    def shortfall(self) -> int:
        """Planned tuples that never arrived/processed (0 when complete)."""
        if self.num_tuples_total < 0 or self.tuples_processed < 0:
            return 0
        return max(self.num_tuples_total - self.tuples_processed, 0)

    @property
    def complete(self) -> bool:
        return self.shortfall == 0


@dataclasses.dataclass
class ExecutionTrace:
    executions: List[BatchExecution] = dataclasses.field(default_factory=list)
    outcomes: List[QueryOutcome] = dataclasses.field(default_factory=list)
    # query_ids of batches whose REAL execution exceeded C_max (straggler
    # re-queue events recorded by the shared runtime loop; empty in pure
    # simulation, where modelled batch costs respect C_max by construction).
    stragglers: List[str] = dataclasses.field(default_factory=list)
    # Pane-sharing bookkeeping (repro.core.panes.SharedBook) when the run
    # had sharing enabled; None otherwise.  Excluded from equality so shared
    # and unshared traces compare on the executions/outcomes alone.
    pane_book: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    @property
    def total_cost(self) -> float:
        return sum(e.end - e.start for e in self.executions)

    def outcome(self, query_id: str) -> QueryOutcome:
        for o in self.outcomes:
            if o.query_id == query_id:
                return o
        raise KeyError(query_id)

    @property
    def all_met(self) -> bool:
        return all(o.met_deadline for o in self.outcomes)


class QueryTable:
    """Struct-of-arrays snapshot of per-query scheduling quantities.

    Packs the fields the dynamic policies' priority math reads — tier,
    rr ticket, deadline, effective target instant, MinBatch, progress and
    the linear cost-model coefficients — into parallel numpy arrays so
    laxity / target-laxity / remaining-cost evaluate vectorized over the
    whole ready set at once (Eq. 9/10 math, one ufunc chain instead of
    n Python attribute walks).

    Packing is only defined for rows whose cost model is a plain
    ``LinearCostModel`` with a known total (``spec.total_known``);
    ``pack`` returns None otherwise and callers fall back to the
    per-query Python path.  Every arithmetic step mirrors
    ``QueryRuntime.remaining_cost``/``laxity``/``target_laxity``
    operation-for-operation, so the packed floats are bit-identical to the
    scalar ones — the property the heap/scan trace-parity gate rests on.
    """

    __slots__ = (
        "n", "tier", "rr_seq", "deadline", "target_time", "min_batch",
        "processed", "batches_done", "total", "tuple_cost", "overhead",
        "agg_per_batch", "agg_overhead",
    )

    @classmethod
    def pack(cls, runtimes: Sequence[object]) -> Optional["QueryTable"]:
        """SoA over ``runtimes`` (``QueryRuntime`` rows), or None when any
        row is ineligible for the vectorized path."""
        from .cost_model import LinearCostModel

        import numpy as np

        # ONE attribute walk per row (``rt.q`` is a property — touching it
        # 12 times per row dominated the packing cost), eligibility checked
        # in the same pass.  All values are exact in float64 (counts are
        # far below 2**53), so one 2-D conversion + int casts of the count
        # columns reproduces the per-field arrays bit for bit.
        rows = []
        for rt in runtimes:
            q = rt.q
            cm = q.cost_model
            if type(cm) is not LinearCostModel or not rt.spec.total_known:
                return None
            rows.append((
                q.tier, rt.rr_seq, q.deadline, q.target_time, rt.min_batch,
                rt.processed, rt.batches_done, q.num_tuples_total,
                cm.tuple_cost, cm.overhead, cm.agg_per_batch, cm.agg_overhead,
            ))
        t = cls()
        t.n = len(rows)
        arr = np.array(rows, dtype=np.float64).reshape(t.n, 12)
        t.tier = arr[:, 0].astype(np.int64)
        t.rr_seq = arr[:, 1].astype(np.int64)
        t.deadline = arr[:, 2]
        t.target_time = arr[:, 3]
        t.min_batch = arr[:, 4].astype(np.int64)
        t.processed = arr[:, 5].astype(np.int64)
        t.batches_done = arr[:, 6].astype(np.int64)
        t.total = arr[:, 7].astype(np.int64)
        t.tuple_cost = arr[:, 8]
        t.overhead = arr[:, 9]
        t.agg_per_batch = arr[:, 10]
        t.agg_overhead = arr[:, 11]
        return t

    def remaining_cost(self, now: float):
        """Vector twin of ``QueryRuntime.remaining_cost`` (FindMinCompCost):
        pending tuples in MinBatch chunks + final aggregation."""
        import numpy as np

        pend = np.maximum(self.total - self.processed, 0)
        mb = np.maximum(self.min_batch, 1)
        full = pend // mb
        rem = pend - full * mb
        # LinearCostModel.cost, with its n<=0 branches, evaluated elementwise
        cost_mb = np.where(
            self.min_batch > 0,
            self.min_batch * self.tuple_cost + self.overhead,
            np.where(self.min_batch == 0, self.overhead, 0.0),
        )
        c = full * cost_mb + np.where(
            rem > 0, rem * self.tuple_cost + self.overhead, 0.0)
        total_batches = self.batches_done + full + (rem > 0)
        agg = np.where(
            total_batches > 1,
            total_batches * self.agg_per_batch + self.agg_overhead, 0.0)
        return np.where(pend == 0, 0.0, c + agg)

    def laxity(self, now: float):
        """Eq. (10): deadline - now - remaining cost (vectorized)."""
        return self.deadline - now - self.remaining_cost(now)

    def target_laxity(self, now: float):
        """Laxity against the effective target instant (``target_time``)."""
        return self.laxity(now) - (self.deadline - self.target_time)


# ---------------------------------------------------------------------------
# Continuous sessions: recurring windows (the paper's Custom Query Scheduler
# runs continuously; each registered query's window RECURS with some period)
# ---------------------------------------------------------------------------


def window_query_id(base_id: str, window: int) -> str:
    """Id of window ``window`` of recurring query ``base_id``."""
    return f"{base_id}{WINDOW_ID_SEP}{window}"


def split_window_id(query_id: str) -> Tuple[str, Optional[int]]:
    """Inverse of ``window_query_id``; (query_id, None) for one-shot ids."""
    base, sep, tail = query_id.rpartition(WINDOW_ID_SEP)
    if sep and tail.isdigit():
        return base, int(tail)
    return query_id, None


@dataclasses.dataclass
class RecurringQuerySpec:
    """A recurring intermittent query: ``base``'s window repeated every
    ``period`` time units.

    ``base`` is window 0 verbatim (its window, arrival shape, cost model and
    deadline).  Window ``w`` covers ``[wind_start + w*period, wind_end +
    w*period)`` with the base arrival model time-shifted by ``w*period`` and
    deadline ``wind_end(w) + deadline_offset`` (defaulting to the base
    query's own deadline-to-window-end gap).  ``num_windows=None`` recurs
    open-endedly — the session instantiates windows lazily, so open-ended
    specs require a run horizon (``Session.run_until``).

    ``truth_factory(w)`` supplies the ACTUAL arrival process of window ``w``
    (already shifted to the window's absolute time frame); default: predicted
    == true.  ``true_cost_model`` injects cost drift in simulation: the
    executor charges it for this query's batches while planners keep seeing
    the (possibly calibrating) ``base.cost_model``.  ``delete_time`` /
    ``total_known`` carry the ``DynamicQuerySpec`` semantics through to every
    instantiated window (a scheduled deletion at an absolute instant; §4.4's
    unknown-total estimation).

    ``slide_tuples`` is the recurrence expressed in STREAM tuples: window
    ``w`` starts ``w * slide_tuples`` tuples after the base window on the
    shared stream named by ``base.stream`` (defaults to
    ``base.num_tuples_total``, i.e. tumbling windows).  A slide smaller than
    the window range makes consecutive windows overlap, which is exactly
    what pane sharing (``repro.core.panes``) exploits: pane partials
    computed for window ``w`` carry over to window ``w+1``.

    ``tenant`` is a convenience mirror of ``base.tenant`` (multi-tenant
    arbitration, ``repro.core.tenancy``): setting either stamps both, so
    every instantiated window carries the owning principal.  Conflicting
    non-None values raise.
    """

    base: Query
    period: float
    num_windows: Optional[int] = None
    deadline_offset: Optional[float] = None
    truth_factory: Optional[Callable[[int], "ArrivalModel"]] = None  # noqa: F821
    true_cost_model: Optional["CostModelBase"] = None  # noqa: F821
    num_groups: int = 0
    delete_time: Optional[float] = None
    total_known: bool = True
    slide_tuples: Optional[int] = None
    tenant: Optional[str] = None

    def __post_init__(self) -> None:
        if self.tenant is None:
            self.tenant = self.base.tenant
        elif self.base.tenant is None:
            self.base = dataclasses.replace(self.base, tenant=self.tenant)
        elif self.base.tenant != self.tenant:
            raise ValueError(
                f"{self.base.query_id}: spec tenant {self.tenant!r} conflicts "
                f"with base query tenant {self.base.tenant!r}")
        if self.period <= 0:
            raise ValueError(f"period must be positive, got {self.period}")
        if self.num_windows is not None and self.num_windows < 1:
            raise ValueError(f"num_windows must be >= 1, got {self.num_windows}")
        if self.deadline_offset is None:
            self.deadline_offset = self.base.deadline - self.base.wind_end
        if self.deadline_offset < 0:
            raise ValueError("deadline_offset must be >= 0 (deadline before "
                             "window end is never schedulable)")
        if self.slide_tuples is None:
            self.slide_tuples = self.base.num_tuples_total
        if self.slide_tuples < 0:
            raise ValueError("slide_tuples must be >= 0")

    @property
    def base_id(self) -> str:
        return self.base.query_id

    def window_start(self, window: int) -> float:
        return self.base.wind_start + window * self.period

    def window_query(self, window: int,
                     cost_model: Optional["CostModelBase"] = None) -> Query:  # noqa: F821
        """Instantiate window ``window`` as a one-shot Query (shifted arrival,
        per-window deadline, optional cost-model override)."""
        from .arrivals import ShiftedArrival  # lazy: arrivals is a sibling

        if self.num_windows is not None and window >= self.num_windows:
            raise IndexError(
                f"{self.base_id}: window {window} >= num_windows {self.num_windows}"
            )
        shift = window * self.period
        arr = self.base.arrival if shift == 0 else ShiftedArrival(
            base=self.base.arrival, shift=shift)
        # A single-window spec IS its base query: keep the base id, so a
        # session over one-shot submissions is trace-identical to the
        # one-shot runtime.  Recurring specs suffix every window.
        qid = (self.base_id if self.num_windows == 1
               else window_query_id(self.base_id, window))
        submit = (None if self.base.submit_time is None
                  else self.base.submit_time + shift)
        return Query(
            query_id=qid,
            wind_start=self.base.wind_start + shift,
            wind_end=self.base.wind_end + shift,
            deadline=self.base.wind_end + shift + self.deadline_offset,
            num_tuples_total=self.base.num_tuples_total,
            cost_model=self.base.cost_model if cost_model is None else cost_model,
            arrival=arr,
            submit_time=submit,
            stream=self.base.stream,
            stream_offset=self.base.stream_offset + window * self.slide_tuples,
            tier=self.base.tier,
            shed=self.base.shed,
            latency_target=self.base.latency_target,
            tenant=self.base.tenant,
            upstream=self.base.upstream,
        )

    def window_truth(self, window: int) -> Optional["ArrivalModel"]:  # noqa: F821
        return None if self.truth_factory is None else self.truth_factory(window)


@dataclasses.dataclass(frozen=True)
class SessionEvent:
    """One lifecycle event of a long-running session (admissions, window
    roll-overs, recalibrations) — the session-level analogue of a
    ``BatchExecution`` row."""

    kind: str   # "submit" | "reject" | "withdraw" | "window_open" |
    #             "window_close" | "recalibrate" | "shed" | "renegotiate" |
    #             "pane_incompatible" | "window_infeasible" |
    #             "forecast_shed" | "forecast_refund" | "pane_prewarm" |
    #             "quota" | "cascade_defer"
    time: float
    query_id: str = ""
    detail: str = ""


@dataclasses.dataclass
class SessionTrace(ExecutionTrace):
    """ExecutionTrace plus the session's own event log.  Per-window outcomes
    of one recurring query form a series (``outcome_series``)."""

    events: List[SessionEvent] = dataclasses.field(default_factory=list)

    def log(self, kind: str, time: float, query_id: str = "",
            detail: str = "") -> None:
        self.events.append(SessionEvent(kind, time, query_id, detail))

    def outcome_series(self, base_id: str) -> List[QueryOutcome]:
        """Outcomes of every window of ``base_id``, in window order."""
        rows = []
        for o in self.outcomes:
            base, w = split_window_id(o.query_id)
            if base == base_id:
                rows.append((0 if w is None else w, o))
        return [o for _, o in sorted(rows, key=lambda p: p[0])]

    def events_for(self, kind: str) -> List[SessionEvent]:
        return [e for e in self.events if e.kind == kind]
