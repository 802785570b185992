"""The ONE runtime loop shared by every executor (simulator, JAX analytics,
serving engine).

Before this module, the plan->execute->finalize loop existed three times
with drift: ``core.single_query.execute_single`` (Algorithm 1's trigger
loop), ``core.multi_query.schedule_dynamic`` (Algorithm 2's NINP loop) and
ad-hoc copies in ``repro.serve.analytics``/``repro.serve.engine``.  Now:

* ``run(policy, workload, executor)``   — the loop.  Static policies plan up
  front and execute per query with Algorithm 1's triggers; dynamic policies
  are consulted at every decision instant (``policy.replan``).  The loop —
  not the policy, not the executor — owns deadline checking (QueryOutcome
  recording), C_max straggler re-queue and trace recording.
* ``execute_plan(query, plan, executor)`` — one query's plan against a
  (possibly divergent) true arrival process.  ``strict=False`` is
  Algorithm 1's adaptive while-loop (trigger a batch when its tuple count is
  ready OR its scheduled instant has passed, then process whatever is
  there); ``strict=True`` replays the planned batches verbatim (real
  backends applying a vetted plan to materialized inputs).
* ``BaseExecutor`` / ``SimulatedExecutor`` — the modelled-clock backend.
  Real executors subclass ``BaseExecutor`` and override ``_execute`` /
  ``_finalize`` to do physical work; the MODELLED clock (cost units == time
  units, §7) stays identical across backends, which is what makes traces
  comparable across the simulator and real executors.
* ``ExecutorPool`` — W parallel workers over ONE physical backend.  Each
  worker keeps its own modelled clock (the instant it next frees); the
  pool's ``clock()`` is the earliest-free instant, so decision instants
  fire whenever ANY worker frees and the NINP invariant (one running batch,
  never preempted) holds PER WORKER.  Physical work still flows through the
  single backend, whose offset-keyed partials/results make shard dispatch
  and straggler re-queue idempotent regardless of worker placement.  With
  ``workers=1`` the pool is trace-identical to the bare executor.

Time semantics match the paper's experiments exactly: the executor clock is
the modelled time; real wall seconds are recorded per query on the executor
(``wall_seconds``) and only feed straggler detection (a real batch slower
than C_max is re-queued once — idempotent inputs — and flagged in
``trace.stragglers``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

from .api import Executor, SchedulingEvent, SchedulingPolicy
from .arrivals import ArrivalModel
from .cost_model import CostModelBase
from .types import (
    EPS,
    BatchExecution,
    ExecutionTrace,
    PolicyDecision,
    Query,
    QueryOutcome,
    Schedule,
    split_window_id,
)

_EPS = EPS  # the one shared tolerance (see types.EPS)
LARGE_NUMBER = 1e18  # Algorithm 2's sentinel for "not ready"


# ---------------------------------------------------------------------------
# Workload specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DynamicQuerySpec:
    """One query as submitted to the runtime.

    ``truth`` is the actual arrival process; planners only ever consult
    ``query.arrival`` (the predicted model).  ``delete_time`` models §4's
    "queries may be added or removed at any point".

    ``shed_fraction``/``error_bound`` record that overload control
    (``repro.core.overload``) thinned this query's stream before/while it
    ran; the loop stamps them onto the ``QueryOutcome`` so degraded answers
    are visibly estimates, not silent truncations.
    """

    query: Query
    truth: Optional[ArrivalModel] = None
    delete_time: Optional[float] = None
    num_groups: int = 0
    total_known: bool = True
    shed_fraction: float = 0.0
    error_bound: float = 0.0

    def __post_init__(self) -> None:
        if self.truth is None:
            self.truth = self.query.arrival


Workload = Sequence[Union[Query, DynamicQuerySpec]]


def as_specs(workload: Union[Query, DynamicQuerySpec, Workload]) -> List[DynamicQuerySpec]:
    if isinstance(workload, (Query, DynamicQuerySpec)):
        workload = [workload]
    return [
        w if isinstance(w, DynamicQuerySpec) else DynamicQuerySpec(query=w)
        for w in workload
    ]


# ---------------------------------------------------------------------------
# Per-query runtime state (Algorithm 2's bookkeeping)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryRuntime:
    spec: DynamicQuerySpec
    min_batch: int = 0
    processed: int = 0
    batches_done: int = 0
    admitted: bool = False
    deleted: bool = False
    completed: bool = False
    rr_seq: int = 0  # FIFO ticket for round-robin

    @property
    def q(self) -> Query:
        return self.spec.query

    def est_total(self, now: float) -> int:
        """Total tuples: known, or estimated from the observed rate (§4.4)."""
        if self.spec.total_known:
            return self.q.num_tuples_total
        seen = self.spec.truth.tuples_available(now)
        span = max(now - self.q.wind_start, _EPS)
        window = max(self.q.wind_end - self.q.wind_start, _EPS)
        if now >= self.q.wind_end:
            return seen
        return max(seen, int(math.ceil(seen / span * window)))

    def pending(self, now: float) -> int:
        return max(self.est_total(now) - self.processed, 0)

    def avail(self, now: float) -> int:
        return max(self.spec.truth.tuples_available(now) - self.processed, 0)

    def remaining_cost(self, now: float) -> float:
        """FindMinCompCost: pending tuples in MinBatch chunks + final agg."""
        pend = self.pending(now)
        if pend == 0:
            return 0.0
        cm = self.q.cost_model
        full, rem = divmod(pend, max(self.min_batch, 1))
        nb = full + (1 if rem else 0)
        c = full * cm.cost(self.min_batch) + (cm.cost(rem) if rem else 0.0)
        total_batches = self.batches_done + nb
        if total_batches > 1:
            c += cm.agg_cost(total_batches)
        return c

    def laxity(self, now: float) -> float:
        """Eq. (10): deadline - now - remaining cost."""
        return self.q.deadline - now - self.remaining_cost(now)

    def target_laxity(self, now: float) -> float:
        """Laxity against the query's EFFECTIVE target instant
        (``Query.target_time`` — Cameo-style latency target, capped by the
        deadline).  Identical to ``laxity`` for target-free queries, so
        policies ordering by it stay byte-identical on the default
        workload."""
        return self.laxity(now) - (self.q.deadline - self.q.target_time)

    def ready(self, now: float) -> bool:
        """MinBatch ready, or past the *predicted* readiness instant with
        something to process, or window over with a tail remainder (§4.4)."""
        if self.completed or self.deleted or not self.admitted:
            return False
        a = self.avail(now)
        if a <= 0:
            return False
        if a >= self.min_batch:
            return True
        est_ready = self.q.arrival.input_time(self.processed + self.min_batch)
        if now >= est_ready - _EPS:
            return True
        return now >= self.q.wind_end - _EPS and self.processed + a >= self.est_total(now)

    def next_ready_time(self, now: float) -> float:
        """Earliest future instant at which ``ready`` can flip true (sim only)."""
        if self.completed or self.deleted:
            return math.inf
        if not self.admitted:
            return self.q.submit_time
        truth = self.spec.truth
        want = self.processed + self.min_batch
        est_ready = self.q.arrival.input_time(want)  # predicted readiness (§4.4)
        cands = []
        if est_ready > now + _EPS:
            cands.append(est_ready)
        elif self.processed + 1 <= truth.num_tuples_total:
            # Predicted readiness already passed: ``ready`` now flips the
            # moment the truth stream delivers its NEXT tuple (avail 0 -> 1
            # past est_ready).  A stale predicted instant must not stay a
            # candidate, or a truth burst arriving later than predicted
            # degenerates the wait loop into eps-stepping until it lands.
            cands.append(truth.input_time(self.processed + 1))
        if want <= truth.num_tuples_total:
            cands.append(truth.input_time(want))  # actual count-readiness
        elif truth.tuples_available(truth.wind_end) > self.processed:
            cands.append(max(self.q.wind_end, truth.input_time(truth.num_tuples_total)))
        t = min(cands) if cands else now + _EPS
        return t if t > now + _EPS else now + _EPS

    def done(self, now: float) -> bool:
        """Everything that will ever arrive has been processed."""
        if self.spec.total_known:
            return self.processed >= self.spec.truth.num_tuples_total
        return now >= self.spec.truth.wind_end - _EPS and self.avail(now) == 0


@dataclasses.dataclass
class RuntimeState:
    """What a dynamic policy sees at a decision instant.

    ``num_workers``/``worker_names``/``worker_clocks`` describe the executor
    pool (1 / ``()`` / ``()`` outside a pool), so policies can emit
    worker-targeted or sharded decisions only when the capacity actually
    exists.  ``worker_clocks`` aligns with ``worker_names`` and is refreshed
    by the loop before every ``replan`` call: each entry is the instant that
    worker next frees, so a policy can tell free workers (clock <= now) from
    busy ones instead of assuming the whole pool is idle.
    """

    runtimes: List[QueryRuntime]
    trace: ExecutionTrace
    rr_counter: int = 0
    num_workers: int = 1
    worker_names: Tuple[str, ...] = ()
    worker_clocks: Tuple[float, ...] = ()
    # Relative worker speeds aligned with worker_names (1.0 = nominal; ()
    # outside a pool or when the backend reports none).  Heterogeneous
    # weights let policies cut weighted shard extents so every device
    # finishes its shard at the same instant.
    worker_weights: Tuple[float, ...] = ()
    # Lazily built query_id -> runtime index (first match wins, like the
    # linear scan it replaces; new runtimes appended mid-run are absorbed
    # on the next lookup).
    _index: Dict[str, "QueryRuntime"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    _indexed: int = dataclasses.field(default=0, repr=False, compare=False)

    def free_workers(self, now: float) -> int:
        """Workers free to start a batch at ``now`` (>= 1: the decision
        instant IS some worker freeing; 1 outside a pool)."""
        if not self.worker_clocks:
            return 1
        return max(1, sum(1 for c in self.worker_clocks if c <= now + _EPS))

    def by_id(self, query_id: str) -> QueryRuntime:
        n = len(self.runtimes)
        if self._indexed < n:
            for rt in self.runtimes[self._indexed:]:
                self._index.setdefault(rt.q.query_id, rt)
            self._indexed = n
        rt = self._index.get(query_id)
        if rt is None:
            raise KeyError(query_id)
        return rt

    def active(self) -> List[QueryRuntime]:
        return [
            r for r in self.runtimes
            if r.admitted and not (r.completed or r.deleted)
        ]

    def unfinished(self) -> List[QueryRuntime]:
        return [r for r in self.runtimes if not (r.completed or r.deleted)]


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


class BaseExecutor:
    """Modelled-clock implementation of the ``Executor`` protocol.

    Subclasses override ``_execute``/``_finalize`` to do REAL work and return
    measured wall seconds (or None); the modelled clock advances by cost-model
    time either way, so all backends produce comparable traces.
    """

    def __init__(self) -> None:
        self._now = 0.0
        self.wall_seconds: Dict[str, float] = {}
        self.last_batch_wall: Optional[float] = None
        self.last_agg_wall: Optional[float] = None

    # -- protocol --------------------------------------------------------
    def clock(self) -> float:
        return self._now

    def advance(self, t: float) -> None:
        if t > self._now:
            self._now = t

    def reset(self, t: float) -> None:
        """Rewind/initialize the modelled clock (start of a run/timeline)."""
        self._now = t

    def submit_batch(self, query: Query, num_tuples: int, offset: int) -> float:
        dur = self._modelled_batch_cost(query, num_tuples)
        self.last_batch_wall = self._execute(query, num_tuples, offset)
        if self.last_batch_wall is not None:
            self.wall_seconds[query.query_id] = (
                self.wall_seconds.get(query.query_id, 0.0) + self.last_batch_wall
            )
        self._now += dur
        return dur

    def finalize(self, query: Query, num_batches: int) -> float:
        agg = self._modelled_agg_cost(query, num_batches)
        wall = self._finalize(query, num_batches)
        self.last_agg_wall = wall
        if wall is not None:
            self.wall_seconds[query.query_id] = (
                self.wall_seconds.get(query.query_id, 0.0) + wall
            )
        self._now += agg
        return agg

    def requeue_batch(self, query: Query, num_tuples: int, offset: int) -> None:
        """Straggler re-dispatch: redo the REAL work of an idempotent batch
        without touching the modelled clock.  ``last_batch_wall`` is updated
        to the re-execution's wall time — the loop requeues BEFORE invoking
        ``on_batch`` observers, so downstream consumers (calibration
        feedback) see exactly one settled measurement per batch, not the
        straggling outlier."""
        wall = self._execute(query, num_tuples, offset)
        if wall is not None:
            self.wall_seconds[query.query_id] = (
                self.wall_seconds.get(query.query_id, 0.0) + wall
            )
            self.last_batch_wall = wall

    # -- backend hooks ---------------------------------------------------
    def _modelled_batch_cost(self, query: Query, num_tuples: int) -> float:
        """TRUE modelled duration of one batch — what the clock advances by.
        Default: the query's own cost model (prediction == truth).  Override
        to inject cost drift (see ``OracleCostExecutor``).

        A cost model with a ``shard_cost`` hook (``ShardedCostModel``) is a
        PLANNING view of a W-way fused dispatch: its ``cost(n)`` is the
        parallel wall time of n tuples split W ways, which must not be what
        a single worker's clock advances by for an n-tuple shard.  The hook
        supplies the per-shard charge (the base model's cost), so the
        modelled clock stays in per-worker work units."""
        shard_cost = getattr(query.cost_model, "shard_cost", None)
        if shard_cost is not None:
            return shard_cost(num_tuples)
        return query.cost_model.cost(num_tuples)

    def _modelled_agg_cost(self, query: Query, num_batches: int) -> float:
        """TRUE modelled duration of the final aggregation."""
        return query.cost_model.agg_cost(num_batches) if num_batches > 1 else 0.0

    def _execute(
        self, query: Query, num_tuples: int, offset: int
    ) -> Optional[float]:
        """Physically process tuples [offset, offset+num_tuples); return wall
        seconds, or None when there is no physical work (simulation)."""
        return None

    def _finalize(self, query: Query, num_batches: int) -> Optional[float]:
        return None


class SimulatedExecutor(BaseExecutor):
    """Pure discrete-event backend: the paper's §7 experiment harness."""


class OracleCostExecutor(SimulatedExecutor):
    """Simulated backend whose TRUE batch costs come from per-query oracle
    models: the modelled clock advances by the oracle's cost while planners
    keep consulting ``query.cost_model`` (the fitted — possibly calibrating —
    model).  This is the cost-side analogue of ``DynamicQuerySpec.truth`` for
    arrivals: §6.2's measured model can be wrong, and a continuously running
    session must detect and absorb that.

    ``true_models`` is keyed by query id; per-window session ids
    ("<base>#w<k>") fall back to their base id, so one entry covers every
    window of a recurring query.  Unkeyed queries use ``default`` (when
    given) or their own cost model (no drift).
    """

    def __init__(
        self,
        true_models: Optional[Dict[str, CostModelBase]] = None,
        default: Optional[CostModelBase] = None,
    ):
        super().__init__()
        self.true_models = dict(true_models or {})
        self.default = default

    def true_model(self, query: Query) -> CostModelBase:
        m = self.true_models.get(query.query_id)
        if m is None:
            m = self.true_models.get(split_window_id(query.query_id)[0])
        if m is None:
            m = self.default
        return query.cost_model if m is None else m

    def _modelled_batch_cost(self, query: Query, num_tuples: int) -> float:
        return self.true_model(query).cost(num_tuples)

    def _modelled_agg_cost(self, query: Query, num_batches: int) -> float:
        if num_batches <= 1:
            return 0.0
        return self.true_model(query).agg_cost(num_batches)


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """Where/when the pool placed the last batch (read by the loop's trace
    recording, which must use the WORKER timeline, not the pool minimum)."""

    worker: str
    start: float
    end: float


class WorkerBackend:
    """Dispatch seam of ``ExecutorPool``: owns the per-worker clocks and
    physically runs batches on its workers.

    The pool keeps the Executor protocol, worker selection
    (``earliest_free``) and the final-aggregation barrier; HOW a batch runs
    and WHAT a worker's clock means is the backend's business:

    * ``ModelledWorkerBackend`` (the default) — W modelled clocks over one
      shared physical ``Executor``; a batch occupies [clock, clock +
      modelled cost) on its worker.  This is PR 2's pool, bit for bit.
    * ``repro.dist.mesh.MeshBackend`` — one worker per jax device; clocks
      are stitched from MEASURED device wall seconds, and a shard group is
      dispatched as ONE fused ``shard_map`` call across the mesh
      (``prefers_group_dispatch``).

    Subclasses must implement ``run_batch``/``run_agg`` (and may implement
    ``run_shard_group``); the clock bookkeeping here is shared.
    """

    #: when True, the runtime loop hands a whole PolicyDecision.shards group
    #: to ``ExecutorPool.submit_shard_group`` as one fused dispatch instead
    #: of one ``submit_batch`` per shard.
    prefers_group_dispatch = False

    def __init__(self, names: Sequence[str]):
        self.worker_names: Tuple[str, ...] = tuple(names)
        self._clocks: Dict[str, float] = {n: 0.0 for n in self.worker_names}
        self.last_batch_wall: Optional[float] = None
        self.last_agg_wall: Optional[float] = None
        self.wall_seconds: Dict[str, float] = {}

    # -- clocks ----------------------------------------------------------
    def worker_clock(self, name: str) -> float:
        return self._clocks[name]

    def clock(self) -> float:
        return min(self._clocks.values())

    def advance(self, t: float) -> None:
        for n, c in self._clocks.items():
            if t > c:
                self._clocks[n] = t

    def reset(self, t: float) -> None:
        for n in self._clocks:
            self._clocks[n] = t

    @property
    def worker_weights(self) -> Tuple[float, ...]:
        """Relative worker speeds (1.0 = nominal) for weighted shard
        splits; homogeneous by default."""
        return (1.0,) * len(self.worker_names)

    # -- dispatch hooks ---------------------------------------------------
    def run_batch(
        self, query: Query, num_tuples: int, offset: int, worker: str
    ) -> Tuple[Dispatch, float]:
        """Run one batch on ``worker``; returns (dispatch, duration) where
        duration is what the Executor protocol's ``submit_batch`` returns."""
        raise NotImplementedError

    def run_agg(
        self,
        query: Query,
        num_batches: int,
        worker: str,
        start: float,
        barrier: float,
    ) -> Tuple[Dispatch, float]:
        """Run the final aggregation on ``worker`` beginning at ``start``
        (already >= both the worker clock and the last-partial ``barrier``).
        Zero-duration aggregations occupy no worker and complete at the
        barrier."""
        raise NotImplementedError

    def run_shard_group(
        self,
        query: Query,
        sizes: Tuple[int, ...],
        base_offset: int,
        workers: Tuple[str, ...],
    ) -> Tuple[Dispatch, ...]:
        """Run one logical batch's shard group, one shard per worker.
        Default: sequential ``run_batch`` calls (semantically identical to
        the loop's per-shard dispatch); fused backends override this to run
        the whole [base_offset, base_offset + sum(sizes)) range as one mesh
        call and return per-shard Dispatches sharing its start/end."""
        dispatches = []
        offset = base_offset
        for size, worker in zip(sizes, workers):
            disp, _ = self.run_batch(query, size, offset, worker)
            dispatches.append(disp)
            offset += size
        return tuple(dispatches)

    def requeue_batch(self, query: Query, num_tuples: int, offset: int) -> None:
        """Straggler re-dispatch of an idempotent batch (no clock motion)."""


class ModelledWorkerBackend(WorkerBackend):
    """W modelled per-worker clocks over ONE shared physical backend — the
    pre-refactor ``ExecutorPool`` dispatch arithmetic, verbatim: physical
    work flows through ``backend`` (whose own modelled clock prices the
    batch), and the named worker's clock advances by that modelled cost."""

    def __init__(self, backend: Executor, names: Sequence[str]):
        super().__init__(names)
        self.backend = backend

    def reset(self, t: float) -> None:
        super().reset(t)
        self.backend.reset(t)

    def run_batch(
        self, query: Query, num_tuples: int, offset: int, worker: str
    ) -> Tuple[Dispatch, float]:
        start = self._clocks[worker]
        dur = self.backend.submit_batch(query, num_tuples, offset)
        end = start + dur
        self._clocks[worker] = end
        return Dispatch(worker=worker, start=start, end=end), dur

    def run_agg(
        self,
        query: Query,
        num_batches: int,
        worker: str,
        start: float,
        barrier: float,
    ) -> Tuple[Dispatch, float]:
        agg = self.backend.finalize(query, num_batches)
        if agg > 0:
            self._clocks[worker] = start + agg
            return Dispatch(worker=worker, start=start, end=start + agg), agg
        # No aggregation work: the result is ready the instant the last
        # partial lands; no worker is occupied.
        return Dispatch(worker=worker, start=barrier, end=barrier), agg

    def requeue_batch(self, query: Query, num_tuples: int, offset: int) -> None:
        requeue = getattr(self.backend, "requeue_batch", None)
        if requeue is not None:
            requeue(query, num_tuples, offset)

    # -- wall-clock bookkeeping lives on the physical backend -------------
    @property
    def last_batch_wall(self) -> Optional[float]:
        return getattr(self.backend, "last_batch_wall", None)

    @last_batch_wall.setter
    def last_batch_wall(self, value: Optional[float]) -> None:
        pass  # the physical backend owns it (base __init__ assigns None)

    @property
    def last_agg_wall(self) -> Optional[float]:
        return getattr(self.backend, "last_agg_wall", None)

    @last_agg_wall.setter
    def last_agg_wall(self, value: Optional[float]) -> None:
        pass

    @property
    def wall_seconds(self) -> Dict[str, float]:
        return getattr(self.backend, "wall_seconds", {})

    @wall_seconds.setter
    def wall_seconds(self, value: Dict[str, float]) -> None:
        pass


class ExecutorPool:
    """W parallel workers with independent modelled clocks over one backend.

    The pool implements the ``Executor`` protocol so the shared runtime loop
    and trace helpers drive it unchanged:

    * ``clock()``  — the earliest-free worker's clock: the next decision
      instant (Algorithm 2's "executor is free" generalizes to "SOME worker
      is free").
    * ``advance``  — idle every worker forward (busy workers, whose clocks
      are already past ``t``, are unaffected).
    * ``submit_batch`` — dispatch to the named worker, or to the
      earliest-free one; the batch occupies [worker clock, worker clock +
      modelled cost) on that worker only.
    * ``finalize`` — final aggregation runs on the worker that can start it
      earliest WITHOUT preceding the query's last batch end (partials from
      all workers must exist first, exactly like combining segagg partials).

    Physical work (``_execute``/``_finalize``) runs on the single shared
    ``backend``, so offset-keyed results combine across workers and
    straggler re-queue stays idempotent.  ``workers=1`` is trace-identical
    to running the bare backend.

    ``worker_backend=`` swaps the whole dispatch seam for an explicit
    ``WorkerBackend`` (e.g. ``repro.dist.mesh.MeshBackend``: one worker per
    jax device, clocks from measured device wall time, shard groups fused
    into one ``shard_map`` call).  Without it the pool builds the
    ``ModelledWorkerBackend`` over ``backend`` — the PR 2 semantics,
    byte-identical.
    """

    is_pool = True

    def __init__(
        self,
        backend: Optional[Executor] = None,
        workers: int = 1,
        names: Optional[Sequence[str]] = None,
        worker_backend: Optional[WorkerBackend] = None,
    ):
        if worker_backend is not None:
            if backend is not None:
                raise TypeError(
                    "pass either backend= (modelled dispatch over one "
                    "physical executor) or worker_backend=, not both"
                )
            if names is not None or workers != 1:
                raise ValueError(
                    "workers=/names= conflict with worker_backend= (the "
                    "worker backend declares its own workers)"
                )
            self._wb = worker_backend
            # The physical executor, for callers that reach through the
            # pool (results, calibration); a mesh backend IS its own
            # physical layer.
            self.backend = getattr(worker_backend, "backend", worker_backend)
        else:
            if getattr(backend, "is_pool", False):
                raise TypeError("cannot nest ExecutorPools")
            if names is not None:
                names = tuple(names)
                if len(set(names)) != len(names):
                    raise ValueError(f"duplicate worker names: {names}")
                if not names:
                    raise ValueError("names must be non-empty")
                if workers not in (1, len(names)):
                    # workers=1 is the constructor default, i.e. "unspecified".
                    raise ValueError(
                        f"workers={workers} conflicts with {len(names)} names"
                    )
            else:
                if workers < 1:
                    raise ValueError(f"need at least one worker, got {workers}")
                names = tuple(f"w{i}" for i in range(workers))
            self.backend = SimulatedExecutor() if backend is None else backend
            self._wb = ModelledWorkerBackend(self.backend, names)
        self.worker_names: Tuple[str, ...] = self._wb.worker_names
        self._rank: Dict[str, int] = {
            n: i for i, n in enumerate(self.worker_names)
        }
        # query_id -> (end, worker) of the query's LAST-ENDING batch so far:
        # its final aggregation cannot start before ``end``.
        self._q_last: Dict[str, Tuple[float, str]] = {}
        self.last_dispatch: Optional[Dispatch] = None

    # -- pool introspection ----------------------------------------------
    @property
    def num_workers(self) -> int:
        return len(self.worker_names)

    @property
    def worker_backend(self) -> WorkerBackend:
        return self._wb

    @property
    def worker_weights(self) -> Tuple[float, ...]:
        return self._wb.worker_weights

    @property
    def prefers_group_dispatch(self) -> bool:
        return self._wb.prefers_group_dispatch

    def worker_clock(self, name: str) -> float:
        return self._wb.worker_clock(name)

    def earliest_free(self, exclude: Sequence[str] = ()) -> str:
        """Name of the earliest-free worker (ties: declaration order).
        ``exclude`` skips workers already claimed by sibling shards — unless
        that would leave none, in which case shards may share a worker."""
        pool = [n for n in self.worker_names if n not in exclude]
        if not pool:
            pool = list(self.worker_names)
        return min(pool, key=lambda n: (self._wb.worker_clock(n), self._rank[n]))

    # -- Executor protocol -----------------------------------------------
    def clock(self) -> float:
        return self._wb.clock()

    def advance(self, t: float) -> None:
        self._wb.advance(t)

    def reset(self, t: float) -> None:
        self._wb.reset(t)
        self._q_last.clear()
        self.last_dispatch = None

    def _note_last(self, query: Query, end: float, name: str) -> None:
        prev = self._q_last.get(query.query_id)
        if prev is None or end >= prev[0]:
            self._q_last[query.query_id] = (end, name)

    def submit_batch(
        self,
        query: Query,
        num_tuples: int,
        offset: int,
        worker: Optional[str] = None,
    ) -> float:
        name = self.earliest_free() if worker is None else worker
        if name not in self._rank:
            raise KeyError(
                f"unknown worker {name!r}; pool workers: {self.worker_names}"
            )
        disp, dur = self._wb.run_batch(query, num_tuples, offset, name)
        self._note_last(query, disp.end, name)
        self.last_dispatch = disp
        return dur

    def submit_shard_group(
        self,
        query: Query,
        sizes: Sequence[int],
        base_offset: int,
    ) -> Tuple[Dispatch, ...]:
        """One logical batch's shard group as a SINGLE fused dispatch
        (worker backends with ``prefers_group_dispatch``): claims one worker
        per shard in earliest-free order and hands the whole group to the
        backend, which runs it as one mesh call.  Returns one Dispatch per
        shard (they share the fused call's start/end)."""
        names: List[str] = []
        for _ in sizes:
            names.append(self.earliest_free(exclude=names))
        dispatches = self._wb.run_shard_group(
            query, tuple(sizes), base_offset, tuple(names)
        )
        end = max(d.end for d in dispatches)
        self._note_last(query, end, dispatches[-1].worker)
        self.last_dispatch = dispatches[-1]
        return dispatches

    def finalize(self, query: Query, num_batches: int) -> float:
        barrier = self._q_last.get(query.query_id, (self.clock(), None))[0]
        # Earliest admissible start: max(worker free, last partial ready).
        name = min(
            self.worker_names,
            key=lambda n: (max(self._wb.worker_clock(n), barrier), self._rank[n]),
        )
        start = max(self._wb.worker_clock(name), barrier)
        disp, agg = self._wb.run_agg(query, num_batches, name, start, barrier)
        self.last_dispatch = disp
        return agg

    # -- optional loop members, proxied to the worker backend -------------
    @property
    def last_batch_wall(self) -> Optional[float]:
        return self._wb.last_batch_wall

    @property
    def last_agg_wall(self) -> Optional[float]:
        return self._wb.last_agg_wall

    @property
    def wall_seconds(self) -> Dict[str, float]:
        return self._wb.wall_seconds

    def requeue_batch(self, query: Query, num_tuples: int, offset: int) -> None:
        self._wb.requeue_batch(query, num_tuples, offset)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"ExecutorPool(workers={self.num_workers}, "
            f"backend={type(self._wb).__name__})"
        )


# ---------------------------------------------------------------------------
# Trace recording helpers (the loop owns these, not the executors)
# ---------------------------------------------------------------------------


def _record_batch(
    trace: ExecutionTrace,
    executor: Executor,
    query: Query,
    num_tuples: int,
    offset: int,
    on_batch: Optional[Callable[[BatchExecution], None]],
    c_max: Optional[float],
    worker: Optional[str] = None,
) -> BatchExecution:
    start = executor.clock()
    if worker is None:
        dur = executor.submit_batch(query, num_tuples, offset)
    else:
        dur = executor.submit_batch(query, num_tuples, offset, worker=worker)
    disp = getattr(executor, "last_dispatch", None)
    if disp is not None:
        # Pool dispatch: record on the WORKER timeline (its start can be
        # later than the pool minimum when a named worker was requested).
        ex = BatchExecution(
            query.query_id, disp.start, disp.end, num_tuples, worker=disp.worker
        )
    else:
        ex = BatchExecution(query.query_id, start, start + dur, num_tuples)
    trace.executions.append(ex)
    wall = getattr(executor, "last_batch_wall", None)
    if c_max is not None and wall is not None and wall > c_max:
        # C_max straggler: the batch's REAL execution blew the blocking
        # bound of §4.2-4.3.  Re-dispatch the (idempotent) batch once and
        # flag the event; modelled time is unaffected.  The requeue runs
        # BEFORE ``on_batch`` so observers see only the settled batch: a
        # SharedBook would otherwise release/evict the batch's panes first
        # and force the re-execution into a full rescan (and re-deposit) of
        # partials it had already shared, and calibration feedback would
        # sample the straggling outlier instead of the final execution.
        trace.stragglers.append(query.query_id)
        requeue = getattr(executor, "requeue_batch", None)
        if requeue is not None:
            requeue(query, num_tuples, offset)
    if on_batch:
        on_batch(ex)
    return ex


def _record_shard_group(
    trace: ExecutionTrace,
    executor: "ExecutorPool",
    query: Query,
    sizes: Sequence[int],
    base_offset: int,
    on_batch: Optional[Callable[[BatchExecution], None]],
    c_max: Optional[float],
) -> List[BatchExecution]:
    """Fused-dispatch analogue of ``_record_batch`` for one shard group:
    the pool hands the whole group to its worker backend as ONE call (e.g.
    one ``shard_map`` over the mesh) and returns per-shard Dispatches that
    share the fused call's timeline.  One BatchExecution is recorded per
    shard so traces stay shaped like per-shard dispatch; the C_max check
    applies to the fused call's measured wall time, and a straggling group
    is requeued as a single covering batch (idempotent offset-keyed redo)."""
    dispatches = executor.submit_shard_group(query, sizes, base_offset)
    exs = [
        BatchExecution(query.query_id, d.start, d.end, size, worker=d.worker)
        for d, size in zip(dispatches, sizes)
    ]
    trace.executions.extend(exs)
    wall = getattr(executor, "last_batch_wall", None)
    if c_max is not None and wall is not None and wall > c_max:
        trace.stragglers.append(query.query_id)
        executor.requeue_batch(query, sum(sizes), base_offset)
    if on_batch:
        for ex in exs:
            on_batch(ex)
    return exs


def _record_final_agg(
    trace: ExecutionTrace,
    executor: Executor,
    query: Query,
    num_batches: int,
    on_batch: Optional[Callable[[BatchExecution], None]],
) -> float:
    """Run the final aggregation and return the query's COMPLETION instant
    (end of the aggregation on whichever timeline ran it)."""
    start = executor.clock()
    agg = executor.finalize(query, num_batches)
    disp = getattr(executor, "last_dispatch", None)
    if disp is not None:
        start, end, worker = disp.start, disp.end, disp.worker
    else:
        end, worker = start + agg, ""
    if agg > 0:
        ex = BatchExecution(
            query.query_id, start, end, 0, kind="final_agg", worker=worker
        )
        trace.executions.append(ex)
        if on_batch:
            on_batch(ex)
    return end


def _record_outcome(
    trace: ExecutionTrace,
    query: Query,
    num_batches: int,
    completion: float,
    *,
    tuples_processed: int = -1,
    shed_fraction: float = 0.0,
    error_bound: float = 0.0,
) -> QueryOutcome:
    out = QueryOutcome(
        query_id=query.query_id,
        completion_time=completion,
        deadline=query.deadline,
        total_cost=sum(
            e.end - e.start
            for e in trace.executions
            if e.query_id == query.query_id
        ),
        num_batches=num_batches,
        tuples_processed=tuples_processed,
        num_tuples_total=query.num_tuples_total,
        shed_fraction=shed_fraction,
        error_bound=error_bound,
        latency_target=query.latency_target,
        target_time=(query.target_time
                     if query.latency_target is not None else None),
        tenant=query.tenant,
    )
    trace.outcomes.append(out)
    return out


# ---------------------------------------------------------------------------
# Plan execution (Algorithm 1's while-loop — the single static-path copy)
# ---------------------------------------------------------------------------


def execute_plan(
    query: Query,
    plan: Schedule,
    executor: Optional[Executor] = None,
    truth: Optional[ArrivalModel] = None,
    *,
    strict: bool = False,
    trace: Optional[ExecutionTrace] = None,
    on_batch: Optional[Callable[[BatchExecution], None]] = None,
    c_max: Optional[float] = None,
    carryover: bool = False,
    shed_fraction: float = 0.0,
    error_bound: float = 0.0,
) -> ExecutionTrace:
    """Execute one query's plan on ``executor`` (simulated by default).

    ``strict=False``: Algorithm 1's adaptive loop — trigger a batch when
    EITHER its planned tuple count is available OR its planned time point is
    reached, then process whatever is there (absorbs input-rate
    mispredictions against the ``truth`` arrival process).

    ``strict=True``: replay the planned batches verbatim (sizes and order) at
    ``max(clock, sched_time)`` — the mode real backends use to apply a vetted
    plan to fully materialized inputs.

    ``carryover=True``: keep the executor's running clock (a continuous
    session timeline, where one executor serves many window queries back to
    back) instead of resetting it to the query's ``submit_time``; the clock
    only ever moves forward.

    With an ``ExecutorPool`` both modes dispatch each triggered batch to the
    earliest-free worker (``pool.clock()`` IS the earliest-free instant), so
    consecutive batches of one query overlap across workers; the final
    aggregation waits for the last partial.
    """
    executor = SimulatedExecutor() if executor is None else executor
    trace = ExecutionTrace() if trace is None else trace
    if carryover:
        executor.advance(query.submit_time)
    else:
        executor.reset(query.submit_time)  # each query gets its own timeline

    n_batches = 0
    if strict:
        offset = 0
        for b in plan.batches:
            if b.num_tuples <= 0:
                continue
            executor.advance(b.sched_time)
            _record_batch(
                trace, executor, query, b.num_tuples, offset,
                on_batch=on_batch, c_max=c_max,
            )
            offset += b.num_tuples
            n_batches += 1
        processed = offset
    else:
        if not plan.batches and query.num_tuples_total > 0:
            raise ValueError(
                f"{query.query_id}: empty plan for {query.num_tuples_total} "
                "tuples — plan the query first (Planner.plan)"
            )
        arr = truth if truth is not None else query.arrival
        pending = query.num_tuples_total
        processed = 0
        ptr = 0
        required = plan.batches[0].num_tuples if plan.batches else 0
        while pending > 0:
            now = executor.clock()
            avail = arr.tuples_available(now) - processed
            point = plan.batches[min(ptr, plan.num_batches - 1)].sched_time
            # Algorithm 1 trigger: enough tuples ready, OR the planned
            # instant passed (then "Process the Available Tuples").
            if (avail >= required or now >= point - _EPS) and avail > 0:
                take = min(avail, pending)
                _record_batch(
                    trace, executor, query, take, processed,
                    on_batch=on_batch, c_max=c_max,
                )
                processed += take
                pending -= take
                n_batches += 1
                required -= take
                if ptr < plan.num_batches - 1 and required <= 0:
                    ptr += 1
                    required += plan.batches[ptr].num_tuples
                required = max(required, 0)
            else:
                # Discrete-event jump: earliest instant at which the trigger
                # can fire — the `required`-th outstanding tuple arriving, or
                # the planned time point, whichever first.  When the truth
                # stream ends before the plan's next full batch, no further
                # arrival helps, but Algorithm 1's "planned instant passed ->
                # process the available tuples" path must still fire at the
                # time point for the arrived tail.
                want = processed + max(required, 1)
                next_arrival = (
                    arr.input_time(want)
                    if want <= arr.num_tuples_total
                    else math.inf
                )
                wait_for = min(processed + 1, arr.num_tuples_total)
                nxt = min(next_arrival, max(point, arr.input_time(wait_for)))
                if not math.isfinite(nxt) or nxt <= now + _EPS:
                    # Nothing further will arrive or trigger: the truth
                    # stream under-delivered against the plan.  The outcome
                    # below records the shortfall (``pending`` tuples never
                    # materialized) instead of posing as a completion.
                    break
                executor.advance(nxt)

    completion = _record_final_agg(trace, executor, query, n_batches, on_batch)
    _record_outcome(
        trace, query, n_batches, completion, tuples_processed=processed,
        shed_fraction=shed_fraction, error_bound=error_bound,
    )
    return trace


# ---------------------------------------------------------------------------
# The shared runtime loop
# ---------------------------------------------------------------------------


def run(
    policy: SchedulingPolicy,
    workload: Union[Query, DynamicQuerySpec, Workload],
    executor: Optional[Executor] = None,
    *,
    start_time: Optional[float] = None,
    max_steps: Optional[int] = None,
    strict: bool = False,
    on_batch: Optional[Callable[[BatchExecution], None]] = None,
    c_max: Optional[float] = None,
    sharing: Optional["SharedBook"] = None,  # noqa: F821  (panes.py)
    runtime: Optional[str] = None,
) -> ExecutionTrace:
    """Run ``workload`` under ``policy`` on ``executor`` (simulated when
    omitted) and return the full ExecutionTrace with per-query outcomes.

    ``c_max`` bounds the REAL per-batch execution time for straggler
    detection; it defaults to the policy's own C_max (dynamic policies carry
    one; static policies don't, so pass it explicitly to enable straggler
    re-queue on static runs).  ``strict`` applies only to static policies
    (replay plans verbatim); ``start_time``/``max_steps`` only to dynamic
    ones — passing an inapplicable argument raises.

    ``runtime`` selects the dynamic decision core: ``"scan"`` (default) is
    the O(n)-per-instant walk; ``"heap"`` is the event-heap core
    (``HeapLoopCore``) — same decisions, byte-identical traces, O(log n)
    per instant.  The heap engages only for policies whose ``replan`` is
    ``DynamicPolicy``'s (see ``heap_capable``); custom-replan and static
    policies fall back to the scan path unchanged.

    ``sharing`` attaches a ``repro.core.panes.SharedBook`` whose pane
    bookkeeping observes every executed batch (deposits the first coverage
    of each pane, counts reuse, releases refcounts).  The workload must
    already be share-transformed (``panes.share_workload`` — which is what
    assigns the shared cost models); ``panes.run_shared`` bundles the
    transform, this call and the book teardown.  ``sharing=None`` (the
    default) leaves the loop byte-identical to the unshared runtime."""
    specs = as_specs(workload)
    executor = SimulatedExecutor() if executor is None else executor
    if sharing is not None:
        on_batch = sharing.chain(on_batch)
    if c_max is None:
        c_max = getattr(policy, "c_max", None)
    if getattr(policy, "kind", "static") == "dynamic":
        if strict:
            raise ValueError(
                "strict= applies to static policies only (dynamic policies "
                "have no up-front plan to replay)"
            )
        return _run_dynamic(
            policy, executor, specs,
            start_time=start_time,
            max_steps=1_000_000 if max_steps is None else max_steps,
            on_batch=on_batch, c_max=c_max, runtime=runtime,
        )
    if runtime not in (None, "scan", "heap"):
        raise ValueError(f"runtime must be 'scan' or 'heap', got {runtime!r}")
    if start_time is not None or max_steps is not None:
        raise ValueError(
            "start_time=/max_steps= apply to dynamic policies only (static "
            "runs give each query its own timeline from submit_time)"
        )
    return _run_static(
        policy, executor, specs, strict=strict, on_batch=on_batch, c_max=c_max,
    )


def _run_static(
    policy: SchedulingPolicy,
    executor: Executor,
    specs: List[DynamicQuerySpec],
    *,
    strict: bool,
    on_batch: Optional[Callable[[BatchExecution], None]],
    c_max: Optional[float],
) -> ExecutionTrace:
    """Static policies: plan each query up front, execute independently.

    Each query runs on its own timeline (the paper's single-query scenarios
    assume a dedicated executor per query; §3)."""
    trace = ExecutionTrace()
    for spec in specs:
        plan = policy.plan(spec.query)[spec.query.query_id]
        execute_plan(
            spec.query, plan, executor,
            truth=spec.truth, strict=strict, trace=trace,
            on_batch=on_batch, c_max=c_max,
            shed_fraction=spec.shed_fraction, error_bound=spec.error_bound,
        )
    return trace


class DynamicLoopCore:
    """One-decision-instant stepping core of Algorithm 2's NINP loop.

    ``run()`` drives it to exhaustion for a fixed workload; a ``Session``
    drives it incrementally (``tick(horizon=...)``) on a CONTINUOUS timeline,
    appending new ``QueryRuntime``s between ticks as windows roll over or
    queries are admitted mid-run.  Admissions/deletions happen only between
    batches (§4.2: "the scheduler takes the new query at the end of the
    batch"); the policy picks the winner at each decision instant; the
    executor performs the batch.  When an admission happens, the next
    ``replan`` receives an ``"admission"`` SchedulingEvent naming the
    admitted query — the decision instant §4.2 introduces for new arrivals.
    """

    def __init__(
        self,
        policy: SchedulingPolicy,
        executor: Executor,
        state: RuntimeState,
        *,
        on_batch: Optional[Callable[[BatchExecution], None]] = None,
        c_max: Optional[float] = None,
    ):
        self.policy = policy
        self.executor = executor
        self.state = state
        self.on_batch = on_batch
        self.c_max = c_max
        self.is_pool = getattr(executor, "is_pool", False)
        self._event_kind = "start"
        self._event_qid: Optional[str] = None

    @property
    def runts(self) -> List[QueryRuntime]:
        return self.state.runtimes

    # -- heap-core hooks (no-ops on the scan core) -----------------------
    def _register_new(self) -> None:
        """Absorb runtimes appended to ``state.runtimes`` since last tick."""

    def notify(self, rt: QueryRuntime) -> None:
        """A runtime's readiness-relevant state changed outside the loop
        (withdraw set ``delete_time``, shed/recalibrate resized MinBatch,
        overload thinned the stream).  The scan core re-derives everything
        each tick; the heap core re-indexes the runtime."""

    def _note_completed(self, rt: QueryRuntime) -> None:
        """``rt`` just completed inside ``tick``."""

    def _admit_and_delete(self, now: float) -> Optional[str]:
        """Flip admissions/deletions due at ``now``; return the last admitted
        query id (None when no admission happened)."""
        admitted: Optional[str] = None
        for rt in self.runts:
            if not rt.admitted and rt.q.submit_time <= now + _EPS:
                rt.admitted = True
                rt.rr_seq = self.state.rr_counter
                self.state.rr_counter += 1
                on_admit = getattr(self.policy, "on_admit", None)
                if on_admit is not None:
                    on_admit(rt, now)
                elif rt.min_batch <= 0:
                    rt.min_batch = 1  # protocol-minimal policy: no sizing hook
                admitted = rt.q.query_id
            if (
                rt.spec.delete_time is not None
                and not rt.deleted
                and rt.spec.delete_time <= now + _EPS
                and not rt.completed
            ):
                rt.deleted = True
                on_withdraw = getattr(self.policy, "on_withdraw", None)
                if on_withdraw is not None:
                    on_withdraw(rt, now)
        return admitted

    def drained(self) -> bool:
        """No active work and nothing pending admission."""
        return not self.state.active() and all(
            r.admitted or r.deleted for r in self.runts
        )

    def tick(self, horizon: float = math.inf) -> str:
        """Process ONE decision instant.  Returns:

        * ``"done"``    — drained: every runtime completed or deleted;
        * ``"stop"``    — the policy declared nothing will ever be ready;
        * ``"wait"``    — idled forward to the policy's wake instant;
        * ``"ran"``     — dispatched one batch (or shard group);
        * ``"horizon"`` — the next actionable instant lies beyond
          ``horizon`` (the clock was advanced exactly to it; only a session
          passes a finite horizon).
        """
        executor, state, trace = self.executor, self.state, self.state.trace
        self._register_new()
        now = executor.clock()
        if now > horizon + _EPS:
            return "horizon"
        admitted = self._admit_and_delete(now)
        if admitted is not None:
            self._event_kind, self._event_qid = "admission", admitted
        if self.drained():
            return "done"

        if self.is_pool:
            state.worker_clocks = tuple(
                executor.worker_clock(n) for n in state.worker_names
            )
            state.worker_weights = tuple(
                getattr(executor, "worker_weights", None) or ()
            )
        decision = self._decide(now)
        if decision.is_stop:
            return "stop"
        if decision.is_wait:
            self._event_kind, self._event_qid = "wake", None
            if decision.wake_at > horizon + _EPS:
                executor.advance(horizon)
                return "horizon"
            executor.advance(decision.wake_at)
            return "wait"

        rt = state.by_id(decision.query_id)
        rt.rr_seq = state.rr_counter  # rotate to the back for RR fairness
        state.rr_counter += 1

        if (decision.worker is not None or decision.shards) and not self.is_pool:
            raise ValueError(
                f"policy {getattr(self.policy, 'name', self.policy)!r} "
                "emitted a worker-targeted decision but the executor is not "
                "an ExecutorPool"
            )
        if decision.shards:
            if (
                getattr(executor, "prefers_group_dispatch", False)
                and all(s.worker is None for s in decision.shards)
            ):
                # Fused group dispatch: the whole shard group runs as ONE
                # backend call (e.g. one shard_map over the mesh) — the
                # dispatch-overhead amortization the modelled per-shard
                # path cannot express.
                sizes = [s.num_tuples for s in decision.shards]
                _record_shard_group(
                    trace, executor, rt.q, sizes, rt.processed,
                    on_batch=self.on_batch, c_max=self.c_max,
                )
                rt.processed += sum(sizes)
                rt.batches_done += len(sizes)
            else:
                # One logical batch split across workers: each shard becomes
                # its own offset-keyed partial (combined in finalize),
                # dispatched to its named worker or the next unclaimed
                # earliest-free one.
                claimed: List[str] = []
                for shard in decision.shards:
                    name = shard.worker
                    if name is None:
                        name = executor.earliest_free(exclude=claimed)
                    claimed.append(name)
                    _record_batch(
                        trace, executor, rt.q, shard.num_tuples, rt.processed,
                        on_batch=self.on_batch, c_max=self.c_max, worker=name,
                    )
                    rt.processed += shard.num_tuples
                    rt.batches_done += 1
        else:
            _record_batch(
                trace, executor, rt.q, decision.num_tuples, rt.processed,
                on_batch=self.on_batch, c_max=self.c_max,
                worker=decision.worker,
            )
            rt.processed += decision.num_tuples
            rt.batches_done += 1
        self._event_kind, self._event_qid = "batch_end", rt.q.query_id

        # -- completion: all that will ever arrive has been processed -----
        if rt.done(executor.clock()):
            completion = _record_final_agg(
                trace, executor, rt.q, rt.batches_done, self.on_batch
            )
            rt.completed = True
            _record_outcome(
                trace, rt.q, rt.batches_done, completion,
                tuples_processed=rt.processed,
                shed_fraction=rt.spec.shed_fraction,
                error_bound=rt.spec.error_bound,
            )
            self._note_completed(rt)
        return "ran"

    def _decide(self, now: float) -> "PolicyDecision":
        """One decision: consult the policy over the full runtime state."""
        return self.policy.replan(
            SchedulingEvent(self._event_kind, now, self._event_qid), self.state
        )


class HeapLoopCore(DynamicLoopCore):
    """Event-heap decision core: O(log n) per decision instant.

    Same decisions, same traces, different bookkeeping.  The scan core
    re-derives everything from scratch each tick — O(n) walks for
    admissions, drain detection and the wait-instant ``min`` over every
    unfinished runtime.  This core replaces the walks with event heaps:

    * **admit heap** ``(submit_time, idx)`` — pending admissions pop in due
      order; due batches are applied in runtime-list order, so ``rr_seq``
      tickets are assigned exactly as the scan's in-order walk assigns them.
    * **delete heap** ``(delete_time, idx)`` — lazy-deletion: ``withdraw``
      just pushes an event (via ``notify``); stale/duplicate entries are
      skipped on pop.  Deletions are processed after the tick's admissions
      (they never touch the rr counter, so relative ticket order — the only
      thing policies compare — matches the scan walk; see the parity tests).
    * **ready heap** ``(wake_time, seq, idx)`` — lower bounds on each
      runtime's ``next_ready_time``.  Due entries pop into a **ready pool**
      whose members are (re)validated with ``QueryRuntime.ready`` at each
      decision instant; validation failures are pushed back at their fresh
      ``next_ready_time``.  When nothing is ready, the wake instant is found
      by peek-revalidate: pop the top, recompute its exact readiness, and
      stop as soon as the recomputed instant is <= every remaining (lower
      bound) entry — which makes it the global minimum, i.e. exactly the
      scan loop's ``min(next_ready_time)``.

    Liveness counters (`admitted & !completed & !deleted`, and
    `!admitted & !deleted`) replace the ``drained`` walks.  One scan
    behaviour is intentionally NOT replicated: the scan walk "admits"
    already-deleted runtimes (consuming an rr ticket for a runtime that can
    never compete); the heap skips those phantom admissions.  Ticket
    *values* then differ, but ticket *order* among live runtimes — the only
    observable — does not, and traces stay byte-identical.

    Winner selection mirrors ``DynamicPolicy.replan`` exactly (the core is
    only engaged for policies whose ``replan`` IS DynamicPolicy's —
    see ``heap_capable``): strict tiers, then ``policy.priority``, with the
    pool's vectorized ``DynamicPolicy.select`` doing the ordering.
    """

    def __init__(
        self,
        policy: SchedulingPolicy,
        executor: Executor,
        state: RuntimeState,
        *,
        on_batch: Optional[Callable[[BatchExecution], None]] = None,
        c_max: Optional[float] = None,
    ):
        super().__init__(policy, executor, state, on_batch=on_batch,
                         c_max=c_max)
        self._registered = 0
        self._rt_index: Dict[int, int] = {}  # id(rt) -> runtimes index
        self._admit_heap: List[Tuple[float, int]] = []
        self._delete_heap: List[Tuple[float, int]] = []
        self._ready_heap: List[Tuple[float, int, int]] = []
        self._ready_pool: Set[int] = set()
        self._seq = 0  # push order: stable tiebreak inside the ready heap
        self._num_active = 0
        self._num_unadmitted = 0
        self._register_new()

    # -- registration and external-change notifications ------------------
    def _register_new(self) -> None:
        runts = self.state.runtimes
        clock = self.executor.clock()
        while self._registered < len(runts):
            idx = self._registered
            rt = runts[idx]
            self._rt_index[id(rt)] = idx
            if not (rt.completed or rt.deleted):
                if rt.admitted:
                    self._num_active += 1
                    self._push_ready(idx, clock)
                else:
                    self._num_unadmitted += 1
                    heapq.heappush(self._admit_heap, (rt.q.submit_time, idx))
            if rt.spec.delete_time is not None and not rt.deleted:
                heapq.heappush(self._delete_heap, (rt.spec.delete_time, idx))
            self._registered = idx + 1

    def notify(self, rt: QueryRuntime) -> None:
        idx = self._rt_index.get(id(rt))
        if idx is None:
            return  # not registered yet; _register_new will index it
        if (rt.spec.delete_time is not None
                and not (rt.deleted or rt.completed)):
            heapq.heappush(self._delete_heap, (rt.spec.delete_time, idx))
        if (rt.admitted and not (rt.completed or rt.deleted)
                and idx not in self._ready_pool):
            # The current clock is always a safe lower bound on the (possibly
            # changed) readiness instant; the stale entry stays in the heap
            # and is lazily revalidated.
            self._push_ready(idx, self.executor.clock())

    def _note_completed(self, rt: QueryRuntime) -> None:
        idx = self._rt_index[id(rt)]
        self._num_active -= 1
        self._ready_pool.discard(idx)

    def _push_ready(self, idx: int, t: float) -> None:
        self._seq += 1
        heapq.heappush(self._ready_heap, (t, self._seq, idx))

    # -- tick bookkeeping -------------------------------------------------
    def _admit_and_delete(self, now: float) -> Optional[str]:
        runts = self.state.runtimes
        due: List[int] = []
        while self._admit_heap and self._admit_heap[0][0] <= now + _EPS:
            _, idx = heapq.heappop(self._admit_heap)
            rt = runts[idx]
            if not rt.admitted and not rt.deleted:
                due.append(idx)
        due.sort()  # runtime-list order: rr tickets match the scan walk
        admitted: Optional[str] = None
        for idx in due:
            rt = runts[idx]
            rt.admitted = True
            rt.rr_seq = self.state.rr_counter
            self.state.rr_counter += 1
            on_admit = getattr(self.policy, "on_admit", None)
            if on_admit is not None:
                on_admit(rt, now)
            elif rt.min_batch <= 0:
                rt.min_batch = 1  # protocol-minimal policy: no sizing hook
            admitted = rt.q.query_id
            self._num_unadmitted -= 1
            self._num_active += 1
            self._ready_pool.add(idx)  # validated at the decision instant
        while self._delete_heap and self._delete_heap[0][0] <= now + _EPS:
            _, idx = heapq.heappop(self._delete_heap)
            rt = runts[idx]
            if (rt.deleted or rt.completed or rt.spec.delete_time is None
                    or rt.spec.delete_time > now + _EPS):
                continue  # stale/duplicate lazy-deletion entry
            rt.deleted = True
            on_withdraw = getattr(self.policy, "on_withdraw", None)
            if on_withdraw is not None:
                on_withdraw(rt, now)
            if rt.admitted:
                self._num_active -= 1
            else:
                self._num_unadmitted -= 1
            self._ready_pool.discard(idx)
        return admitted

    def drained(self) -> bool:
        return self._num_active == 0 and self._num_unadmitted == 0

    # -- the decision ----------------------------------------------------
    def _collect_ready(self, now: float) -> List[int]:
        """Due heap entries join the pool; the pool is then (re)validated.
        Returns the validated ready set in runtime-list order."""
        runts = self.state.runtimes
        heap, pool = self._ready_heap, self._ready_pool
        while heap and heap[0][0] <= now + _EPS:
            _, _, idx = heapq.heappop(heap)
            rt = runts[idx]
            if rt.admitted and not (rt.completed or rt.deleted):
                pool.add(idx)
        ready: List[int] = []
        stale: List[int] = []
        for idx in pool:
            if runts[idx].ready(now):
                ready.append(idx)
            else:
                stale.append(idx)
        for idx in stale:
            pool.discard(idx)
            self._push_ready(idx, runts[idx].next_ready_time(now))
        ready.sort()
        return ready

    def _next_wake(self, now: float) -> float:
        """Exact ``min(next_ready_time)`` over unfinished runtimes, found by
        peek-revalidating the event heaps instead of walking the world."""
        runts = self.state.runtimes
        best = math.inf
        while self._admit_heap:
            t, idx = self._admit_heap[0]
            rt = runts[idx]
            if rt.admitted or rt.deleted:
                heapq.heappop(self._admit_heap)
                continue
            best = t  # an unadmitted runtime wakes at its submit_time
            break
        heap = self._ready_heap
        while heap:
            if heap[0][0] >= best:
                break  # every (lower-bound) entry is at/past the admit wake
            t, seq, idx = heapq.heappop(heap)
            rt = runts[idx]
            if rt.completed or rt.deleted or not rt.admitted:
                continue
            fresh = rt.next_ready_time(now)
            heapq.heappush(heap, (fresh, seq, idx))
            if fresh <= heap[0][0]:
                best = min(best, fresh)
                break
        return best

    def _decide(self, now: float) -> PolicyDecision:
        ready_idx = self._collect_ready(now)
        if not ready_idx:
            nxt = self._next_wake(now)
            if not math.isfinite(nxt):
                return PolicyDecision()  # stop: nothing will ever be ready
            return PolicyDecision(wake_at=nxt)
        runts = self.state.runtimes
        rt = self.policy.select([runts[i] for i in ready_idx], now)
        take = min(rt.avail(now), rt.min_batch)
        ways = min(self.policy.shard_across, self.state.free_workers(now),
                   take)
        if ways > 1:
            from .policies.dynamic import make_shards

            return PolicyDecision(
                query_id=rt.q.query_id, num_tuples=take,
                shards=make_shards(self.state, take, ways, now),
            )
        return PolicyDecision(query_id=rt.q.query_id, num_tuples=take)


def heap_capable(policy: SchedulingPolicy) -> bool:
    """True when ``policy``'s decisions are exactly ``DynamicPolicy.replan``
    — the contract the heap core mirrors.  Policies overriding ``replan``
    (custom decision logic the heap cannot see) silently fall back to the
    scan core."""
    if getattr(policy, "kind", "static") != "dynamic":
        return False
    from .policies.dynamic import DynamicPolicy

    return (isinstance(policy, DynamicPolicy)
            and type(policy).replan is DynamicPolicy.replan)


def _core_class(policy: SchedulingPolicy, runtime: Optional[str]):
    if runtime not in (None, "scan", "heap"):
        raise ValueError(
            f"runtime must be 'scan' or 'heap', got {runtime!r}"
        )
    if runtime == "heap" and heap_capable(policy):
        return HeapLoopCore
    return DynamicLoopCore


def _run_dynamic(
    policy: SchedulingPolicy,
    executor: Executor,
    specs: List[DynamicQuerySpec],
    *,
    start_time: Optional[float],
    max_steps: int,
    on_batch: Optional[Callable[[BatchExecution], None]],
    c_max: Optional[float],
    runtime: Optional[str] = None,
) -> ExecutionTrace:
    """Algorithm 2's NINP loop over a fixed workload (see DynamicLoopCore)."""
    runts = [QueryRuntime(spec=s) for s in specs]
    trace = ExecutionTrace()
    if not runts:
        return trace
    start = (
        min(r.q.submit_time for r in runts) if start_time is None else start_time
    )
    executor.reset(start)
    state = RuntimeState(
        runtimes=runts,
        trace=trace,
        num_workers=getattr(executor, "num_workers", 1),
        worker_names=tuple(getattr(executor, "worker_names", ())),
    )
    core = _core_class(policy, runtime)(policy, executor, state,
                                        on_batch=on_batch, c_max=c_max)
    for _ in range(max_steps):
        if core.tick() in ("done", "stop"):
            break
    return trace
