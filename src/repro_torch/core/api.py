"""The scheduling API: Planner / SchedulingPolicy / Executor.

The paper's contribution is a FAMILY of interchangeable scheduling schemes —
single-query with/without aggregation cost (§3.1), constraint-based (§3.2),
dynamic multi-query under LLF/EDF/SJF/RR (§4) — evaluated against a common
executor.  This module makes that structure first-class:

* ``SchedulingPolicy``  — the scheme interface: ``plan(queries, ...) -> Plan``
  for static planning, plus ``replan(event, state) -> PolicyDecision`` for
  event-driven dynamic dispatch (Algorithm 2's per-decision-instant logic).
* policy registry      — string-keyed: ``@register_policy("edf-dynamic")``,
  ``get_policy(name, **params)``, ``list_policies()``.  Every legacy
  ``schedule_*`` free function is a registered policy; the old names survive
  as thin deprecation shims.
* ``Planner``          — the user-facing facade: ``Planner(policy="single")``
  then ``.plan(queries)`` or ``.run(workload, executor)``.
* ``Executor``         — the execution backend protocol: ``submit_batch`` /
  ``finalize`` / ``clock``.  Implemented by the discrete-event simulator
  (``repro.core.runtime.SimulatedExecutor``), the JAX analytics executor
  (``repro.serve.analytics.AnalyticsRuntimeExecutor``) and the model-serving
  engine (``repro.serve.engine.ServingExecutor``).  All three share ONE
  runtime loop (``repro.core.runtime.run``), which owns deadline checking,
  C_max straggler re-queue and trace recording.  Any backend scales out by
  wrapping it in ``repro.core.runtime.ExecutorPool`` (W workers with
  independent modelled clocks over one physical backend); decisions may
  target a named worker or split into per-worker shards
  (``PolicyDecision.worker`` / ``PolicyDecision.shards``).

Scheduling state/decision events flow::

    Planner(policy) --plan()--> Plan --run()--> runtime.run(policy, executor)
                                                   |  replan(event, state)
                                                   v
                                            executor.submit_batch/finalize
"""
from __future__ import annotations

import dataclasses
from typing import (
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    Type,
    Union,
    runtime_checkable,
)

from .cost_model import CostModelBase
from .types import ExecutionTrace, Plan, PolicyDecision, Query, Schedule


# ---------------------------------------------------------------------------
# Policy protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchedulingEvent:
    """Why the runtime is consulting the policy (§4.2's decision instants)."""

    kind: str  # "start" | "batch_end" | "admission" | "wake"
    now: float
    query_id: Optional[str] = None


@runtime_checkable
class SchedulingPolicy(Protocol):
    """One scheduling scheme.

    ``kind`` is "static" (a full per-query Plan is computed up front and
    executed with Algorithm 1's triggers) or "dynamic" (the policy is
    consulted at every decision instant via ``replan``).
    """

    name: str
    kind: str

    def plan(
        self,
        queries: Union[Query, Sequence[Query]],
        cost_model: Optional[CostModelBase] = None,
        now: float = 0.0,
    ) -> Plan:
        """Static plan for ``queries`` (predicted arrival models only).

        ``cost_model`` overrides the per-query cost model when given (e.g. a
        freshly calibrated model for all queries of one executor).
        """
        ...

    def replan(self, event: SchedulingEvent, state: "RuntimeState") -> PolicyDecision:  # noqa: F821
        """Dynamic decision at one instant; static policies need not implement."""
        ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type] = {}


def register_policy(name: str, *aliases: str) -> Callable[[Type], Type]:
    """Class decorator: register a SchedulingPolicy under ``name`` (+aliases).

        @register_policy("edf-dynamic")
        class EDFPolicy(DynamicPolicy): ...
    """

    def deco(cls: Type) -> Type:
        for key in (name, *aliases):
            if key in _REGISTRY and _REGISTRY[key] is not cls:
                raise ValueError(f"policy name {key!r} already registered")
        if _REGISTRY.get(getattr(cls, "name", None)) is not cls:
            # First registration fixes the canonical name; registering the
            # same class again only adds aliases (list_policies() keeps
            # reporting the canonical name).
            cls.name = name
        for key in (name, *aliases):
            _REGISTRY[key] = cls
        return cls

    return deco


def _ensure_builtin_policies() -> None:
    # Importing the package registers every built-in policy exactly once.
    from . import policies  # noqa: F401


def get_policy(name: str, **params) -> SchedulingPolicy:
    """Instantiate the policy registered under ``name``.

    ``params`` are forwarded to the policy constructor (e.g.
    ``get_policy("llf-dynamic", delta_rsf=0.5, c_max=30.0)``).
    """
    _ensure_builtin_policies()
    try:
        cls = _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(set(_REGISTRY)))
        raise KeyError(f"unknown policy {name!r}; registered: {known}") from None
    return cls(**params)


def list_policies() -> Tuple[str, ...]:
    """Canonical names of all registered policies (aliases excluded)."""
    _ensure_builtin_policies()
    return tuple(sorted({cls.name for cls in _REGISTRY.values()}))


# ---------------------------------------------------------------------------
# Executor protocol
# ---------------------------------------------------------------------------


@runtime_checkable
class Executor(Protocol):
    """Execution backend driven by the shared runtime loop.

    Executors keep the MODELLED clock (cost units == time units, exactly how
    the paper's §7 experiments report results); real backends additionally do
    the physical work inside ``submit_batch``/``finalize``.

    Prefer subclassing ``repro.core.runtime.BaseExecutor`` (override
    ``_execute``/``_finalize``) over implementing this protocol from scratch:
    the base class also provides the OPTIONAL members the loop uses when
    present — ``wall_seconds`` (per-query real seconds), ``last_batch_wall``
    (feeds C_max straggler detection; without it stragglers are never
    flagged) and ``requeue_batch`` (idempotent straggler re-dispatch).
    """

    def clock(self) -> float:
        """Current modelled time."""
        ...

    def advance(self, t: float) -> None:
        """Idle forward to modelled time ``t`` (no-op if in the past)."""
        ...

    def reset(self, t: float) -> None:
        """Rewind/initialize the clock to ``t`` (start of a query timeline —
        static runs give every query its own timeline, so this can move the
        clock backward, unlike ``advance``)."""
        ...

    def submit_batch(self, query: Query, num_tuples: int, offset: int) -> float:
        """Process ``num_tuples`` of ``query`` starting at tuple ``offset``;
        advance the clock by — and return — the modelled batch cost."""
        ...

    def finalize(self, query: Query, num_batches: int) -> float:
        """Final aggregation (§2.1) after the last batch; advance the clock
        by — and return — the modelled aggregation cost."""
        ...


# ---------------------------------------------------------------------------
# Planner facade
# ---------------------------------------------------------------------------


class Planner:
    """User-facing entry point: a policy plus convenience plumbing.

        planner = Planner(policy="single")
        plan = planner.plan(query)                       # static Plan
        trace = planner.run(specs)                       # simulate
        trace = planner.run(specs, executor=real_exec)   # real backend
    """

    def __init__(
        self,
        policy: Union[str, SchedulingPolicy] = "single",
        **policy_params,
    ):
        if isinstance(policy, str):
            self.policy = get_policy(policy, **policy_params)
        else:
            if policy_params:
                raise TypeError(
                    "policy_params only apply when policy is given by name"
                )
            self.policy = policy

    @property
    def name(self) -> str:
        """Canonical registry name of the wrapped policy."""
        return self.policy.name

    def plan(
        self,
        queries: Union[Query, Sequence[Query]],
        cost_model: Optional[CostModelBase] = None,
        now: float = 0.0,
    ) -> Plan:
        """Static ``Plan`` for ``queries`` under the wrapped policy (the
        PREDICTED arrival models; dynamic policies return their
        deterministic projection).  ``cost_model`` overrides every query's
        own model when given."""
        return self.policy.plan(queries, cost_model=cost_model, now=now)

    def schedule(self, query: Query, **kw) -> Schedule:
        """Single-query convenience: the Schedule for one query."""
        return self.plan(query, **kw)[query.query_id]

    def run(
        self,
        workload,
        executor: Optional[Executor] = None,
        *,
        workers: Optional[int] = None,
        share: bool = False,
        pane_tuples: Optional[int] = None,
        **runtime_kw,
    ) -> ExecutionTrace:
        """Execute ``workload`` (Queries or DynamicQuerySpecs) end to end
        through the shared runtime loop; simulates when no executor given.

        ``workers=W`` wraps ``executor`` in an ``ExecutorPool`` of W workers
        (``workers=4`` with no executor: a 4-way simulated pool).

        ``share=True`` enables pane-based shared execution for queries that
        name a common ``Query.stream`` (``repro.core.panes``): their cost
        models become amortized one-scan-+-k-merges ``SharedCostModel``s and
        pane partials are cached/reused across overlapping windows.
        ``pane_tuples`` overrides the per-stream GCD pane width.  The
        returned trace carries the pane bookkeeping as ``trace.pane_book``
        (scan/hit/eviction stats under ``.store.stats``).  With
        ``share=False`` (default) the run is byte-identical to the unshared
        runtime.

        ``runtime="heap"`` opts dynamic policies into the event-heap
        decision core (``repro.core.runtime.HeapLoopCore``): O(log n) per
        decision instant instead of the reference core's full O(n) state
        walk, with byte-identical traces (docs/ARCHITECTURE.md "Decision
        core").  ``runtime="scan"``/default keeps the reference core;
        policies with custom ``replan`` logic fall back to it silently."""
        from .runtime import ExecutorPool, run as _run

        if workers is not None:
            executor = ExecutorPool(backend=executor, workers=workers)
        if share:
            from .panes import run_shared

            trace, book = run_shared(
                self.policy, workload, executor,
                pane_tuples=pane_tuples, **runtime_kw,
            )
            trace.pane_book = book
            return trace
        if pane_tuples is not None:
            raise ValueError("pane_tuples= only applies with share=True")
        return _run(self.policy, workload, executor=executor, **runtime_kw)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"Planner(policy={self.policy.name!r})"


def as_queries(queries: Union[Query, Sequence[Query]]) -> List[Query]:
    """Normalize the ``plan()`` input: one query or a sequence."""
    if isinstance(queries, Query):
        return [queries]
    return list(queries)


# ---------------------------------------------------------------------------
# Session facade (continuous operation)
# ---------------------------------------------------------------------------


class Session:
    """Facade over ``repro.core.session.SessionRuntime``: the long-running
    counterpart of ``Planner`` for CONTINUOUS operation.

    Where ``Planner.run`` drains a fixed workload and returns, a Session
    stays live: recurring queries roll over window after window on one
    carried-over executor timeline, new queries are admitted (gated by a
    schedulability pre-flight) or withdrawn mid-run, and — with
    ``calibrate=True`` — cost models refit themselves from execution
    feedback, triggering replans of future windows when drift crosses the
    threshold::

        s = Session(policy="llf-dynamic", calibrate=True)
        s.submit(RecurringQuerySpec(base=q, period=60.0, num_windows=None))
        s.run_until(600.0)            # ten windows roll over
        s.submit(urgent_query)        # online admission at t=600
        s.run_until(1200.0)
        s.withdraw(q.query_id)
        series = s.trace.outcome_series(q.query_id)

    Accepts everything ``Planner.run`` accepts (policy name or instance,
    ``executor=``, ``workers=`` pool shorthand) plus the session knobs
    (``calibrate``, ``drift_threshold``, ``min_samples``, ``refit_every``,
    ``c_max``, ``admission_control``, ``start_time``), the pane-sharing
    knobs (``sharing=True`` to share pane partials across overlapping
    windows of queries on a common ``Query.stream``, ``pane_tuples`` to
    override the GCD pane width — docs/API.md "Pane sharing"), the
    overload knobs (``overload=``, ``on_renegotiate=`` — docs/API.md
    "Overload control"), the predictive-scheduling knob (``forecast=``
    — arrival forecasting, proactive shedding ahead of forecast bursts,
    speculative pane pre-warming; docs/API.md "Predictive scheduling")
    and the scaling knobs (``runtime="heap"`` for the O(log n) event-heap
    decision core, ``admission="incremental"`` for the maintained
    ``DemandLedger`` admission fast path — docs/API.md "Scaling the
    decision core").  ``tenancy=`` (a ``repro.core.tenancy.TenancyConfig``
    or a ``{tenant: TenantQuota}`` dict) turns on multi-tenant arbitration:
    per-tenant rate/capacity quotas at admission, weighted max-min fairness
    ACROSS tenants when overload shedding kicks in, and ``set_quota`` for
    runtime quota changes (docs/API.md "Multi-tenancy").
    """

    def __init__(self, policy: Union[str, SchedulingPolicy] = "llf-dynamic",
                 executor: Optional[Executor] = None, **session_kw):
        from .session import SessionRuntime

        self._runtime = SessionRuntime(policy, executor, **session_kw)

    # -- delegation (the facade IS the runtime, minus its internals) -----
    @property
    def policy(self) -> SchedulingPolicy:
        """The scheduling policy driving this session."""
        return self._runtime.policy

    @property
    def executor(self) -> Executor:
        """The session's (single, carried-over) execution backend."""
        return self._runtime.executor

    @property
    def now(self) -> float:
        """Current modelled time of the session's continuous timeline."""
        return self._runtime.now

    @property
    def trace(self):
        """The live ``SessionTrace``: executions, outcomes and session
        lifecycle events recorded so far."""
        return self._runtime.trace

    @property
    def live_ids(self) -> List[str]:
        """Base ids of every submitted, not-yet-withdrawn query."""
        return self._runtime.live_ids

    @property
    def book(self):
        """Pane-sharing bookkeeping (``repro.core.panes.SharedBook``) when
        the session runs with ``sharing=True``; None otherwise."""
        return self._runtime.book

    @property
    def pane_stats(self):
        """Pane-cache scan/hit/eviction counters (None without sharing)."""
        return self._runtime.pane_stats

    def calibrator(self, base_id: str):
        """The live ``CalibratingCostModel`` of ``base_id`` (None unless
        the session was built with ``calibrate=True``)."""
        return self._runtime.calibrator(base_id)

    def history(self, base_id: Optional[str] = None):
        """Public per-spec observation record
        (``repro.core.forecast.SpecHistory``): per-window realized arrival
        observations (collected at every window close, with or without
        ``forecast=``) plus the calibration loop's cost samples and the
        admission-time shed in force.  With ``base_id`` one spec's record;
        without, a dict over every spec ever submitted."""
        return self._runtime.history(base_id)

    def forecaster(self, base_id: str):
        """The live ``ArrivalForecaster`` of ``base_id`` (None unless the
        session was built with ``forecast=``)."""
        return self._runtime.forecaster(base_id)

    def submit(self, spec, *, force: bool = False):
        """Admit a Query / DynamicQuerySpec / RecurringQuerySpec into the
        live session, gated by the schedulability pre-flight
        (``repro.core.schedulability.admission_check``); ``force=True``
        records the report but admits regardless.  Returns an
        ``AdmissionResult`` (truthy iff admitted)."""
        return self._runtime.submit(spec, force=force)

    def withdraw(self, base_id: str) -> None:
        """Remove a live query mid-run: active windows are deleted at the
        next between-batch instant (§4.2), future windows never open."""
        self._runtime.withdraw(base_id)

    def set_quota(self, tenant: str, quota=None):
        """Set, replace or (``quota=None``) remove one tenant's
        ``TenantQuota`` at run time, then rebalance so a tightened quota
        immediately sheds that tenant's own live windows against its new
        share.  Returns the applied ``SheddingPlan`` (None when nothing
        had to move)."""
        return self._runtime.set_quota(tenant, quota)

    def rebalance(self):
        """Mid-run overload response: shed the minimum from the lowest
        tiers (fair shares first under ``tenancy=``) when the live set has
        drifted infeasible.  Returns the applied ``SheddingPlan`` or None."""
        return self._runtime.rebalance()

    def run_until(self, horizon: float, max_steps: int = 1_000_000):
        """Advance the continuous timeline to ``horizon``, processing every
        decision instant (window roll-overs, admissions, batches,
        recalibrations) on the way; returns the ``SessionTrace``."""
        return self._runtime.run_until(horizon, max_steps=max_steps)

    def run(self, max_steps: int = 1_000_000):
        """Drain every admitted window (bounded specs only — open-ended
        recurrence needs ``run_until``)."""
        return self._runtime.run(max_steps=max_steps)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return repr(self._runtime).replace("SessionRuntime", "Session", 1)
