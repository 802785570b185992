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

        ``share=True`` (pane-based shared execution, ``core/panes.py`` in
        the JAX package) raises until pane sharing is ported.

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
            raise NotImplementedError(
                "share=True needs pane sharing (core/panes.py), which is not "
                "ported to repro_torch yet")
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
