"""Continuous intermittent-query sessions (the paper's Custom Query
Scheduler RUNS CONTINUOUSLY — §1's "results are obtained at the end of each
window", §4's "queries may be added or removed at any point").

Everything before this module modelled one-shot windows: ``Planner.run``
drains a fixed workload, resets the executor per query and returns.  A
``SessionRuntime`` is the long-lived generalization:

* **recurring windows** — a ``RecurringQuerySpec`` is instantiated into
  per-window ``Query`` objects lazily at window roll-over; executor/pool
  clocks CARRY OVER across windows (one continuous timeline, never reset
  after session start);
* **online admission** — ``submit`` gates new work behind a schedulability
  pre-flight (``repro.core.schedulability.admission_check``) against
  remaining-work snapshots of the live set; ``withdraw`` removes a query
  mid-run.  Both take effect between batches (§4.2) through the shared
  ``DynamicLoopCore``, whose ``replan`` receives ``"admission"``
  SchedulingEvents;
* **self-calibrating costs** — with ``calibrate=True`` each recurring
  query's cost model is wrapped in a ``CalibratingCostModel`` fed by
  execution feedback (modelled true durations in simulation — see
  ``OracleCostExecutor`` — or measured wall seconds on real backends).
  When the drift metric crosses ``drift_threshold`` the session refits and
  replans FUTURE work: static windows are planned at window start with the
  refreshed model; dynamic runtimes get their MinBatch re-sized through the
  policy's ``on_recalibrate`` hook;
* **pane sharing** — with ``sharing=True`` the session keeps ONE
  ``repro.core.panes.SharedBook`` for its whole lifetime: window queries on
  a common ``Query.stream`` with actual overlap (several live specs, or one
  spec whose ``slide_tuples`` < range) run under the amortized
  ``SharedCostModel`` and their pane partials carry over across recurring
  windows — window ``w+1`` reuses what window ``w`` scanned, and the
  refcounted ``PaneStore`` evicts each pane the moment its last subscriber
  has consumed it;
* **predictive scheduling** — with ``forecast=`` every closed window's
  realized arrivals feed a per-spec ``repro.core.forecast``
  ``ArrivalForecaster`` (Holt-style level+trend with confidence bands).
  At window roll-over the session re-runs the overload machinery against
  the FORECAST arrival curve and sheds the new window proactively —
  before the burst lands — instead of reacting mid-burst; a mid-window
  miss detector compares realized arrivals against the forecast burst and
  REFUNDS a premature shed (restoring the original window) when the
  predicted demand is not materializing, falling back to the reactive
  path.  With ``sharing=True`` idle loop instants additionally pre-warm
  the pane cache for forecast future windows (speculative deposits,
  written off as misses when the window never consumes them).  The
  arrival history itself is collected UNCONDITIONALLY and exposed through
  ``history()`` — forecasting only adds the acting-on part.

Static policies run each window's plan on the same carried-over timeline
(``execute_plan(carryover=True)``): window k+1 starts no earlier than both
its own ``submit_time`` and the end of window k's execution — the session
owns ONE executor, exactly like the dynamic NINP loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

from .api import Executor, SchedulingPolicy, get_policy
from .arrivals import ArrivalModel, ThinnedArrival, TraceArrival
from .cost_model import CalibratingCostModel, SharedCostModel
from .forecast import (
    ArrivalForecast,
    ArrivalForecaster,
    ArrivalObservation,
    ForecastConfig,
    SpecHistory,
    forecast_query,
    observe_arrival,
    offered_arrival,
)
from .overload import (
    OverloadConfig,
    RenegotiationProposal,
    apply_shed,
    min_deadline_extension,
    overload_check,
    plan_shedding,
    tiered_work_demand_condition,
)
from .panes import PaneStats, SharedBook, pane_width
from .runtime import (
    DynamicQuerySpec,
    ExecutorPool,
    OracleCostExecutor,
    QueryRuntime,
    RuntimeState,
    _core_class,
)
from .schedulability import DemandLedger, FeasibilityReport, admission_check
from .tenancy import TenancyConfig, TenantQuota, tenant_quota_condition
from .types import (
    EPS,
    BatchExecution,
    InfeasibleDeadline,
    Query,
    QueryOutcome,
    RecurringQuerySpec,
    SessionTrace,
    split_window_id,
    window_query_id,
)

# Remaining-arrival snapshots for the admission pre-flight are exact up to
# this many pending tuples; beyond it the ORIGINAL query stands in (a
# conservative, still-valid input to the necessary conditions).
_SNAPSHOT_CAP = 20_000

# Per-spec arrival observations retained for ``history()``/forecasting
# (oldest evicted first; the forecaster's EWMA state is unaffected).
_HISTORY_CAP = 512

# Pseudo-subscriber prefix for speculative pane pre-warms.  ``?`` cannot
# start a submitted base id's per-window query id, so prewarm references
# can never collide with a real subscriber.
_PREWARM_TAG = "?forecast:"


@dataclasses.dataclass(frozen=True)
class AdmissionResult:
    """Outcome of ``SessionRuntime.submit``.

    ``decision`` refines the boolean: ``"admit"`` (feasible as submitted),
    ``"shed"`` (admitted with load shedding — ``shed_fraction`` of the
    stream dropped, answers are estimates within ``error_bound``),
    ``"renegotiate"`` (admitted after the accept hook took the proposed
    deadline extension in ``proposal``), or ``"reject"``.  Without overload
    control only ``"admit"``/``"reject"`` occur, and a declined proposal is
    a ``"reject"`` whose ``proposal`` records what was offered.
    """

    admitted: bool
    report: FeasibilityReport
    base_id: str
    decision: str = ""
    shed_fraction: float = 0.0
    error_bound: float = 0.0
    proposal: Optional[RenegotiationProposal] = None

    def __bool__(self) -> bool:
        return self.admitted


@dataclasses.dataclass
class _LiveSpec:
    """Session-side bookkeeping for one recurring query."""

    rspec: RecurringQuerySpec
    calibrator: Optional[CalibratingCostModel] = None
    next_window: int = 0
    withdrawn: bool = False
    # pane sharing: False when the stream's (first-registration-wins) pane
    # width does not divide this spec's range/slide/offset — such a spec
    # runs UNSHARED (no amortized cost model, no pane subscriptions) rather
    # than promising amortization it cannot physically realize.
    pane_ok: bool = True
    # overload control: admission-time load shed applied to this spec (every
    # window samples its stream at rate 1 - shed_fraction; answers are
    # scaled estimates within error_bound).
    shed_fraction: float = 0.0
    error_bound: float = 0.0
    # seed threaded into every ThinnedArrival this spec's shedding creates
    # (``OverloadConfig.seed``): fixes the systematic-sampling phase so
    # shed runs are reproducible; None keeps the historical phase-0 picks.
    shed_seed: Optional[int] = None
    # predictive scheduling (repro.core.forecast): per-window realized
    # arrival observations (collected unconditionally — the fuel of
    # ``history()``), the spec's forecaster (None unless ``forecast=``),
    # and the miss-triggered hold that keeps a misbehaving forecast from
    # acting until a window lands back inside its band.
    history: List[ArrivalObservation] = dataclasses.field(default_factory=list)
    forecaster: Optional[ArrivalForecaster] = None
    forecast_hold: bool = False
    # dynamic path: instantiated window runtimes; static path: pending Queries
    runtimes: List[QueryRuntime] = dataclasses.field(default_factory=list)
    pending_static: List[Query] = dataclasses.field(default_factory=list)

    @property
    def base_id(self) -> str:
        return self.rspec.base_id

    @property
    def exhausted(self) -> bool:
        if self.withdrawn:
            return True
        nw = self.rspec.num_windows
        return nw is not None and self.next_window >= nw

    @property
    def in_flight(self) -> bool:
        """Any instantiated window still running (or waiting to run)."""
        if self.pending_static:
            return True
        return any(not (rt.completed or rt.deleted) for rt in self.runtimes)

    @property
    def open_ended(self) -> bool:
        return self.rspec.num_windows is None and not self.withdrawn

    def cost_model(self):
        return (self.calibrator if self.calibrator is not None
                else self.rspec.base.cost_model)

    def window_truth(self, window: int) -> Optional[ArrivalModel]:
        """Window ``window``'s TRUE arrival process, thinned to this spec's
        shed rate when overload control degraded it: shedding is an
        actuation — the dropped tuples are never ingested, so the loop's
        availability/readiness logic must see the sampled stream."""
        truth = self.rspec.window_truth(window)
        if truth is None or self.shed_fraction <= 0:
            return truth
        keep = self.rspec.base.num_tuples_total  # base already thinned
        if truth.num_tuples_total <= keep:
            return truth
        return ThinnedArrival(base=truth, keep=keep, seed=self.shed_seed)


@dataclasses.dataclass
class _ProactiveShed:
    """One window's forecast-driven proactive shed, kept until the window
    closes so the mid-window miss check can compare realized arrivals
    against the forecast burst — and refund the shed (restore the original
    window) when the predicted demand is not materializing."""

    live: _LiveSpec
    forecast: ArrivalForecast
    check_at: float            # instant of the mid-window forecast-miss check
    fraction: float            # cumulative shed applied to the window
    error_bound: float
    orig_query: Query          # pre-shed window query (the refund target)
    orig_truth: Optional[ArrivalModel]
    checked: bool = False
    missed: bool = False


def as_recurring(
    spec: Union[Query, DynamicQuerySpec, RecurringQuerySpec],
) -> RecurringQuerySpec:
    """Normalize a submission: one-shot queries become single-window specs."""
    if isinstance(spec, RecurringQuerySpec):
        return spec
    if isinstance(spec, DynamicQuerySpec):
        truth = spec.truth
        return RecurringQuerySpec(
            base=spec.query,
            period=max(spec.query.wind_end - spec.query.wind_start, 1.0),
            num_windows=1,
            truth_factory=(lambda w: truth),
            num_groups=spec.num_groups,
            delete_time=spec.delete_time,
            total_known=spec.total_known,
        )
    if isinstance(spec, Query):
        return RecurringQuerySpec(
            base=spec,
            period=max(spec.wind_end - spec.wind_start, 1.0),
            num_windows=1,
        )
    raise TypeError(f"cannot submit {type(spec).__name__} to a session")


class SessionRuntime:
    """The long-running event loop behind ``repro.core.Session``.

    Drive it with ``submit`` / ``withdraw`` between ``run_until`` calls::

        s = SessionRuntime(policy="llf-dynamic")
        s.submit(RecurringQuerySpec(base=q, period=60.0, num_windows=10))
        s.run_until(300.0)          # windows roll over, clocks carry
        s.submit(other)             # mid-run admission (pre-flight gated)
        s.run_until(900.0)
        s.trace.outcome_series(q.query_id)
    """

    def __init__(
        self,
        policy: Union[str, SchedulingPolicy] = "llf-dynamic",
        executor: Optional[Executor] = None,
        *,
        workers: Optional[int] = None,
        start_time: Optional[float] = None,
        calibrate: bool = False,
        drift_threshold: float = 0.25,
        min_samples: int = 4,
        refit_every: int = 8,
        c_max: Optional[float] = None,
        admission_control: bool = True,
        sharing: bool = False,
        pane_tuples: Optional[int] = None,
        overload: Union[bool, OverloadConfig] = False,
        on_renegotiate: Optional[
            Callable[[RenegotiationProposal], bool]] = None,
        forecast: Union[bool, ForecastConfig, None] = None,
        runtime: Optional[str] = None,
        admission: str = "snapshot",
        tenancy: Union[TenancyConfig, Dict[str, TenantQuota], None] = None,
        **policy_params,
    ):
        if isinstance(policy, str):
            policy = get_policy(policy, **policy_params)
        elif policy_params:
            raise TypeError("policy_params only apply when policy is a name")
        if c_max is not None and hasattr(policy, "c_max"):
            # ``c_max`` is both a session knob (the loop's wall-time
            # straggler bound) and a policy knob (MinBatch sizing, §4.2).
            # One explicit value must mean ONE bound — mirror it onto the
            # policy so Session(policy="llf-dynamic", c_max=x) sizes batches
            # exactly like Planner(policy="llf-dynamic", c_max=x).
            policy.c_max = c_max
        self.policy = policy
        executor = OracleCostExecutor() if executor is None else executor
        if workers is not None:
            executor = ExecutorPool(backend=executor, workers=workers)
        self.executor = executor
        self.calibrate = calibrate
        self.drift_threshold = drift_threshold
        self.min_samples = min_samples
        self.refit_every = refit_every
        self.c_max = c_max if c_max is not None else getattr(policy, "c_max", None)
        self.admission_control = admission_control
        # Overload control (repro.core.overload): None == disabled — the
        # admission gate stays the plain admit/reject of the feasible-regime
        # runtime.  Enabled, an infeasible submission is degraded instead of
        # rejected: minimum load shed (lowest tiers first), else the
        # smallest deadline extension offered through ``on_renegotiate``.
        if isinstance(overload, OverloadConfig):
            self.overload: Optional[OverloadConfig] = overload
        else:
            self.overload = OverloadConfig() if overload else None
        self.on_renegotiate = on_renegotiate
        # Predictive scheduling (repro.core.forecast): None == disabled —
        # arrival history is still collected (``history()``), but nothing
        # acts on it and every trace stays byte-identical to the reactive
        # session.  Enabled, window roll-overs replan against the forecast
        # arrival curve (proactive shedding needs ``overload=`` too) and
        # idle capacity pre-warms forecast panes (needs ``sharing=True``).
        if isinstance(forecast, ForecastConfig):
            self.forecast: Optional[ForecastConfig] = forecast
        else:
            self.forecast = ForecastConfig() if forecast else None
        # Multi-tenancy (repro.core.tenancy): None == disabled — every
        # query belongs to the anonymous pool and all traces stay
        # byte-identical to the single-tenant session.  Enabled, admission
        # enforces per-tenant rate/capacity quotas and overload shedding
        # arbitrates ACROSS tenants by weighted max-min fairness before the
        # strict tiers order work WITHIN each tenant's share.
        if isinstance(tenancy, dict):
            tenancy = TenancyConfig(quotas=dict(tenancy))
        self.tenancy: Optional[TenancyConfig] = tenancy
        # Pane sharing (repro.core.panes): ONE book for the whole session, so
        # pane partials cached in window w carry over to every later window
        # that overlaps it (slide < range), and across queries on the stream.
        self.book: Optional[SharedBook] = (
            SharedBook(pane_tuples=pane_tuples) if sharing else None
        )
        if pane_tuples is not None and not sharing:
            raise ValueError("pane_tuples= only applies with sharing=True")
        self.trace = SessionTrace()
        # live SharedCostModel wrappers per stream (query_id, model), kept
        # in sync with the sharer count by _resync_sharers
        self._shared_models: Dict[str, List] = {}
        self._live: Dict[str, _LiveSpec] = {}
        self._state = RuntimeState(
            runtimes=[],
            trace=self.trace,
            num_workers=getattr(executor, "num_workers", 1),
            worker_names=tuple(getattr(executor, "worker_names", ())),
        )
        # Decision core: ``runtime="heap"`` opts the dynamic loop into the
        # event-heap core (O(log n) per decision, trace-identical to the
        # scan); ``"scan"``/None keep the reference full-walk core.
        self._core = _core_class(policy, runtime)(
            policy, executor, self._state,
            on_batch=self._observe, c_max=self.c_max,
        )
        # Admission pre-flight mode: ``"snapshot"`` rebuilds remaining-work
        # snapshots of the live set per submission (exact, O(n) cost-model
        # and planner calls each time); ``"incremental"`` maintains a
        # per-deadline ``DemandLedger`` updated by delta on window
        # open/close/withdraw/shed and answers the prefix-sum conditions
        # from it — full-window rows, so demand is over-estimated and an
        # infeasible verdict falls back to the exact snapshot path before
        # any reject/shed decision (the fast path only ever short-circuits
        # ACCEPTS).
        if admission not in ("snapshot", "incremental"):
            raise ValueError(
                f"admission must be 'snapshot' or 'incremental', "
                f"got {admission!r}"
            )
        self._ledger: Optional[DemandLedger] = (
            DemandLedger() if admission == "incremental" else None
        )
        self._is_dynamic = getattr(policy, "kind", "static") == "dynamic"
        self._start_time = start_time
        self._started = start_time is not None
        self._outcomes_seen = 0
        # per-window batch counts for final-agg calibration feedback (O(1)
        # instead of re-scanning the whole session trace per window)
        self._batch_counts: Dict[str, int] = {}
        # window-level (mid-run) sheds on the static path: query_id ->
        # (cumulative fraction, error bound), stamped onto the outcome
        self._window_shed: Dict[str, tuple] = {}
        # predictive scheduling: per-window offered arrival awaiting its
        # close-time observation, forecasts awaiting band scoring,
        # proactive sheds awaiting the mid-window miss check, and window
        # ids whose panes were speculatively pre-warmed.
        self._window_truths: Dict[
            str, Tuple[_LiveSpec, ArrivalModel, int, float, float]] = {}
        self._pending_forecasts: Dict[
            str, Tuple[_LiveSpec, ArrivalForecast]] = {}
        self._proactive: Dict[str, _ProactiveShed] = {}
        self._prewarmed: set = set()
        # cascaded rollups: window ids currently deferred on an upstream
        # spec (their panes pre-subscribed so the upstream's partials
        # survive until the downstream window materializes)
        self._cascade_wait: set = set()
        if start_time is not None:
            executor.reset(start_time)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def now(self) -> float:
        """Current modelled time of the session's continuous timeline."""
        return self.executor.clock()

    @property
    def live_ids(self) -> List[str]:
        """Base ids of every submitted, not-yet-withdrawn query."""
        return [b for b, l in self._live.items() if not l.withdrawn]

    def calibrator(self, base_id: str) -> Optional[CalibratingCostModel]:
        """The live ``CalibratingCostModel`` of ``base_id`` (None unless the
        session runs with ``calibrate=True``)."""
        return self._live[base_id].calibrator

    @property
    def pane_stats(self) -> Optional[PaneStats]:
        """Scan/hit/eviction counters of the session's pane cache (None
        unless the session runs with ``sharing=True``)."""
        return None if self.book is None else self.book.store.stats

    def _stream_sharers(self, stream: str) -> int:
        """Expected subscribers per pane of ``stream`` across the live
        PANE-COMPATIBLE specs: each spec contributes its window-overlap
        factor (how many of its own sliding windows cover one pane) — 1
        for tumbling windows.  Incompatible specs run unshared and count
        for nothing.  A spec whose last window has been INSTANTIATED but is
        still in flight keeps counting: its windows still subscribe panes,
        so dropping it from the divisor would re-price the other sharers'
        scans as if the sharing had already ended."""
        return sum(
            _spec_overlap(l.rspec) for l in self._live.values()
            if not l.withdrawn and l.pane_ok
            and (not l.exhausted or l.in_flight)
            and l.rspec.base.stream == stream
        )

    def _resync_sharers(self, stream: str) -> None:
        """Re-amortize every live window's SharedCostModel on ``stream`` to
        the CURRENT sharer count (documented mutability of ``sharers``):
        queries joining or leaving must not leave in-flight windows pricing
        scans against a stale k.  Models of completed windows are pruned."""
        if self.book is None:
            return
        k = max(self._stream_sharers(stream), 1)
        models = self._shared_models.get(stream, [])
        keep = []
        for qid, m in models:
            sub = self.book._subs.get(qid)
            if sub is not None and sub.done:
                continue
            m.sharers = k
            keep.append((qid, m))
        self._shared_models[stream] = keep

    # ------------------------------------------------------------------
    # Admission / withdrawal
    # ------------------------------------------------------------------
    def submit(
        self,
        spec: Union[Query, DynamicQuerySpec, RecurringQuerySpec],
        *,
        force: bool = False,
    ) -> AdmissionResult:
        """Admit a (recurring) query into the live session.

        The schedulability pre-flight checks the spec's FIRST window against
        remaining-work snapshots of everything currently admitted, evaluated
        AT the submission instant — work cannot run in the past, so backlog
        that already arrived counts in full (necessary conditions only:
        rejection proves infeasibility, acceptance promises nothing —
        deadline misses remain a measured outcome).  ``force=True`` records
        the report but admits regardless.

        With overload control enabled (``overload=``), an infeasible
        submission is degraded instead of rejected: the minimum load shed
        (lowest priority tiers first, incoming and active queries alike)
        that restores the necessary conditions is applied — answers become
        scaled sample estimates, reported through
        ``QueryOutcome.shed_fraction``/``error_bound`` and ``"shed"``
        session events; when shedding is disallowed (``Query.shed=False``)
        or insufficient, the smallest feasible deadline extension is
        offered to the ``on_renegotiate`` hook (``"renegotiate"`` events).
        Only then does the submission fall through to rejection.
        """
        rspec = as_recurring(spec)
        base_id = rspec.base_id
        if split_window_id(base_id)[1] is not None:
            raise ValueError(
                f"{base_id!r} collides with the per-window id namespace "
                "'<base>#w<k>'; pick a base id without a '#w<digits>' suffix"
            )
        if base_id in self._live:
            # Covers withdrawn ids too: a second incarnation would re-mint
            # the same per-window ids, and runtime/trace lookups (first
            # match by id) would then hit the dead incarnation's rows.
            raise ValueError(
                f"{base_id!r} already used in this session (live or "
                "withdrawn); pick a fresh base id per incarnation"
            )
        if rspec.base.upstream == base_id:
            raise ValueError(
                f"{base_id!r} names itself as upstream; a cascaded rollup "
                "must consume a DIFFERENT live spec's output"
            )
        calibrator = None
        if self.calibrate:
            if isinstance(rspec.base.cost_model, CalibratingCostModel):
                calibrator = rspec.base.cost_model
            else:
                calibrator = CalibratingCostModel(
                    rspec.base.cost_model,
                    min_samples=self.min_samples,
                    refit_every=self.refit_every,
                )
        live = _LiveSpec(rspec=rspec, calibrator=calibrator)
        live.shed_seed = None if self.overload is None else self.overload.seed
        if self.forecast is not None:
            live.forecaster = ArrivalForecaster(self.forecast)

        first = rspec.window_query(0, cost_model=live.cost_model())
        stream = rspec.base.stream
        width = None
        if self.book is not None and stream is not None:
            # Pane grid of the stream: fixed by the first compatible
            # submission as the GCD of its window range, slide and start
            # offset (so every window lands on pane boundaries).  A LATER
            # spec whose geometry the established width does not divide
            # runs unshared — re-gridding a live stream would invalidate
            # existing subscriptions, and wrapping an unalignable spec in
            # SharedCostModel would promise amortization that never
            # physically happens.
            width = self.book.peek_width(
                stream,
                pane_width(
                    (rspec.base.num_tuples_total,),
                    (s for s in (rspec.slide_tuples, rspec.base.stream_offset)
                     if s),
                ),
            )
            live.pane_ok = _pane_compatible(rspec, width)
            if live.pane_ok:
                # The admission pre-flight must already see the SHARED
                # cost — a query that is only feasible because its scans
                # are amortized should be admitted under sharing.
                k = self._stream_sharers(stream) + _spec_overlap(rspec)
                if k >= 2:
                    first = dataclasses.replace(
                        first,
                        cost_model=SharedCostModel(first.cost_model,
                                                   sharers=k,
                                                   pane_tuples=width),
                    )
        c_max = self.c_max if self.c_max is not None else float("inf")
        now = self.now
        snaps: List[Query] = []
        fast_ok = False
        if (self._ledger is not None and self.admission_control
                and not force):
            # Incremental fast path (admission="incremental"): answer the
            # prefix-sum conditions from the maintained ledger — no
            # snapshot rebuild, no per-row planner calls.  Ledger rows are
            # FULL windows, so demand is over-estimated; a feasible verdict
            # safely short-circuits to admit, an infeasible one falls back
            # to the exact snapshot pre-flight below before any
            # reject/shed decision.
            report = admission_check([first], (), c_max=c_max, now=now,
                                     ledger=self._ledger)
            fast_ok = report.feasible and (
                self.overload is None
                or tiered_work_demand_condition(
                    [*self._ledger.queries, first], now).feasible
            ) and (
                self.tenancy is None
                or self._ledger.tenant_check(
                    [first], now=now, config=self.tenancy).feasible
            )
        if not fast_ok:
            snaps = self._active_snapshot()
            report = admission_check([first], snaps, c_max=c_max, now=now)
            if self.tenancy is not None:
                # Per-tenant quota pre-flight rides on top of the generic
                # schedulability conditions (same merged ordering as the
                # ledger's ``tenant_check`` so reasons stay byte-equal).
                quota = tenant_quota_condition(
                    [*snaps, first], self.tenancy, now)
                report = FeasibilityReport(
                    feasible=report.feasible and quota.feasible,
                    reasons=(*report.reasons, *quota.reasons),
                )
        decision, shed_fraction, error_bound, proposal = "admit", 0.0, 0.0, None
        if self.admission_control and not force and not fast_ok:
            if self.overload is not None:
                # Overload activation additionally consults the tier-strict
                # demand bound: THIS runtime protects low tier numbers, so
                # a submission the generic (policy-agnostic) conditions
                # accept can still be doomed behind higher-priority work.
                needs = (not report.feasible or not
                         tiered_work_demand_condition([*snaps, first],
                                                      now).feasible)
            else:
                needs = not report.feasible
            if needs:
                outcome = None
                if self.overload is not None:
                    outcome = self._overload_admit(
                        live, first, snaps, c_max, now)
                if outcome is None:
                    self.trace.log("reject", now, base_id,
                                   "; ".join(report.reasons))
                    return AdmissionResult(False, report, base_id,
                                           decision="reject",
                                           proposal=proposal)
                decision, report, shed_fraction, error_bound, proposal = outcome
                if decision == "reject":
                    self.trace.log("reject", now, base_id,
                                   "; ".join(report.reasons))
                    return AdmissionResult(False, report, base_id,
                                           decision="reject",
                                           proposal=proposal)
                rspec = live.rspec  # shed/renegotiation may have replaced it

        self._register_true_cost(rspec)
        if self.book is not None and stream is not None:
            if live.pane_ok:
                self.book.register_stream(stream, width)
            else:
                self.trace.log(
                    "pane_incompatible", now, base_id,
                    f"stream={stream};width={width};"
                    f"range={rspec.base.num_tuples_total};"
                    f"slide={rspec.slide_tuples};"
                    f"offset={rspec.base.stream_offset}",
                )
        self._live[base_id] = live
        self.trace.log(
            "submit", now, base_id,
            f"period={rspec.period};windows={rspec.num_windows or 'inf'}",
        )
        self._instantiate_next(live)
        return AdmissionResult(
            True, report, base_id, decision=decision,
            shed_fraction=shed_fraction, error_bound=error_bound,
            proposal=proposal,
        )

    def withdraw(self, base_id: str) -> None:
        """Remove a live query mid-run: active windows are deleted at the
        next between-batch instant (§4.2), future windows never open."""
        live = self._live[base_id]
        if live.withdrawn:
            return
        now = self.now
        live.withdrawn = True
        for rt in live.runtimes:
            if not rt.completed and rt.spec.delete_time is None:
                rt.spec.delete_time = now
                self._core.notify(rt)
        if self._ledger is not None:
            for rt in live.runtimes:
                if not rt.completed:
                    self._ledger.discard(rt.q.query_id)
            for q in live.pending_static:
                self._ledger.discard(q.query_id)
        if self.book is not None:
            # Release the withdrawn windows' pane references so shared
            # panes they alone were pinning get evicted.
            for rt in live.runtimes:
                if not rt.completed:
                    self.book.withdraw(rt.q.query_id)
            for q in live.pending_static:
                self.book.withdraw(q.query_id)
            if live.rspec.base.stream is not None:
                # Surviving windows must stop amortizing scans across a
                # sharer that just left: re-amortize their SharedCostModels
                # AND re-size their MinBatches — remaining-cost and laxity
                # recompute from the live model at every decision instant,
                # but a MinBatch sized under the cheaper pre-withdraw
                # amortization can now cost more than C_max per batch,
                # breaking the §4.2-4.3 blocking bound for everyone else.
                stream = live.rspec.base.stream
                self._resync_sharers(stream)
                self._resize_stream_minbatches(stream, now)
        # Predictive bookkeeping dies with the windows: pending forecasts
        # of never-closing windows are unscoreable, and unconsumed
        # pre-warms are forecast misses (the demand never ran).
        for qid in ([rt.q.query_id for rt in live.runtimes]
                    + [q.query_id for q in live.pending_static]):
            self._pending_forecasts.pop(qid, None)
            self._proactive.pop(qid, None)
            if self.book is not None and qid in self._prewarmed:
                self.book.discard_prewarm(_PREWARM_TAG + qid)
                self._prewarmed.discard(qid)
        live.pending_static.clear()
        self.trace.log("withdraw", now, base_id)

    def _resize_stream_minbatches(self, stream: str, now: float) -> None:
        """Re-run MinBatch sizing for every live runtime on ``stream`` (its
        amortized cost just changed — a sharer joined or left)."""
        hook = getattr(self.policy, "on_recalibrate", None)
        if hook is None:
            return
        for l in self._live.values():
            if l.withdrawn or l.rspec.base.stream != stream:
                continue
            for rt in l.runtimes:
                if rt.admitted and not (rt.completed or rt.deleted):
                    try:
                        hook(rt, now)
                    except InfeasibleDeadline:
                        pass  # keep the previous MinBatch; sizing is advisory
                    self._core.notify(rt)
                    if (self._ledger is not None
                            and self._ledger.discard(rt.q.query_id)):
                        self._ledger.add(rt.q)

    # ------------------------------------------------------------------
    # Overload control (repro.core.overload)
    # ------------------------------------------------------------------
    def _overload_admit(self, live, first: Query, snaps: List[Query],
                        c_max: float, now: float):
        """The infeasible-admission escalation ladder: minimum load shed
        (lowest tiers first, incoming and actives alike), else smallest
        deadline extension through the ``on_renegotiate`` hook, else None
        (fall through to rejection).  Returns ``(decision, report,
        shed_fraction, error_bound, proposal)`` and mutates ``live`` (and
        shed active runtimes) accordingly."""
        cfg = self.overload
        rspec = live.rspec
        base_id = rspec.base_id
        plan = plan_shedding([first, *snaps], c_max=c_max, now=now,
                             config=cfg, prior_shed=self._prior_shed(),
                             tenancy=self.tenancy)
        if plan.feasible and not plan.fractions:
            return "admit", plan.report, 0.0, 0.0, None
        # ``plan.report`` explains every rejection below: it is the FAILING
        # feasibility report (shedding could not restore the conditions).
        if plan.feasible and plan.fractions:
            f_in = plan.fractions.get(first.query_id, 0.0)
            shed_fr = bound = 0.0
            if f_in > 0:
                thin_base, shed_fr, bound = apply_shed(
                    rspec.base, f_in, seed=cfg.seed)
                live.rspec = dataclasses.replace(rspec, base=thin_base)
                live.shed_fraction, live.error_bound = shed_fr, bound
                # A thinned window no longer lands on the stream's pane
                # grid: run it unshared rather than promising amortization
                # the sampled scan cannot realize.
                live.pane_ok = False
                self.trace.log(
                    "shed", now, base_id,
                    f"fraction={shed_fr:.4f};error_bound={bound:.4f}",
                )
            for qid, f in plan.fractions.items():
                if qid != first.query_id:
                    self._shed_active(qid, f, now)
            return "shed", plan.report, shed_fr, bound, None
        if cfg.renegotiate:
            proposal = min_deadline_extension(
                first, snaps, c_max=c_max, now=now, config=cfg)
            if proposal is not None:
                accepted = (bool(self.on_renegotiate(proposal))
                            if self.on_renegotiate is not None else False)
                self.trace.log(
                    "renegotiate", now, base_id,
                    f"extension={proposal.extension:.6g};accepted={accepted}",
                )
                if accepted:
                    ext = proposal.extension
                    live.rspec = dataclasses.replace(
                        rspec,
                        deadline_offset=rspec.deadline_offset + ext,
                        base=dataclasses.replace(
                            rspec.base, deadline=rspec.base.deadline + ext),
                    )
                    return "renegotiate", proposal.report, 0.0, 0.0, proposal
                return "reject", plan.report, 0.0, 0.0, proposal
        return "reject", plan.report, 0.0, 0.0, None

    def _shed_active(self, qid: str, fraction: float, now: float) -> None:
        """Apply a shed fraction to one LIVE window (dynamic runtime or
        pending static window) — the dropped tuples are never ingested."""
        for l in self._live.values():
            if l.withdrawn:
                continue
            for rt in l.runtimes:
                if rt.q.query_id == qid and not (rt.completed or rt.deleted):
                    self._apply_runtime_shed(rt, fraction, now)
                    return
            for i, q in enumerate(l.pending_static):
                if q.query_id == qid:
                    thin, cum, bound = apply_shed(
                        q, fraction, seed=self._shed_seed)
                    if thin is not q:
                        l.pending_static[i] = thin
                        self._window_shed[qid] = (cum, bound)
                        if (self._ledger is not None
                                and self._ledger.discard(qid)):
                            self._ledger.add(thin)
                        self.trace.log(
                            "shed", now, qid,
                            f"fraction={cum:.4f};error_bound={bound:.4f}",
                        )
                    return

    def _apply_runtime_shed(self, rt: QueryRuntime, fraction: float,
                            now: float) -> None:
        thin, cum, bound = apply_shed(rt.q, fraction, processed=rt.processed,
                                      seed=self._shed_seed)
        if thin is rt.q:
            return
        rt.spec.query = thin
        truth = rt.spec.truth
        if truth is not None and truth.num_tuples_total > thin.num_tuples_total:
            # Shedding is an actuation: the dropped tuples are never
            # ingested, so the TRUE arrival the loop polls must be the
            # sampled stream too.
            keep = thin.num_tuples_total - rt.processed
            tail = truth.num_tuples_total - rt.processed
            rt.spec.truth = ThinnedArrival(
                base=truth, keep=max(0, min(keep, tail)), prefix=rt.processed,
                seed=self._shed_seed)
        rt.spec.shed_fraction, rt.spec.error_bound = cum, bound
        self.trace.log("shed", now, rt.q.query_id,
                       f"fraction={cum:.4f};error_bound={bound:.4f}")
        hook = getattr(self.policy, "on_shed", None)
        if hook is not None and rt.admitted:
            try:
                hook(rt, now)
            except InfeasibleDeadline:
                pass  # keep the previous MinBatch; sizing is advisory
        self._core.notify(rt)
        if self._ledger is not None and self._ledger.discard(rt.q.query_id):
            self._ledger.add(rt.q)

    def rebalance(self):
        """Mid-run overload response: when cost drift (recalibration) or a
        mis-sized admission leaves the LIVE set infeasible, shed the minimum
        from the lowest tiers to restore the necessary conditions.  Returns
        the ``SheddingPlan`` applied, or None when overload control is off
        or the live set is already feasible.  Called automatically after
        every recalibration refit; safe to call by hand at any time."""
        if self.overload is None:
            return None
        now = self.now
        snaps = self._active_snapshot()
        c_max = self.c_max if self.c_max is not None else float("inf")
        ok = overload_check(snaps, c_max=c_max, now=now).feasible
        if ok and self.tenancy is not None:
            ok = tenant_quota_condition(snaps, self.tenancy, now).feasible
        if ok:
            return None
        plan = plan_shedding(snaps, c_max=c_max, now=now,
                             config=self.overload,
                             prior_shed=self._prior_shed(),
                             tenancy=self.tenancy)
        if plan.feasible:
            for qid, f in plan.fractions.items():
                self._shed_active(qid, f, now)
        return plan

    def set_quota(self, tenant: str,
                  quota: Optional[TenantQuota] = None):
        """Set, replace or (``quota=None``) remove one tenant's quota at
        run time, then ``rebalance()`` so a tightened quota immediately
        sheds that tenant's own live windows against its new share.  Logged
        as a ``"quota"`` session event; enables tenancy on first use if the
        session was built without ``tenancy=``.  Returns the applied
        ``SheddingPlan`` (None when nothing had to move)."""
        if self.tenancy is None:
            self.tenancy = TenancyConfig()
        if quota is None:
            self.tenancy.quotas.pop(tenant, None)
            detail = "removed"
        else:
            self.tenancy.quotas[tenant] = quota
            detail = (f"weight={quota.weight:.6g};"
                      f"capacity={quota.capacity};rate={quota.rate}")
        self.trace.log("quota", self.now, tenant, detail)
        return self.rebalance()

    @property
    def _shed_seed(self) -> Optional[int]:
        """Sampling-phase seed every session-made ``ThinnedArrival`` uses
        (``OverloadConfig.seed``; None == historical phase 0)."""
        return None if self.overload is None else self.overload.seed

    def _prior_shed(self) -> Dict[str, float]:
        """Cumulative already-shed fraction per live window — snapshots
        erase the thinned arrival history, so the shed planner needs it
        supplied to keep repeated rounds within the configured caps."""
        from .overload import existing_shed

        out: Dict[str, float] = {}
        for l in self._live.values():
            if l.withdrawn:
                continue
            for rt in l.runtimes:
                if not (rt.completed or rt.deleted):
                    f = existing_shed(rt.q)
                    if f > 0:
                        out[rt.q.query_id] = f
            for q in l.pending_static:
                f = existing_shed(q)
                if f > 0:
                    out[q.query_id] = f
        return out

    # ------------------------------------------------------------------
    # Predictive scheduling (repro.core.forecast)
    # ------------------------------------------------------------------
    def history(
        self, base_id: Optional[str] = None,
    ) -> Union[SpecHistory, Dict[str, SpecHistory]]:
        """Public per-spec observation record: what the session has LEARNED
        about its recurring queries.

        For each spec: the per-window realized arrival observations
        (count, mean rate, burstiness — collected at every window close,
        with or without ``forecast=``), the calibration feedback loop's
        cost samples (``(num_tuples, observed_cost)`` batch pairs and
        ``(num_batches, observed_cost)`` final-aggregation pairs; empty
        without ``calibrate=True``), and the admission-time degradation in
        force.  This is the supported read path for consumers — the
        ``_LiveSpec``/calibrator buffers behind it are internals.

        With ``base_id`` returns that spec's ``SpecHistory`` (KeyError for
        unknown ids); without, a dict over every spec ever submitted
        (withdrawn ones included — their history remains observable).
        """
        if base_id is not None:
            return self._spec_history(self._live[base_id])
        return {b: self._spec_history(l) for b, l in self._live.items()}

    def _spec_history(self, live: _LiveSpec) -> SpecHistory:
        cal = live.calibrator
        return SpecHistory(
            base_id=live.base_id,
            arrivals=tuple(live.history),
            cost_samples=cal.samples if cal is not None else (),
            agg_samples=cal.agg_samples if cal is not None else (),
            shed_fraction=live.shed_fraction,
            error_bound=live.error_bound,
        )

    def forecaster(self, base_id: str) -> Optional[ArrivalForecaster]:
        """The live ``ArrivalForecaster`` of ``base_id`` (None unless the
        session runs with ``forecast=``)."""
        return self._live[base_id].forecaster

    def _proactive_replan(
        self, live: _LiveSpec, w: int, q: Query,
    ) -> Tuple[Query, Optional[Tuple[float, float]]]:
        """Window roll-over under forecasting: forecast window ``w``'s
        arrivals and, when the forecast burst would leave the live set
        infeasible, shed the new window NOW — before the burst lands —
        instead of waiting for the reactive path to fire mid-burst.

        Returns ``(query, None)`` when nothing was shed, else ``(thinned
        query, (cumulative_fraction, error_bound))``.  Only the NEW
        window's own planned fraction is actuated: proactively thinning
        OTHER live queries on a forecast would not be refundable once they
        process sampled prefixes, so active queries stay with the reactive
        machinery (``rebalance``/admission), which this window's trimmed
        demand now helps avoid."""
        fcr = live.forecaster
        if fcr is None or not fcr.ready or live.withdrawn:
            return q, None
        fc = fcr.forecast(w)
        if fc is None:
            return q, None
        # Score every acted-era forecast at window close (band check), even
        # ones a hold kept from acting — a held forecaster must be able to
        # EARN the hold release by landing back inside its band.
        self._pending_forecasts[q.query_id] = (live, fc)
        if (live.forecast_hold or self.overload is None or not q.shed
                or fc.lower <= 0):
            return q, None
        fq = forecast_query(q, fc)
        if fq is q:
            return q, None  # no burst compression to act on
        now = self.now
        c_max = self.c_max if self.c_max is not None else float("inf")
        snaps = self._active_snapshot()
        probe = [fq, *snaps]
        if (overload_check(probe, c_max=c_max, now=now).feasible
                and tiered_work_demand_condition(probe, now).feasible
                and (self.tenancy is None or tenant_quota_condition(
                    probe, self.tenancy, now).feasible)):
            return q, None  # the forecast burst fits — nothing to do
        plan = plan_shedding(probe, c_max=c_max, now=now,
                             config=self.overload,
                             prior_shed=self._prior_shed(),
                             tenancy=self.tenancy)
        if not plan.feasible:
            return q, None  # reactive path will deal with the real burst
        f = plan.fractions.get(fq.query_id, 0.0)
        if f <= 0:
            return q, None
        thin, cum, bound = apply_shed(q, f, seed=live.shed_seed)
        if thin is q:
            return q, None
        bs = fc.burst_span(q.wind_start, q.wind_end)
        check_at = (q.wind_end - bs) + self.forecast.miss_check_frac * bs
        self._proactive[q.query_id] = _ProactiveShed(
            live=live, forecast=fc, check_at=check_at, fraction=cum,
            error_bound=bound, orig_query=q, orig_truth=live.window_truth(w),
        )
        self.trace.log(
            "forecast_shed", now, q.query_id,
            f"fraction={cum:.4f};error_bound={bound:.4f};"
            f"predicted={fc.tuples:.1f};band=[{fc.lower:.1f},{fc.upper:.1f}]",
        )
        return thin, (cum, bound)

    def _forecast_review(self) -> None:
        """Mid-window forecast-miss check: once ``miss_check_frac`` of a
        proactively-shed window's forecast burst should have arrived,
        realized arrivals below the expected curve (lower band) mean the
        burst is NOT materializing — the shed was premature.  Record the
        miss, hold the forecaster from further action, and refund the shed
        when the window has not started consuming its sampled stream."""
        if not self._proactive:
            return
        now = self.now
        for qid, rec in self._proactive.items():
            if rec.checked or now < rec.check_at - EPS:
                continue
            rec.checked = True
            q0 = rec.orig_query
            offered = offered_arrival(
                rec.orig_truth if rec.orig_truth is not None else q0.arrival)
            actual = offered.tuples_available(now)
            expected = rec.forecast.expected_by(now, q0.wind_start,
                                                q0.wind_end)
            expected *= self.forecast.miss_tolerance
            if actual + EPS >= expected:
                continue  # burst on track (within tolerance) — keep the shed
            rec.missed = True
            rec.live.forecaster.record_miss()
            rec.live.forecast_hold = True
            self._refund_forecast_shed(qid, rec, now)

    def _refund_forecast_shed(self, qid: str, rec: _ProactiveShed,
                              now: float) -> None:
        """Undo one window's proactive shed (the forecast missed): restore
        the original window query/truth so the tuples the shed would have
        dropped are ingested after all.  Only safe while nothing of the
        sampled stream has been processed — beyond that the kept-index
        sampling is already baked into results and the shed stands."""
        live = rec.live
        for rt in live.runtimes:
            if rt.q.query_id != qid or rt.completed or rt.deleted:
                continue
            if rt.processed > 0:
                return  # sampled prefix consumed — refund no longer sound
            rt.spec.query = rec.orig_query
            rt.spec.truth = rec.orig_truth
            rt.spec.shed_fraction = live.shed_fraction
            rt.spec.error_bound = live.error_bound
            self.trace.log("forecast_refund", now, qid,
                           f"fraction={rec.fraction:.4f}")
            hook = getattr(self.policy, "on_shed", None)
            if hook is not None and rt.admitted:
                try:
                    hook(rt, now)  # re-size MinBatch for the restored total
                except InfeasibleDeadline:
                    pass  # keep the previous MinBatch; sizing is advisory
            self._core.notify(rt)
            if (self._ledger is not None
                    and self._ledger.discard(rt.q.query_id)):
                self._ledger.add(rt.q)
            return
        for i, q in enumerate(live.pending_static):
            if q.query_id == qid:
                live.pending_static[i] = rec.orig_query
                if self._ledger is not None and self._ledger.discard(qid):
                    self._ledger.add(rec.orig_query)
                self._window_shed.pop(qid, None)
                self.trace.log("forecast_refund", now, qid,
                               f"fraction={rec.fraction:.4f}")
                return

    def _prewarm(self) -> None:
        """Speculative pane pre-warming: the loop just idled, so spend the
        free capacity computing pane partials for registered FUTURE windows
        of specs whose forecaster has earned trust — when the window later
        runs, its scans become cache hits.  Deposits are refcount-tagged
        speculative (``repro.core.panes``): consumed ones convert to
        ``speculative_hits``, unconsumed ones are written off as
        ``speculative_misses`` when the window closes or is withdrawn."""
        if (self.book is None or self.forecast is None
                or not self.forecast.prewarm):
            return
        now = self.now
        for live in self._live.values():
            fcr = live.forecaster
            if (live.withdrawn or not live.pane_ok or fcr is None
                    or not fcr.ready or live.forecast_hold):
                continue
            for rt in live.runtimes:
                q = rt.q
                if (rt.completed or rt.deleted or rt.processed > 0
                        or q.stream is None
                        or q.wind_start <= now + EPS
                        or q.query_id in self._prewarmed
                        or q.query_id in self._proactive
                        or not self.book.knows(q.query_id)):
                    continue
                n = self.book.prewarm(q, _PREWARM_TAG + q.query_id)
                if n:
                    self._prewarmed.add(q.query_id)
                    self.trace.log("pane_prewarm", now, q.query_id,
                                   f"panes={n}")

    def _on_window_close(self, outcome: QueryOutcome) -> None:
        """Close-time bookkeeping of one window: observe its realized
        arrivals into the spec's history, fold them into the forecaster,
        score the window's forecast against its confidence band, and write
        off any unconsumed speculative pre-warm."""
        qid = outcome.query_id
        rec = self._window_truths.pop(qid, None)
        if rec is None:
            return  # not a session window (defensive)
        live, offered, w, ws, we = rec
        obs = observe_arrival(offered, window=w, wind_start=ws, wind_end=we)
        live.history.append(obs)
        if len(live.history) > _HISTORY_CAP:
            del live.history[0]
        fcr = live.forecaster
        pending = self._pending_forecasts.pop(qid, None)
        pro = self._proactive.pop(qid, None)
        if fcr is not None:
            if pending is not None and not (pro is not None and pro.missed):
                fc = pending[1]
                if fc.contains(obs.num_tuples):
                    fcr.record_hit()
                    live.forecast_hold = False
                else:
                    fcr.record_miss()
                    live.forecast_hold = True
            fcr.observe(obs)
        if self.book is not None and qid in self._prewarmed:
            self.book.discard_prewarm(_PREWARM_TAG + qid)
            self._prewarmed.discard(qid)

    # ------------------------------------------------------------------
    # Driving the loop
    # ------------------------------------------------------------------
    def run_until(self, horizon: float, max_steps: int = 1_000_000) -> SessionTrace:
        """Advance the session's continuous timeline to ``horizon``,
        processing every decision instant on the way (window roll-overs,
        admissions, batches, recalibrations)."""
        if math.isinf(horizon):
            open_ended = [l.base_id for l in self._live.values() if l.open_ended]
            if open_ended:
                raise ValueError(
                    f"open-ended specs {open_ended} never drain; use a "
                    "finite horizon (run_until) or withdraw them first"
                )
        self._ensure_started(horizon)
        if self._is_dynamic:
            self._run_dynamic_until(horizon, max_steps)
        else:
            self._run_static_until(horizon, max_steps)
        self._drain_outcome_events()
        return self.trace

    def run(self, max_steps: int = 1_000_000) -> SessionTrace:
        """Drain every admitted window (bounded specs only)."""
        return self.run_until(math.inf, max_steps=max_steps)

    # -- dynamic path ---------------------------------------------------
    def _run_dynamic_until(self, horizon: float, max_steps: int) -> None:
        for _ in range(max_steps):
            self._replenish()
            status = self._core.tick(horizon)
            self._drain_outcome_events()
            if status == "wait":
                # The loop just idled forward to the next readiness
                # instant: free capacity forecast-driven pane pre-warming
                # may spend (no-op unless forecast= AND sharing=).
                self._prewarm()
            if status == "horizon":
                return
            if status == "stop" or (
                status == "done"
                and all(l.exhausted for l in self._live.values())
            ):
                # Drained (or the policy declared nothing will ever be
                # ready): reflect the full passage of time to the horizon so
                # later submissions join at the session's current instant.
                if math.isfinite(horizon):
                    self.executor.advance(horizon)
                return
        raise RuntimeError(f"session exceeded {max_steps} steps before "
                           f"reaching horizon {horizon}")

    # -- static path ----------------------------------------------------
    def _run_static_until(self, horizon: float, max_steps: int) -> None:
        from .runtime import execute_plan

        for _ in range(max_steps):
            self._replenish(horizon)
            q, live = self._next_static(horizon)
            if q is None:
                # Nothing left at or before the horizon; reflect the passage
                # of time so admissions submitted later see a current clock.
                if math.isfinite(horizon):
                    nxt = self._earliest_static()
                    self.executor.advance(
                        horizon if nxt is None else min(horizon, nxt)
                    )
                return
            live.pending_static.remove(q)
            window = split_window_id(q.query_id)[1] or 0
            truth = live.window_truth(window)
            if (truth is not None
                    and truth.num_tuples_total > q.num_tuples_total):
                # Window-level shed (``_shed_active`` or a proactive
                # forecast shed thinned this one pending window): the true
                # stream must deliver the sampled tuples only — shedding
                # happens at ingestion.
                truth = ThinnedArrival(base=truth, keep=q.num_tuples_total,
                                       seed=self._shed_seed)
            try:
                plan = self.policy.plan(q)[q.query_id]
            except InfeasibleDeadline as e:
                # An unplannable window is a MISS, not a non-event: record
                # an outcome (never completes, full shortfall) so met/total
                # metrics stay honest, plus the reason as its own event.
                self.trace.log("window_infeasible",
                               max(self.now, q.submit_time), q.query_id,
                               str(e))
                self.trace.outcomes.append(QueryOutcome(
                    query_id=q.query_id,
                    completion_time=math.inf,
                    deadline=q.deadline,
                    total_cost=0.0,
                    num_batches=0,
                    tuples_processed=0,
                    num_tuples_total=q.num_tuples_total,
                    tenant=q.tenant,
                ))
                self._drain_outcome_events()
                continue
            shed_fr, err_b = self._window_shed.get(
                q.query_id, (live.shed_fraction, live.error_bound))
            execute_plan(
                q, plan, self.executor, truth=truth,
                trace=self.trace, on_batch=self._observe,
                c_max=self.c_max, carryover=True,
                shed_fraction=shed_fr, error_bound=err_b,
            )
            self._drain_outcome_events()
        raise RuntimeError(f"session exceeded {max_steps} steps before "
                           f"reaching horizon {horizon}")

    def _next_static(self, horizon: float):
        best, best_live = None, None
        for live in self._live.values():
            for q in live.pending_static:
                if q.submit_time > horizon + EPS:
                    continue
                if best is None or q.submit_time < best.submit_time:
                    best, best_live = q, live
        return best, best_live

    def _earliest_static(self) -> Optional[float]:
        starts = [q.submit_time for l in self._live.values()
                  for q in l.pending_static]
        return min(starts) if starts else None

    # ------------------------------------------------------------------
    # Window roll-over
    # ------------------------------------------------------------------
    def _cascade_ready(self, live: _LiveSpec, w: int) -> bool:
        """A cascaded window (its spec names ``upstream=``) only opens once
        every upstream window its span covers has CLOSED — the rollup
        consumes the upstream's per-window outputs, so opening earlier
        would read a partial cascade.  Upstream windows are covered when
        their window end falls within the downstream window's span.  An
        unknown or withdrawn upstream ungates (nothing left to wait for)."""
        up = live.rspec.base.upstream
        if up is None:
            return True
        uplive = self._live.get(up)
        if uplive is None or uplive.withdrawn:
            return True
        ur = uplive.rspec
        q_end = live.rspec.base.wind_end + w * live.rspec.period
        kmax = math.floor((q_end - ur.base.wind_end) / ur.period + EPS)
        if ur.num_windows is not None:
            kmax = min(kmax, ur.num_windows - 1)
        if kmax < 0:
            return True
        if uplive.next_window <= kmax:
            return False  # a covered upstream window has not even opened
        for rt in uplive.runtimes:
            uw = split_window_id(rt.q.query_id)[1] or 0
            if uw <= kmax and not (rt.completed or rt.deleted):
                return False
        for uq in uplive.pending_static:
            if (split_window_id(uq.query_id)[1] or 0) <= kmax:
                return False
        return True

    def _cascade_defer(self, live: _LiveSpec, w: int) -> None:
        """First deferral of a cascaded window: pre-subscribe its panes so
        the upstream windows' reference-counted partials survive in the
        ``PaneStore`` until the rollup materializes, and log one
        ``"cascade_defer"`` event.  Subsequent deferrals of the same window
        are silent — ``_replenish`` retries every heartbeat."""
        qid = (live.rspec.base_id if live.rspec.num_windows == 1
               else window_query_id(live.rspec.base_id, w))
        if qid in self._cascade_wait:
            return
        self._cascade_wait.add(qid)
        if (self.book is not None and live.pane_ok
                and live.rspec.base.stream is not None
                and live.rspec.base.stream in self.book.widths):
            q = live.rspec.window_query(w, cost_model=live.cost_model())
            self.book.register(q)
        self.trace.log("cascade_defer", self.now, qid,
                       f"upstream={live.rspec.base.upstream}")

    def _instantiate_next(self, live: _LiveSpec) -> None:
        if live.exhausted:
            return
        w = live.next_window
        if not self._cascade_ready(live, w):
            self._cascade_defer(live, w)
            return
        q = live.rspec.window_query(w, cost_model=live.cost_model())
        truth = live.window_truth(w)
        # Arrival history is collected for EVERY window (the fuel of
        # ``history()`` and forecasting): remember the offered stream —
        # shedding unwrapped — and observe it once the window closes.
        self._window_truths[q.query_id] = (
            live,
            offered_arrival(truth if truth is not None else q.arrival),
            w,
            q.wind_start,
            q.wind_end,
        )
        q, proactive = self._proactive_replan(live, w, q)
        if (proactive is not None and truth is not None
                and truth.num_tuples_total > q.num_tuples_total):
            # A proactive shed is the same actuation as a reactive one:
            # the dropped tuples are never ingested.
            truth = ThinnedArrival(base=truth, keep=q.num_tuples_total,
                                   seed=live.shed_seed)
        if (self.book is not None and q.stream is not None and live.pane_ok
                and proactive is None):
            # Shared stream with actual overlap (other live specs and/or
            # this spec's own sliding windows): the window query plans and
            # runs under the amortized shared cost, and its panes join the
            # session-wide store — partials cached by earlier windows are
            # reused here (cache carry-over across recurring windows).
            # A proactively-shed window skips this: its thinned scan no
            # longer lands on the pane grid (same rule as admission shed).
            k = self._stream_sharers(q.stream)
            if k >= 2:
                q.cost_model = SharedCostModel(
                    q.cost_model, sharers=k,
                    pane_tuples=self.book.widths[q.stream],
                )
                self.book.register(q)
                self._shared_models.setdefault(q.stream, []).append(
                    (q.query_id, q.cost_model))
                self._resync_sharers(q.stream)
        live.next_window += 1
        self.trace.log("window_open", q.submit_time, q.query_id,
                       "" if q.upstream is None
                       else f"upstream={q.upstream}")
        if self._ledger is not None:
            # One ledger row per open window, in deadline position; the
            # post-window work is computed lazily at the first check.
            self._ledger.add(q)
        if self._is_dynamic:
            shed_fr, err_b = (proactive if proactive is not None
                              else (live.shed_fraction, live.error_bound))
            spec = DynamicQuerySpec(
                query=q,
                truth=truth,
                num_groups=live.rspec.num_groups,
                delete_time=live.rspec.delete_time,
                total_known=live.rspec.total_known,
                shed_fraction=shed_fr,
                error_bound=err_b,
            )
            rt = QueryRuntime(spec=spec)
            live.runtimes.append(rt)
            self._state.runtimes.append(rt)
        else:
            if proactive is not None:
                self._window_shed[q.query_id] = proactive
            live.pending_static.append(q)

    def _replenish(self, horizon: float = math.inf) -> None:
        """Keep the NEXT window of every live spec instantiated (lazy
        roll-over: open-ended recurrence never materializes more than one
        future window ahead).  The static path additionally materializes
        every window opening before ``horizon``.

        Doubles as the predictive heartbeat: pending forecast-miss checks
        run first, so a refund lands before the loop's next decision."""
        self._forecast_review()
        for live in self._live.values():
            if self._is_dynamic:
                last = live.runtimes[-1] if live.runtimes else None
                if (last is None or last.admitted) and not live.exhausted:
                    self._instantiate_next(live)
            else:
                while (
                    not live.exhausted
                    and live.rspec.window_start(live.next_window)
                    <= horizon + EPS
                ):
                    before = live.next_window
                    self._instantiate_next(live)
                    if live.next_window == before:
                        break  # cascade-deferred: retry next heartbeat

    # ------------------------------------------------------------------
    # Calibration feedback
    # ------------------------------------------------------------------
    def _observe(self, ex: BatchExecution) -> None:
        shared = False
        if self.book is not None:
            shared = self.book.knows(ex.query_id)
            self.book.observe(ex)
        live = self._live.get(split_window_id(ex.query_id)[0])
        if live is None or live.calibrator is None or shared:
            # Shared windows skip calibration feedback: the modelled batch
            # durations are amortized shared costs, which would mis-train a
            # calibrator that predicts the UNSHARED base (see docs/API.md,
            # "Pane sharing" — compose the two only on real backends whose
            # wall seconds measure actual shared work).
            return
        cal = live.calibrator
        if ex.kind == "final_agg":
            # Observed duration: measured wall seconds on real backends,
            # modelled (true) duration in simulation.
            wall = getattr(self.executor, "last_agg_wall", None)
            nb = self._batch_counts.pop(ex.query_id, 0)
            cal.observe_agg(nb, wall if wall is not None else ex.end - ex.start)
            return
        if ex.kind != "batch" or ex.num_tuples <= 0:
            return
        self._batch_counts[ex.query_id] = (
            self._batch_counts.get(ex.query_id, 0) + 1
        )
        wall = getattr(self.executor, "last_batch_wall", None)
        cal.observe(ex.num_tuples,
                    wall if wall is not None else ex.end - ex.start,
                    worker=ex.worker or None)
        drift = cal.drift()
        if drift > self.drift_threshold and cal.num_observations >= cal.min_samples:
            self._recalibrate(live, drift)

    def _recalibrate(self, live: _LiveSpec, drift: float) -> None:
        """Drift crossed the threshold: refit NOW and replan future work.

        Dynamic runtimes get their MinBatch re-sized via the policy's
        ``on_recalibrate`` hook; static windows pick the refreshed model up
        at plan time (plans are made at window start).  The NINP invariant
        is untouched — only future sizing/ordering changes.
        """
        cal = live.calibrator
        if not cal.refit_now():
            return
        now = self.now
        self.trace.log(
            "recalibrate", now, live.base_id,
            f"drift={drift:.4f};refit={cal.refits};obs={cal.num_observations}",
        )
        hook = getattr(self.policy, "on_recalibrate", None)
        if hook is not None:
            for rt in live.runtimes:
                if rt.admitted and not (rt.completed or rt.deleted):
                    try:
                        hook(rt, now)
                    except InfeasibleDeadline:
                        pass  # keep the previous MinBatch; sizing is advisory
                    self._core.notify(rt)
        if self._ledger is not None:
            # The refit changed the shared cost model underneath every row
            # of this spec: re-read the cached work quantities.
            for rt in live.runtimes:
                if (not (rt.completed or rt.deleted)
                        and self._ledger.discard(rt.q.query_id)):
                    self._ledger.add(rt.q)
            for i, q in enumerate(live.pending_static):
                if self._ledger.discard(q.query_id):
                    self._ledger.add(q)
        # Drift can leave the corrected workload infeasible — the overload
        # path (when enabled) sheds the minimum from the lowest tiers to
        # restore the necessary conditions instead of riding into misses.
        self.rebalance()

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _ensure_started(self, horizon: float) -> None:
        """First drive: anchor the timeline at the earliest submitted work
        (matching ``runtime.run``'s start), unless ``start_time`` pinned it."""
        if self._started:
            return
        starts: List[float] = []
        if self._is_dynamic:
            starts = [rt.q.submit_time for rt in self._state.runtimes]
        else:
            starts = [q.submit_time for l in self._live.values()
                      for q in l.pending_static]
        start = min(starts, default=0.0)
        if math.isfinite(horizon):
            start = min(start, horizon)
        self.executor.reset(start)
        self._started = True

    def _register_true_cost(self, rspec: RecurringQuerySpec) -> None:
        if rspec.true_cost_model is None:
            return
        backend = getattr(self.executor, "backend", self.executor)
        if isinstance(backend, OracleCostExecutor):
            backend.true_models[rspec.base_id] = rspec.true_cost_model
        else:
            raise TypeError(
                "true_cost_model requires an OracleCostExecutor backend "
                f"(got {type(backend).__name__}); real backends exhibit "
                "their own true costs"
            )

    def _active_snapshot(self) -> List[Query]:
        """Remaining-work snapshots of everything currently admitted, for
        the admission pre-flight."""
        now = self.now
        snaps: List[Query] = []
        for live in self._live.values():
            if live.withdrawn:
                continue
            for rt in live.runtimes:
                if rt.completed or rt.deleted:
                    continue
                snap = _remaining_query(rt, now)
                if snap is not None:
                    snaps.append(snap)
            snaps.extend(live.pending_static)
        return _relax_doomed(snaps, now)

    def _drain_outcome_events(self) -> None:
        while self._outcomes_seen < len(self.trace.outcomes):
            o = self.trace.outcomes[self._outcomes_seen]
            self._outcomes_seen += 1
            self.trace.log(
                "window_close", o.completion_time, o.query_id,
                f"met={o.met_deadline};shortfall={o.shortfall}",
            )
            if self._ledger is not None:
                self._ledger.discard(o.query_id)
            self._on_window_close(o)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"SessionRuntime(policy={getattr(self.policy, 'name', '?')!r}, "
            f"now={self.now:.6g}, live={self.live_ids})"
        )


def _pane_compatible(rspec: RecurringQuerySpec, width: int) -> bool:
    """True when ``width`` divides the spec's window range, slide and start
    offset — i.e. every window of the spec is an exact union of panes on
    the stream's grid.  Anything else would subscribe few or zero panes
    while still advertising amortized costs."""
    if width < 1:
        return False
    slide = rspec.slide_tuples or 0
    return (
        rspec.base.num_tuples_total % width == 0
        and rspec.base.stream_offset % width == 0
        and (slide % width == 0 if slide else True)
    )


def _spec_overlap(rspec: RecurringQuerySpec) -> int:
    """How many windows of ``rspec`` cover one stream pane in steady state:
    ``ceil(range / slide)`` for sliding windows, 1 for tumbling (slide >=
    range) or single-window specs."""
    if rspec.base.stream is None or rspec.num_windows == 1:
        return 1
    slide = rspec.slide_tuples or 0
    if slide <= 0:
        ov = max(rspec.base.num_tuples_total, 1)  # identical windows
    else:
        ov = -(-rspec.base.num_tuples_total // slide)  # ceil
    if rspec.num_windows is not None:
        # No more windows than exist can ever cover one pane.
        ov = min(ov, rspec.num_windows)
    return max(ov, 1)


def _remaining_query(rt: QueryRuntime, now: float) -> Optional[Query]:
    """Snapshot of an in-flight query's REMAINING work as a fresh Query
    (pending tuples with their remaining arrival instants): the live-set
    input to ``admission_check``.  Falls back to the original query above
    ``_SNAPSHOT_CAP`` pending tuples (conservative but still a valid
    necessary-condition input).

    Deadlines already beyond saving are relaxed by the caller
    (``_relax_doomed``) before the snapshot set reaches the admission
    checks."""
    q = rt.q
    remaining = q.num_tuples_total - rt.processed
    if remaining <= 0:
        return None
    if rt.processed == 0 or remaining > _SNAPSHOT_CAP:
        return q
    ts = tuple(
        q.arrival.input_time(k)
        for k in range(rt.processed + 1, q.num_tuples_total + 1)
    )
    return dataclasses.replace(
        q,
        num_tuples_total=remaining,
        arrival=TraceArrival(timestamps=ts),
        wind_start=ts[0],
        wind_end=max(ts[-1], ts[0]),
        submit_time=None,
    )


def _relax_doomed(snaps: List[Query], now: float) -> List[Query]:
    """Relax deadlines that are already beyond saving.

    Processing the snapshot set in EDF order, each query's completion is at
    least ``now`` plus the cumulative minimum work before and including it —
    arrival availability and batching overheads only push it later.  A
    deadline below that lower bound is ALREADY lost, whatever is or is not
    admitted next: leaving it in place would make every deadline-prefix
    containing it infeasible and lock admissions out permanently.  Such
    deadlines are relaxed to the bound — the query's demand still occupies
    the executor in every prefix, but only deadlines that can still be won
    constrain the verdict."""
    order = sorted(snaps, key=lambda q: q.deadline)
    t = now
    relaxed: Dict[int, float] = {}
    for q in order:
        t += q.cost_model.cost(q.num_tuples_total)
        if q.deadline < t:
            relaxed[id(q)] = t
    if not relaxed:
        return snaps
    return [
        dataclasses.replace(q, deadline=relaxed[id(q)])
        if id(q) in relaxed else q
        for q in snaps
    ]
