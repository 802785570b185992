"""Overload control: priority tiers, bounded-error load shedding and
deadline renegotiation.

The paper's schedulers (§4-§5) assume the workload is schedulable; when the
necessary conditions of ``repro.core.schedulability`` fail — at admission,
or mid-run when cost drift makes remaining deadlines infeasible — the
runtime previously let queries blow their deadlines with full shortfall.
Deadline-aware engines need an explicit overloaded-regime story (Cameo's
priority + reactive degradation; POTUS's predictive shedding): this module
adds a fourth decision dimension — how MUCH of the stream to process — on
top of the paper's when / where / in-what-order:

* **priority tiers** — ``Query.tier`` (0 = highest) is STRICT: the dynamic
  policies never run a ready tier-k query while a ready query of a lower
  tier number exists; within a tier the chosen strategy (LLF/EDF/SJF/RR)
  orders as before.  With every query on the default tier 0 the ordering —
  and every trace — is byte-identical to the tierless runtime.
* **bounded-error load shedding** — ``plan_shedding`` computes the MINIMUM
  shed (uniform tuple sampling, lowest-priority tiers first) that restores
  the necessary schedulability conditions, as a ``SheddingPlan`` of
  per-query drop fractions.  ``apply_shed`` realizes a fraction on a query
  by thinning its arrival (``repro.core.arrivals.ThinnedArrival`` —
  systematic uniform sampling), so every planner, policy and admission
  check transparently sees the smaller workload.  Real backends fetch the
  sampled tuples through the thinned index map and SCALE the aggregates by
  the inverse keep rate (``repro.serve.analytics``), making shed answers
  unbiased estimates whose relative error bound (``shed_error_bound``) is
  reported in ``QueryOutcome.shed_fraction`` / ``error_bound``.
* **deadline renegotiation** — when a query's answer must stay exact
  (``Query.shed=False``), ``min_deadline_extension`` finds the smallest
  deadline extension that makes the workload feasible; a session surfaces
  it as a ``RenegotiationProposal`` through its accept/reject hook and a
  ``"renegotiate"`` session event (``repro.core.session``).

Everything here is advisory arithmetic over the schedulability conditions —
pure functions with no runtime state.  The *enforcement* points are the
tier-aware ``DynamicPolicy.replan`` ordering and the session admission path
(admit / admit-with-shed / renegotiate / reject); both are inert unless
overload control is switched on (``Session(overload=True)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .arrivals import ThinnedArrival
from .schedulability import FeasibilityReport, admission_check, edf_order
from .tenancy import (TenancyConfig, demand_by_tenant,
                      tenant_quota_condition)
from .types import EPS, Query

__all__ = [
    "OverloadConfig",
    "RenegotiationProposal",
    "SheddingPlan",
    "apply_shed",
    "min_deadline_extension",
    "overload_check",
    "plan_shedding",
    "shed_error_bound",
    "tiered_work_demand_condition",
]

# Shed fractions are searched on a per-mille grid: fine enough that the
# minimum-shed guarantee is within 0.1% of optimal, coarse enough that the
# search (and the reported fractions) stay deterministic and readable.
_SHED_RESOLUTION = 1000


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Knobs of the overload-control subsystem.

    ``max_shed`` caps the tuple fraction any single query may lose;
    ``max_error_bound`` caps the reported relative error bound of a shed
    answer — a shed that would blow either cap is treated as infeasible and
    the admission falls through to renegotiation/rejection.
    ``renegotiate`` gates the deadline-extension path for ``shed=False``
    queries; ``max_extension`` bounds the largest extension ever proposed.

    ``headroom`` over-sheds (and over-extends) past the bare necessary
    conditions by requiring every deadline budget to fit ``1 + headroom``
    times the demanded work.  The conditions are NECESSARY, not sufficient:
    they ignore per-batch overheads, final aggregations and NINP
    quantization (waiting for MinBatches, non-preemptable blocking), so a
    workload shed exactly to the conditions' edge completes a whisker past
    its deadlines.  ``headroom=0`` keeps the pure minimum-shed semantics;
    ~0.2-0.3 absorbs the batching overheads in practice (the overload
    benchmark's setting).  Overload ACTIVATION always uses the untightened
    conditions — headroom only shapes how far a triggered shed goes.

    ``seed`` is threaded into every ``ThinnedArrival`` the session applies
    (``apply_shed(seed=...)``): the systematic sample's random start phase
    becomes an explicit, reproducible choice instead of the fixed phase 0.
    Which tuples a shed keeps never changes plan arithmetic (counts are
    phase-invariant) — only the realized sample; ``None`` (the default)
    keeps the historical phase-0 sampling byte-for-byte.
    """

    max_shed: float = 0.9
    max_error_bound: float = 0.5
    renegotiate: bool = True
    max_extension: float = math.inf
    headroom: float = 0.0
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.max_shed < 1.0:
            raise ValueError(f"max_shed must be in [0, 1), got {self.max_shed}")
        if self.max_error_bound <= 0:
            raise ValueError("max_error_bound must be positive")
        if self.max_extension < 0:
            raise ValueError("max_extension must be >= 0")
        if self.headroom < 0:
            raise ValueError("headroom must be >= 0")


@dataclasses.dataclass(frozen=True)
class SheddingPlan:
    """Output of ``plan_shedding``: the minimum shed restoring feasibility.

    ``fractions[qid]`` is the fraction of query ``qid``'s REMAINING tuples
    to drop — only sheddable queries appear, and only with fractions > 0.
    ``error_bounds[qid]`` is the reported relative error bound of the
    resulting estimate (``shed_error_bound`` of the cumulative degradation,
    prior rounds included).  ``feasible`` says whether
    the plan actually restores the necessary conditions: ``False`` means
    even the maximum allowed shed cannot, and ``fractions`` is empty.
    """

    fractions: Dict[str, float]
    error_bounds: Dict[str, float]
    feasible: bool
    report: FeasibilityReport

    def __bool__(self) -> bool:
        return self.feasible

    @property
    def total_shed(self) -> float:
        """Sum of per-query shed fractions (the search's minimization
        objective, lexicographic after tier order)."""
        return sum(self.fractions.values())


@dataclasses.dataclass(frozen=True)
class RenegotiationProposal:
    """The smallest deadline extension that makes ``query_id`` feasible
    against the live set — offered to the submitter for accept/reject."""

    query_id: str
    deadline: float
    proposed_deadline: float
    report: FeasibilityReport

    @property
    def extension(self) -> float:
        return self.proposed_deadline - self.deadline


def shed_error_bound(shed_fraction: float, kept_tuples: int) -> float:
    """Relative error bound of a scaled aggregate estimate after dropping
    ``shed_fraction`` of the tuples uniformly, keeping ``kept_tuples``.

    A sum/count estimated from a uniform sample of ``n`` of ``N`` tuples and
    scaled by ``N/n`` has relative standard error ``sqrt((1-n/N)/n) * cv``
    where ``cv`` is the per-tuple coefficient of variation; we report the
    2-sigma (~95%) bound under the distribution-free normalization
    ``cv = 1``::

        bound = 2 * sqrt(shed_fraction / kept_tuples)

    Monotone increasing in the shed fraction, decreasing in sample size, and
    exactly 0 when nothing was shed — which is what the monotonicity tests
    and the benchmark's error-vs-load curves rely on.  ``kept_tuples == 0``
    (everything shed) reports ``inf``: there is no estimate.
    """
    if shed_fraction <= 0:
        return 0.0
    if kept_tuples <= 0:
        return math.inf
    return 2.0 * math.sqrt(shed_fraction / kept_tuples)


def apply_shed(query: Query, fraction: float, *,
               processed: int = 0,
               seed: Optional[int] = None) -> Tuple[Query, float, float]:
    """Thin ``query`` by dropping ``fraction`` of its not-yet-processed
    tuples uniformly; returns ``(thinned_query, actual_fraction, bound)``.

    ``processed`` tuples (a mid-run shed) are exempt — they already ran.
    Dropping is integral, so ``actual_fraction`` (dropped / original total,
    NOT just the tail) can differ slightly from the request; the reported
    ``bound`` is ``shed_error_bound`` of the realized shed.  ``fraction <=
    0`` returns the query untouched.  Re-shedding an already-thinned query
    composes: the new ``ThinnedArrival`` wraps the previous one.
    ``seed`` picks the systematic sample's start phase
    (``ThinnedArrival.seed`` — reproducible sampling; None = phase 0).
    """
    total = query.num_tuples_total
    tail = total - processed
    if fraction <= 0 or tail <= 0:
        return query, existing_shed(query), shed_error_bound(
            existing_shed(query), total)
    drop = min(int(fraction * tail + 1e-9), tail)
    if drop <= 0:
        return query, existing_shed(query), shed_error_bound(
            existing_shed(query), total)
    keep = tail - drop
    arr = ThinnedArrival(base=query.arrival, keep=keep, prefix=processed,
                         seed=seed)
    new_total = processed + keep
    # Cumulative fraction against the query's ORIGINAL (pre-shed) total.
    orig = original_total(query)
    cum = (orig - new_total) / orig if orig > 0 else 0.0
    thinned = dataclasses.replace(
        query,
        num_tuples_total=new_total,
        arrival=arr,
        wind_end=max(arr.wind_end, query.wind_start),
    )
    return thinned, cum, shed_error_bound(cum, new_total)


def original_total(query: Query) -> int:
    """The query's pre-shed tuple total: unwraps nested ``ThinnedArrival``
    AND ``ShiftedArrival`` layers — windows >= 1 of a shed recurring spec
    carry ``ShiftedArrival(base=ThinnedArrival(...))``, and stopping at the
    shift wrapper would erase the shed history (under-reporting cumulative
    degradation and letting repeated shed rounds compound past the caps)."""
    from .arrivals import ShiftedArrival

    arr = query.arrival
    while isinstance(arr, (ThinnedArrival, ShiftedArrival)):
        arr = arr.base
    return max(arr.num_tuples_total, query.num_tuples_total)


def existing_shed(query: Query) -> float:
    """Fraction already shed from ``query`` (0.0 for unthinned queries)."""
    orig = original_total(query)
    if orig <= 0:
        return 0.0
    return max(0.0, (orig - query.num_tuples_total) / orig)


def _sheddable(q: Query) -> bool:
    # Pane-shared queries are excluded: thinning one subscriber's window
    # would desynchronize it from the stream's pane grid, silently breaking
    # the amortization its SharedCostModel promises.
    from .cost_model import SharedCostModel

    return q.shed and not isinstance(q.cost_model, SharedCostModel)


def tiered_work_demand_condition(
    queries: Sequence[Query], now: Optional[float] = None
) -> FeasibilityReport:
    """Work-demand bound specialized to the TIER-STRICT runtime.

    The generic necessary conditions (``repro.core.schedulability``) hold
    for ANY dispatch strategy — including ones that would starve high
    tiers.  The overload runtime is not any strategy: a ready lower-tier-
    number query always runs first, so before a query can COMPLETE the
    executor must also have absorbed (almost) every strictly-higher-
    priority tuple that arrived first.  The charge horizon is therefore
    ``min(q.deadline, q's last-tuple arrival)`` — a query cannot finish
    before its own stream does, but higher-tier work arriving AFTER the
    query could already be done never delays it.  Edge effects (a final
    batch dispatched just before a higher-tier MinBatch turns ready) can
    make this mildly conservative, so it steers only the shed/renegotiation
    planners on top of ``admission_check``; it is NOT part of the generic
    admission gate, whose verdicts stay policy-agnostic.
    """
    reasons: List[str] = []
    queries = list(queries)
    # Hoisted row caches: the quadratic walk below used to re-derive
    # min_comp_cost (a cost-model call) and the first-tuple instant (an
    # arrival-model call) per (q, p) PAIR; one call per query suffices.
    # The inner loop keeps the original submission order so the float
    # accumulation — and therefore any logged reason text — is unchanged.
    min_cost = [p.min_comp_cost for p in queries]
    first_in = [p.arrival.input_time(1) for p in queries]
    for q in edf_order(queries):
        # Lower bound on q's completion: its own last tuple must arrive.
        done_floor = q.arrival.input_time(q.num_tuples_total)
        if now is not None:
            done_floor = max(done_floor, now)
        horizon = min(q.deadline, done_floor)
        work = 0.0
        start = math.inf
        for j, p in enumerate(queries):
            if p.deadline <= q.deadline + 1e-12:
                work += min_cost[j]
            elif p.tier < q.tier:
                # Higher-priority work competing before q can be done:
                # only the tuples that will have arrived by the horizon.
                avail = p.arrival.tuples_available(horizon)
                if avail <= 0:
                    continue
                work += p.cost_model.cost(avail)
            else:
                continue
            start = min(start, first_in[j])
        anchor = start if now is None else max(start, now)
        budget = q.deadline - anchor
        if work > budget + 1e-9:
            reasons.append(
                f"tiered demand through {q.query_id}: work {work:.4g} "
                f"(incl. higher tiers) exceeds budget {budget:.4g} "
                f"(deadline {q.deadline:.6g} - work start {anchor:.6g})"
            )
    return FeasibilityReport(feasible=not reasons, reasons=tuple(reasons))


def overload_check(
    queries: Sequence[Query],
    c_max: float = float("inf"),
    now: Optional[float] = None,
) -> FeasibilityReport:
    """The overload subsystem's feasibility verdict: the generic necessary
    conditions PLUS the tier-strict demand bound."""
    rep = admission_check(queries, c_max=c_max, now=now)
    tiered = tiered_work_demand_condition(queries, now)
    return FeasibilityReport(
        feasible=rep.feasible and tiered.feasible,
        reasons=(*rep.reasons, *tiered.reasons),
    )


def _tighten(queries: Sequence[Query], now: Optional[float],
             headroom: float) -> List[Query]:
    """Shrink every deadline budget by ``1 + headroom`` (see
    ``OverloadConfig.headroom``) so the shed/extension search leaves room
    for the batching overheads the necessary conditions cannot see."""
    if headroom <= 0:
        return list(queries)
    out = []
    for q in queries:
        ref = now if now is not None else min(q.submit_time, q.wind_start)
        budget = q.deadline - ref
        if budget > 0:
            q = dataclasses.replace(q, deadline=ref + budget / (1.0 + headroom))
        out.append(q)
    return out


def _tenant_shed_groups(
    queries: Sequence[Query],
    tenancy: TenancyConfig,
    now: Optional[float],
) -> List[List[str]]:
    """Shed-group order under tenancy: fairness ABOVE tiers.

    Capacity over the workload's deadline horizon is divided across
    tenants by weight: tenant ``t``'s entitlement is ``w_t / sum(w) *
    capacity``, further capped by its ``capacity`` quota.  Tenants OVER
    their entitlement drain first, in order of normalized utilization
    (demand / entitlement, highest first) — the weighted max-min
    draining order: bursters consuming multiples of their slice shed
    against their own excess before anyone else is touched.  If pinning
    every over-entitlement tenant at its cap still leaves the set
    infeasible, the residual comes from the within-entitlement tenants
    in ascending WEIGHT order (utilization descending as tie-break):
    the weight is precisely the knob a tenant's SLO buys, so a weight-2
    victim outlasts every weight-1 neighbour even when the victim's own
    utilization is momentarily higher.  That is the no-starvation
    property the tenancy test suite pins: a well-behaved tenant is
    never degraded while an over-entitlement tenant still has shed
    budget left, and never before a lower-weight peer.  Tiers order
    groups WITHIN each tenant exactly as the single-principal planner
    does (lowest tier first).

    The ratio is taken against the UNCAPPED entitlement, not the
    demand-capped ``fair_shares`` allocation — under the latter every
    satisfied tenant's ratio degenerates to exactly 1.0 and the order
    between them would collapse to the name tie-break.

    Deterministic: final ties break on the tenant name (tenantless
    queries sort last among equals).
    """
    demand = demand_by_tenant(queries)
    anchor = now if now is not None else min(
        q.arrival.input_time(1) for q in queries)
    capacity = max(max(q.deadline for q in queries) - anchor, 0.0)
    weights = {t: tenancy.weight(t) for t in demand}
    total_w = sum(weights.values())

    def entitlement(t) -> float:
        slice_ = capacity * weights[t] / total_w if total_w > EPS else 0.0
        quota = tenancy.quota(t)
        if quota is not None and quota.capacity is not None:
            slice_ = min(slice_, quota.capacity * capacity)
        return slice_

    def ratio(t) -> float:
        d = demand[t]
        if d <= EPS:
            return 0.0
        s = entitlement(t)
        return d / s if s > EPS else math.inf

    def sort_key(t):
        name = "" if t is None else str(t)
        if ratio(t) > 1.0 + 1e-9:
            # Over entitlement: most-over first.
            return (0, -ratio(t), 0.0, name)
        # Within entitlement: lowest weight first, then highest
        # utilization — weight buys protection, not just share.
        return (1, weights[t], -ratio(t), name)

    order = sorted(demand, key=sort_key)
    groups: List[List[str]] = []
    for t in order:
        mine = [q for q in queries if _sheddable(q) and q.tenant == t]
        for tier in sorted({q.tier for q in mine}, reverse=True):
            groups.append([q.query_id for q in mine if q.tier == tier])
    return groups


def plan_shedding(
    queries: Sequence[Query],
    c_max: float = float("inf"),
    now: Optional[float] = None,
    config: OverloadConfig = OverloadConfig(),
    processed: Optional[Dict[str, int]] = None,
    prior_shed: Optional[Dict[str, float]] = None,
    tenancy: Optional[TenancyConfig] = None,
) -> SheddingPlan:
    """Minimum load shed restoring the necessary schedulability conditions.

    ``queries`` is the would-be live set (remaining-work snapshots for
    in-flight queries; ``processed`` marks tuples of each that already ran
    and are exempt from shedding).  Sheddable queries (``Query.shed=True``,
    not pane-shared) are degraded group by group — one group per tier,
    lowest tier (largest ``tier`` number) first: a drop fraction is
    binary-searched per group — each member sheds ``min(group level, its
    own cap)``, where a query's cap is the largest fraction keeping its
    cumulative shed within ``config.max_shed`` and its reported error
    bound within ``config.max_error_bound``.  Only if a group's maximum
    allowed shed still leaves the set infeasible does the next group join
    the search.  Within the deciding group the level is minimized to the
    search resolution (0.1%), so the plan is the smallest shed — group-
    lexicographically — that the (headroom-tightened) necessary conditions
    accept.

    ``tenancy`` switches on multi-tenant arbitration (inert while every
    query has ``tenant=None`` — the group order, every probe and every
    report stay byte-identical to the single-principal planner).  With
    tenants present, feasibility additionally requires
    ``tenant_quota_condition`` and groups are ordered tenant-major by
    ``_tenant_shed_groups``: over-fair-share tenants shed first (against
    their OWN quota), tiers order groups within each tenant, and a tenant
    within its share is touched only after every over-share tenant is
    exhausted.

    Error bounds are stamped PER QUERY, from each query's own kept sample
    (``effective``/``realize``), never from the pooled totals of its
    group: two queries at the same group level report different bounds
    when their kept counts differ, and a small tenant population can
    never borrow a large pool's optimistic bound.  The tenancy regression
    tests pin this invariant.

    The returned plan's ``feasible`` is False when even shedding every
    allowed query to its cap cannot restore the conditions.

    ``prior_shed`` maps a query id to the fraction ALREADY shed from it in
    earlier rounds (vs its true original total).  Remaining-work snapshots
    erase the thinned history, so without it successive shed rounds — one
    per admission — would each see a fresh query and compound past the
    caps; with it, a query's cap reflects its CUMULATIVE degradation, and
    an exhausted query simply stops being sheddable.
    """
    processed = processed or {}
    prior_shed = prior_shed or {}
    tenant_mode = tenancy is not None and any(
        q.tenant is not None for q in queries)

    def feasibility(qs: Sequence[Query]) -> FeasibilityReport:
        rep = overload_check(qs, c_max=c_max, now=now)
        if not tenant_mode:
            return rep
        tq = tenant_quota_condition(qs, tenancy, now)
        return FeasibilityReport(
            feasible=rep.feasible and tq.feasible,
            reasons=(*rep.reasons, *tq.reasons),
        )

    base_report = feasibility(queries)
    if base_report.feasible:
        return SheddingPlan({}, {}, True, base_report)

    if tenant_mode:
        groups = _tenant_shed_groups(queries, tenancy, now)
    else:
        tiers = sorted({q.tier for q in queries if _sheddable(q)},
                       reverse=True)
        groups = [[q.query_id for q in queries
                   if _sheddable(q) and q.tier == t] for t in tiers]
    groups = [g for g in groups if g]
    if not groups:
        return SheddingPlan({}, {}, False, base_report)
    group_of = {qid: gi for gi, g in enumerate(groups) for qid in g}

    def effective(q: Query, kept_local: int):
        """(cumulative fraction vs the TRUE original, error bound) of a
        candidate shed leaving ``kept_local`` of ``q``'s current tuples.

        The prior degradation is the LARGER of ``prior_shed``'s entry and
        what the query's own arrival chain still shows (a remaining-work
        snapshot may retain the thin chain or erase it); the cumulative
        fraction is then one minus the surviving ratio — prior kept times
        this round's local keep ratio.  Composing ``apply_shed``'s
        returned fraction with ``prior_shed`` instead would double-count
        every round whose snapshot retained its chain (``apply_shed``
        already reports CUMULATIVE fractions for those), collapsing the
        query's remaining cap and recruiting higher-priority groups for
        load the degraded query could still absorb itself.  The bound
        uses the locally-kept count, which under-counts a prior round's
        processed prefix — conservative (never reports a bound smaller
        than the realized one)."""
        total = q.num_tuples_total
        orig = original_total(q)
        pf_visible = 1.0 - total / orig if orig > 0 else 0.0
        pf = max(prior_shed.get(q.query_id, 0.0), pf_visible)
        ratio = kept_local / total if total > 0 else 1.0
        cum = max(1.0 - (1.0 - pf) * ratio, 0.0)
        return cum, shed_error_bound(cum, kept_local)

    def query_cap(q: Query) -> float:
        """Largest grid fraction whose REALIZED shed keeps this query's
        cumulative fraction and error bound within the caps.  Both grow
        monotonically with the fraction, so binary-searchable."""
        pr = processed.get(q.query_id, 0)
        lo, hi = 0, _SHED_RESOLUTION
        while lo < hi:
            mid = (lo + hi + 1) // 2
            f = mid / _SHED_RESOLUTION
            thin, _, _ = apply_shed(q, f, processed=pr)
            cum, bound = effective(q, thin.num_tuples_total)
            if (cum <= config.max_shed + 1e-9
                    and bound <= config.max_error_bound + 1e-9):
                lo = mid
            else:
                hi = mid - 1
        return lo / _SHED_RESOLUTION

    caps = {q.query_id: query_cap(q) for q in queries if _sheddable(q)}

    def realize(levels: Dict[int, float]):
        """Apply per-group levels (clipped to each member's own cap);
        returns (shed set, fractions, bounds).  The bound stamped for a
        query comes from ITS OWN cumulative fraction and kept count —
        never from pooled group totals (see the docstring invariant)."""
        out: List[Query] = []
        fr: Dict[str, float] = {}
        eb: Dict[str, float] = {}
        for q in queries:
            f = levels.get(group_of.get(q.query_id, -1), 0.0)
            f = min(f, caps.get(q.query_id, 0.0))
            if f <= 0:
                out.append(q)
                continue
            thin, _, _ = apply_shed(
                q, f, processed=processed.get(q.query_id, 0))
            out.append(thin)
            if thin is not q:
                cum, bound = effective(q, thin.num_tuples_total)
                fr[q.query_id] = f
                eb[q.query_id] = bound
        return out, fr, eb

    def check_levels(levels: Dict[int, float]):
        out, fr, eb = realize(levels)
        rep = feasibility(_tighten(out, now, config.headroom))
        return rep.feasible, fr, eb, rep

    levels: Dict[int, float] = {}
    for gi in range(len(groups)):
        probe = dict(levels)
        probe[gi] = 1.0  # every member clipped to its own cap
        feas, _, _, rep = check_levels(probe)
        if not feas:
            if gi < len(groups) - 1:
                # Even this group's maximum shed is not enough: pin it and
                # recruit the next group.
                levels[gi] = 1.0
                continue
            return SheddingPlan({}, {}, False, rep)
        # Binary-search the minimal level for THIS group (earlier groups
        # stay pinned): feasibility is monotone in the level.
        lo, hi = 0, _SHED_RESOLUTION
        while lo < hi:
            mid = (lo + hi) // 2
            probe[gi] = mid / _SHED_RESOLUTION
            feas, _, _, _ = check_levels(probe)
            if feas:
                hi = mid
            else:
                lo = mid + 1
        # ``lo`` always lands on a level that tested feasible (``hi`` only
        # ever holds feasible levels, and the loop exits with lo == hi).
        probe[gi] = lo / _SHED_RESOLUTION
        _, fr, eb, rep = check_levels(probe)
        return SheddingPlan(fr, eb, True, rep)
    return SheddingPlan({}, {}, False, base_report)


def min_deadline_extension(
    incoming: Query,
    active: Sequence[Query] = (),
    c_max: float = float("inf"),
    now: Optional[float] = None,
    config: OverloadConfig = OverloadConfig(),
) -> Optional[RenegotiationProposal]:
    """Smallest deadline extension making ``incoming`` feasible against
    ``active`` — the renegotiation offer for ``shed=False`` queries.

    Returns None when no extension up to ``config.max_extension`` restores
    the conditions (the active set is already drowning) or when the
    workload is feasible as-is (nothing to renegotiate).

    The returned proposal is always VALID (re-verified feasible at the
    proposed deadline).  It is the true minimum when feasibility is
    monotone in the extension — the common case; a longer deadline can in
    principle pull extra work into its own demand prefix faster than it
    buys budget, and the geometric probe + bisection then land on a
    feasible-but-not-globally-minimal boundary.
    """
    def feasible(ext: float, headroom: float = config.headroom
                 ) -> Tuple[bool, FeasibilityReport]:
        q = dataclasses.replace(incoming, deadline=incoming.deadline + ext)
        rep = overload_check(
            [*_tighten([q], now, headroom), *_tighten(active, now, headroom)],
            c_max=c_max, now=now)
        return rep.feasible, rep

    # Activation on the UNTIGHTENED conditions (headroom only shapes the
    # proposal): nothing to renegotiate when the workload truly fits.
    ok, rep = feasible(0.0, headroom=0.0)
    if ok:
        return None
    # Exponential probe for a feasible ceiling, then bisect.  The natural
    # scale is the query's own single-batch cost (an extension smaller than
    # one batch rarely flips a verdict).
    step = max(incoming.min_comp_cost, 1.0)
    hi = step
    cap = config.max_extension
    for _ in range(60):  # bounded probe: the active set may be past saving
        if hi >= cap or feasible(hi)[0]:
            break
        hi *= 2.0
    hi = min(hi, cap)
    if not math.isfinite(hi):
        return None
    ok, rep = feasible(hi)
    if not ok:
        return None
    lo = 0.0
    for _ in range(60):  # bisect to float resolution
        if hi - lo <= max(1e-9, 1e-9 * abs(hi)):
            break
        mid = (lo + hi) / 2.0
        if feasible(mid)[0]:
            hi = mid
        else:
            lo = mid
    ok, rep = feasible(hi)
    return RenegotiationProposal(
        query_id=incoming.query_id,
        deadline=incoming.deadline,
        proposed_deadline=incoming.deadline + hi,
        report=rep,
    )
