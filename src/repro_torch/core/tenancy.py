"""Multi-tenant arbitration: per-tenant quotas, weighted max-min fairness
and Zipf-skewed traffic (the production regime the paper abstracts away).

The paper's multi-query scheduler assumes every query belongs to one
principal; a shared serving deployment has thousands of tenants on one
stream, where one tenant's burst must not shed another tenant's workload.
This module supplies the cross-tenant layer, sitting ABOVE the strict
priority tiers of ``repro.core.overload``:

* fairness decides how much executor capacity each tenant is entitled to
  (``fair_shares``: weighted max-min / water-filling over per-tenant
  demand, bounded by each tenant's ``TenantQuota``);
* tiers keep ordering queries WITHIN a tenant's share exactly as before
  (dispatch selection is untouched — arbitration acts only through the
  shedding planner and the admission gate, which is what keeps
  ``tenant=None`` traces byte-identical to the single-principal runtime).

``tenant_quota_condition`` is the admission-side check: a NECESSARY
per-tenant condition in the style of ``work_demand_condition``, evaluated
against each tenant's quota-scaled capacity slice.  ``plan_shedding``
(``repro.core.overload``) consumes the same config to shed an over-quota
tenant against its OWN share before touching anyone else's queries.

Nothing here imports the overload or session machinery — pure math over
``Query`` rows, so it is usable from planners, ledgers and benchmarks
alike.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from .schedulability import FeasibilityReport, edf_order
from .types import EPS, Query, QueryOutcome

__all__ = [
    "TenantQuota",
    "TenancyConfig",
    "fair_shares",
    "demand_by_tenant",
    "tenant_quota_condition",
    "zipf_shares",
    "zipf_counts",
    "zipf_traffic",
    "tenant_summary",
]


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's entitlement.

    ``weight`` is the tenant's weight in max-min fair capacity division
    (relative to every other tenant's weight; the config default applies
    to tenants without an explicit quota).  ``capacity`` caps the
    tenant's share as a FRACTION of one executor's capacity (0.25 = "at
    most a quarter of the machine over any deadline horizon"); ``rate``
    caps the tenant's aggregate offered tuple rate.  ``None`` leaves a
    dimension uncapped.
    """

    weight: float = 1.0
    capacity: Optional[float] = None
    rate: Optional[float] = None

    def __post_init__(self) -> None:
        if self.weight < 0:
            raise ValueError(f"weight must be >= 0, got {self.weight}")
        if self.capacity is not None and self.capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {self.capacity}")
        if self.rate is not None and self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")


@dataclasses.dataclass
class TenancyConfig:
    """Session-level tenancy knob: per-tenant quotas + the default weight
    for tenants submitting without one.  Mutable on purpose — sessions
    renegotiate quotas at runtime (``Session.set_quota``)."""

    quotas: Dict[str, TenantQuota] = dataclasses.field(default_factory=dict)
    default_weight: float = 1.0

    def quota(self, tenant: Optional[str]) -> Optional[TenantQuota]:
        return None if tenant is None else self.quotas.get(tenant)

    def weight(self, tenant: Optional[str]) -> float:
        q = self.quota(tenant)
        return self.default_weight if q is None else q.weight


def demand_by_tenant(queries: Sequence[Query]) -> Dict[Optional[str], float]:
    """Total minimum work (``min_comp_cost``) keyed by tenant, in first-
    appearance order (deterministic for the fairness math downstream)."""
    demand: Dict[Optional[str], float] = {}
    for q in queries:
        demand[q.tenant] = demand.get(q.tenant, 0.0) + q.min_comp_cost
    return demand


def fair_shares(
    demand: Dict[Optional[str], float],
    weights: Optional[Dict[Optional[str], float]] = None,
    capacity: float = 0.0,
) -> Dict[Optional[str], float]:
    """Weighted max-min fair division (progressive filling / water-filling).

    Divide ``capacity`` across tenants in proportion to ``weights``
    (uniform when ``None``); a tenant never receives more than its
    ``demand``, and capacity a saturated tenant leaves on the table is
    re-divided among the still-unsatisfied ones by the same weights.
    Deterministic: saturation resolves in rounds, no ordering choices.
    """
    share = {t: 0.0 for t in demand}
    if capacity <= 0:
        return share

    def w(t) -> float:
        return 1.0 if weights is None else weights.get(t, 0.0)

    active = {t for t, d in demand.items() if d > EPS and w(t) > 0}
    remaining = {t: demand[t] for t in active}
    cap = capacity
    while active and cap > EPS:
        wsum = sum(w(t) for t in active)
        if wsum <= 0:
            break
        alloc = {t: cap * w(t) / wsum for t in active}
        saturated = [t for t in active if alloc[t] >= remaining[t] - 1e-12]
        if not saturated:
            for t in active:
                share[t] += alloc[t]
            break
        for t in saturated:
            share[t] += remaining[t]
            cap -= remaining[t]
            active.discard(t)
            del remaining[t]
    return share


def tenant_quota_condition(
    queries: Sequence[Query],
    config: TenancyConfig,
    now: Optional[float] = None,
) -> FeasibilityReport:
    """Per-tenant quota check: NECESSARY conditions against each tenant's
    quota-scaled slice of the executor.

    For every tenant with a ``capacity`` quota, walk that tenant's rows in
    stable EDF order (the shared ``edf_order`` helper, exactly like
    ``work_demand_condition``): each deadline-prefix's total minimum work
    must fit inside ``capacity`` × the prefix's time budget (deadline
    minus the earliest work-start instant, floored at ``now``).  For every
    tenant with a ``rate`` quota, the aggregate window-average tuple rate
    of its rows must not exceed the quota.

    Tenantless rows (``tenant=None``) and tenants without a quota are
    never flagged — the check degenerates to always-feasible for
    single-principal workloads, which is what keeps ``tenant=None``
    sessions byte-identical to the pre-tenancy runtime.  Reasons are
    reported in sorted-tenant order and are deterministic given the row
    order, so the incremental ledger path (``DemandLedger.tenant_check``)
    reproduces them byte for byte.
    """
    by_tenant: Dict[str, List[Query]] = {}
    for q in queries:
        if q.tenant is not None:
            by_tenant.setdefault(q.tenant, []).append(q)
    reasons: List[str] = []
    for tenant in sorted(by_tenant):
        quota = config.quotas.get(tenant)
        if quota is None:
            continue
        rows = edf_order(by_tenant[tenant])
        if quota.rate is not None:
            offered = sum(
                q.num_tuples_total / max(q.wind_end - q.wind_start, EPS)
                for q in rows)
            if offered > quota.rate + 1e-9:
                reasons.append(
                    f"tenant {tenant}: offered rate {offered:.4g} exceeds "
                    f"rate quota {quota.rate:.4g}")
        if quota.capacity is not None:
            cumw = 0.0
            start = float("inf")
            for q in rows:
                cumw += q.min_comp_cost
                start = min(start, q.arrival.input_time(1))
                anchor = start if now is None else max(start, now)
                budget = (q.deadline - anchor) * quota.capacity
                if cumw > budget + 1e-9:
                    reasons.append(
                        f"tenant {tenant} deadline-prefix through "
                        f"{q.query_id}: work {cumw:.4g} exceeds capacity "
                        f"share {budget:.4g} (quota {quota.capacity:.4g} of "
                        f"budget {q.deadline - anchor:.4g})")
    return FeasibilityReport(feasible=not reasons, reasons=tuple(reasons))


# ---------------------------------------------------------------------------
# Zipf-skewed multi-tenant traffic
# ---------------------------------------------------------------------------


def zipf_shares(num_tenants: int, skew: float = 1.0) -> List[float]:
    """Normalized Zipf popularity: tenant k (1-based) gets weight
    ``1 / k**skew``.  ``skew=0`` is uniform."""
    if num_tenants < 1:
        raise ValueError(f"num_tenants must be >= 1, got {num_tenants}")
    raw = [1.0 / (k ** skew) for k in range(1, num_tenants + 1)]
    total = sum(raw)
    return [r / total for r in raw]


def zipf_counts(total: int, num_tenants: int, skew: float = 1.0,
                min_each: int = 0) -> List[int]:
    """Split ``total`` items across tenants by Zipf shares, deterministically
    (largest-remainder rounding; ties break toward the more popular
    tenant).  ``min_each`` floors every tenant's count first."""
    if total < num_tenants * min_each:
        raise ValueError(
            f"total {total} cannot give {num_tenants} tenants {min_each} each")
    shares = zipf_shares(num_tenants, skew)
    spare = total - num_tenants * min_each
    exact = [s * spare for s in shares]
    counts = [int(e) for e in exact]
    remainder = spare - sum(counts)
    order = sorted(range(num_tenants),
                   key=lambda i: (-(exact[i] - counts[i]), i))
    for i in order[:remainder]:
        counts[i] += 1
    return [c + min_each for c in counts]


def zipf_traffic(
    total_queries: int,
    tenants: Sequence[str],
    query_factory: Callable[[str, int, int], Query],
    skew: float = 1.0,
) -> List[Query]:
    """Zipf-skewed multi-tenant workload: ``total_queries`` queries divided
    across ``tenants`` by ``zipf_counts`` and built via
    ``query_factory(tenant, index_within_tenant, global_index)``.  The
    factory's ``tenant`` field is stamped if it left it unset.  Queries
    are emitted round-robin across tenants (heavy tenants keep emitting
    after light ones run dry) so a time-indexed consumer sees tenants
    interleaved, not blocked — deterministic, no RNG.
    """
    counts = zipf_counts(total_queries, len(tenants), skew)
    emitted = [0] * len(tenants)
    out: List[Query] = []
    g = 0
    while g < total_queries:
        for i, tenant in enumerate(tenants):
            if emitted[i] >= counts[i] or g >= total_queries:
                continue
            q = query_factory(tenant, emitted[i], g)
            if q.tenant is None:
                q = dataclasses.replace(q, tenant=tenant)
            elif q.tenant != tenant:
                raise ValueError(
                    f"query_factory stamped tenant {q.tenant!r}, "
                    f"expected {tenant!r}")
            out.append(q)
            emitted[i] += 1
            g += 1
    return out


def tenant_summary(
    outcomes: Iterable[QueryOutcome],
) -> Dict[Optional[str], Dict[str, float]]:
    """Per-tenant SLO rollup over trace outcomes: window count, deadline-
    met count/rate, exact-answer (never shed) count, and the worst
    reported error bound.  Keys are ``QueryOutcome.tenant`` values."""
    out: Dict[Optional[str], Dict[str, float]] = {}
    for o in outcomes:
        row = out.setdefault(o.tenant, {
            "windows": 0, "met": 0, "exact": 0, "max_error_bound": 0.0,
        })
        row["windows"] += 1
        row["met"] += 1 if o.met_deadline else 0
        row["exact"] += 1 if o.shed_fraction == 0.0 else 0
        row["max_error_bound"] = max(row["max_error_bound"], o.error_bound)
    for row in out.values():
        row["met_rate"] = row["met"] / row["windows"] if row["windows"] else 1.0
    return out
