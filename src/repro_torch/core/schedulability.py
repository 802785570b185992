"""Schedulability analysis for the dynamic NINP scheduler (paper §4.3, §7.4).

Exact schedulability of non-preemptive task sets is NP-complete (Georges et
al., paper ref [21]), so — like the paper — we provide *necessary* conditions
used as a pre-flight check and in experiments to explain infeasible cases
(the paper's §7.4 "sum of last-batch costs was ~105, so the largest deadline
must be >= windowEnd + 105" analysis is exactly `post_window_condition`).

Every check takes an optional ``now``: the instant the verdict is being made
(an online admission).  Work cannot be scheduled in the past, so prewindow
capacity before ``now`` — a "phantom prefix" that previously let mid-session
admissions credit processing time that had already elapsed — does not count,
and neither does post-window budget before ``now``.  ``now=None`` (the
default) is the offline pre-run case: the whole timeline is still ahead.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from .policies.single import plan_single, plan_without_agg_cost
from .types import EPS, InfeasibleDeadline, Query


@dataclasses.dataclass(frozen=True)
class FeasibilityReport:
    feasible: bool  # False == a NECESSARY condition failed (definitely infeasible)
    reasons: Tuple[str, ...]

    def __bool__(self) -> bool:
        return self.feasible


def edf_order(queries: Sequence[Query]) -> List[Query]:
    """Deadline-ascending (EDF) order — stable, so equal deadlines keep
    their submission order.  THE shared helper behind every deadline-prefix
    walk (``post_window_condition``, ``work_demand_condition``, the tiered
    overload variant and the incremental ``DemandLedger``), which used to
    be four private copies of the same ``sorted(..., key=deadline)``."""
    return sorted(queries, key=lambda q: q.deadline)


def max_prewindow_tuples(q: Query, now: Optional[float] = None) -> int:
    """Largest stream prefix a dedicated executor could finish strictly by
    q's window end (in-order batches, arrivals respected, nothing scheduled
    before ``now``).  Monotone in k, so binary-searchable via the backward
    planner on the k-tuple prefix."""
    import dataclasses as _dc

    floor = -math.inf if now is None else now

    def feasible(k: int) -> bool:
        if k == 0:
            return True
        # The k-prefix as its own query.  ``wind_end`` is inert to the
        # backward planner (it plans against the explicit deadline below)
        # but must satisfy the Query invariant wind_end >= wind_start even
        # for arrival models whose early instants precede the declared
        # window start (session remaining-work snapshots, ShiftedArrival
        # windows) — clamp instead of crashing the admission path.
        qk = _dc.replace(
            q,
            num_tuples_total=k,
            wind_end=max(q.arrival.input_time(k), q.wind_start),
            deadline=q.wind_end,
        )
        try:
            plan = plan_without_agg_cost(qk, q.wind_end)
        except InfeasibleDeadline:
            return False
        # No phantom prefix: the plan must be executable from ``now`` on.
        return not plan.batches or plan.batches[0].sched_time >= floor - EPS

    lo, hi = 0, q.num_tuples_total
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if feasible(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def min_post_window_work(q: Query, now: Optional[float] = None) -> float:
    """Lower bound on the work that MUST run after q's window end: even if a
    dedicated executor maximally front-loads the stream prefix (from ``now``
    on), the remaining tuples still cost at least one batch after the window
    (final-aggregation cost excluded to keep the bound valid for
    single-batch completions)."""
    k = max_prewindow_tuples(q, now)
    rest = q.num_tuples_total - k
    return q.cost_model.cost(rest) if rest > 0 else 0.0


class DemandLedger:
    """Maintained per-deadline demand structure for INCREMENTAL admission.

    One row per live query, kept in EDF (deadline-ascending, stable) order
    in a sorted container; each row caches the quantities the deadline-
    prefix conditions read — minimum work (``min_comp_cost``), first-tuple
    arrival instant, window end, and (lazily) the minimum post-window work.
    ``add``/``discard``/``update`` apply single-row deltas — an O(n)
    memmove in the row lists but NO cost-model or planner calls for the
    untouched rows — instead of rebuilding the whole snapshot, and the
    checks evaluate every deadline prefix at once as numpy prefix sums.

    ``work_demand`` is byte-identical to ``work_demand_condition`` over the
    same rows (``np.cumsum`` accumulates left-to-right exactly like the
    scalar loop; the parity tests pin this).  ``post_window`` matches
    ``post_window_condition`` when the cached post-window work is fresh;
    rows cached at an earlier ``now`` UNDERSTATE the pinned work
    (``min_post_window_work`` is nondecreasing in ``now``), so a stale
    ledger errs on the admitting side — the direction the §4.3 gate is
    documented to err in anyway.

    ``extra`` rows (the incoming queries of an admission check) are merged
    into deadline position on the fly without mutating the ledger.
    """

    def __init__(self, queries: Sequence[Query] = ()):
        self._ids: List[str] = []
        self._queries: List[Query] = []
        self._deadlines: List[float] = []
        self._work: List[float] = []
        self._arrive: List[float] = []
        self._wind_end: List[float] = []
        self._post: List[Optional[float]] = []
        self._arrays = None  # cached numpy views of the base rows
        for q in edf_order(queries):
            self._insert(len(self._ids), q, None)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, query_id: str) -> bool:
        return query_id in self._ids

    @property
    def queries(self) -> List[Query]:
        """Live rows in EDF order (e.g. for the tiered overload check)."""
        return list(self._queries)

    # -- delta maintenance ----------------------------------------------
    def _insert(self, i: int, q: Query,
                post_work: Optional[float]) -> None:
        self._ids.insert(i, q.query_id)
        self._queries.insert(i, q)
        self._deadlines.insert(i, q.deadline)
        self._work.insert(i, q.min_comp_cost)
        self._arrive.insert(i, q.arrival.input_time(1))
        self._wind_end.insert(i, q.wind_end)
        self._post.insert(i, post_work)
        self._arrays = None

    def add(self, q: Query, now: Optional[float] = None,
            post_work: Optional[float] = None) -> None:
        """Insert a row at its deadline position (equal deadlines keep
        insertion order, like the stable EDF sort).  ``post_work`` may be
        supplied to skip the planner call; None computes it lazily on the
        first ``post_window`` check."""
        i = bisect.bisect_right(self._deadlines, q.deadline)
        if post_work is None and now is not None:
            post_work = min_post_window_work(q, now)
        self._insert(i, q, post_work)

    def discard(self, query_id: str) -> bool:
        """Drop the row for ``query_id`` (False when absent)."""
        try:
            i = self._ids.index(query_id)
        except ValueError:
            return False
        for rows in (self._ids, self._queries, self._deadlines, self._work,
                     self._arrive, self._wind_end, self._post):
            del rows[i]
        self._arrays = None
        return True

    def update(self, q: Query, now: Optional[float] = None) -> None:
        """Replace the row for ``q.query_id`` (shed thinned the stream,
        renegotiation moved the deadline): discard + re-add."""
        self.discard(q.query_id)
        self.add(q, now=now)

    # -- the checks ------------------------------------------------------
    def _base_arrays(self):
        if self._arrays is None:
            import numpy as np

            self._arrays = (
                np.array(self._deadlines, dtype=np.float64),
                np.array(self._work, dtype=np.float64),
                np.array(self._arrive, dtype=np.float64),
                np.array(self._wind_end, dtype=np.float64),
            )
        return self._arrays

    def _merged(self, extra: Sequence[Query], now: Optional[float],
                with_post: bool):
        """Base rows + ``extra`` merged into deadline position.  Returns
        (ids, deadlines, work, arrive, wind_end, post_or_None)."""
        import numpy as np

        dl, work, arrive, wend = self._base_arrays()
        ids = self._ids
        post = None
        if with_post:
            for i, p in enumerate(self._post):
                if p is None:  # lazily computed, then cached
                    self._post[i] = min_post_window_work(self._queries[i], now)
            post = np.array(self._post, dtype=np.float64)
        if extra:
            # np.insert with sorted positions keeps the stable merge order:
            # an extra row lands AFTER every equal-deadline base row, the
            # same place the stable sort of [*base, *extra] puts it.
            pos: List[int] = []
            edl: List[float] = []
            ework: List[float] = []
            earr: List[float] = []
            ewend: List[float] = []
            epost: List[float] = []
            eids = list(ids)
            offset = 0
            for q in edf_order(extra):
                i = bisect.bisect_right(self._deadlines, q.deadline)
                pos.append(i)
                eids.insert(i + offset, q.query_id)
                edl.append(q.deadline)
                ework.append(q.min_comp_cost)
                earr.append(q.arrival.input_time(1))
                ewend.append(q.wind_end)
                if with_post:
                    epost.append(min_post_window_work(q, now))
                offset += 1
            dl = np.insert(dl, pos, edl)
            work = np.insert(work, pos, ework)
            arrive = np.insert(arrive, pos, earr)
            wend = np.insert(wend, pos, ewend)
            if with_post:
                post = np.insert(post, pos, epost)
            ids = eids
        return ids, dl, work, arrive, wend, post

    def work_demand(self, extra: Sequence[Query] = (),
                    now: Optional[float] = None) -> FeasibilityReport:
        """Processor-demand bound over the maintained rows (+ ``extra``):
        vectorized twin of ``work_demand_condition``."""
        import numpy as np

        ids, dl, work, arrive, _, _ = self._merged(extra, now, False)
        if not len(dl):
            return FeasibilityReport(feasible=True, reasons=())
        cumw = np.cumsum(work)
        start = np.minimum.accumulate(arrive)
        anchor = start if now is None else np.maximum(start, now)
        budget = dl - anchor
        reasons = tuple(
            f"deadline-prefix through {ids[i]}: total work "
            f"{float(cumw[i]):.4g} exceeds budget {float(budget[i]):.4g} "
            f"(deadline {float(dl[i]):.6g} - work start {float(anchor[i]):.6g})"
            for i in np.flatnonzero(cumw > budget + 1e-9)
        )
        return FeasibilityReport(feasible=not reasons, reasons=reasons)

    def post_window(self, extra: Sequence[Query] = (),
                    now: Optional[float] = None) -> FeasibilityReport:
        """§7.4 post-window bound over the maintained rows (+ ``extra``):
        vectorized twin of ``post_window_condition`` (exact when the cached
        post-window work is fresh; see the class docstring)."""
        import numpy as np

        ids, dl, _, _, wend, post = self._merged(extra, now, True)
        if not len(dl):
            return FeasibilityReport(feasible=True, reasons=())
        cumpost = np.cumsum(post)
        anchor = np.minimum.accumulate(wend)
        if now is not None:
            anchor = np.maximum(anchor, now)
        budget = dl - anchor
        reasons = tuple(
            f"deadline-prefix through {ids[i]}: post-window work "
            f"{float(cumpost[i]):.4g} exceeds budget {float(budget[i]):.4g} "
            f"(deadline {float(dl[i]):.6g} - work start {float(anchor[i]):.6g})"
            for i in np.flatnonzero(cumpost > budget + 1e-9)
        )
        return FeasibilityReport(feasible=not reasons, reasons=reasons)

    def check(self, extra: Sequence[Query] = (),
              now: Optional[float] = None) -> FeasibilityReport:
        """Both prefix conditions over the maintained rows (+ ``extra``)."""
        parts = [self.post_window(extra, now), self.work_demand(extra, now)]
        return FeasibilityReport(
            feasible=all(p.feasible for p in parts),
            reasons=tuple(r for p in parts for r in p.reasons),
        )

    # -- tenancy ---------------------------------------------------------
    def merged_queries(self, extra: Sequence[Query] = ()) -> List[Query]:
        """Live ``Query`` rows with ``extra`` merged into deadline position
        — the same stable merge as ``_merged`` (an extra row lands AFTER
        every equal-deadline base row), but materialized as query objects
        for checks that need more than the cached numeric columns."""
        if not extra:
            return list(self._queries)
        out = list(self._queries)
        deadlines = list(self._deadlines)
        for q in edf_order(extra):
            i = bisect.bisect_right(deadlines, q.deadline)
            out.insert(i, q)
            deadlines.insert(i, q.deadline)
        return out

    def tenant_check(self, extra: Sequence[Query] = (),
                     now: Optional[float] = None,
                     config: Optional["TenancyConfig"] = None,  # noqa: F821
                     ) -> FeasibilityReport:
        """Per-tenant quota conditions over the maintained rows
        (+ ``extra``): the incremental twin of calling
        ``repro.core.tenancy.tenant_quota_condition`` on the equivalent
        snapshot list.  Verdicts AND reason strings are byte-identical to
        the snapshot path over the same rows — the condition re-sorts each
        tenant's rows with the stable EDF helper, so the merge order above
        collapses to the stable sort of ``[*base, *extra]`` (the tenancy
        regression tests pin this).  ``config=None`` is trivially
        feasible (no quotas to violate)."""
        if config is None:
            return FeasibilityReport(feasible=True, reasons=())
        from .tenancy import tenant_quota_condition

        return tenant_quota_condition(self.merged_queries(extra), config, now)


def post_window_condition(
    queries: Sequence[Query], now: Optional[float] = None
) -> FeasibilityReport:
    """§7.4's necessary condition, generalised to EDF prefixes.

    Sort by deadline; for every deadline-prefix, the sum of minimum
    post-window work must fit between the EARLIEST window end in the prefix
    (before which none of that work can start — and never before ``now``)
    and the prefix's deadline.  A single shared executor cannot do better
    regardless of strategy, so failure proves infeasibility.  (The paper's
    §7.4 instance — identical windows, sum of last-batch costs 105 vs
    largest deadline — is the degenerate case of this check.)

    Evaluated as prefix sums over a one-shot ``DemandLedger`` built at
    ``now``: each query's ``min_post_window_work`` is computed ONCE (the
    per-prefix re-walk used to re-run the backward planner O(n^2) times)
    and accumulated left-to-right exactly like the old inner sum.
    """
    return DemandLedger(queries).post_window(now=now)


def work_demand_condition(
    queries: Sequence[Query], now: Optional[float] = None
) -> FeasibilityReport:
    """Processor-demand bound (classic single-machine necessary condition):
    for every deadline-prefix, the prefix's TOTAL minimum work must fit
    between the earliest instant any of it could start — no query can run
    before its first tuple arrives, and nothing runs before ``now`` — and
    the prefix's deadline.  One shared executor must complete ALL of the
    prefix's work by then regardless of strategy, so failure proves
    infeasibility.

    This complements ``post_window_condition``, which bounds only the work
    pinned AFTER each window's end: under smooth arrivals the per-query
    prewindow capacity of that check assumes a dedicated executor, so k
    overlapping queries that individually keep up — but jointly offer k
    times the executor's capacity — pass it while failing this one.  The
    overloaded regime (``repro.core.overload``) is detected here.

    Delegates to a one-shot ``DemandLedger`` (the maintained structure
    sessions keep incrementally); the prefix sums accumulate in the same
    order as the old scalar loop, so reports are byte-identical.
    """
    return DemandLedger(queries).work_demand(now=now)


def single_query_condition(queries: Sequence[Query]) -> FeasibilityReport:
    """Each query must be feasible in isolation (necessary)."""
    reasons: List[str] = []
    for q in queries:
        try:
            plan_single(q)
        except InfeasibleDeadline as e:
            reasons.append(f"{q.query_id}: infeasible alone ({e})")
    return FeasibilityReport(feasible=not reasons, reasons=tuple(reasons))


def blocking_period_bound(queries: Sequence[Query], c_max: float) -> FeasibilityReport:
    """§4.3: with batch costs bounded by C_max, a newly released urgent query
    waits at most C_max (+ its own work).  Flags queries whose slack at
    submission is smaller than that bound — they can miss purely from
    blocking, which no NINP strategy avoids."""
    reasons: List[str] = []
    for q in queries:
        slack = q.deadline - q.wind_end - q.min_comp_cost
        if 0 <= slack < c_max:
            reasons.append(
                f"{q.query_id}: slack {slack:.4g} < C_max {c_max:.4g}; "
                "vulnerable to NINP blocking"
            )
    # Blocking vulnerability is a warning, not a proof of infeasibility.
    return FeasibilityReport(feasible=True, reasons=tuple(reasons))


def check(
    queries: Sequence[Query],
    c_max: float = float("inf"),
    now: Optional[float] = None,
) -> FeasibilityReport:
    """Combined pre-flight: necessary conditions + blocking warnings."""
    parts = [
        single_query_condition(queries),
        post_window_condition(queries, now),
        work_demand_condition(queries, now),
        blocking_period_bound(queries, c_max),
    ]
    return FeasibilityReport(
        feasible=all(p.feasible for p in parts),
        reasons=tuple(r for p in parts for r in p.reasons),
    )


def admission_check(
    incoming: Sequence[Query],
    active: Sequence[Query] = (),
    c_max: float = float("inf"),
    now: Optional[float] = None,
    ledger: Optional[DemandLedger] = None,
) -> FeasibilityReport:
    """Online admission pre-flight: may ``incoming`` join the LIVE set?

    ``active`` are remaining-work snapshots of the currently admitted
    queries (a session builds them from its runtime state: pending tuples
    and their remaining arrival instants).  ``now`` is the admission
    instant: snapshots carry arrival timestamps of already-arrived-but-
    unprocessed tuples in the past, and without the ``now`` floor the
    prewindow analysis would credit a phantom prefix of processing time
    that has already elapsed.  The checks stay NECESSARY conditions, so
    ``feasible=False`` proves the union cannot be scheduled by any NINP
    strategy on one executor — the caller should reject the submission
    (§4.3: exact schedulability is NP-complete, so the gate errs on the
    admitting side; deadline misses remain a measured outcome).

    * each incoming query must be feasible in isolation (the active ones
      passed this gate at their own admission);
    * the §7.4 post-window condition must hold across the UNION;
    * C_max blocking warnings are reported for the incoming set.

    ``ledger`` switches the union checks to the INCREMENTAL path: the
    prefix conditions read the maintained ``DemandLedger`` rows (with
    ``incoming`` merged in on the fly) instead of rebuilding from an
    ``active`` snapshot list — ``active`` is ignored in that case.  Ledger
    rows are registered full-window demand, not remaining-work snapshots,
    and cached post-window work may predate ``now``; both approximations
    err on the admitting side (see ``DemandLedger``), so a session using
    this as a fast pre-gate falls back to the exact snapshot path when the
    fast verdict is infeasible.
    """
    if ledger is not None:
        parts = [
            single_query_condition(incoming),
            ledger.post_window(extra=incoming, now=now),
            ledger.work_demand(extra=incoming, now=now),
            blocking_period_bound(incoming, c_max),
        ]
    else:
        parts = [
            single_query_condition(incoming),
            post_window_condition([*active, *incoming], now),
            work_demand_condition([*active, *incoming], now),
            blocking_period_bound(incoming, c_max),
        ]
    return FeasibilityReport(
        feasible=all(p.feasible for p in parts),
        reasons=tuple(r for p in parts for r in p.reasons),
    )
