"""Pane-based shared execution for overlapping multi-query windows.

The paper schedules each intermittent query as if it owned its input: k
queries over the same stream with overlapping windows pay k scans over the
shared tuples.  Window-based stream processing solved exactly this with
pane/slice sharing (Li et al.'s panes; Cutty/Scotty slices; Mayer et al.'s
window-based parallel CEP): decompose every window into aligned panes —
width = GCD of the subscribed windows' ranges and slides, in tuples — keep
one partial aggregate per pane, and assemble each window's result by
MERGING its panes' partials.  The shared tuples are scanned once, total.

This module is that layer for ``repro.core``:

* ``pane_width``        — the GCD decomposition (window ranges + slides ->
  pane width in stream tuples).
* ``PaneStore``         — the partial-aggregate cache: panes are
  subscribed by every query whose window contains them, deposited once
  (the first scan), reused by later subscribers, and EVICTED by reference
  count the moment the last subscriber has consumed them — the cache's
  resident set is bounded by the windows still in flight, not by stream
  length.
* ``SharedBook``        — runtime-side bookkeeping: it watches the shared
  loop's ``BatchExecution`` stream (``observe`` plugs into the loop's
  ``on_batch`` hook) and advances per-query watermarks, depositing and
  releasing panes as batches cover them.  Physical executors (e.g.
  ``repro.serve.analytics.SharedAnalyticsExecutor``) share the same
  ``PaneStore`` to deduplicate REAL work; in pure simulation the store
  carries no data and the book alone keeps the counts honest.
* ``share_workload``    — the enabling transform: group a workload by
  ``Query.stream``, wrap each shared query's cost model in
  ``SharedCostModel`` (one scan + k merges, amortized per query — so
  policies, MinBatch sizing and ``admission_check`` all see the cheaper
  shared cost), and subscribe every query's panes.
* ``run_shared``        — ``runtime.run`` with sharing enabled end to end.

Sharing is a POLICY-VISIBLE choice, not a runtime fork: the loop itself is
unchanged, decisions still come from the same nine policies, and with
sharing disabled (the default everywhere) traces are byte-identical to the
unshared runtime.  What changes when it is on: per-query cost models (and
therefore laxities, MinBatch sizes and admission verdicts) reflect the
shared cost, dynamic policies align MinBatches to pane boundaries, and the
pane store deduplicates the physical work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .cost_model import SharedCostModel
from .types import BatchExecution, ExecutionTrace, PaneSpec, Query

__all__ = [
    "PaneStats",
    "PaneStore",
    "SharedBook",
    "pane_width",
    "panes_in",
    "run_shared",
    "share_workload",
]


def pane_width(ranges: Iterable[int], slides: Iterable[int] = ()) -> int:
    """Pane width in stream tuples: GCD of the window ranges and slides.

    With this width every subscribed window starts and ends exactly on a
    pane boundary (a window range is a multiple of the width, and so is
    every offset between window starts), so windows are exact unions of
    panes.  Zero slides (fully aligned windows) contribute nothing; an
    empty input yields 1.
    """
    g = 0
    for v in ranges:
        g = math.gcd(g, int(v))
    for v in slides:
        g = math.gcd(g, int(v))
    return max(g, 1)


def panes_in(stream: str, width: int, lo: int, hi: int) -> List[PaneSpec]:
    """The panes of ``stream`` fully contained in global tuple range
    ``[lo, hi)``.  With GCD-aligned windows this is an exact cover; with an
    explicit (smaller/misaligned) width the uncovered fragments simply stay
    unshared."""
    if hi <= lo:
        return []
    first = -(-lo // width)  # ceil: first pane starting at/after lo
    out = []
    idx = first
    while (idx + 1) * width <= hi:
        out.append(PaneSpec(stream=stream, index=idx, offset=idx * width,
                            num_tuples=width))
        idx += 1
    return out


@dataclasses.dataclass
class PaneStats:
    """Aggregate counters of one ``PaneStore``.

    ``scans`` — panes computed (deposited) for the first time;
    ``hits`` — pane consumptions served from the cache (a subscriber other
    than the depositor folded a cached partial instead of rescanning);
    ``fragment_scans`` — panes a query covered across MULTIPLE batches
    (batch boundary inside the pane): the tuples were scanned privately as
    fragments, so no reusable partial exists and the pane stays
    undeposited for later subscribers to compute wholesale;
    ``evictions`` — cached panes dropped after their last subscriber
    released them; ``peak_resident`` — high-water mark of simultaneously
    cached panes (the cache's memory bound, in panes).

    Speculative (forecast-driven) pre-warming keeps its own books:
    ``speculative_deposits`` — panes computed AHEAD of demand during idle
    capacity (``SharedBook.prewarm``; not counted in ``scans`` — the work
    was free wrt the loaded period); ``speculative_hits`` — pre-warmed
    panes a real subscriber later consumed from cache (the gamble paid
    off); ``speculative_misses`` — pre-warmed panes discarded unconsumed
    (the forecast was wrong; the idle work is written off).
    """

    scans: int = 0
    hits: int = 0
    fragment_scans: int = 0
    evictions: int = 0
    peak_resident: int = 0
    speculative_deposits: int = 0
    speculative_hits: int = 0
    speculative_misses: int = 0

    @property
    def reuse_ratio(self) -> float:
        """Fraction of pane consumptions served from cache (0 when nothing
        was consumed)."""
        total = self.scans + self.hits
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class PaneEntry:
    """One pane's cache slot: who still needs it, who computed it, and the
    (optional) physical partial aggregate."""

    spec: PaneSpec
    refs: set = dataclasses.field(default_factory=set)
    computed: bool = False
    depositor: str = ""
    data: Optional[object] = None
    speculative: bool = False  # pre-warmed on a forecast, not yet consumed


class PaneStore:
    """Reference-counted pane partial-aggregate cache.

    Lifecycle of a pane: ``subscribe`` (each query whose window contains it
    takes a reference, at share/plan time) -> ``deposit`` (the first
    subscriber to scan it stores the partial; idempotent — later deposits
    are no-ops) -> ``release`` (a subscriber consumed it; when the last
    reference goes, the pane is EVICTED and its data dropped).  Panes
    nobody subscribed to are never cached; panes released before being
    computed vanish silently (the window was withdrawn first).

    The store is executor-agnostic: ``data`` is whatever the physical
    backend wants to cache (a ``(num_groups, V)`` numpy partial for the
    segagg executor, ``None`` in pure simulation where only the
    bookkeeping matters).
    """

    def __init__(self) -> None:
        self._entries: Dict[Tuple[str, int], PaneEntry] = {}
        self.stats = PaneStats()

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def entry(self, stream: str, index: int) -> Optional[PaneEntry]:
        """The live entry for (stream, index), or None."""
        return self._entries.get((stream, index))

    @property
    def resident(self) -> int:
        """Panes currently cached (computed and not yet evicted)."""
        return sum(1 for e in self._entries.values() if e.computed)

    def refcount(self, stream: str, index: int) -> int:
        """Outstanding subscriber references of one pane (0 when absent)."""
        e = self._entries.get((stream, index))
        return len(e.refs) if e is not None else 0

    # -- lifecycle -------------------------------------------------------
    def subscribe(self, pane: PaneSpec, query_id: str) -> None:
        """Take a reference: ``query_id``'s window contains ``pane``."""
        e = self._entries.get(pane.key)
        if e is None:
            e = self._entries[pane.key] = PaneEntry(spec=pane)
        e.refs.add(query_id)

    def deposit(self, stream: str, index: int, *, by: str,
                data: Optional[object] = None,
                speculative: bool = False) -> bool:
        """Store the pane's partial aggregate (the first scan).  Returns
        True when this call computed the pane, False when it was already
        cached (idempotent: straggler re-queues and the book's
        watermark-level deposit after a physical deposit are no-ops).

        ``speculative=True`` marks a forecast-driven pre-warm deposit
        (``SharedBook.prewarm``): counted under ``speculative_deposits``
        rather than ``scans`` — the pane was computed from idle capacity,
        not charged to any subscriber's demand scan."""
        e = self._entries.get((stream, index))
        if e is None:
            # Unsubscribed pane: nobody else will ever need it — don't cache.
            return False
        if e.computed:
            return False
        e.computed = True
        e.depositor = by
        e.data = data
        e.speculative = speculative
        if speculative:
            self.stats.speculative_deposits += 1
        else:
            self.stats.scans += 1
        self.stats.peak_resident = max(self.stats.peak_resident, self.resident)
        return True

    def release(self, stream: str, index: int, query_id: str) -> None:
        """Drop ``query_id``'s reference; evict the pane when it was the
        last one."""
        e = self._entries.get((stream, index))
        if e is None:
            return
        e.refs.discard(query_id)
        if not e.refs:
            if e.computed:
                self.stats.evictions += 1
            e.data = None
            del self._entries[(stream, index)]

    def record_hit(self) -> None:
        """Count one cache-served pane consumption (called by the book)."""
        self.stats.hits += 1

    def record_fragment_scan(self) -> None:
        """Count one pane consumed as private fragments (no reusable
        partial produced; called by the book)."""
        self.stats.fragment_scans += 1


@dataclasses.dataclass
class _QuerySub:
    """Per-query subscription state inside a ``SharedBook``."""

    query_id: str
    stream: str
    lo: int               # global stream index of the window's first tuple
    hi: int               # one past the window's last tuple
    panes: List[PaneSpec]
    watermark: int        # global stream index processed so far
    next_pane: int = 0    # position in ``panes`` not yet consumed/released
    done: bool = False


class SharedBook:
    """Runtime-side pane bookkeeping shared by the loop and the executors.

    The book owns the ``PaneStore`` plus the per-stream pane widths and
    per-query subscriptions.  It learns about progress purely from the
    loop's trace stream: ``observe`` is an ``on_batch`` callback — batches
    advance the query's stream watermark, and every pane the watermark
    passes is deposited (first coverage) or counted as a cache hit
    (previously deposited by another query), then released.  The loop and
    executors never need pane-aware control flow; physical executors that
    want to deduplicate REAL work read and write ``book.store`` directly
    inside ``_execute``/``_finalize``.
    """

    def __init__(self, pane_tuples: Optional[int] = None):
        self.store = PaneStore()
        self.widths: Dict[str, int] = {}
        self._subs: Dict[str, _QuerySub] = {}
        self._default_width = pane_tuples
        self._prewarms: Dict[str, List[PaneSpec]] = {}

    # -- registration ----------------------------------------------------
    def register_stream(self, stream: str, width: int) -> int:
        """Fix ``stream``'s pane width (first registration wins — panes of
        a live stream cannot be re-gridded mid-run).  The book's explicit
        ``pane_tuples`` override, when given, beats the caller's derived
        width.  Returns the width in effect."""
        if self._default_width is not None:
            width = self._default_width
        if width < 1:
            raise ValueError(f"pane width must be >= 1, got {width}")
        return self.widths.setdefault(stream, width)

    def peek_width(self, stream: str, derived: int) -> int:
        """The width that WOULD govern ``stream``: the registered one, else
        the book's explicit override, else ``derived`` — without
        registering anything (callers gate registration on admission and
        compatibility checks first)."""
        got = self.widths.get(stream)
        if got is not None:
            return got
        return self._default_width if self._default_width is not None else derived

    def knows(self, query_id: str) -> bool:
        """True when ``query_id`` has a pane subscription in this book."""
        return query_id in self._subs

    def register(self, query: Query) -> Optional[_QuerySub]:
        """Subscribe ``query``'s window panes.  The stream must have been
        registered (``register_stream``); non-stream queries are ignored."""
        if query.stream is None:
            return None
        width = self.widths.get(query.stream)
        if width is None:
            width = self.register_stream(
                query.stream,
                self._default_width or max(query.num_tuples_total, 1),
            )
        lo = query.stream_offset
        hi = lo + query.num_tuples_total
        panes = panes_in(query.stream, width, lo, hi)
        sub = _QuerySub(query_id=query.query_id, stream=query.stream,
                        lo=lo, hi=hi, panes=panes, watermark=lo)
        self._subs[query.query_id] = sub
        for p in panes:
            self.store.subscribe(p, query.query_id)
        return sub

    def sharers(self, stream: str) -> int:
        """Live (not withdrawn) subscriptions on ``stream``."""
        return sum(1 for s in self._subs.values()
                   if s.stream == stream and not s.done)

    # -- speculative pre-warming (forecast-driven) -----------------------
    def prewarm(self, query: Query, tag: str) -> int:
        """Speculatively compute ``query``'s window panes from idle
        capacity, on a forecast that the window WILL be demanded.

        Every pane of the window not yet cached is deposited with
        ``speculative=True`` under ``tag`` (the forecaster's identity — a
        ``\"?\"``-prefixed pseudo-subscriber so it can never collide with a
        real query id).  The tag holds a keep-alive reference per pane so
        an eviction by departing real subscribers cannot throw the warm
        partial away before the forecast resolves.  When real demand later
        consumes a pane, ``observe`` converts it into a ``speculative_hit``
        and drops the tag reference; panes still speculative when the
        forecast is judged wrong are written off via ``discard_prewarm``.

        Returns the number of panes actually pre-warmed (0 when the stream
        has no registered pane grid yet, the window is empty, or everything
        was already cached).  Idempotent per tag."""
        if query.stream is None or tag in self._prewarms:
            return 0
        width = self.widths.get(query.stream)
        if width is None:
            return 0
        lo = query.stream_offset
        panes = panes_in(query.stream, width, lo, lo + query.num_tuples_total)
        warmed: List[PaneSpec] = []
        for p in panes:
            e = self.store.entry(p.stream, p.index)
            if e is not None and e.computed:
                continue  # already cached by real demand — nothing to warm
            self.store.subscribe(p, tag)
            if self.store.deposit(p.stream, p.index, by=tag,
                                  speculative=True):
                warmed.append(p)
            else:
                self.store.release(p.stream, p.index, tag)
        if warmed:
            self._prewarms[tag] = warmed
        return len(warmed)

    def discard_prewarm(self, tag: str) -> int:
        """Write off ``tag``'s pre-warm: every pane still speculative is a
        forecast miss (counted, then released — evicting it unless real
        subscribers hold it).  Panes already converted to hits were
        released by ``observe`` and are skipped.  Returns the miss count;
        idempotent."""
        missed = 0
        for p in self._prewarms.pop(tag, []):
            e = self.store.entry(p.stream, p.index)
            if e is not None and e.speculative and e.depositor == tag:
                e.speculative = False
                self.store.stats.speculative_misses += 1
                missed += 1
                self.store.release(p.stream, p.index, tag)
        return missed

    # -- observation (the loop's on_batch hook) --------------------------
    def observe(self, ex: BatchExecution) -> None:
        """Advance ``ex.query_id``'s watermark by one executed batch and
        deposit/consume/release every pane the watermark fully passed.

        Batches of one query are sequential over its window (the loop
        dispatches them in offset order), so cumulative ``num_tuples`` IS
        the watermark — the book needs no offsets in the trace rows.
        """
        sub = self._subs.get(ex.query_id)
        if sub is None or sub.done or ex.kind != "batch":
            return
        batch_start = sub.watermark
        sub.watermark += ex.num_tuples
        while sub.next_pane < len(sub.panes):
            pane = sub.panes[sub.next_pane]
            if pane.end > sub.watermark:
                break
            entry = self.store.entry(pane.stream, pane.index)
            if entry is not None and entry.computed:
                if entry.depositor != ex.query_id:
                    self.store.record_hit()
                # depositor == query_id: the scan was already counted at
                # deposit time (by this very query's physical _execute or a
                # previous observe call) — nothing more to count.
                if entry.speculative:
                    # A pre-warmed pane met real demand: the forecast paid
                    # off.  Hand ownership to the demand path and drop the
                    # prewarm tag's keep-alive reference.
                    entry.speculative = False
                    self.store.stats.speculative_hits += 1
                    self.store.release(pane.stream, pane.index,
                                       entry.depositor)
            elif pane.offset >= batch_start:
                # This batch covered the whole pane: a reusable partial
                # exists (real executors deposited data just before this
                # callback; in simulation the bookkeeping alone matters).
                self.store.deposit(pane.stream, pane.index, by=ex.query_id)
            else:
                # The pane straddled a batch boundary: this query scanned
                # it as private fragments, so there is NO whole-pane
                # partial to reuse.  Leave the entry uncomputed — a later
                # subscriber covering it in one batch deposits it properly
                # — and never count phantom cache activity for it.
                self.store.record_fragment_scan()
            self.store.release(pane.stream, pane.index, ex.query_id)
            sub.next_pane += 1
        if sub.watermark >= sub.hi:
            sub.done = True

    # -- teardown --------------------------------------------------------
    def withdraw(self, query_id: str) -> None:
        """Release every pane ``query_id`` still holds (the query was
        withdrawn mid-run or under-delivered); idempotent."""
        sub = self._subs.get(query_id)
        if sub is None:
            return
        while sub.next_pane < len(sub.panes):
            pane = sub.panes[sub.next_pane]
            self.store.release(pane.stream, pane.index, query_id)
            sub.next_pane += 1
        sub.done = True

    def close(self) -> None:
        """End of run: release every outstanding reference so the store
        drains (shortfalls and withdrawn queries would otherwise pin
        panes).  Unresolved pre-warms are written off as forecast misses —
        the demand they anticipated never ran."""
        for tag in list(self._prewarms):
            self.discard_prewarm(tag)
        for qid in list(self._subs):
            self.withdraw(qid)

    def chain(
        self, on_batch: Optional[Callable[[BatchExecution], None]]
    ) -> Callable[[BatchExecution], None]:
        """``on_batch`` callback that first feeds the book, then the
        caller's own callback (if any)."""
        if on_batch is None:
            return self.observe

        def chained(ex: BatchExecution) -> None:
            self.observe(ex)
            on_batch(ex)

        return chained


# ---------------------------------------------------------------------------
# Workload transform + one-call runner
# ---------------------------------------------------------------------------


def share_workload(
    workload,
    *,
    pane_tuples: Optional[int] = None,
    book: Optional[SharedBook] = None,
) -> Tuple[List["DynamicQuerySpec"], SharedBook]:  # noqa: F821
    """Enable pane sharing on a workload: returns ``(specs, book)``.

    Queries naming the same ``Query.stream`` (two or more of them) become a
    share group: each one's cost model is wrapped in ``SharedCostModel``
    (amortized one-scan-+-k-merges, with the stream's pane width) and its
    window panes are subscribed in the book's ``PaneStore``.  Queries with
    ``stream=None`` — or alone on their stream — pass through UNTOUCHED, so
    a mixed workload shares only where sharing helps.  Input specs/queries
    are never mutated; shared ones are replaced copies.

    ``pane_tuples`` overrides the per-stream GCD width (the default derives
    it from every group member's window range and start-offset deltas, which
    makes windows exact unions of panes).  Pass an existing ``book`` to
    accumulate several submissions into one cache (what a Session does —
    cache carry-over across recurring windows).
    """
    from .runtime import as_specs

    specs = as_specs(workload)
    book = SharedBook(pane_tuples=pane_tuples) if book is None else book

    groups: Dict[str, List[int]] = {}
    for i, spec in enumerate(specs):
        if spec.query.stream is not None:
            groups.setdefault(spec.query.stream, []).append(i)

    out = list(specs)
    for stream, idxs in groups.items():
        if len(idxs) < 2:
            continue  # nothing to share with
        qs = [specs[i].query for i in idxs]
        if pane_tuples is not None:
            width = pane_tuples
        else:
            # ABSOLUTE offsets, not deltas: panes are anchored at global
            # stream index 0 (``panes_in``), so the width must divide every
            # window's start offset too — otherwise no window lands on the
            # pane grid and nothing is physically shared while the wrapped
            # cost models still promise amortization.
            width = pane_width(
                (q.num_tuples_total for q in qs),
                (q.stream_offset for q in qs if q.stream_offset),
            )
        width = book.register_stream(stream, width)
        # Per-query amortization from ACTUAL pane overlap, not group size:
        # each query's ``sharers`` is the mean subscriber count over its own
        # panes, so staggered windows amortize by their true overlap and a
        # window disjoint from every other stays unshared (k < 2) instead
        # of being priced against sharing that never happens.
        spans = {
            i: panes_in(stream, width, specs[i].query.stream_offset,
                        specs[i].query.stream_offset
                        + specs[i].query.num_tuples_total)
            for i in idxs
        }
        counts: Dict[int, int] = {}
        for panes in spans.values():
            for p in panes:
                counts[p.index] = counts.get(p.index, 0) + 1
        for i in idxs:
            panes = spans[i]
            if not panes:
                continue
            mean = sum(counts[p.index] for p in panes) / len(panes)
            k = max(1, int(round(mean)))
            if k < 2:
                continue  # no real overlap for this window: run unshared
            q = specs[i].query
            shared_q = dataclasses.replace(
                q, cost_model=SharedCostModel(q.cost_model, sharers=k,
                                              pane_tuples=width),
            )
            out[i] = dataclasses.replace(specs[i], query=shared_q)
            book.register(shared_q)
    return out, book


def run_shared(
    policy,
    workload,
    executor=None,
    *,
    pane_tuples: Optional[int] = None,
    on_batch: Optional[Callable[[BatchExecution], None]] = None,
    **runtime_kw,
) -> Tuple[ExecutionTrace, SharedBook]:
    """``runtime.run`` with pane sharing enabled end to end.

    Transforms the workload (``share_workload``), chains the book's
    observer into the loop's ``on_batch`` hook, runs, and closes the book
    (releasing any references a shortfall left behind).  Returns the trace
    plus the book — ``book.store.stats`` has the scan/hit/eviction counts
    a benchmark or operator dashboard wants.
    """
    from .runtime import run

    specs, book = share_workload(workload, pane_tuples=pane_tuples)
    trace = run(policy, specs, executor, on_batch=on_batch, sharing=book,
                **runtime_kw)
    book.close()
    return trace, book
