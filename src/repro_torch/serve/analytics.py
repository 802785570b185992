"""Analytics executor of the port: the paper's intermittent GROUP-BY queries
run on the card through the segagg kernels, scheduled by ``repro_torch.core``.

Executor model (as in the JAX package's ``repro/serve/analytics.py``):

* a batch = concatenated record files; one ``process_batch`` call copies
  keys and values to the device, computes the (num_groups, V) partial
  aggregate there and SPILLS it to the host — device memory is released
  between batches exactly as the paper stores intermediate results in files
  between Spark jobs;
* ``finalize`` = the paper's final aggregation step: combine partials.

``AnalyticsRuntimeExecutor`` adapts this to the ``Executor`` protocol of
``repro_torch.core.api``, so the shared runtime loop drives real segagg
batches; ``run_plan`` replays a plan through ``execute_plan`` and
``run_session`` runs one recurring query window after window in a
``Session``.  Partials are keyed by tuple offset, so a C_max straggler
re-queue overwrites rather than double-counts.

``SharedAnalyticsExecutor`` runs overlapping windows over one stream with
pane sharing (``repro_torch.core.panes``): each uncached run of panes is
scanned once on the card by ``pane_segagg``, and the pane partials are kept
on the host in the book's ``PaneStore`` for later windows;
``run_shared_jobs`` drives it end to end, shared or unshared.

``measure_cost_model`` reproduces §6.2: run batches of different sizes,
time them, fit the piecewise-linear cost model the scheduler consumes.

Under load shedding (a ``ThinnedArrival``) batch offsets arrive in
KEPT-tuple units; the executor maps them to the underlying file indices and
weights each sampled record by the inverse keep rate (Horvitz-Thompson).

The knobs are ``device=``: the CUDA card unless the caller passes
``device="cpu"`` (see ``repro_torch.device.resolve_device``); and ``mesh=``
(a ``repro_torch.dist.DeviceMesh``), which sends every scan through the
sharded path: rows split over the mesh's devices, one segagg per device,
partials merged on its first device, which is then the executor's device.
``MeshAnalyticsBackend`` is the pool's worker backend over a mesh, with
worker clocks from measured wall seconds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (
    CostModelBase,
    LinearCostModel,
    Planner,
    Query,
    RecurringQuerySpec,
    Schedule,
    Session,
    SessionTrace,
    ShiftedArrival,
    ThinnedArrival,
    TraceArrival,
    fit_piecewise_linear,
)
from ..core.runtime import BaseExecutor, execute_plan
from ..data.tpch import AnalyticsQuery, StreamScale
from ..device import DeviceLike, resolve_device
from ..dist.mesh import MeshBackend
from ..kernels import _build
from ..kernels.segagg.ops import pane_segagg, segagg


@dataclasses.dataclass
class BatchResult:
    num_records: int
    seconds: float


def _executor_device(device: DeviceLike, mesh) -> torch.device:
    """The device an executor's partials come back on: ``device``, or the
    first device of ``mesh``; both given, they must agree.  On the card the
    kernels are built and loaded here, so no timed batch ever pays for the
    build."""
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.devices[0]
        if device is not None:
            want = resolve_device(device)
            if want.type != dev.type or (
                    want.index is not None and want.index != dev.index):
                raise ValueError(
                    f"device={want} but the mesh's first device is {dev}")
    if dev.type == "cuda":
        _build.build_all()
    return dev


class AnalyticsExecutor:
    """Executes one AnalyticsQuery in intermittent batches on ``device``.

    ``mesh=`` (a ``repro_torch.dist.DeviceMesh``) routes every scan through
    the sharded path: rows split over the mesh's devices, one segagg per
    device, partials merged across devices.  Equal to the single-device
    path for integer-valued f32 (exact under any association); ``mesh=None``
    is the unsharded path."""

    def __init__(self, query: AnalyticsQuery, scale: StreamScale,
                 device: DeviceLike = None, mesh=None):
        self.query = query
        self.scale = scale
        self.num_groups = query.num_groups(scale)
        self.device = _executor_device(device, mesh)
        self.mesh = mesh
        # Partials keyed by slot (tuple offset when driven by the runtime
        # loop): re-queued stragglers overwrite instead of double-counting.
        self.partials: Dict[int, np.ndarray] = {}
        self.batch_log: List[BatchResult] = []

    def process_batch(self, records: Dict[str, np.ndarray],
                      slot: Optional[int] = None,
                      weights: Optional[np.ndarray] = None) -> BatchResult:
        """Compute one partial aggregate.  ``weights`` (per-record value
        multipliers) realize sampled scans under load shedding.  The timed
        window covers the host-to-device copy, the kernel and the spill."""
        keys = np.asarray(self.query.key_fn(records), np.int32)
        vals = np.asarray(self.query.value_fn(records), np.float32)
        if weights is not None:
            vals = vals * np.asarray(weights, np.float32).reshape(-1, 1)
        t0 = time.perf_counter()
        if self.mesh is not None:
            part = self.mesh.segagg(keys, vals, self.num_groups)
        else:
            part = segagg(torch.from_numpy(keys).to(self.device),
                          torch.from_numpy(vals).to(self.device), self.num_groups)
        part = part.cpu().numpy()  # spill to host; device buffers released
        dt = time.perf_counter() - t0
        if slot is None:  # sequential mode: next free key, never clobber
            slot = len(self.partials)
            while slot in self.partials:
                slot += 1
        self.partials[slot] = part
        res = BatchResult(num_records=len(keys), seconds=dt)
        self.batch_log.append(res)
        return res

    def finalize(self) -> Tuple[np.ndarray, float]:
        """Final aggregation step (paper §2.1): combine the partials."""
        t0 = time.perf_counter()
        total = (
            np.sum(np.stack(list(self.partials.values())), axis=0)
            if self.partials
            else np.zeros((self.num_groups, 1), np.float32)
        )
        return total, time.perf_counter() - t0

    @property
    def num_batches(self) -> int:
        return len(self.partials)


def concat_files(files: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = files[0].keys()
    return {k: np.concatenate([f[k] for f in files]) for k in keys}


def _is_thinned(arrival) -> bool:
    """Does the arrival chain contain a ``ThinnedArrival`` (load shedding)?"""
    while True:
        if isinstance(arrival, ThinnedArrival):
            return True
        if isinstance(arrival, ShiftedArrival):
            arrival = arrival.base
            continue
        return False


def _thinned_file_index(arrival, k: int):
    """Map kept-tuple index ``k`` (1-based) through the arrival chain to the
    underlying stream index, accumulating the inverse-keep-rate weight.
    Nested thins (a query shed more than once) compose multiplicatively."""
    w = 1.0
    while True:
        if isinstance(arrival, ShiftedArrival):
            arrival = arrival.base
            continue
        if isinstance(arrival, ThinnedArrival):
            if k > arrival.prefix and arrival.keep > 0:
                w *= arrival.tail / arrival.keep
            k = arrival.base_index(k)
            arrival = arrival.base
            continue
        return k, w


class AnalyticsRuntimeExecutor(BaseExecutor):
    """``Executor`` over real segagg analytics jobs.

    ``jobs`` maps a scheduler query_id to its (AnalyticsQuery, files); batch
    tuple units are FILES (exactly the paper's setup).  The modelled clock
    advances by cost-model time; measured wall seconds are recorded per
    query (``wall_seconds``) and final results land in ``results``.
    """

    def __init__(
        self,
        jobs: Dict[str, Tuple[AnalyticsQuery, Sequence[Dict[str, np.ndarray]]]],
        scale: StreamScale,
        device: DeviceLike = None,
        mesh=None,
    ):
        super().__init__()
        self._jobs = {
            qid: (AnalyticsExecutor(aq, scale, device, mesh), files)
            for qid, (aq, files) in jobs.items()
        }
        self.results: Dict[str, np.ndarray] = {}
        self.agg_seconds: Dict[str, float] = {}

    def physical(self, query_id: str) -> AnalyticsExecutor:
        return self._jobs[query_id][0]

    def _execute(self, query: Query, num_tuples: int, offset: int) -> Optional[float]:
        ex, files = self._jobs[query.query_id]
        if _is_thinned(query.arrival):
            # Sampled scan (load shedding): offsets are in KEPT-tuple
            # units; fetch the systematically sampled files and weight
            # their records by the inverse keep rate so the partial is an
            # unbiased scaled estimate of the unsampled aggregate.
            chunk, weights = [], []
            for k in range(offset + 1, offset + num_tuples + 1):
                idx, w = _thinned_file_index(query.arrival, k)
                if 0 < idx <= len(files):
                    f = files[idx - 1]
                    chunk.append(f)
                    weights.append(
                        np.full(len(next(iter(f.values()))), w, np.float32))
            if not chunk:
                return None
            return ex.process_batch(
                concat_files(chunk), slot=offset,
                weights=np.concatenate(weights),
            ).seconds
        chunk = files[offset: offset + num_tuples]
        if not chunk:
            return None
        return ex.process_batch(concat_files(chunk), slot=offset).seconds

    def _finalize(self, query: Query, num_batches: int) -> Optional[float]:
        ex, _ = self._jobs[query.query_id]
        total, agg_s = ex.finalize()
        self.results[query.query_id] = total
        self.agg_seconds[query.query_id] = agg_s
        return agg_s


class SharedAnalyticsExecutor(BaseExecutor):
    """``Executor`` over real segagg jobs with PANE SHARING: every job is a
    window over ONE shared stream of record files, and pane partial
    aggregates are computed once, cached in the ``SharedBook``'s
    ``PaneStore``, and fanned out to every subscribed window.

    ``_execute`` decomposes a batch's global file range into full panes and
    edge fragments.  Cached panes are folded in at merge cost (a numpy add
    on the host, no device scan); runs of uncomputed panes are scanned in
    ONE ``pane_segagg`` pass on ``device`` (composite pane x group keys
    through the same kernels) and each pane's partial is spilled to the host
    and deposited for later subscribers.  Fragments are scanned directly and
    never cached (only a fully covered pane is valid for reuse).  Per-query
    accumulators stay offset-keyed exactly like
    ``AnalyticsExecutor.partials``, so C_max straggler re-queues overwrite
    instead of double-counting, and ``_finalize`` combines them into
    ``results[query_id]`` (the fan-out finalize).

    The modelled clock still advances by the scheduler-visible cost models
    (``SharedCostModel`` when the workload was share-transformed); this
    class deduplicates the PHYSICAL work and records measured wall seconds.
    """

    def __init__(
        self,
        query: AnalyticsQuery,
        stream_files: Sequence[Dict[str, np.ndarray]],
        scale: StreamScale,
        book,  # repro_torch.core.panes.SharedBook (shared with the runtime loop)
        device: DeviceLike = None,
        mesh=None,
    ):
        super().__init__()
        self.aquery = query
        self.files = list(stream_files)
        self.num_groups = query.num_groups(scale)
        self.book = book
        self.device = _executor_device(device, mesh)
        self.mesh = mesh
        # query_id -> {local offset: partial}: straggler-idempotent, like
        # AnalyticsExecutor.partials.
        self._acc: Dict[str, Dict[int, np.ndarray]] = {}
        self.results: Dict[str, np.ndarray] = {}
        self.agg_seconds: Dict[str, float] = {}

    # -- physical helpers ------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _scan(self, records: Dict[str, np.ndarray]) -> np.ndarray:
        keys = np.asarray(self.aquery.key_fn(records), np.int32)
        vals = np.asarray(self.aquery.value_fn(records), np.float32)
        if self.mesh is not None:
            part = self.mesh.segagg(keys, vals, self.num_groups)
        else:
            part = segagg(self._to_device(keys), self._to_device(vals),
                          self.num_groups)
        return part.cpu().numpy()

    def _scan_panes(self, stream: str, first_pane: int, count: int,
                    width: int, by: str) -> np.ndarray:
        """Scan ``count`` contiguous panes in one ``pane_segagg`` pass,
        deposit each pane's partial, and return their sum (this caller's
        share of the batch)."""
        lo = first_pane * width
        chunk = self.files[lo: lo + count * width]
        records = concat_files(chunk)
        keys = np.asarray(self.aquery.key_fn(records), np.int32)
        vals = np.asarray(self.aquery.value_fn(records), np.float32)
        # Row counts straight from the record arrays (every field of a file
        # has one row per record): running key_fn per file would pay a
        # second full key pass inside the timed region.
        sizes = [len(next(iter(f.values()))) for f in chunk]
        pane_of_file = np.repeat(
            np.arange(count, dtype=np.int32), width)[: len(chunk)]
        pane_ids = np.repeat(pane_of_file, sizes).astype(np.int32)
        if self.mesh is not None:
            parts = self.mesh.pane_segagg(keys, vals, pane_ids, count,
                                          self.num_groups)
        else:
            parts = pane_segagg(
                self._to_device(keys), self._to_device(vals),
                self._to_device(pane_ids), count, self.num_groups,
            )
        parts = parts.cpu().numpy()
        for j in range(count):
            self.book.store.deposit(stream, first_pane + j, by=by,
                                    data=parts[j])
        return parts.sum(axis=0)

    # -- BaseExecutor hooks ----------------------------------------------
    def _execute(self, query: Query, num_tuples: int, offset: int) -> Optional[float]:
        if num_tuples <= 0:
            return None
        stream = query.stream
        if stream is None:
            raise ValueError(
                f"{query.query_id}: SharedAnalyticsExecutor needs stream-"
                "placed queries (Query.stream/stream_offset)"
            )
        width = self.book.widths.get(stream, max(query.num_tuples_total, 1))
        store = self.book.store
        g0 = query.stream_offset + offset
        g1 = g0 + num_tuples
        t0 = time.perf_counter()
        acc: Optional[np.ndarray] = None
        pos = g0
        pending_scan: Optional[int] = None  # first pane of an uncached run

        def fold(part: np.ndarray) -> None:
            nonlocal acc
            acc = part if acc is None else acc + part

        def flush(upto_pane: int) -> None:
            nonlocal pending_scan
            if pending_scan is not None:
                fold(self._scan_panes(stream, pending_scan,
                                      upto_pane - pending_scan, width,
                                      by=query.query_id))
                pending_scan = None

        while pos < g1:
            pane_idx = pos // width
            pane_lo, pane_hi = pane_idx * width, (pane_idx + 1) * width
            if pos == pane_lo and pane_hi <= g1:
                entry = store.entry(stream, pane_idx)
                if entry is not None and entry.computed and entry.data is not None:
                    flush(pane_idx)
                    fold(entry.data)  # cache hit: merge, no scan
                else:
                    if pending_scan is None:
                        pending_scan = pane_idx
                pos = pane_hi
            else:
                # Edge fragment (batch boundary inside a pane): scan
                # directly, never cached.
                flush(pane_idx)
                frag_hi = min(pane_hi, g1)
                fold(self._scan(concat_files(self.files[pos:frag_hi])))
                pos = frag_hi
        flush(-(-g1 // width))
        self._acc.setdefault(query.query_id, {})[offset] = (
            acc if acc is not None
            else np.zeros((self.num_groups, 1), np.float32)
        )
        return time.perf_counter() - t0

    def _finalize(self, query: Query, num_batches: int) -> Optional[float]:
        t0 = time.perf_counter()
        parts = list(self._acc.get(query.query_id, {}).values())
        total = (np.sum(np.stack(parts), axis=0) if parts
                 else np.zeros((self.num_groups, 1), np.float32))
        self.results[query.query_id] = total
        dt = time.perf_counter() - t0
        self.agg_seconds[query.query_id] = dt
        return dt


class MeshAnalyticsBackend(MeshBackend):
    """``repro_torch.dist.mesh.MeshBackend`` over real segagg analytics
    jobs: one pool worker per mesh slot, worker clocks stitched from
    MEASURED wall seconds, shard groups run as one mesh call.

    Usage::

        mesh = DeviceMesh(["cuda:0", "cuda:0"])
        wb = MeshAnalyticsBackend(jobs, scale, mesh)
        pool = ExecutorPool(worker_backend=wb)
        run(Planner(policy="llf-dynamic", shard_across=2).policy, specs, pool)

    A dispatch's partial aggregate is kept on the mesh's first device (the
    host spill is deferred to ``_agg_execute``), and each dispatch returns
    only when every device of the mesh has finished, so the measured
    seconds cover the device work.  Partials stay offset-keyed like
    ``AnalyticsExecutor.partials``: a straggler requeue of a shard group
    re-runs the covering range and OVERWRITES its slot.
    """

    def __init__(
        self,
        jobs: Dict[str, Tuple[AnalyticsQuery, Sequence[Dict[str, np.ndarray]]]],
        scale: StreamScale,
        mesh,  # repro_torch.dist.DeviceMesh
        names: Optional[Sequence[str]] = None,
    ):
        super().__init__(mesh, names)
        if mesh.devices[0].type == "cuda":
            _build.build_all()
        self._jobs = {qid: (aq, list(files)) for qid, (aq, files) in jobs.items()}
        self._groups = {qid: aq.num_groups(scale) for qid, (aq, _) in jobs.items()}
        # query_id -> {offset: partial on the mesh's first device}.
        self._partials: Dict[str, Dict[int, torch.Tensor]] = {}
        self.results: Dict[str, np.ndarray] = {}

    def reset(self, t: float) -> None:
        super().reset(t)
        self._partials.clear()
        self.results.clear()

    # -- physical hooks ----------------------------------------------------
    def _run_range(self, query: Query, num_tuples: int, offset: int) -> None:
        aq, files = self._jobs[query.query_id]
        chunk = files[offset: offset + num_tuples]
        if not chunk:
            return
        records = concat_files(chunk)
        keys = np.asarray(aq.key_fn(records), np.int32)
        vals = np.asarray(aq.value_fn(records), np.float32)
        part = self.mesh.segagg(keys, vals, self._groups[query.query_id])
        self.mesh.synchronize()  # the measured dt covers the device work
        self._partials.setdefault(query.query_id, {})[offset] = part

    def _batch_execute(self, query: Query, num_tuples: int, offset: int) -> None:
        self._run_range(query, num_tuples, offset)

    def _group_execute(
        self,
        query: Query,
        sizes: Tuple[int, ...],
        base_offset: int,
        workers: Tuple[str, ...],
    ) -> None:
        # ONE mesh call over the covering range: the shard split is
        # realized by the mesh's own row split (its shard_extents match the
        # pool's batch_shard_extents), not by per-shard dispatches.
        self._run_range(query, sum(sizes), base_offset)

    def _agg_execute(self, query: Query, num_batches: int) -> None:
        parts = self._partials.get(query.query_id, {})
        if parts:
            total = np.sum(
                np.stack([p.cpu().numpy() for p in parts.values()]), axis=0
            )
        else:
            total = np.zeros((self._groups[query.query_id], 1), np.float32)
        self.results[query.query_id] = total

    def requeue_batch(self, query: Query, num_tuples: int, offset: int) -> None:
        """Straggler redo: re-run the covering range; the offset-keyed
        partial overwrites, so no double counting."""
        self._run_range(query, num_tuples, offset)


def _plan_query(query_id: str, num_files: int) -> Query:
    """Untimed stand-in Query for replaying a vetted plan over materialized
    files (all inputs present; modelled costs zero)."""
    return Query(
        query_id=query_id,
        wind_start=0.0,
        wind_end=0.0,
        deadline=float("inf"),
        num_tuples_total=num_files,
        cost_model=LinearCostModel(tuple_cost=0.0),
        arrival=TraceArrival(timestamps=(0.0,) * max(num_files, 1)),
    )


def run_plan(query: AnalyticsQuery, files: Sequence[Dict[str, np.ndarray]],
             plan: Schedule, scale: StreamScale,
             device: DeviceLike = None, mesh=None
             ) -> Tuple[np.ndarray, List[BatchResult], float]:
    """Execute a scheduler plan (batch sizes in FILES) against real files
    through the shared runtime loop (strict mode: replay the plan verbatim)."""
    rex = AnalyticsRuntimeExecutor({query.query_id: (query, files)}, scale,
                                   device, mesh)
    q = _plan_query(query.query_id, len(files))
    execute_plan(q, plan, rex, strict=True)
    return (
        rex.results[query.query_id],
        rex.physical(query.query_id).batch_log,
        rex.agg_seconds[query.query_id],
    )


def run_batched(query: AnalyticsQuery, files: Sequence[Dict[str, np.ndarray]],
                batch_files: int, scale: StreamScale,
                device: DeviceLike = None,
                mesh=None) -> Tuple[np.ndarray, float, int]:
    """Process in fixed-size batches of ``batch_files``; returns
    (result, total_seconds incl. final agg, num_batches)."""
    ex = AnalyticsExecutor(query, scale, device, mesh)
    for i in range(0, len(files), batch_files):
        ex.process_batch(concat_files(files[i:i + batch_files]))
    result, agg_s = ex.finalize()
    total = sum(b.seconds for b in ex.batch_log) + agg_s
    return result, total, ex.num_batches


def run_session(
    query: AnalyticsQuery,
    windows: Sequence[Sequence[Dict[str, np.ndarray]]],
    window_timestamps: Sequence[Sequence[float]],
    scale: StreamScale,
    cost_model: CostModelBase,
    *,
    period: Optional[float] = None,
    deadline_offset: Optional[float] = None,
    policy: str = "llf-dynamic",
    calibrate: bool = True,
    device: DeviceLike = None,
    mesh=None,
    forecast=None,
    latency_target: Optional[float] = None,
    tenant: Optional[str] = None,
    **session_kw,
) -> Tuple[Dict[int, np.ndarray], SessionTrace]:
    """Session mode over the REAL segagg backend: the paper's continuously
    running scheduler, one recurring GROUP-BY query, one result per window.

    ``windows[w]`` are window ``w``'s files; ``window_timestamps[w]`` their
    ACTUAL arrival instants (the per-window truth — predictions come from
    window 0's trace shifted by ``period``).  Every window must carry the
    same file count (the recurring spec's shape).  With ``calibrate=True``
    the scheduler's cost model refits online from measured wall seconds
    (cost units == seconds, §1/§6.2), so a mis-measured offline model heals
    while the session runs.

    Predictive-scheduling knobs (docs/API.md "Predictive scheduling"):
    ``forecast=`` (bool or ``repro_torch.core.ForecastConfig``) turns on arrival
    forecasting and proactive replanning over the real backend —
    per-window FILE-arrival observations feed the forecaster exactly like
    tuple arrivals in simulation; ``latency_target=`` stamps a Cameo-style
    per-query latency target (seconds past window close) onto the
    recurring query, tightening its urgency in the dynamic policies and
    reported per window via ``QueryOutcome.met_target``; ``tenant=``
    stamps the tenant identity onto the recurring query so per-window
    outcomes carry it (``QueryOutcome.tenant``) and a ``tenancy=``
    session config (forwarded via ``**session_kw``) can enforce the
    tenant's quota.

    Returns ({window_index: combined_aggregate}, SessionTrace).
    """
    if not windows:
        raise ValueError("need at least one window")
    n = len(windows[0])
    if any(len(w) != n for w in windows):
        raise ValueError("every window must carry the same file count "
                         f"(window 0 has {n})")
    if len(window_timestamps) != len(windows):
        raise ValueError("windows and window_timestamps must align")
    base_arr = TraceArrival(timestamps=tuple(window_timestamps[0]))
    if period is None:
        period = base_arr.wind_end - base_arr.wind_start or 1.0
    if deadline_offset is None:
        deadline_offset = 2.0 * cost_model.cost(n)
    base = Query(
        query_id=query.query_id,
        wind_start=base_arr.wind_start,
        wind_end=base_arr.wind_end,
        deadline=base_arr.wind_end + deadline_offset,
        num_tuples_total=n,
        cost_model=cost_model,
        arrival=base_arr,
        latency_target=latency_target,
        tenant=tenant,
    )
    truths = [TraceArrival(timestamps=tuple(ts)) for ts in window_timestamps]
    rspec = RecurringQuerySpec(
        base=base,
        period=period,
        num_windows=len(windows),
        deadline_offset=deadline_offset,
        truth_factory=lambda w: truths[w],
        num_groups=query.num_groups(scale),
    )
    jobs = {
        rspec.window_query(w).query_id: (query, list(files))
        for w, files in enumerate(windows)
    }
    executor = AnalyticsRuntimeExecutor(jobs, scale, device, mesh)
    session = Session(policy=policy, executor=executor, calibrate=calibrate,
                      forecast=forecast, **session_kw)
    session.submit(rspec)
    trace = session.run()
    results = {
        w: executor.results[rspec.window_query(w).query_id]
        for w in range(len(windows))
        if rspec.window_query(w).query_id in executor.results
    }
    return results, trace


def run_shared_jobs(
    query: AnalyticsQuery,
    files: Sequence[Dict[str, np.ndarray]],
    windows: Sequence[Tuple[int, int]],
    scale: StreamScale,
    cost_model: CostModelBase,
    *,
    policy: str = "llf-dynamic",
    share: bool = True,
    pane_tuples: Optional[int] = None,
    deadline_frac: float = 3.0,
    device: DeviceLike = None,
    mesh=None,
    **policy_params,
):
    """Overlapping GROUP-BY windows over ONE real stream, end to end.

    ``windows[i] = (stream_offset, num_files)`` places job ``i``'s window on
    the shared stream (one file arrives per modelled time unit).  With
    ``share=True`` the workload is pane-share-transformed
    (``repro_torch.core.panes.share_workload``) and executed on a
    ``SharedAnalyticsExecutor``: overlapping windows reuse cached pane
    partials, so shared files are scanned once.  With ``share=False`` the
    same executor class runs with an empty book — every window rescans its
    own files — which is the apples-to-apples unshared baseline.

    Returns ``({job_id: (num_groups, V) aggregate}, trace, book)``.
    """
    from ..core.panes import SharedBook, share_workload
    from ..core.runtime import run as run_loop

    stream = f"{query.query_id}-stream"
    qs = []
    for i, (off, n) in enumerate(windows):
        if off < 0 or off + n > len(files):
            raise ValueError(
                f"window {i} [{off}, {off + n}) outside the stream "
                f"(0..{len(files)})"
            )
        arr = TraceArrival(timestamps=tuple(float(t) for t in range(off, off + n)))
        qs.append(Query(
            query_id=f"{query.query_id}-w{i}",
            wind_start=arr.wind_start,
            wind_end=arr.wind_end,
            deadline=arr.wind_end + deadline_frac * cost_model.cost(n),
            num_tuples_total=n,
            cost_model=cost_model,
            arrival=arr,
            stream=stream,
            stream_offset=off,
        ))
    pol = Planner(policy=policy, **policy_params).policy
    if share:
        specs, book = share_workload(qs, pane_tuples=pane_tuples)
    else:
        specs, book = qs, SharedBook(pane_tuples=pane_tuples)
    executor = SharedAnalyticsExecutor(query, files, scale, book,
                                       device=device, mesh=mesh)
    trace = run_loop(pol, specs, executor,
                     sharing=book if share else None)
    if share:
        book.close()
    return executor.results, trace, book


def measure_cost_model(query: AnalyticsQuery,
                       files: Sequence[Dict[str, np.ndarray]],
                       scale: StreamScale,
                       batch_sizes: Sequence[int] = (1, 4, 16, 64),
                       device: DeviceLike = None,
                       mesh=None) -> CostModelBase:
    """§6.2 calibration: measure execution time vs batch size, fit the
    piecewise-linear model (file units).  Calibrate on the device (or the
    mesh) the queries will run on: the model describes its wall clock."""
    samples = []
    agg_samples = [(1, 0.0)]
    for bs in batch_sizes:
        bs = min(bs, len(files))
        # warmup: the first batches of a shape fill the allocator's cache
        # (the kernels themselves were built before any timed call)
        run_batched(query, files[:bs], bs, scale, device, mesh)
        ex = AnalyticsExecutor(query, scale, device, mesh)
        reps = max(3, min(8, len(files) // bs))
        for i in range(reps):
            lo = (i * bs) % max(len(files) - bs, 1)
            ex.process_batch(concat_files(files[lo:lo + bs]))
        secs = sorted(b.seconds for b in ex.batch_log)
        samples.append((bs, secs[len(secs) // 2]))  # median per-batch cost
    # final-agg cost vs #batches
    for nb in (2, 8, 32):
        per = max(len(files) // nb, 1)
        ex = AnalyticsExecutor(query, scale, device, mesh)
        for i in range(nb):
            ex.process_batch(concat_files(files[i * per: (i + 1) * per] or
                                          files[:1]))
        _, agg_s = ex.finalize()
        agg_samples.append((nb, agg_s))
    model = fit_piecewise_linear(samples, agg_samples)
    return model
