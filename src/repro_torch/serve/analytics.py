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
batches; ``run_plan`` replays a plan through ``execute_plan``.  Partials
are keyed by tuple offset, so a C_max straggler re-queue overwrites rather
than double-counts.

``measure_cost_model`` reproduces §6.2: run batches of different sizes,
time them, fit the piecewise-linear cost model the scheduler consumes.

Under load shedding (a ``ThinnedArrival``) batch offsets arrive in
KEPT-tuple units; the executor maps them to the underlying file indices and
weights each sampled record by the inverse keep rate (Horvitz-Thompson).

The knob is ``device=``: the CUDA card unless the caller passes
``device="cpu"`` (see ``repro_torch.device.resolve_device``).
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
    Query,
    Schedule,
    ShiftedArrival,
    ThinnedArrival,
    TraceArrival,
    fit_piecewise_linear,
)
from ..core.runtime import BaseExecutor, execute_plan
from ..data.tpch import AnalyticsQuery, StreamScale
from ..device import DeviceLike, resolve_device
from ..kernels import _build
from ..kernels.segagg.ops import segagg


@dataclasses.dataclass
class BatchResult:
    num_records: int
    seconds: float


class AnalyticsExecutor:
    """Executes one AnalyticsQuery in intermittent batches on ``device``.

    On the card the kernels are built and loaded here, so no timed batch
    ever pays for the build."""

    def __init__(self, query: AnalyticsQuery, scale: StreamScale,
                 device: DeviceLike = None):
        self.query = query
        self.scale = scale
        self.num_groups = query.num_groups(scale)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _build.build_all()
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
    ):
        super().__init__()
        self._jobs = {
            qid: (AnalyticsExecutor(aq, scale, device), files)
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
             device: DeviceLike = None
             ) -> Tuple[np.ndarray, List[BatchResult], float]:
    """Execute a scheduler plan (batch sizes in FILES) against real files
    through the shared runtime loop (strict mode: replay the plan verbatim)."""
    rex = AnalyticsRuntimeExecutor({query.query_id: (query, files)}, scale,
                                   device)
    q = _plan_query(query.query_id, len(files))
    execute_plan(q, plan, rex, strict=True)
    return (
        rex.results[query.query_id],
        rex.physical(query.query_id).batch_log,
        rex.agg_seconds[query.query_id],
    )


def run_batched(query: AnalyticsQuery, files: Sequence[Dict[str, np.ndarray]],
                batch_files: int, scale: StreamScale,
                device: DeviceLike = None) -> Tuple[np.ndarray, float, int]:
    """Process in fixed-size batches of ``batch_files``; returns
    (result, total_seconds incl. final agg, num_batches)."""
    ex = AnalyticsExecutor(query, scale, device)
    for i in range(0, len(files), batch_files):
        ex.process_batch(concat_files(files[i:i + batch_files]))
    result, agg_s = ex.finalize()
    total = sum(b.seconds for b in ex.batch_log) + agg_s
    return result, total, ex.num_batches


def measure_cost_model(query: AnalyticsQuery,
                       files: Sequence[Dict[str, np.ndarray]],
                       scale: StreamScale,
                       batch_sizes: Sequence[int] = (1, 4, 16, 64),
                       device: DeviceLike = None) -> CostModelBase:
    """§6.2 calibration: measure execution time vs batch size, fit the
    piecewise-linear model (file units).  Calibrate on the device the
    queries will run on: the model describes that device's wall clock."""
    samples = []
    agg_samples = [(1, 0.0)]
    for bs in batch_sizes:
        bs = min(bs, len(files))
        # warmup: the first batches of a shape fill the allocator's cache
        # (the kernels themselves were built before any timed call)
        run_batched(query, files[:bs], bs, scale, device)
        ex = AnalyticsExecutor(query, scale, device)
        reps = max(3, min(8, len(files) // bs))
        for i in range(reps):
            lo = (i * bs) % max(len(files) - bs, 1)
            ex.process_batch(concat_files(files[lo:lo + bs]))
        secs = sorted(b.seconds for b in ex.batch_log)
        samples.append((bs, secs[len(secs) // 2]))  # median per-batch cost
    # final-agg cost vs #batches
    for nb in (2, 8, 32):
        per = max(len(files) // nb, 1)
        ex = AnalyticsExecutor(query, scale, device)
        for i in range(nb):
            ex.process_batch(concat_files(files[i * per: (i + 1) * per] or
                                          files[:1]))
        _, agg_s = ex.finalize()
        agg_samples.append((nb, agg_s))
    model = fit_piecewise_linear(samples, agg_samples)
    return model
