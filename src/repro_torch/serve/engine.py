"""Deadline-aware batch serving engine: the paper's scheduler driving real
model prefill (the JAX package's ``serve/engine.py`` on the port's
``core`` and ``models.lm``).

A ``WindowJob`` is the serving analogue of the paper's intermittent query:
prompts arrive over a window and all their logits are due at a deadline.
The engine plans batch points with the ``single`` policy, or time-shares
several jobs under a ``*-dynamic`` policy, and every scheduled MinBatch
runs a real prefill on the card.  ``ServingExecutor`` implements the
runtime loop's executor protocol, so C_max straggler handling is the loop's
own.  ``serve_session`` (online admission) waits for the port's Session.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (
    ArrivalModel,
    CostModelBase,
    DynamicQuerySpec,
    Planner,
    Query,
    Strategy,
    fit_piecewise_linear,
)
from ..core.policies.dynamic import policy_for_strategy
from ..core.runtime import BaseExecutor, ExecutorPool, execute_plan, run
from ..device import DeviceLike, resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..models.params import Params


@dataclasses.dataclass
class WindowJob:
    """A deadline-bound batch-inference job."""

    job_id: str
    prompts: np.ndarray            # (N, S) int32, arrival order
    arrival: ArrivalModel          # predicted arrival of the N prompts
    deadline: float
    results: List[np.ndarray] = dataclasses.field(default_factory=list)
    processed: int = 0

    @property
    def num_requests(self) -> int:
        return self.prompts.shape[0]

    def as_query(self, cost_model: CostModelBase) -> Query:
        """The scheduler's view of this job (request units)."""
        return Query(
            query_id=self.job_id,
            wind_start=self.arrival.wind_start,
            wind_end=self.arrival.wind_end,
            deadline=self.deadline,
            num_tuples_total=self.num_requests,
            cost_model=cost_model,
            arrival=self.arrival,
        )


class PrefillExecutor:
    """Real prefill batches; pads to a small set of bucket sizes so the
    per-batch cost is a function of the bucket (as the reference bounds its
    recompilations).  ``params`` are keyed as ``models.lm`` keys them and
    live on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 buckets=(1, 2, 4, 8, 16, 32), device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.buckets = tuple(sorted(buckets))

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def run_batch(self, prompts: np.ndarray) -> Tuple[np.ndarray, float]:
        """Returns (last-token logits (n, V), wall seconds).  The wall time
        covers the copy in, the prefill and the copy of the logits out,
        which waits for the device.

        Requests beyond the largest bucket are split into bucket-sized
        sub-batches (wall times summed, logits concatenated in order)."""
        n = prompts.shape[0]
        cap = self.buckets[-1]
        if n > cap:
            outs: List[np.ndarray] = []
            total = 0.0
            for lo in range(0, n, cap):
                out, dt = self.run_batch(prompts[lo:lo + cap])
                outs.append(out)
                total += dt
            return np.concatenate(outs, axis=0), total
        b = self._bucket(n)
        padded = np.zeros((b, prompts.shape[1]), np.int32)
        padded[:n] = prompts
        t0 = time.perf_counter()
        tokens = torch.from_numpy(padded).to(self.device)
        logits, _, _ = lm.prefill(self.cfg, self.params, tokens, tokens.shape[1])
        out = logits.cpu().numpy()
        return out[:n], time.perf_counter() - t0

    def calibrate(self, seq_len: int, vocab: int) -> CostModelBase:
        """§6.2 for serving: measure per-batch cost vs batch size, fit the
        cost model the scheduler plans with (one warm-up call per bucket)."""
        rng = np.random.default_rng(0)
        samples = []
        for b in self.buckets:
            toks = rng.integers(0, vocab, (b, seq_len)).astype(np.int32)
            self.run_batch(toks)          # warm-up of this bucket
            _, dt = self.run_batch(toks)
            samples.append((b, dt))
        return fit_piecewise_linear(samples)


class ServingExecutor(BaseExecutor):
    """The runtime loop's executor over real prefill batches.

    Time is modelled from the cost model, but every submitted batch runs a
    real prefill; measured wall time accumulates in ``wall_seconds`` and
    feeds the loop's C_max straggler detection.  Logits are keyed by
    request offset so a re-queued straggler batch overwrites its own
    results (idempotent)."""

    def __init__(self, prefill: PrefillExecutor, jobs: Sequence[WindowJob]):
        super().__init__()
        self.prefill = prefill
        self._jobs: Dict[str, WindowJob] = {j.job_id: j for j in jobs}
        self._logits: Dict[str, Dict[int, np.ndarray]] = {
            j.job_id: {} for j in jobs
        }

    def _execute(self, query: Query, num_tuples: int, offset: int) -> Optional[float]:
        job = self._jobs[query.query_id]
        chunk = job.prompts[offset: offset + num_tuples]
        if len(chunk) == 0:
            return None
        logits, dt = self.prefill.run_batch(chunk)
        self._logits[job.job_id][offset] = logits
        job.processed = sum(
            len(v) for v in self._logits[job.job_id].values()
        )
        return dt

    def _finalize(self, query: Query, num_batches: int) -> Optional[float]:
        job = self._jobs[query.query_id]
        job.results = [
            self._logits[job.job_id][off]
            for off in sorted(self._logits[job.job_id])
        ]
        return None


def serve_single_job(job: WindowJob, executor: PrefillExecutor,
                     cost_model: CostModelBase,
                     policy: str = "single",
                     c_max: Optional[float] = None) -> Dict[str, float]:
    """One job end to end: plan with a static policy, execute the plan with
    real prefill batches through the shared runtime loop (strict mode: the
    plan is replayed verbatim).  ``c_max`` (wall seconds) enables the loop's
    straggler flag and re-queue."""
    q = job.as_query(cost_model)
    plan = Planner(policy=policy).schedule(q)
    serving = ServingExecutor(executor, [job])
    trace = execute_plan(q, plan, serving, strict=True, c_max=c_max)
    out = trace.outcome(job.job_id)
    return {
        "num_batches": out.num_batches,
        "modelled_finish": out.completion_time,
        "deadline": job.deadline,
        "met_modelled": out.met_deadline,
        "wall_exec_seconds": serving.wall_seconds.get(job.job_id, 0.0),
        "processed": job.processed,
        "straggler_events": trace.stragglers.count(job.job_id),
    }


def serve_multi_jobs(jobs: Sequence[WindowJob], executor: PrefillExecutor,
                     cost_model: CostModelBase,
                     strategy: Strategy = Strategy.LLF,
                     delta_rsf: float = 0.5, c_max: float = 30.0,
                     workers: int = 1) -> Dict[str, Dict]:
    """Algorithm 2 (LLF by default) across concurrent jobs: the
    ``*-dynamic`` policy decides, the shared runtime loop drives,
    ``ServingExecutor`` runs each scheduled MinBatch.  ``workers=W``
    time-shares the jobs across a W-way ``ExecutorPool`` (modelled clocks;
    the prefill still runs through the one ``PrefillExecutor``)."""
    serving = ServingExecutor(executor, jobs)
    specs = [DynamicQuerySpec(query=j.as_query(cost_model)) for j in jobs]
    policy = policy_for_strategy(strategy, delta_rsf=delta_rsf, c_max=c_max)
    pool = ExecutorPool(backend=serving, workers=workers) if workers > 1 \
        else serving
    trace = run(policy, specs, pool)
    by_id = {j.job_id: j for j in jobs}
    return {
        o.query_id: {
            "met_modelled": o.met_deadline,
            "completion": o.completion_time,
            "deadline": o.deadline,
            "num_batches": o.num_batches,
            "wall_exec_seconds": serving.wall_seconds.get(o.query_id, 0.0),
            "processed": by_id[o.query_id].processed,
            "straggler_events": trace.stragglers.count(o.query_id),
        }
        for o in trace.outcomes
    }
