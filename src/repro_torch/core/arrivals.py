"""Input-stream arrival models (paper §2.1: "the input data rate can be
modeled"; §4.4 variable-rate handling).

The planners need two primitives:

* ``input_time(k)``        — InputTime(s, k): time at which the k-th tuple of
                             the window has arrived (k in 1..N; k=0 -> wind_start).
* ``tuples_available(t)``  — number of window tuples that have arrived by t.

Both are exact inverses for the deterministic models.  ``JitteredArrival``
wraps a base model with seeded noise to model the *actual* arrival process
diverging from the *predicted* one (§3.1 last paragraphs, §4.4) — planners
always see the base model, executors see the jittered truth.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

# All arrival-boundary comparisons share the module-level tolerance from
# repro.core.types: a tuple arriving exactly at instant t counts as available
# AT t for every model (see the EPS docstring there).  Historically each model
# carried its own magic epsilon (1e-9 count-scale here, 1e-12 time-scale in
# TraceArrival, another 1e-9 in runtime.py).
from .types import EPS


class ArrivalModel:
    wind_start: float
    wind_end: float
    num_tuples_total: int

    def input_time(self, num_tuples: int) -> float:
        raise NotImplementedError

    def tuples_available(self, t: float) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantRateArrival(ArrivalModel):
    """rate tuples per unit time, uniformly over [wind_start, wind_end].

    Matches the paper's worked example (§3.1): window [1, 10], 1 tuple/s ->
    tuple k available at time wind_start + k/rate ... with their convention
    tuple k arrives at time k (wind_start=1 means arrivals at 1+? they use
    "available from time 6" for 6 tuples) — i.e. the k-th tuple lands at
    ``wind_start + (k - 1)/rate``?  Their numbers: 10 tuples, window [1,10],
    rate 1/s, "8 tuples available by time 8", "6 tuples available from 6":
    tuple k arrives at time k = wind_start + (k-1)/rate.  We therefore use
    ``input_time(k) = wind_start + (k - 1) / rate`` and require
    ``input_time(N) == wind_end``.
    """

    wind_start: float
    rate: float
    num_tuples_total: int

    @property
    def wind_end(self) -> float:  # type: ignore[override]
        return self.input_time(self.num_tuples_total)

    def input_time(self, num_tuples: int) -> float:
        if num_tuples <= 0:
            return self.wind_start
        return self.wind_start + (num_tuples - 1) / self.rate

    def tuples_available(self, t: float) -> int:
        if t < self.wind_start:
            return 0
        k = int((t - self.wind_start) * self.rate + EPS) + 1
        return min(k, self.num_tuples_total)


@dataclasses.dataclass(frozen=True)
class UniformWindowArrival(ArrivalModel):
    """N tuples spread uniformly over an explicitly given [wind_start, wind_end].

    The k-th tuple arrives at ``wind_start + (k-1)/(N-1) * (wind_end-wind_start)``
    (first at window start, last exactly at window end).  This is the default
    for synthetic experiments where the window is given, not the rate.
    """

    wind_start: float
    wind_end: float
    num_tuples_total: int

    def input_time(self, num_tuples: int) -> float:
        n = self.num_tuples_total
        if num_tuples <= 0 or n <= 1:
            return self.wind_start if num_tuples <= 0 else self.wind_end
        k = min(num_tuples, n)
        return self.wind_start + (k - 1) / (n - 1) * (self.wind_end - self.wind_start)

    def tuples_available(self, t: float) -> int:
        n = self.num_tuples_total
        if t < self.wind_start:
            return 0
        if t >= self.wind_end:
            return n
        if n <= 1:
            return n
        frac = (t - self.wind_start) / (self.wind_end - self.wind_start)
        return min(n, int(frac * (n - 1) + EPS) + 1)


@dataclasses.dataclass(frozen=True)
class TraceArrival(ArrivalModel):
    """Arrivals given by an explicit sorted timestamp list (one per tuple).

    Used as the *ground truth* in dynamic/jittered scenarios and by the data
    pipeline (each generated record carries a timestamp, §7.1).
    """

    timestamps: Tuple[float, ...]

    def __post_init__(self) -> None:
        ts = list(self.timestamps)
        if ts != sorted(ts):
            raise ValueError("timestamps must be sorted")
        if not ts:
            raise ValueError("empty trace")

    @property
    def wind_start(self) -> float:  # type: ignore[override]
        return self.timestamps[0]

    @property
    def wind_end(self) -> float:  # type: ignore[override]
        return self.timestamps[-1]

    @property
    def num_tuples_total(self) -> int:  # type: ignore[override]
        return len(self.timestamps)

    def input_time(self, num_tuples: int) -> float:
        if num_tuples <= 0:
            return self.wind_start
        return self.timestamps[min(num_tuples, len(self.timestamps)) - 1]

    def tuples_available(self, t: float) -> int:
        return bisect.bisect_right(self.timestamps, t + EPS)


@dataclasses.dataclass(frozen=True)
class ShiftedArrival(ArrivalModel):
    """``base`` translated ``shift`` time units later: window ``w`` of a
    ``RecurringQuerySpec`` is the base window shifted by ``w * period``.

    Pure time translation — exactly preserves the base model's inverse
    relationship between ``input_time`` and ``tuples_available``.
    """

    base: ArrivalModel
    shift: float

    @property
    def wind_start(self) -> float:  # type: ignore[override]
        return self.base.wind_start + self.shift

    @property
    def wind_end(self) -> float:  # type: ignore[override]
        return self.base.wind_end + self.shift

    @property
    def num_tuples_total(self) -> int:  # type: ignore[override]
        return self.base.num_tuples_total

    def input_time(self, num_tuples: int) -> float:
        return self.base.input_time(num_tuples) + self.shift

    def tuples_available(self, t: float) -> int:
        return self.base.tuples_available(t - self.shift)


@dataclasses.dataclass(frozen=True)
class ThinnedArrival(ArrivalModel):
    """``base`` uniformly thinned past a prefix: load shedding's arrival view
    (``repro.core.overload``).

    The first ``prefix`` base tuples pass through 1:1 (work already processed
    before the shed was applied); of the remaining ``tail = base.N - prefix``
    base tuples only ``keep`` survive, sampled SYSTEMATICALLY — kept tail
    tuple ``j`` (1-based) is base tuple ``prefix + ceil((j*tail - r) / keep)``
    where ``r`` is the sampling phase, so the sample is uniform over the tail
    and the LAST base tuple is always kept (the thinned window ends exactly
    where the base window does).  ``input_time``/``tuples_available`` stay
    exact inverses of each other, which every planner and the runtime's
    readiness logic rely on.

    ``seed`` picks the phase ``r`` (systematic sampling with a seeded random
    start, ``r in [0, keep)``) so repeated runs draw the SAME sample —
    benchmarks thread one explicit seed through every shed they apply.
    ``seed=None`` (the default) fixes ``r = 0``, which is bit-for-bit the
    historical phase-free sampling.

    ``base_index(k)`` exposes the kept->base tuple mapping (1-based both
    sides); real backends use it to fetch the sampled records and scale the
    aggregates by ``tail / keep`` (``repro.serve.analytics`` sampled scans).
    """

    base: ArrivalModel
    keep: int
    prefix: int = 0
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.prefix < 0:
            raise ValueError(f"prefix must be >= 0, got {self.prefix}")
        tail = self.base.num_tuples_total - self.prefix
        if tail < 0:
            raise ValueError(
                f"prefix {self.prefix} exceeds base total "
                f"{self.base.num_tuples_total}"
            )
        if not 0 <= self.keep <= tail:
            raise ValueError(f"keep must be in [0, {tail}], got {self.keep}")
        phase = 0
        if self.seed is not None and self.keep > 1:
            import random

            # Any r < keep keeps the last base tuple (window end anchored)
            # and the first kept index >= 1; see ``base_index``.
            phase = random.Random(self.seed).randrange(self.keep)
        object.__setattr__(self, "_phase", phase)

    @property
    def phase(self) -> int:
        """Systematic-sampling start offset ``r`` (0 without a seed)."""
        return self._phase

    @property
    def tail(self) -> int:
        """Base tuples subject to thinning (everything past the prefix)."""
        return self.base.num_tuples_total - self.prefix

    @property
    def wind_start(self) -> float:  # type: ignore[override]
        return self.base.wind_start

    @property
    def wind_end(self) -> float:  # type: ignore[override]
        return self.input_time(self.num_tuples_total)

    @property
    def num_tuples_total(self) -> int:  # type: ignore[override]
        return self.prefix + self.keep

    def base_index(self, num_tuples: int) -> int:
        """Base-stream index (1-based) of the ``num_tuples``-th kept tuple."""
        if num_tuples <= self.prefix or self.keep == 0:
            return min(num_tuples, self.prefix)
        j = min(num_tuples - self.prefix, self.keep)
        # ceil((j*tail - r) / keep); r < keep so j=keep still maps to tail.
        return self.prefix + -(-(j * self.tail - self._phase) // self.keep)

    def input_time(self, num_tuples: int) -> float:
        if num_tuples <= 0:
            return self.base.input_time(0)
        return self.base.input_time(self.base_index(num_tuples))

    def tuples_available(self, t: float) -> int:
        a = self.base.tuples_available(t)
        if a <= self.prefix:
            return a
        if self.keep == 0:
            return self.prefix
        # Exact inverse of ``base_index``: kept tail tuple j has arrived iff
        # ceil((j*tail - r)/keep) <= a - prefix, i.e.
        # j <= ((a-prefix)*keep + r)/tail.
        return self.prefix + min(
            ((a - self.prefix) * self.keep + self._phase) // self.tail,
            self.keep)


def partition_stream(
    base: ArrivalModel,
    counts: List[int],
    seed: Optional[int] = None,
) -> List[ThinnedArrival]:
    """Split one shared stream across principals: partition ``i`` sees a
    systematic uniform subsample of ``base`` with ``counts[i]`` tuples.

    The multi-tenant traffic generator (``repro.core.tenancy.zipf_counts``
    supplies Zipf-skewed ``counts``) models many tenants filtering the
    SAME eventstream: each tenant's query reads its own thinned view, all
    views anchored to the base window (a ``ThinnedArrival`` always keeps
    the last base tuple, so every partition closes with the stream).
    Partitions are views, not a disjoint cover — two tenants may keep the
    same base tuple, exactly like two filters matching the same record.
    ``seed`` decorrelates the sampling phases (partition ``i`` draws phase
    ``seed + i``); ``None`` keeps every phase 0.
    """
    total = base.num_tuples_total
    out: List[ThinnedArrival] = []
    for i, keep in enumerate(counts):
        if not 0 <= keep <= total:
            raise ValueError(
                f"counts[{i}] = {keep} outside [0, {total}]")
        out.append(ThinnedArrival(
            base=base, keep=keep,
            seed=None if seed is None else seed + i))
    return out


def jittered_trace(
    base: ArrivalModel,
    seed: int,
    jitter_frac: float = 0.1,
    rate_scale: float = 1.0,
) -> TraceArrival:
    """Build a ground-truth trace = predicted model + seeded jitter (§4.4).

    ``rate_scale`` > 1 means the true stream is faster than predicted (arrives
    earlier), < 1 slower.  Per-tuple jitter is uniform in
    ±jitter_frac * inter-arrival.  Monotonicity is restored by sorting.
    """
    import random

    rng = random.Random(seed)
    n = base.num_tuples_total
    ts: List[float] = []
    for k in range(1, n + 1):
        t = base.input_time(k)
        span = (t - base.wind_start) / max(rate_scale, 1e-9)
        t = base.wind_start + span
        if k < n:  # keep the window-end anchor exact for the last tuple
            gap = (base.wind_end - base.wind_start) / max(n - 1, 1)
            t += rng.uniform(-jitter_frac, jitter_frac) * gap
        ts.append(max(t, base.wind_start))
    ts.sort()
    return TraceArrival(timestamps=tuple(ts))
