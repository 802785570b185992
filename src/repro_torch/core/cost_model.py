"""Cost models (paper §2.2, Fig 1; §6.2 piecewise-linear fit).

A cost model answers three questions the planners need:

* ``cost(n)``            — cost (== time, in the paper's units) of processing
                           ``n`` tuples in ONE batch.  Eq. (1) for the linear
                           model: ``n * tupleProcCost + overheadCost``.
* ``tuples_processable(d)`` — ``EstTuplesProcessed``: max tuples one batch can
                           process within duration ``d`` (inverse of ``cost``).
* ``agg_cost(b)``        — final-aggregation cost when partials from ``b``
                           batches are combined (Eq. (4) context; §6.2 models
                           it as piecewise linear in the number of batches).

All models must be monotone non-decreasing in ``n``; the Algorithm-1 planner
works for ANY such model (§3.1 closing remark), which we exercise in tests.

Zero-batch convention (shared by every model): ``cost(0)`` is the fixed
per-batch overhead — the n->0 limit of the model, i.e. what dispatching an
empty batch would cost.  ``tuples_processable`` relies on it: a duration
below ``cost(0)`` cannot pay the overhead, so no tuples fit.  Negative
``n`` is not a batch; ``cost(n < 0)`` returns 0.0.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple


class CostModelBase:
    """Interface; see module docstring."""

    def cost(self, num_tuples: int) -> float:
        """Cost of one batch of ``num_tuples``; ``cost(0)`` is the per-batch
        overhead (see the module docstring's zero-batch convention)."""
        raise NotImplementedError

    def agg_cost(self, num_batches: int) -> float:
        """Final-aggregation cost. Single-batch runs need no final agg (§2.1)."""
        raise NotImplementedError

    def merge_cost(self, num_panes: int) -> float:
        """Cost of folding ``num_panes`` cached pane partial aggregates into
        a query's running state (pane sharing, ``repro.core.panes``).

        Merging pane partials is the same kind of work as the final
        aggregation's partial combine — the accumulator plus ``num_panes``
        partials — so the default prices it as ``agg_cost(num_panes + 1)``.
        Models whose aggregation is free (the paper's §3.1 worked examples)
        therefore merge for free too.  ``merge_cost(0)`` is 0.
        """
        if num_panes <= 0:
            return 0.0
        return self.agg_cost(num_panes + 1)

    # -- derived ---------------------------------------------------------
    def tuples_processable(self, duration: float, hi: int = 1 << 40) -> int:
        """EstTuplesProcessed(q, duration): largest n with cost(n) <= duration.

        Generic integer bisection so arbitrary monotone models work; linear
        models override with a closed form.
        """
        if duration < 0 or self.cost(0) > duration:
            # Cannot even pay the per-batch overhead.
            return 0
        lo, hi_ = 0, 1
        while hi_ < hi and self.cost(hi_) <= duration:
            lo, hi_ = hi_, hi_ * 2
        # invariant: cost(lo) <= duration < cost(hi_)
        while lo + 1 < hi_:
            mid = (lo + hi_) // 2
            if self.cost(mid) <= duration:
                lo = mid
            else:
                hi_ = mid
        return lo

    def batched_cost(self, num_tuples: int, batch_size: int) -> float:
        """Total cost of processing ``num_tuples`` in chunks of ``batch_size``
        plus the final aggregation (used by MinBatch sizing, §4.1)."""
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        full, rem = divmod(num_tuples, batch_size)
        nb = full + (1 if rem else 0)
        c = full * self.cost(batch_size) + (self.cost(rem) if rem else 0.0)
        if nb > 1:
            c += self.agg_cost(nb)
        return c


@dataclasses.dataclass(frozen=True)
class LinearCostModel(CostModelBase):
    """Eq. (1): compCost = n * tuple_cost + overhead  (per batch).

    ``agg_tuple_cost``: final aggregation modelled as linear in the number of
    batches (each batch contributes one partial-aggregate file, §6.1/6.2),
    plus a fixed ``agg_overhead`` — 0 by default so the paper's §3.1 worked
    examples (no aggregation cost) hold exactly.
    """

    tuple_cost: float
    overhead: float = 0.0
    agg_per_batch: float = 0.0
    agg_overhead: float = 0.0

    def cost(self, num_tuples: int) -> float:
        """Eq. (1): ``n * tuple_cost + overhead`` (``cost(0)`` = overhead)."""
        if num_tuples <= 0:
            return self.overhead if num_tuples == 0 else 0.0
        return num_tuples * self.tuple_cost + self.overhead

    def agg_cost(self, num_batches: int) -> float:
        """Linear-in-batches final aggregation; free for single batches."""
        if num_batches <= 1:
            return 0.0
        return num_batches * self.agg_per_batch + self.agg_overhead

    def tuples_processable(self, duration: float, hi: int = 1 << 40) -> int:
        """Closed-form inverse of ``cost`` (caps at ``hi`` for free models)."""
        if duration < self.overhead:
            return 0
        if self.tuple_cost <= 0:
            return hi
        return int(math.floor((duration - self.overhead) / self.tuple_cost + 1e-9))


@dataclasses.dataclass(frozen=True)
class PiecewiseLinearCostModel(CostModelBase):
    """§6.2: measured (batch-size, cost) samples fitted piecewise-linearly.

    ``points`` are (num_tuples, cost) knots sorted by num_tuples; costs are
    linearly interpolated between knots and extrapolated from the last
    segment's slope beyond them.  ``agg_points`` similarly maps
    (num_batches, agg_cost).
    """

    points: Tuple[Tuple[float, float], ...]
    agg_points: Tuple[Tuple[float, float], ...] = ((1, 0.0),)

    def __post_init__(self) -> None:
        self._validate("points", self.points, min_knots=2)
        # agg_points feed the same ``bisect``-based interpolation: unsorted
        # or non-monotone agg knots silently mis-interpolate, so they get
        # the same validation (a single (1, 0.0) knot — "no agg cost" — is
        # the legitimate minimal form).
        self._validate("agg_points", self.agg_points, min_knots=1)

    @staticmethod
    def _validate(
        label: str, points: Sequence[Tuple[float, float]], min_knots: int
    ) -> None:
        xs = [p[0] for p in points]
        if xs != sorted(xs) or len(set(xs)) != len(xs) or len(xs) < min_knots:
            raise ValueError(
                f"{label} must be >={min_knots} knots strictly sorted by x, "
                f"got {tuple(points)!r}"
            )
        cs = [p[1] for p in points]
        if any(b < a - 1e-12 for a, b in zip(cs, cs[1:])):
            raise ValueError(f"{label} cost must be monotone non-decreasing")

    @staticmethod
    def _interp(points: Sequence[Tuple[float, float]], x: float) -> float:
        if len(points) == 1:
            return points[0][1]
        xs = [p[0] for p in points]
        i = bisect.bisect_left(xs, x)
        if i < len(xs) and xs[i] == x:
            return points[i][1]
        if i == 0:
            (x0, y0), (x1, y1) = points[0], points[1]
        elif i == len(xs):
            (x0, y0), (x1, y1) = points[-2], points[-1]
        else:
            (x0, y0), (x1, y1) = points[i - 1], points[i]
        if x1 == x0:
            return y0
        t = (x - x0) / (x1 - x0)
        return y0 + t * (y1 - y0)

    def cost(self, num_tuples: int) -> float:
        """Interpolated batch cost from the fitted knots."""
        if num_tuples < 0:
            return 0.0
        if num_tuples == 0:
            # Zero-batch convention: the fitted model's per-batch overhead is
            # the first segment extrapolated to n=0 (clamped — measured knots
            # can extrapolate below zero).
            return max(0.0, self._interp(self.points, 0.0))
        return max(0.0, self._interp(self.points, float(num_tuples)))

    def agg_cost(self, num_batches: int) -> float:
        """Interpolated final-aggregation cost from the ``agg_points``."""
        if num_batches <= 1:
            return 0.0
        return max(0.0, self._interp(self.agg_points, float(num_batches)))


@dataclasses.dataclass(frozen=True)
class SublinearCostModel(CostModelBase):
    """Fig 1's non-linear curve: cost grows sublinearly with batch size
    (``scale * n**exponent + overhead``, exponent in (0, 1]).  Used in tests to
    show Algorithm 1 handles arbitrary monotone models."""

    scale: float
    exponent: float = 0.85
    overhead: float = 0.0
    agg_per_batch: float = 0.0

    def cost(self, num_tuples: int) -> float:
        """``scale * n**exponent + overhead`` (sublinear in batch size)."""
        if num_tuples < 0:
            return 0.0
        if num_tuples == 0:
            return self.overhead  # zero-batch convention: n->0 limit
        return self.scale * float(num_tuples) ** self.exponent + self.overhead

    def agg_cost(self, num_batches: int) -> float:
        """Linear-in-batches final aggregation; free for single batches."""
        if num_batches <= 1:
            return 0.0
        return num_batches * self.agg_per_batch


class SharedCostModel(CostModelBase):
    """Per-query cost under pane-based shared execution: one scan + k merges.

    ``sharers`` queries subscribe to the same stream; a pane batch of ``n``
    tuples is SCANNED once for all of them and each subscriber folds the
    pane partials into its own state at merge cost.  The per-query charge is
    therefore the amortized share of the scan plus this query's merges::

        cost(n) = base.cost(n) / sharers + base.merge_cost(ceil(n / pane))

    Summed over all ``sharers`` processing the same ``n`` tuples this
    recovers exactly ``base.cost(n) + sharers * merges`` — the shared-batch
    total — while each individual query (and therefore every policy's
    laxity/remaining-cost computation, MinBatch sizing and
    ``admission_check``) sees the CHEAPER shared cost instead of a full
    private scan.  ``agg_cost`` passes through unchanged: the final
    aggregation stays per query.

    ``sharers`` is mutable on purpose: a session updates it as queries join
    or leave a stream, and every window query holding this instance sees the
    new amortization immediately (same pattern as ``CalibratingCostModel``).
    Wrap a ``CalibratingCostModel`` to compose sharing with online
    calibration — observations then calibrate the SHARED per-query cost,
    which is also what the executor charges.
    """

    def __init__(self, base: CostModelBase, sharers: int, pane_tuples: int):
        if sharers < 1:
            raise ValueError(f"sharers must be >= 1, got {sharers}")
        if pane_tuples < 1:
            raise ValueError(f"pane_tuples must be >= 1, got {pane_tuples}")
        self.base = base
        self.sharers = sharers
        self.pane_tuples = pane_tuples

    def cost(self, num_tuples: int) -> float:
        """Amortized shared-batch cost (see class docstring); monotone
        whenever ``base`` is."""
        if num_tuples < 0:
            return 0.0
        scan = self.base.cost(num_tuples) / max(self.sharers, 1)
        if num_tuples == 0:
            return scan  # zero-batch convention: the amortized overhead
        panes = -(-num_tuples // self.pane_tuples)  # ceil
        return scan + self.base.merge_cost(panes)

    def agg_cost(self, num_batches: int) -> float:
        """Final aggregation is per query — delegates to the base model."""
        return self.base.agg_cost(num_batches)

    def merge_cost(self, num_panes: int) -> float:
        """Pane merges are physical work on the base model's terms."""
        return self.base.merge_cost(num_panes)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"SharedCostModel(sharers={self.sharers}, "
            f"pane_tuples={self.pane_tuples}, base={self.base!r})"
        )


class ShardedCostModel(CostModelBase):
    """Planning view of W-way fused shard dispatch (mesh execution).

    On a device mesh a logical batch of ``n`` tuples is split into W
    near-equal shards that run CONCURRENTLY as one fused ``shard_map``
    call, so its wall time is the cost of one ``ceil(n / ways)``-tuple
    shard — per-batch overhead (dispatch, one compiled call) is paid once
    per GROUP, not once per shard.  Exposing that parallel cost to the
    planners makes Eq. 9's MinBatch ~W times larger: W times fewer logical
    batches, each amortizing its overhead over W shards — the paper's
    overhead-amortization argument applied to dispatch fan-out.

    The modelled executor must NOT advance a single worker's clock by this
    parallel cost for an n-tuple shard; ``shard_cost`` supplies the
    per-shard charge (the base model's cost of the shard's own tuples) and
    ``BaseExecutor._modelled_batch_cost`` prefers it when present.

    ``agg_cost``/``merge_cost`` pass through: partial combination is not
    sharded.  Monotone whenever ``base`` is, so the generic
    ``tuples_processable`` bisection stands.
    """

    def __init__(self, base: CostModelBase, ways: int):
        if ways < 1:
            raise ValueError(f"ways must be >= 1, got {ways}")
        self.base = base
        self.ways = ways

    def cost(self, num_tuples: int) -> float:
        """Parallel wall time of one fused W-way dispatch of ``n`` tuples:
        the largest shard's cost."""
        if num_tuples < 0:
            return 0.0
        if num_tuples == 0:
            return self.base.cost(0)  # zero-batch convention: one overhead
        return self.base.cost(-(-num_tuples // self.ways))

    def shard_cost(self, num_tuples: int) -> float:
        """Per-shard charge for a worker clock: the shard's own tuples at
        the base model's (sequential) cost."""
        return self.base.cost(num_tuples)

    def agg_cost(self, num_batches: int) -> float:
        return self.base.agg_cost(num_batches)

    def merge_cost(self, num_panes: int) -> float:
        return self.base.merge_cost(num_panes)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"ShardedCostModel(ways={self.ways}, base={self.base!r})"


def _isotonic(samples: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sort, dedupe (max y per x — repeated measurements of one size), and
    make costs monotone by cumulative max: measurement noise can otherwise
    produce a locally decreasing cost, which the planners' inversion logic
    and the knot validation reject."""
    by_x: dict = {}
    for x, y in samples:
        x, y = float(x), float(y)
        by_x[x] = max(y, by_x.get(x, y))
    mono: List[Tuple[float, float]] = []
    running = 0.0
    for x in sorted(by_x):
        running = max(running, by_x[x])
        mono.append((x, running))
    return mono


def fit_piecewise_linear(
    samples: Sequence[Tuple[float, float]],
    agg_samples: Sequence[Tuple[float, float]] = ((1, 0.0),),
) -> PiecewiseLinearCostModel:
    """§6.2 cost modelling: fit measured (batch_size, time) samples.

    We keep the measured points as knots after isotonic cleanup — applied to
    BOTH the per-batch samples and the final-aggregation samples, which feed
    the same interpolation.
    """
    mono = _isotonic(samples)
    if len(mono) == 1:
        x, y = mono[0]
        mono.append((x + 1.0, y))
    return PiecewiseLinearCostModel(
        points=tuple(mono), agg_points=tuple(_isotonic(agg_samples))
    )


class CalibratingCostModel(CostModelBase):
    """Self-calibrating wrapper: §6.2's offline fit made CONTINUOUS.

    The paper fits its piecewise-linear cost model once, offline, from
    measured batches; a long-running session cannot afford that — data
    distributions, cluster load and compilation caches shift, so predicted
    batch costs drift away from observed wall times.  This wrapper

    * starts out delegating to ``base`` (the offline fit);
    * records ``(num_tuples, observed_cost)`` pairs from execution feedback
      (``observe``; final-aggregation pairs via ``observe_agg``);
    * refits its knots every ``refit_every`` observations once
      ``min_samples`` have accumulated, through ``fit_piecewise_linear``'s
      isotonic path (same cleanup as the offline fit);
    * exposes ``drift()`` — mean relative |observed - predicted| over the
      last ``window`` observations, where "predicted" is what the model in
      effect AT OBSERVATION TIME said.  A session compares it against its
      drift threshold to trigger replanning of future windows.

    Mutable by design: every Query holding this instance (all windows of a
    recurring query) sees refits immediately — dynamic policies consult
    ``cost``/``agg_cost`` at each decision instant, so refits steer
    priorities and MinBatch re-sizing without object swapping.
    """

    def __init__(
        self,
        base: CostModelBase,
        *,
        min_samples: int = 4,
        refit_every: int = 8,
        window: int = 64,
        max_samples: int = 4096,
    ):
        if min_samples < 2:
            raise ValueError("min_samples must be >= 2 (a fit needs 2 knots)")
        if refit_every < 1:
            raise ValueError("refit_every must be >= 1")
        if window < 1:
            raise ValueError("window must be >= 1")
        if max_samples < 1:
            # 0 would make the `del lst[:-0 or None]` trim wipe the buffer.
            raise ValueError("max_samples must be >= 1")
        self.base = base
        self.min_samples = min_samples
        self.refit_every = refit_every
        self.window = window
        self.max_samples = max_samples
        self._samples: List[Tuple[float, float]] = []
        self._agg_samples: List[Tuple[float, float]] = []
        self._errors: List[float] = []   # relative error per observation
        # worker name -> observed/predicted cost ratios (window-capped):
        # per-device calibration on a heterogeneous mesh.  The pooled fit
        # absorbs the AVERAGE level; these capture each device's deviation
        # from it (see ``worker_scale``).
        self._worker_ratios: dict = {}
        self._fitted: Optional[PiecewiseLinearCostModel] = None
        self._fitted_agg = False  # did the current fit include agg samples?
        self._since_refit = 0
        self.refits = 0

    # -- CostModelBase ---------------------------------------------------
    def cost(self, num_tuples: int) -> float:
        model = self.base if self._fitted is None else self._fitted
        return model.cost(num_tuples)

    def agg_cost(self, num_batches: int) -> float:
        # Agg knots come from the fit only when the FIT saw agg feedback;
        # per-batch refits alone must not zero out the base model's
        # aggregation cost.
        if not self._fitted_agg or self._fitted is None:
            return self.base.agg_cost(num_batches)
        return self._fitted.agg_cost(num_batches)

    # -- feedback --------------------------------------------------------
    @property
    def calibrated(self) -> bool:
        """True once at least one refit has replaced the offline base fit."""
        return self._fitted is not None

    @property
    def num_observations(self) -> int:
        """Per-batch feedback samples currently buffered."""
        return len(self._samples)

    @property
    def samples(self) -> Tuple[Tuple[float, float], ...]:
        """Read-only view of the buffered per-batch feedback, as
        ``(num_tuples, observed_cost)`` pairs in observation order — the
        public face of the calibration history (``Session.history()`` and
        the forecasting subsystem consume this instead of reaching into
        the private buffers)."""
        return tuple(self._samples)

    @property
    def agg_samples(self) -> Tuple[Tuple[float, float], ...]:
        """Read-only view of the buffered final-aggregation feedback, as
        ``(num_batches, observed_cost)`` pairs in observation order."""
        return tuple(self._agg_samples)

    def observe(
        self,
        num_tuples: int,
        observed_cost: float,
        worker: Optional[str] = None,
    ) -> None:
        """Record one executed batch: ``observed_cost`` is the batch's true
        duration (modelled true cost in simulation, wall seconds on a real
        backend — cost units == time units, §1).

        ``worker`` (when the dispatching executor is a pool) additionally
        feeds per-device calibration: each worker accumulates its own
        observed/predicted ratios, so ``worker_scale``/``worker_weights``
        can expose REAL per-shard speed skew to the planners (weighted
        shard extents on a heterogeneous mesh)."""
        if num_tuples <= 0 or observed_cost < 0:
            return
        predicted = self.cost(num_tuples)
        scale = max(abs(observed_cost), abs(predicted), 1e-12)
        self._errors.append(abs(observed_cost - predicted) / scale)
        del self._errors[: -self.window or None]
        if worker is not None and predicted > 1e-12:
            ratios = self._worker_ratios.setdefault(worker, [])
            ratios.append(observed_cost / predicted)
            del ratios[: -self.window or None]
        self._samples.append((float(num_tuples), float(observed_cost)))
        del self._samples[: -self.max_samples or None]
        self._since_refit += 1
        if (
            len(self._samples) >= self.min_samples
            and self._since_refit >= self.refit_every
        ):
            self.refit_now()

    def observe_agg(self, num_batches: int, observed_cost: float) -> None:
        """Record one executed final aggregation (its true duration, like
        ``observe`` for batches)."""
        if num_batches <= 1 or observed_cost < 0:
            return
        self._agg_samples.append((float(num_batches), float(observed_cost)))
        del self._agg_samples[: -self.max_samples or None]
        if self._fitted is not None:
            # Fold the (rare: one per multi-batch query) agg sample straight
            # into the already-calibrated fit.
            self.refit_now()

    def _knots(self, samples, base_fn):
        """Knots for one axis of the refit.

        Rich feedback (>= 3 distinct sizes) fits the raw measurements —
        exactly §6.2 with fresher data.  Sparse feedback (a session that so
        far only ran MinBatch-sized batches) cannot pin down a shape, and
        raw knots would extrapolate FLAT (poisoning ``cost(1)`` and
        therefore MinBatch sizing and C_max checks); instead the BASE
        model's shape is kept and its level corrected by the median
        observed/predicted ratio (a multiplicative drift correction).
        """
        xs = sorted({x for x, _ in samples})
        if len(xs) >= 3:
            return samples
        ratios = sorted(
            y / base_fn(int(x)) for x, y in samples if base_fn(int(x)) > 1e-12
        )
        r = ratios[len(ratios) // 2] if ratios else 1.0
        grid = sorted({1.0, *xs, 2.0 * max(xs)})
        return [(x, r * base_fn(int(x))) for x in grid]

    def refit_now(self) -> bool:
        """Refit immediately (a session's drift trigger); False when there
        are not yet enough samples for a meaningful fit."""
        if len(self._samples) < self.min_samples:
            return False
        if self._agg_samples:
            agg = [(1.0, 0.0),
                   *self._knots(self._agg_samples, self.base.agg_cost)]
        else:
            agg = ((1, 0.0),)
        self._fitted = fit_piecewise_linear(
            self._knots(self._samples, self.base.cost), agg
        )
        self._fitted_agg = bool(self._agg_samples)
        self._since_refit = 0
        self._errors.clear()  # errors measured against the superseded model
        self.refits += 1
        return True

    def drift(self) -> float:
        """Mean relative prediction error SINCE THE LAST REFIT (0 = the
        current model predicted every observed cost exactly).  Resets on
        refit, so a session trigger (`drift() > threshold` -> ``refit_now``)
        does not immediately re-fire."""
        if not self._errors:
            return 0.0
        recent = self._errors[-self.window:]
        return sum(recent) / len(recent)

    # -- per-device calibration ------------------------------------------
    @staticmethod
    def _median(values: List[float]) -> float:
        s = sorted(values)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def worker_scale(self, worker: str) -> float:
        """Relative cost multiplier of ``worker`` vs the pool average:
        >1 means slower than its peers, <1 faster, 1.0 when there is not
        yet enough evidence (fewer than 2 samples for this worker).

        Computed as this worker's median observed/predicted ratio divided
        by the median over ALL per-worker observations, so the pooled fit
        (which absorbs the average level) and the per-device deviations
        compose instead of double-counting drift."""
        ratios = self._worker_ratios.get(worker)
        if not ratios or len(ratios) < 2:
            return 1.0
        pooled = [r for rs in self._worker_ratios.values() for r in rs]
        base = self._median(pooled)
        if base <= 1e-12:
            return 1.0
        return self._median(ratios) / base

    def worker_cost(self, num_tuples: int, worker: str) -> float:
        """Predicted cost of one batch ON ``worker`` — the pooled model's
        prediction scaled by the device's calibrated deviation."""
        return self.cost(num_tuples) * self.worker_scale(worker)

    def worker_weights(self, names: Sequence[str]) -> Tuple[float, ...]:
        """Relative worker SPEEDS aligned with ``names`` (inverse cost
        scales, normalized to mean 1.0) — the shape
        ``weighted_shard_extents`` consumes.  All-1.0 until at least one
        worker has calibrated away from its peers."""
        inv = [1.0 / max(self.worker_scale(n), 1e-12) for n in names]
        if not inv:
            return ()
        mean = sum(inv) / len(inv)
        if mean <= 1e-12:
            return (1.0,) * len(inv)
        return tuple(v / mean for v in inv)
