"""Arrival forecasting for predictive (proactive) scheduling.

The paper's schedulers assume each window's arrival curve is known up
front; PRs 3/5 made the runtime *reactive* — it recalibrates after cost
drift is observed and sheds after overload has already materialized, so
deadlines are at risk before the system acts.  Predictive tuple scheduling
(POTUS) shows that acting on a FORECAST of the arrival process beats the
reactive baseline: by the time a burst lands, the schedule has already
made room for it.

This module is the forecasting layer of that story:

* ``ArrivalObservation`` / ``observe_arrival`` — one closed window's
  realized arrival statistics (tuple count, mean rate, burstiness),
  extracted from the window's OFFERED stream (``offered_arrival`` unwraps
  any shedding so the forecast tracks demand, not past actuation).
* ``ArrivalForecaster`` — per-spec Holt-style EWMA (level + linear trend)
  over the inter-window observation series, with an exponentially-weighted
  residual variance giving confidence bands; rate and burstiness are
  EWMA-smoothed alongside the count.
* ``ArrivalForecast`` — one window-ahead point forecast plus its band
  (``lower``/``upper`` = point ± z·std) and the forecast burst SHAPE
  (``expected_by`` — how many tuples should have arrived by an instant if
  the forecast is on track; the session's forecast-miss detector compares
  realized arrivals against it mid-window).
* ``forecast_query`` — a pessimistic stand-in window query for the
  schedulability machinery: the planned tuple count arriving at the
  forecast burst pace (compressed into the tail of the window), which is
  what ``repro.core.session`` feeds to ``admission_check``/
  ``plan_shedding`` at window roll-over so shedding happens BEFORE the
  burst (proactive replanning).
* ``SpecHistory`` — the public per-spec observation record returned by
  ``Session.history()``: arrival observations plus the calibrator's cost
  feedback (``CalibratingCostModel.samples``/``agg_samples``), replacing
  consumer access to ``_LiveSpec``/calibrator privates.

Everything here is advisory arithmetic with no runtime state of its own;
the enforcement points live in ``repro.core.session`` (proactive shed /
refund / speculative pane pre-warm) and are inert — every trace
byte-identical — unless a session enables ``forecast=``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .arrivals import ArrivalModel, ShiftedArrival, ThinnedArrival, UniformWindowArrival
from .types import EPS, Query

__all__ = [
    "ArrivalForecast",
    "ArrivalForecaster",
    "ArrivalObservation",
    "ForecastConfig",
    "SpecHistory",
    "forecast_query",
    "observe_arrival",
    "offered_arrival",
]

# Segments the window is split into when estimating burstiness from a
# closed window's arrival curve: peak segment rate over mean rate.  Eight
# localizes a burst to 12.5% of the window — sharp enough to act on,
# coarse enough that ordinary jitter does not read as a burst.
_BURST_SEGMENTS = 8


def offered_arrival(arr: ArrivalModel) -> ArrivalModel:
    """The OFFERED stream behind ``arr``: every ``ThinnedArrival`` layer
    (load shedding is an actuation, not demand) unwrapped, time shifts
    preserved.  Forecasts must be fit on what the stream tried to deliver,
    or a shed window would teach the forecaster that demand dropped."""
    if isinstance(arr, ShiftedArrival):
        base = offered_arrival(arr.base)
        if base is arr.base:
            return arr
        return ShiftedArrival(base=base, shift=arr.shift)
    if isinstance(arr, ThinnedArrival):
        return offered_arrival(arr.base)
    return arr


@dataclasses.dataclass(frozen=True)
class ArrivalObservation:
    """Realized arrival statistics of ONE closed window.

    ``burstiness`` is the peak-to-mean rate ratio over
    ``_BURST_SEGMENTS`` equal sub-spans: 1.0 for a uniform stream, ~k when
    the whole window lands in a 1/k tail."""

    window: int
    wind_start: float
    wind_end: float
    num_tuples: int
    burstiness: float = 1.0

    @property
    def span(self) -> float:
        return self.wind_end - self.wind_start

    @property
    def mean_rate(self) -> float:
        """Tuples per time unit over the window span (inf for instant
        windows)."""
        if self.span <= 0:
            return math.inf if self.num_tuples > 0 else 0.0
        return self.num_tuples / self.span


def observe_arrival(arr: ArrivalModel, window: int = 0, *,
                    wind_start: Optional[float] = None,
                    wind_end: Optional[float] = None) -> ArrivalObservation:
    """Extract an ``ArrivalObservation`` from a CLOSED window's arrival
    model (all arrivals realized).  ``arr`` should be the offered stream —
    callers with a possibly-shed model unwrap via ``offered_arrival``.

    ``wind_start`` / ``wind_end`` override the observation frame; pass the
    QUERY's window bounds when the arrival model covers a narrower span
    (e.g. a tail burst), or burstiness would be measured against the burst
    itself and read as uniform."""
    n = arr.num_tuples_total
    start = arr.wind_start if wind_start is None else wind_start
    end = arr.wind_end if wind_end is None else wind_end
    span = end - start
    burst = 1.0
    if n > 0 and span > 0:
        prev = 0
        peak = 0
        for i in range(1, _BURST_SEGMENTS + 1):
            a = arr.tuples_available(start + span * i / _BURST_SEGMENTS)
            peak = max(peak, a - prev)
            prev = a
        burst = max(1.0, peak * _BURST_SEGMENTS / n)
    return ArrivalObservation(
        window=window, wind_start=start, wind_end=end,
        num_tuples=n, burstiness=burst,
    )


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    """Knobs of the predictive-scheduling subsystem
    (``Session(forecast=...)``).

    ``alpha`` is the EWMA smoothing factor for level/trend/rate/burstiness
    (1.0 = last observation wins); ``z`` the half-width of the confidence
    band in residual standard deviations; ``min_history`` how many closed
    windows a spec needs before its forecasts are ACTED on (proactive
    shedding, pre-warming) — below it the forecaster only learns.
    ``miss_check_frac`` places the mid-window forecast-miss check: once
    that fraction of the FORECAST burst should have arrived, realized
    arrivals below ``miss_tolerance`` times the expected curve (lower
    band) declare a miss (the session falls back to the reactive path and
    refunds the window's proactive shed).  The tolerance absorbs burst
    TIMING error — a real burst landing slightly later than forecast must
    not read as "the burst is not coming".
    ``prewarm`` gates speculative pane deposits during idle capacity
    (``repro.core.panes``; needs ``sharing=True`` to do anything).
    """

    alpha: float = 0.5
    z: float = 2.0
    min_history: int = 2
    miss_check_frac: float = 0.5
    miss_tolerance: float = 0.5
    prewarm: bool = True

    def __post_init__(self) -> None:
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        if self.z < 0:
            raise ValueError(f"z must be >= 0, got {self.z}")
        if self.min_history < 1:
            raise ValueError(
                f"min_history must be >= 1, got {self.min_history}")
        if not 0.0 < self.miss_check_frac <= 1.0:
            raise ValueError(
                f"miss_check_frac must be in (0, 1], got "
                f"{self.miss_check_frac}")
        if not 0.0 < self.miss_tolerance <= 1.0:
            raise ValueError(
                f"miss_tolerance must be in (0, 1], got "
                f"{self.miss_tolerance}")


@dataclasses.dataclass(frozen=True)
class ArrivalForecast:
    """One window-ahead forecast: expected tuple count with a ±z·std band,
    plus the smoothed rate and burstiness shaping the expected curve."""

    window: int
    tuples: float
    std: float
    z: float
    rate: float
    burstiness: float = 1.0

    @property
    def lower(self) -> float:
        return max(0.0, self.tuples - self.z * self.std)

    @property
    def upper(self) -> float:
        return self.tuples + self.z * self.std

    def contains(self, actual: float) -> bool:
        """Did the realized count land inside the confidence band?"""
        return self.lower - EPS <= actual <= self.upper + EPS

    def burst_span(self, wind_start: float, wind_end: float) -> float:
        """Forecast burst duration inside ``[wind_start, wind_end]``: the
        window span compressed by the burstiness ratio, anchored at the
        window END (bursts that matter are the ones that leave no time to
        drain)."""
        span = max(wind_end - wind_start, 0.0)
        return span / max(self.burstiness, 1.0)

    def expected_by(self, t: float, wind_start: float, wind_end: float,
                    count: Optional[float] = None) -> float:
        """Tuples expected to have arrived by ``t`` if the forecast is on
        track: ``count`` (default: the band's LOWER edge — the miss check
        must not cry wolf on an ordinary shortfall) arriving uniformly
        over the forecast burst span at the window tail."""
        if count is None:
            count = self.lower
        bs = self.burst_span(wind_start, wind_end)
        if bs <= 0:
            return count if t >= wind_end - EPS else 0.0
        frac = (t - (wind_end - bs)) / bs
        return count * min(max(frac, 0.0), 1.0)


class ArrivalForecaster:
    """Per-spec arrival forecaster: Holt's linear exponential smoothing on
    the inter-window tuple-count series plus EWMA rate/burstiness, fed one
    ``ArrivalObservation`` per closed window (``observe``).

    The confidence band is ±z standard deviations of the exponentially-
    weighted ONE-STEP-AHEAD residuals: each observation is first scored
    against the forecast made before it, then folded in — so the band
    widens exactly when the forecaster is actually missing.  ``hits`` /
    ``misses`` count the session's scoring of acted-on forecasts (band
    containment at window close, mid-window burst checks)."""

    def __init__(self, config: Optional[ForecastConfig] = None):
        self.config = config if config is not None else ForecastConfig()
        self._level: Optional[float] = None
        self._trend = 0.0
        self._var = 0.0
        self._rate: Optional[float] = None
        self._burst: Optional[float] = None
        self._count = 0
        self.hits = 0
        self.misses = 0

    @property
    def num_observations(self) -> int:
        return self._count

    @property
    def ready(self) -> bool:
        """Enough history to ACT on forecasts (vs just learning)."""
        return self._count >= self.config.min_history

    def observe(self, obs: ArrivalObservation) -> None:
        """Fold one closed window's realized arrivals into the forecast
        state."""
        a = self.config.alpha
        y = float(obs.num_tuples)
        if self._level is None:
            self._level = y
        else:
            resid = y - (self._level + self._trend)
            self._var += a * (resid * resid - self._var)
            prev = self._level
            self._level = a * y + (1.0 - a) * (self._level + self._trend)
            self._trend = a * (self._level - prev) + (1.0 - a) * self._trend
        rate = obs.mean_rate
        if math.isfinite(rate):
            self._rate = rate if self._rate is None else (
                a * rate + (1.0 - a) * self._rate)
        # Level-style initialization: the first observation IS the estimate
        # (an EWMA crawling up from 1.0 would under-forecast the burst for
        # many windows, and a too-wide burst span under-sheds).
        if self._burst is None:
            self._burst = obs.burstiness
        else:
            self._burst += a * (obs.burstiness - self._burst)
        self._count += 1

    def forecast(self, window: int) -> Optional[ArrivalForecast]:
        """One-window-ahead forecast (None before any observation)."""
        if self._level is None:
            return None
        return ArrivalForecast(
            window=window,
            tuples=max(0.0, self._level + self._trend),
            std=math.sqrt(max(self._var, 0.0)),
            z=self.config.z,
            rate=self._rate if self._rate is not None else 0.0,
            burstiness=max(self._burst if self._burst is not None else 1.0,
                           1.0),
        )

    def record_hit(self) -> None:
        self.hits += 1

    def record_miss(self) -> None:
        self.misses += 1

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"ArrivalForecaster(n={self._count}, level={self._level}, "
                f"trend={self._trend:.4g}, burst={self._burst:.3g}, "
                f"hits={self.hits}, misses={self.misses})")


def forecast_query(query: Query, fc: ArrivalForecast) -> Query:
    """The pessimistic stand-in ``query`` for proactive feasibility checks:
    the PLANNED tuple count arriving at the forecast burst pace — uniformly
    over the burst span at the window tail — instead of the predicted
    curve.  Count stays the planned one (the window never processes more
    than it planned; fewer-than-planned arrivals only make scheduling
    easier), so the stand-in differs from the real window purely in
    arrival TIMING, which is exactly the risk a late burst poses.

    Near-uniform forecasts (burst span within 10% of the window span —
    segment discretization alone reads a uniform stream as burstiness
    ~1.04) return ``query`` unchanged: a no-op stand-in keeps the
    proactive path inert when there is no burst to get ahead of."""
    span = query.wind_end - query.wind_start
    bs = fc.burst_span(query.wind_start, query.wind_end)
    if span <= 0 or bs >= 0.9 * span - EPS or query.num_tuples_total <= 0:
        return query
    arr = UniformWindowArrival(
        wind_start=query.wind_end - bs,
        wind_end=query.wind_end,
        num_tuples_total=query.num_tuples_total,
    )
    return dataclasses.replace(query, wind_start=arr.wind_start, arrival=arr)


@dataclasses.dataclass(frozen=True)
class SpecHistory:
    """Public per-spec observation record (``Session.history()``): what
    the session has LEARNED about one recurring query — per-window arrival
    observations plus the calibration feedback loop's cost samples.

    ``cost_samples`` / ``agg_samples`` are the calibrator's buffered
    ``(num_tuples, observed_cost)`` / ``(num_batches, observed_cost)``
    pairs (empty without ``calibrate=True``); ``shed_fraction`` /
    ``error_bound`` the spec-level admission degradation currently in
    force.  This is the supported read path — ``_LiveSpec`` and the
    calibrator's buffers are internals."""

    base_id: str
    arrivals: Tuple[ArrivalObservation, ...] = ()
    cost_samples: Tuple[Tuple[float, float], ...] = ()
    agg_samples: Tuple[Tuple[float, float], ...] = ()
    shed_fraction: float = 0.0
    error_bound: float = 0.0

    @property
    def num_windows_observed(self) -> int:
        return len(self.arrivals)
