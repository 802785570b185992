"""Synthetic TPC-H-like record streams (paper §7.1) + the paper's query set.

The paper streams Orders and Lineitem files (1 file of each per second,
4500 s, 25 GB total) with a timestamp column added, against static
Customer/Part/... relations.  Here the streams are seeded numpy structured
batches with the same logical schema, scaled by ``scale`` so tests run in
milliseconds and benchmarks in seconds.

Queries (Table 3 + the TPC-H subset used in §7): each is (filter +)
(join +) GROUP-BY aggregate, expressed against columnar record batches and
executed by ``repro.serve.analytics`` with the segagg kernel.  Group counts
follow the paper (CQ2 ~5 groups, CQ3 ~360K, CQ4 ~1.5M at full scale).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

FULL_SCALE_SUPPKEYS = 360_000
FULL_SCALE_PARTKEYS = 1_500_000
ORDER_PRIORITIES = 5
ORDERS_PER_FILE = 3_300          # ~1.2 MB of orders per file in the paper
LINEITEMS_PER_FILE = 13_000      # ~5 MB of lineitem per file


@dataclasses.dataclass(frozen=True)
class StreamScale:
    """scale=1.0 reproduces the paper's cardinalities; tests use ~1e-3."""

    scale: float = 1.0

    @property
    def orders_per_file(self) -> int:
        return max(int(ORDERS_PER_FILE * self.scale), 8)

    @property
    def lineitems_per_file(self) -> int:
        return max(int(LINEITEMS_PER_FILE * self.scale), 16)

    @property
    def num_suppkeys(self) -> int:
        return max(int(FULL_SCALE_SUPPKEYS * self.scale), 16)

    @property
    def num_partkeys(self) -> int:
        return max(int(FULL_SCALE_PARTKEYS * self.scale), 32)


def orders_batch(rng: np.random.Generator, n: int, t0: float, t1: float,
                 sc: StreamScale) -> Dict[str, np.ndarray]:
    ts = np.sort(rng.uniform(t0, t1, n))
    return {
        "order_id": rng.integers(0, 1 << 31, n, dtype=np.int64),
        "cust_id": rng.integers(0, max(int(1000 * sc.scale), 10), n),
        "order_priority": rng.integers(0, ORDER_PRIORITIES, n),
        "total_price": rng.gamma(2.0, 150.0, n).astype(np.float32),
        "ts": ts,
    }


def lineitem_batch(rng: np.random.Generator, n: int, t0: float, t1: float,
                   sc: StreamScale) -> Dict[str, np.ndarray]:
    ts = np.sort(rng.uniform(t0, t1, n))
    return {
        "order_id": rng.integers(0, 1 << 31, n, dtype=np.int64),
        "supp_key": rng.integers(0, sc.num_suppkeys, n),
        "part_key": rng.integers(0, sc.num_partkeys, n),
        "quantity": rng.integers(1, 50, n).astype(np.float32),
        "price": rng.gamma(2.0, 30.0, n).astype(np.float32),
        "ts": ts,
    }


def stream_files(seed: int, num_files: int, sc: StreamScale,
                 files_per_second: float = 1.0
                 ) -> Iterator[Tuple[float, Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
    """Yield (arrival_time, orders_file, lineitem_file) like §7.1's
    1 orders-file + 1 lineitem-file per second."""
    rng = np.random.default_rng(seed)
    for i in range(num_files):
        t0, t1 = i / files_per_second, (i + 1) / files_per_second
        yield (t1, orders_batch(rng, sc.orders_per_file, t0, t1, sc),
               lineitem_batch(rng, sc.lineitems_per_file, t0, t1, sc))


# ---------------------------------------------------------------------------
# Queries (paper Table 3 + TPC-H subset)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnalyticsQuery:
    """GROUP-BY aggregate over one of the streams.

    key_fn(batch) -> int group ids; value_fn(batch) -> (N, V) values.
    ``num_groups`` bounds the group-id domain (drives MinBatch sizing and
    the final-aggregation cost, §4.1/§6.2)."""

    query_id: str
    stream: str                    # "orders" | "lineitem"
    num_groups_fn: Callable[[StreamScale], int]
    key_fn: Callable[[Dict[str, np.ndarray]], np.ndarray]
    value_fn: Callable[[Dict[str, np.ndarray]], np.ndarray]
    description: str = ""

    def num_groups(self, sc: StreamScale) -> int:
        return self.num_groups_fn(sc)


def _ones(b: Dict[str, np.ndarray]) -> np.ndarray:
    n = len(next(iter(b.values())))
    return np.ones((n, 1), np.float32)


PAPER_QUERIES: List[AnalyticsQuery] = [
    AnalyticsQuery(
        "CQ1", "orders", lambda sc: 1,
        key_fn=lambda b: np.zeros(len(b["order_id"]), np.int64),
        value_fn=_ones,
        description="SELECT count(*) FROM orders",
    ),
    AnalyticsQuery(
        "CQ2", "orders", lambda sc: ORDER_PRIORITIES,
        key_fn=lambda b: b["order_priority"],
        value_fn=_ones,
        description="count(*) GROUP BY orderPriority (~5 groups)",
    ),
    AnalyticsQuery(
        "CQ3", "lineitem", lambda sc: sc.num_suppkeys,
        key_fn=lambda b: b["supp_key"],
        value_fn=_ones,
        description="count(*) GROUP BY suppKey (~360K groups full scale)",
    ),
    AnalyticsQuery(
        "CQ4", "lineitem", lambda sc: sc.num_partkeys,
        key_fn=lambda b: b["part_key"],
        value_fn=_ones,
        description="count(*) GROUP BY partKey (~1.5M groups full scale)",
    ),
    AnalyticsQuery(
        "TPC-Q6-like", "lineitem", lambda sc: 1,
        key_fn=lambda b: np.zeros(len(b["price"]), np.int64),
        value_fn=lambda b: (b["price"] * b["quantity"]
                            * (b["quantity"] < 24)).astype(np.float32)[:, None],
        description="filtered revenue sum (Q6 shape)",
    ),
    AnalyticsQuery(
        "TPC-Q4-like", "lineitem", lambda sc: ORDER_PRIORITIES,
        key_fn=lambda b: b["order_id"] % ORDER_PRIORITIES,
        value_fn=_ones,
        description="orders x lineitem same-batch join, count by priority "
                    "(§6.1 same-batch join assumption)",
    ),
]


# ---------------------------------------------------------------------------
# Paper-shaped cost models (§6.2, Fig 3): per-file piecewise-linear costs.
# Units: seconds of executor time per FILE (the paper's batch unit), fitted
# to reproduce the relationships reported in §7.2 (e.g. Q10's 60-batch cost
# ~6x its single-batch cost; CQ2 2.7x CQ1 at 60 batches via agg cost).
# ---------------------------------------------------------------------------

def paper_cost_model(query_id: str, regime: str = "fig4"):
    """Linear Eq.-(1) models fitted to the paper's reported relationships:

    * Table 2 file-based single-batch costs: CQ1 17.9s, CQ2 18.9s, CQ3 32s,
      CQ4 32.5s;
    * Fig 4: cost grows with #batches; TPC-Q10 at 60 batches ~6x its
      single-batch cost (highest of the set);
    * §7.2: final-aggregation cost ordering CQ4 > CQ3 >> CQ2 > CQ1
      (group counts 1.5M / 360K / 5 / 1), with CQ3's per-tuple cost higher
      than CQ4's.
    Units: seconds; "tuples" are FILES (the paper's batching unit).

    The final-aggregation model is PIECEWISE linear in the number of batches
    (§6.2: "we fit a piece-wise linear model to estimate the final
    aggregation cost"): shallow below ~5 batches — which is what lets the
    paper's 0.1D single-query cases still schedule 2-3 batches (Fig 6) —
    and steeper toward the 60-batch regime that drives Fig 4's blow-up.
    """
    from ..core import PiecewiseLinearCostModel

    # (per_file_s, per_batch_overhead_s, agg_cost_at_60_batches_s)
    # Derivation from the paper's reported facts:
    #   * Table 2 file-based single-batch costs (CQ1 17.9 .. CQ4 32.5s);
    #   * Fig 4: CQ1 at 60 batches ~2.7x its baseline; TPC-Q10 ~6x;
    #   * §7.2: agg costs at 60 batches ~0.6/1.6/3/7s for CQ1..CQ4 (the
    #     only reading under which "CQ4 only slightly above CQ3 overall"
    #     and the CQ2-vs-CQ1 ratio are simultaneously true);
    #   * Fig 3: the join queries Q3/Q9/Q10 are disproportionately costly
    #     at SMALL batch sizes => high per-batch intercept, which is also
    #     exactly what makes them need 3 batches at the 0.1D deadline
    #     (Fig 6) while every other query needs 2.
    consts = {
        "CQ1": (0.0038, 0.5, 0.6), "CQ2": (0.0040, 0.5, 1.6),
        "CQ3": (0.0070, 0.5, 3.0), "CQ4": (0.0066, 0.5, 7.0),
        "TPC-Q1": (0.0080, 0.6, 1.5), "TPC-Q3": (0.0110, 4.0, 3.0),
        "TPC-Q4": (0.0090, 0.7, 1.2), "TPC-Q6": (0.0040, 0.4, 0.5),
        "TPC-Q9": (0.0120, 4.5, 3.0), "TPC-Q10": (0.0080, 2.7, 3.0),
        "TPC-Q12": (0.0090, 0.7, 1.2), "TPC-Q14": (0.0060, 0.5, 1.0),
        "TPC-Q19": (0.0080, 0.7, 1.5),
        "TPC-Q6-like": (0.0040, 0.4, 0.5), "TPC-Q4-like": (0.0090, 0.7, 1.2),
    }
    per_file, overhead, agg60 = consts.get(query_id, (0.008, 0.7, 1.2))
    join_heavy = query_id in ("TPC-Q3", "TPC-Q9", "TPC-Q10")
    if regime == "spark":
        # Multi-query-experiment regime (§7.4): the paper's own feasibility
        # analysis there (sum of last-batch costs ~105s vs largest deadline
        # windEnd+94) implies per-batch overheads of ~8.5% of the single-
        # batch cost for EVERY query — much larger than the Fig-4-implied
        # overheads.  The two regimes cannot be reconciled by one constant
        # set (see EXPERIMENTS.md "calibration notes"); benchmarks report
        # both.
        overhead = max(overhead, 0.085 * (NUM_FILES * per_file) / (1 - 0.085))
    n = NUM_FILES
    cost_points = ((1.0, overhead + per_file),
                   (float(n), overhead + per_file * n),
                   (float(4 * n), overhead + per_file * 4 * n))
    if join_heavy:
        # startup-dominated final agg (reads many partial files of a join)
        agg_points = ((1.0, 0.0), (2.0, 1.0), (3.0, 1.1), (5.0, 1.3),
                      (60.0, agg60))
    else:
        agg_points = ((1.0, 0.0), (2.0, 0.2), (5.0, 0.2 + agg60 * 0.06),
                      (60.0, agg60))
    return PiecewiseLinearCostModel(points=cost_points, agg_points=agg_points)


PAPER_QUERY_IDS = ["CQ1", "CQ2", "CQ3", "CQ4", "TPC-Q1", "TPC-Q3", "TPC-Q4",
                   "TPC-Q6", "TPC-Q9", "TPC-Q10", "TPC-Q12", "TPC-Q14",
                   "TPC-Q19"]
NUM_FILES = 4500  # §7.1: 4500 files at 1 file/s
