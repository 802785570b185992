"""Minimum batch size for the dynamic scenario (paper §4.1, Eq. 9).

The dynamic scheduler cannot hold work back for globally optimal batches
(other queries claim the executor), so each query is processed whenever
``MinBatch`` tuples are ready.  ``MinBatch`` trades cost against
schedulability:

* cost bound   — processing everything in MinBatch-sized chunks (plus final
                 aggregation) must cost at most ``(1 + delta_rsf)`` times the
                 single-batch minimum (Eq. 9: delta_rsf = 0.1 -> factor 1.1);
* latency bound— one MinBatch must cost <= ``c_max`` so the non-preemptive
                 blocking period is bounded (§4.2/§4.3);
* group floor  — at least ~2x the number of GROUP-BY groups, else partial
                 aggregation shrinks nothing (§4.1).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Union

from .cost_model import CostModelBase, LinearCostModel
from .types import InfeasibleDeadline


def find_min_batch_size(
    num_tuples_total: int,
    cost_model: CostModelBase,
    delta_rsf: float,
    c_max: float,
    num_groups: int = 0,
) -> int:
    """FindMinBatchSize (Algorithm 2 helper).

    Smallest batch size whose total batched cost respects Eq. (9), then capped
    so a single batch never exceeds ``c_max``; floored at ``2 * num_groups``
    when that is compatible with ``c_max``.
    """
    n = num_tuples_total
    if n <= 0:
        return 1
    budget = (1.0 + delta_rsf) * cost_model.cost(n)

    # batched_cost is non-increasing in batch size (fewer batches => less
    # overhead + less final agg), so binary-search the smallest x within budget.
    lo, hi = 1, n
    if cost_model.batched_cost(n, n) > budget + 1e-9:
        raise InfeasibleDeadline("cost budget below single-batch cost")
    while lo < hi:
        mid = (lo + hi) // 2
        if cost_model.batched_cost(n, mid) <= budget + 1e-9:
            hi = mid
        else:
            lo = mid + 1
    x = lo

    # Group floor (§4.1): significant reduction needs >= 2x groups per batch.
    if num_groups > 0:
        x = max(x, min(2 * num_groups, n))

    # C_max cap (§4.2): one batch must fit the scheduler quantum.  This may
    # override the Eq.-9 bound — the paper gives C_max precedence ("its
    # Minbatch size is reduced such that its cost does not exceed C_max").
    if cost_model.cost(1) > c_max + 1e-9:
        raise InfeasibleDeadline(
            f"cost of a single tuple {cost_model.cost(1):.3g} exceeds C_max {c_max:.3g}"
        )
    cap = cost_model.tuples_processable(c_max)
    return max(1, min(x, cap, n))


def find_min_batch_sizes(
    num_tuples_totals: Sequence[int],
    cost_models: Sequence[CostModelBase],
    delta_rsf: float,
    c_max: float,
    num_groups: Union[int, Sequence[int]] = 0,
) -> List[int]:
    """Batch ``find_min_batch_size`` over parallel rows.

    When every row's cost model is exactly a ``LinearCostModel`` (and
    ``c_max`` is finite), all binary searches run SIMULTANEOUSLY over
    packed numpy arrays — each iteration halves every row's bracket at
    once, so sizing k queries costs O(log max_n) vectorized steps instead
    of k independent scalar searches.  The float operations replicate the
    scalar algorithm's order exactly, so results are identical element for
    element, and an infeasible row raises the same ``InfeasibleDeadline``
    (first row in input order wins, like a scalar loop would).  Any other
    cost model falls back to the per-row scalar routine.
    """
    ns = [int(n) for n in num_tuples_totals]
    models = list(cost_models)
    if len(ns) != len(models):
        raise ValueError("num_tuples_totals and cost_models length mismatch")
    if isinstance(num_groups, int):
        groups = [num_groups] * len(ns)
    else:
        groups = [int(g) for g in num_groups]
        if len(groups) != len(ns):
            raise ValueError("num_groups length mismatch")
    if (not ns
            or not math.isfinite(c_max)
            or any(type(m) is not LinearCostModel for m in models)):
        return [
            find_min_batch_size(n, m, delta_rsf, c_max, g)
            for n, m, g in zip(ns, models, groups)
        ]
    import numpy as np

    n_arr = np.array(ns, dtype=np.int64)
    tc = np.array([m.tuple_cost for m in models], dtype=np.float64)
    oh = np.array([m.overhead for m in models], dtype=np.float64)
    apb = np.array([m.agg_per_batch for m in models], dtype=np.float64)
    agg_oh = np.array([m.agg_overhead for m in models], dtype=np.float64)
    g_arr = np.array(groups, dtype=np.int64)

    live = n_arr > 0  # n <= 0 rows return 1 before any feasibility check
    n = np.where(live, n_arr, 1)
    single = n * tc + oh  # cost(n), n >= 1
    budget = (1.0 + delta_rsf) * single
    cost1 = 1 * tc + oh  # cost(1)
    bad_budget = live & (single > budget + 1e-9)
    bad_cmax = live & (cost1 > c_max + 1e-9)
    bad = bad_budget | bad_cmax
    if bad.any():
        i = int(np.argmax(bad))
        if bad_budget[i]:
            raise InfeasibleDeadline("cost budget below single-batch cost")
        raise InfeasibleDeadline(
            f"cost of a single tuple {float(cost1[i]):.3g} "
            f"exceeds C_max {c_max:.3g}"
        )

    # All rows bisect in lock-step; a row whose bracket closed keeps
    # evaluating its (now fixed) lo — harmless and branch-free.
    lo = np.ones_like(n)
    hi = n.copy()
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        full = n // mid
        rem = n - full * mid
        c = full * (mid * tc + oh) + np.where(rem > 0, rem * tc + oh, 0.0)
        nb = full + (rem > 0)
        c = c + np.where(nb > 1, nb * apb + agg_oh, 0.0)
        ok = c <= budget + 1e-9
        hi = np.where(active & ok, mid, hi)
        lo = np.where(active & ~ok, mid + 1, lo)
    x = lo

    x = np.where(g_arr > 0, np.maximum(x, np.minimum(2 * g_arr, n)), x)
    tc_safe = np.where(tc > 0, tc, 1.0)
    capf = np.floor((c_max - oh) / tc_safe + 1e-9)
    cap = np.where(
        c_max < oh, 0,
        np.where(tc <= 0, 1 << 40, capf.astype(np.int64)),
    )
    out = np.maximum(1, np.minimum(np.minimum(x, cap), n))
    return [int(v) if ok_row else 1 for v, ok_row in zip(out, live)]
