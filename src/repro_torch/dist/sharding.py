"""Pure-Python shard extents for pool dispatch, and the divisibility-fallback
event.

Copied from the JAX package's ``repro/dist/sharding.py`` (only the
functions that need no JAX): ``core/policies/dynamic.py`` imports the two
extents functions lazily whenever a decision is split across pool workers;
``dist/mesh.py`` reports a batch that stays replicated with
``fallback_event``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple


def fallback_event(dim: int, axes: Tuple[str, ...], axis_size: int) -> Dict:
    """The ``sharding_fallback`` event of a batch-like dim that stays
    REPLICATED because the data-parallel axis size does not divide it: the
    dict the JAX package's ``_emit_fallback`` sends to its listeners.
    Under-sharding is correct but slow (the whole array lands on every
    device), so it is reported, not silent."""
    return {
        "kind": "sharding_fallback",
        "dim": dim,
        "axes": axes,
        "axis_size": axis_size,
        "detail": (
            f"dim {dim} not divisible by axis size {axis_size} "
            f"({'x'.join(axes)}); dim stays replicated"
        ),
    }


def batch_shard_extents(
    num_tuples: int, num_shards: int
) -> Tuple[Tuple[int, int], ...]:
    """Contiguous (offset, size) extents splitting one logical batch across
    ``num_shards`` pool workers: tuples spread as evenly as possible, the
    remainder going to the earliest shards, empty shards dropped
    (``num_tuples < num_shards`` yields fewer extents, never zero-sized
    ones).  Offsets are relative to the logical batch start, so callers add
    their own base offset; the resulting per-shard partials are offset-keyed
    and combine in ``finalize`` like segagg partials.
    """
    if num_tuples < 0:
        raise ValueError(f"negative num_tuples {num_tuples}")
    if num_shards <= 0:
        raise ValueError(f"need at least one shard, got {num_shards}")
    base, rem = divmod(num_tuples, num_shards)
    extents = []
    offset = 0
    for i in range(num_shards):
        size = base + (1 if i < rem else 0)
        if size == 0:
            break
        extents.append((offset, size))
        offset += size
    return tuple(extents)


def weighted_shard_extents(
    num_tuples: int, weights: Sequence[float]
) -> Tuple[Tuple[int, int], ...]:
    """Contiguous (offset, size) extents splitting one logical batch across
    heterogeneous workers in proportion to ``weights`` (relative worker
    speeds from per-device calibration).  Largest-remainder apportionment:
    each worker gets ``floor(n * w_i / sum(w))`` tuples, the leftover going
    one-by-one to the largest fractional parts (ties to the earliest
    worker).  With equal weights this reduces EXACTLY to
    ``batch_shard_extents``.

    Unlike ``batch_shard_extents``, the result is aligned 1:1 with
    ``weights`` — zero-sized extents are KEPT so callers can zip the result
    with their worker list and drop empty assignments themselves.
    """
    if num_tuples < 0:
        raise ValueError(f"negative num_tuples {num_tuples}")
    if not weights:
        raise ValueError("need at least one weight")
    if any(w < 0 for w in weights):
        raise ValueError(f"weights must be non-negative, got {tuple(weights)}")
    total_w = float(sum(weights))
    if total_w <= 0:
        raise ValueError("at least one weight must be positive")
    ideal = [num_tuples * float(w) / total_w for w in weights]
    sizes = [int(math.floor(x)) for x in ideal]
    leftover = num_tuples - sum(sizes)
    # Largest fractional part first; ties broken toward the earliest worker
    # (matching batch_shard_extents' remainder-to-earliest rule).
    order = sorted(range(len(weights)), key=lambda i: (-(ideal[i] - sizes[i]), i))
    for i in order[:leftover]:
        sizes[i] += 1
    extents = []
    offset = 0
    for size in sizes:
        extents.append((offset, size))
        offset += size
    return tuple(extents)
