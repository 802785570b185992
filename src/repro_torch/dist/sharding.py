"""Partition specs from logical axis names (launch side of
repro_torch.dist), the scheduler's 1-D batch splits, and divisibility-fallback
reporting: the JAX package's ``dist/sharding.py``.

``repro_torch.models.params.ParamSpec`` carries a logical axis name per dim
("embed", "heads", "ffn", ...); these helpers turn a whole spec table into
specs (``dist.context``'s tuples, the entries of a JAX ``PartitionSpec``)
or DTensor placements for one mesh:

* parameters — FSDP on "data" over the embed dim, tensor-parallel on "model"
  over heads/ffn/vocab/experts dims (first eligible dim wins an axis);
* inputs     — batch dim (dim 0) sharded over the data-parallel axes
  ("pod" x "data" on the multi-pod mesh);
* caches     — decode caches are (layer_units, batch, ...): batch dim (dim 1)
  sharded over the data-parallel axes.

A mesh axis is applied to a dim only when the dim size is divisible by the
axis size; otherwise the dim stays replicated (correct, just less sharded)
and a batch-like dim reports it.  ``core/policies/dynamic.py`` imports the
two extents functions lazily whenever a decision is split across pool
workers; ``dist/mesh.py`` reports a batch that stays replicated with
``fallback_event``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .context import PARAM_AXIS_RULES, Spec, _resolve, mesh_axes, to_placements

# Abstract stand-ins by name: (shape, dtype) pairs or tensors with .shape.
Structs = Dict[str, object]

# Divisibility-fallback listeners: when a batch-like dim stays REPLICATED
# because the data-parallel axis size does not divide it, every registered
# listener receives one ``fallback_event`` dict.
_fallback_listeners: List[Callable[[Dict], None]] = []


def on_fallback(listener: Callable[[Dict], None]) -> Callable[[], None]:
    """Register a divisibility-fallback listener; returns an unsubscribe
    callable (idempotent)."""
    _fallback_listeners.append(listener)

    def unsubscribe() -> None:
        try:
            _fallback_listeners.remove(listener)
        except ValueError:
            pass

    return unsubscribe


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


def _emit_fallback(dim: int, axes: Tuple[str, ...], axis_size: int) -> None:
    event = fallback_event(dim, axes, axis_size)
    for listener in tuple(_fallback_listeners):
        listener(event)


def _dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes, outermost first."""
    return tuple(ax for ax in ("pod", "data") if ax in mesh_axes(mesh))


def _dp_entry(mesh, dim: int):
    """Spec entry for a batch-like dim: the DP axes if evenly divisible.
    A non-divisible dim stays replicated AND emits a ``sharding_fallback``
    event to the registered ``on_fallback`` listeners."""
    axes = _dp_axes(mesh)
    size = 1
    for ax in axes:
        size *= mesh_axes(mesh)[ax]
    if not axes or size <= 0:
        return None
    if dim % size:  # only reachable with size >= 2: every dim divides 1
        _emit_fallback(dim, axes, size)
        return None
    return axes if len(axes) > 1 else axes[0]


def _shape(struct) -> Tuple[int, ...]:
    """The shape of a (shape, dtype) pair or of a tensor."""
    return tuple(struct.shape) if hasattr(struct, "shape") else tuple(struct[0])


def param_pspecs(specs: Dict[str, "ParamSpec"], mesh) -> Dict[str, Spec]:  # noqa: F821
    """Spec per parameter leaf from its logical axes (``()``: replicated)."""
    out: Dict[str, Spec] = {}
    for name, spec in specs.items():
        resolved = _resolve(spec.shape, spec.axes, PARAM_AXIS_RULES, mesh)
        out[name] = resolved if resolved is not None else ()
    return out


def param_shardings(specs: Dict[str, "ParamSpec"], mesh) -> Dict[str, tuple]:  # noqa: F821
    """DTensor placements per parameter leaf on ``mesh`` (a DeviceMesh)."""
    return {k: to_placements(s, mesh) for k, s in param_pspecs(specs, mesh).items()}


def batch_spec(mesh, batch_rows: int, ndim: int) -> Tuple[Optional[object], ...]:
    """Spec entries for a (batch_rows, ...) array of rank ``ndim``: DP axes
    on dim 0 (when divisible), replicated elsewhere.  Callers may prepend
    extra ``None`` entries for leading dims (e.g. a microbatch dim)."""
    return (_dp_entry(mesh, batch_rows),) + (None,) * (ndim - 1)


def input_pspecs(structs: Structs, mesh) -> Dict[str, Spec]:
    """Batch-shard model inputs over the data-parallel axes (dim 0)."""
    return {k: batch_spec(mesh, _shape(s)[0], len(_shape(s))) for k, s in structs.items()}


def cache_pspecs(cfg, structs: Structs, mesh) -> Dict[str, Spec]:
    """Decode-cache specs: caches are (layer_units, batch, ...) — shard the
    batch dim (dim 1) over the data-parallel axes.  ``structs`` is
    ``lm.cache_shape_specs``' {name: (shape, dtype)}."""
    out: Dict[str, Spec] = {}
    for k, s in structs.items():
        shape = _shape(s)
        if len(shape) >= 2:
            out[k] = (None, _dp_entry(mesh, shape[1]), *(None,) * (len(shape) - 2))
        else:
            out[k] = (None,) * len(shape)
    return out
