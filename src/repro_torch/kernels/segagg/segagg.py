"""ctypes wrappers of the Hopper segagg kernels (``csrc/segagg.cu``).

* ``segagg_scatter_cuda`` replaces the JAX package's
  ``_segagg_scatter_kernel`` (``repro/kernels/segagg/segagg.py:75``): the
  blocks of a thread-block cluster pool their shared memory into one f32
  table of a key range; half the elements are mailed to the block that owns
  their group and added there, the other half go to the output by global
  atomics, and each block flushes its part of the table with 16-byte vector
  atomics.  ``tuning.scatter_plan`` picks the cluster size and the key
  ranges from what the card reports and the tuned table
  (``scatter_plan_for``); a table that needs more ranges than pay off goes
  to ``segagg_scatter_atomic_cuda``.
  Bounded by bytes (keys + values read, output written once).
* ``segagg_scatter_atomic_cuda``, the first design of the scatter kernel:
  one global atomicAdd per (row, v) element into a (G, V) output that lives
  in L2; skewed keys contend on its atomics.  The wide route of
  ``segagg_scatter_cuda``, and the yardstick it is timed against.
* ``segagg_narrow_cuda`` replaces ``_segagg_matmul_kernel``
  (``repro/kernels/segagg/segagg.py:48``): keys and values streamed as
  16-byte quads, several in flight a thread, into register slots with warp
  pre-combining when G*V <= 32, else a per-block (G, V) table in shared
  memory (at most ``NARROW_TABLE_BYTES``); the blocks' tables meet in a
  zeroed accumulator of the stream's workspace (``narrow_work``), which
  the last block copies into the output and zeroes again.  Bounded by the
  same bytes.  One launch a call: its output is not zeroed first.

Each wrapper checks device, dtype, shape and contiguity, allocates the
output (the scatter kernels' zeroed), launches on the current stream,
raises on a launch error and counts its launches in ``.launches`` (a plain
int, reset by the caller).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from . import tuning
from .tuning import NARROW_TABLE_BYTES


def _check(keys: torch.Tensor, values: torch.Tensor, num_groups: int,
           what: str) -> None:
    if not (keys.is_cuda and values.is_cuda and keys.get_device() == values.get_device()):
        raise ValueError(f"{what}: keys and values must be on one CUDA device "
                         f"(got {keys.device} and {values.device})")
    if keys.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(f"{what}: needs int32 keys and float32 values "
                        f"(got {keys.dtype} and {values.dtype})")
    if keys.dim() != 1 or values.dim() != 2 or values.shape[0] != keys.shape[0]:
        raise ValueError(f"{what}: needs (N,) keys and (N, V) values "
                         f"(got {tuple(keys.shape)} and {tuple(values.shape)})")
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError(f"{what}: keys and values must be contiguous")
    if num_groups <= 0 or values.shape[1] <= 0:
        raise ValueError(f"{what}: needs num_groups > 0 and V > 0")


def _stream(index: int) -> int:
    """The current stream of card ``index``, as a raw ``cudaStream_t``."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(fn_name: str, keys: torch.Tensor, values: torch.Tensor,
            out: torch.Tensor, *extra: int, stream: Optional[int] = None) -> None:
    """Calls launcher ``fn_name`` on the current stream of the values' card
    (``stream``, if the caller has it), made the current card for the call
    where it is not."""
    lib = _build.load("segagg")
    n, v = values.shape
    index = values.get_device()
    switch = index != torch._C._cuda_getDevice()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        code = getattr(lib, fn_name)(keys.data_ptr(), values.data_ptr(),
                                     out.data_ptr(), n, v, out.shape[0], *extra,
                                     _stream(index) if stream is None else stream)
    _build.check("segagg", code, fn_name)


# (device index, cluster, smem bytes) -> clusters the card runs at once;
# device index -> (opt-in shared memory a block, largest cluster size)
_active: Dict[Tuple[int, int, int], int] = {}
_caps: Dict[int, Tuple[int, int]] = {}


def _query(fn_name: str, *args: int) -> int:
    lib = _build.load("segagg")
    out = ctypes.c_int32(0)
    _build.check("segagg", getattr(lib, fn_name)(*args, ctypes.byref(out)), fn_name)
    return out.value


def active_clusters(device: torch.device, cluster: int, smem_bytes: int) -> int:
    """Clusters of ``cluster`` blocks with ``smem_bytes`` of table each that
    the card runs at once (``cudaOccupancyMaxActiveClusters``)."""
    key = (device.index or 0, cluster, smem_bytes)
    if key not in _active:
        with torch.cuda.device(device):
            _active[key] = _query("segagg_scatter_clusters", cluster, smem_bytes)
    return _active[key]


def scatter_caps(device: torch.device | str) -> Tuple[int, int]:
    """What the card offers the cluster kernel: the opt-in shared memory a
    block, and the largest cluster size, 16 blocks if the card runs such
    clusters at that size, else the portable 8."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _caps:
        device = torch.device("cuda", index)
        with torch.cuda.device(device):
            smem = _query("segagg_scatter_smem_optin")
        largest = max(tuning.SCATTER_CLUSTER_SIZES)
        fits = active_clusters(device, largest, smem) > 0
        _caps[index] = (smem, largest if fits else min(tuning.SCATTER_CLUSTER_SIZES))
    return _caps[index]


def scatter_plan_for(num_groups: int, v: int, device: torch.device | str, *, n: int,
                     max_ranges: Optional[int] = None,
                     sizes: Optional[Tuple[int, ...]] = None) -> tuning.ScatterPlan:
    """``tuning.scatter_plan`` of an (n rows, num_groups, v) call, fed by
    what the card reports (``scatter_caps``) and by the tuned table:
    ``tuning.tuned_blocks("cuda", n, num_groups)`` gives the cluster size
    tried first and ``max_ranges``.  An explicit ``max_ranges`` or
    ``sizes`` wins (a measurement's forced layout)."""
    smem, max_blocks = scatter_caps(device)
    cluster, tuned_ranges = tuning.tuned_blocks("cuda", n, num_groups)
    if sizes is None:
        sizes = (cluster,) + tuple(c for c in tuning.SCATTER_CLUSTER_SIZES if c != cluster)
    if max_ranges is None:
        max_ranges = tuned_ranges
    return tuning.scatter_plan(num_groups, v, max_blocks, smem, max_ranges, sizes)


def _zeros(values: torch.Tensor, num_groups: int) -> torch.Tensor:
    return torch.zeros((num_groups, values.shape[1]), dtype=torch.float32,
                       device=values.device)


def segagg_scatter_cuda(keys: torch.Tensor, values: torch.Tensor, num_groups: int,
                        plan: Optional[tuning.ScatterPlan] = None) -> torch.Tensor:
    """(N,) int32 keys + (N, V) f32 values on the card -> (num_groups, V)
    f32 sums, through cluster-shared tables (or, on the ``atomic`` route,
    ``segagg_scatter_atomic_cuda``).  ``plan`` defaults to
    ``scatter_plan_for``'s; a measurement may pass another.  Keys outside
    [0, num_groups) are dropped."""
    _check(keys, values, num_groups, "segagg_scatter")
    if plan is None:
        plan = scatter_plan_for(num_groups, values.shape[1], values.device,
                                n=values.shape[0])
    if plan.route == "atomic":
        return segagg_scatter_atomic_cuda(keys, values, num_groups)
    out = _zeros(values, num_groups)
    if values.shape[0]:
        clusters = tuning.scatter_clusters(
            active_clusters(values.device, plan.cluster, plan.smem_bytes),
            len(plan.ranges))
        _launch("segagg_scatter", keys, values, out, plan.cluster, clusters,
                plan.range_len, plan.slice_chunks, plan.capacity)
        segagg_scatter_cuda.launches += 1
    return out


def segagg_scatter_atomic_cuda(keys: torch.Tensor, values: torch.Tensor,
                               num_groups: int) -> torch.Tensor:
    """As ``segagg_scatter_cuda`` by one global atomic an element (the
    first design)."""
    _check(keys, values, num_groups, "segagg_scatter_atomic")
    out = _zeros(values, num_groups)
    if values.shape[0]:
        _launch("segagg_scatter_atomic", keys, values, out)
        segagg_scatter_atomic_cuda.launches += 1
    return out


# (device index, stream) -> the narrow kernel's workspace on that stream
_narrow_work: Dict[Tuple[int, int], torch.Tensor] = {}


def narrow_work(device: torch.device, stream: Optional[int] = None) -> torch.Tensor:
    """The narrow kernel's workspace on ``device``'s current stream (or raw
    ``stream``): a ``NARROW_TABLE_BYTES`` f32 accumulator and a uint32
    ticket (int32 words here), zero between calls (each call's last block
    leaves them so).  One a stream, so calls that share it are ordered; made
    (one fill) at a stream's first call."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, _stream(index) if stream is None else stream)
    work = _narrow_work.get(key)
    if work is None:  # once a stream
        work = _narrow_work[key] = torch.zeros(NARROW_TABLE_BYTES // 4 + 4, dtype=torch.int32,
                                               device=torch.device("cuda", index))
    return work


def segagg_narrow_cuda(keys: torch.Tensor, values: torch.Tensor,
                       num_groups: int) -> torch.Tensor:
    """As ``segagg_scatter_cuda`` through register slots or per-block
    shared-memory tables, in one launch; needs ``num_groups * V * 4 <=
    NARROW_TABLE_BYTES``."""
    _check(keys, values, num_groups, "segagg_narrow")
    if num_groups * values.shape[1] * 4 > NARROW_TABLE_BYTES:
        raise ValueError(
            f"segagg_narrow: a ({num_groups}, {values.shape[1]}) f32 table "
            f"exceeds {NARROW_TABLE_BYTES} bytes of shared memory; use scatter")
    if not values.shape[0]:
        return _zeros(values, num_groups)
    out = values.new_empty((num_groups, values.shape[1]))
    stream = _stream(values.get_device())
    work = narrow_work(values.device, stream)
    _launch("segagg_narrow", keys, values, out, work.data_ptr(), stream=stream)
    segagg_narrow_cuda.launches += 1
    return out


segagg_scatter_cuda.launches = 0
segagg_scatter_atomic_cuda.launches = 0
segagg_narrow_cuda.launches = 0
