"""ctypes wrappers of the two Hopper segagg kernels (``csrc/segagg.cu``).

* ``segagg_scatter_cuda`` replaces the JAX package's
  ``_segagg_scatter_kernel`` (``repro/kernels/segagg/segagg.py:75``): one
  global atomicAdd per (row, v) element into a (G, V) output that lives in
  L2.  Bounded by bytes (keys + values read, output written once); its
  weakness is atomic contention on skewed keys.
* ``segagg_narrow_cuda`` replaces ``_segagg_matmul_kernel``
  (``repro/kernels/segagg/segagg.py:48``): a per-block (G, V) table in
  shared memory (at most ``NARROW_TABLE_BYTES``), with register and warp
  pre-combining when G*V <= 32.  Bounded by the same bytes.

Each wrapper checks device, dtype, shape and contiguity, allocates the
zeroed output, launches on the current stream, raises on a launch error and
counts its launches in ``.launches`` (a plain int, reset by the caller).
"""
from __future__ import annotations

import torch

from .. import _build

# Shared-memory table of the narrow kernel: the default dynamic limit.
NARROW_TABLE_BYTES = 48 * 1024


def _check(keys: torch.Tensor, values: torch.Tensor, num_groups: int,
           what: str) -> None:
    if keys.device.type != "cuda" or values.device != keys.device:
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


def _launch(fn_name: str, keys: torch.Tensor, values: torch.Tensor,
            out: torch.Tensor) -> None:
    lib = _build.load("segagg")
    n, v = values.shape
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn_name)(keys.data_ptr(), values.data_ptr(),
                                     out.data_ptr(), n, v, out.shape[0], stream)
    _build.check("segagg", code, fn_name)


def _zeros(values: torch.Tensor, num_groups: int) -> torch.Tensor:
    return torch.zeros((num_groups, values.shape[1]), dtype=torch.float32,
                       device=values.device)


def segagg_scatter_cuda(keys: torch.Tensor, values: torch.Tensor,
                        num_groups: int) -> torch.Tensor:
    """(N,) int32 keys + (N, V) f32 values on the card -> (num_groups, V)
    f32 sums, by global atomics.  Keys outside [0, num_groups) are dropped."""
    _check(keys, values, num_groups, "segagg_scatter")
    out = _zeros(values, num_groups)
    if values.shape[0]:
        _launch("segagg_scatter", keys, values, out)
        segagg_scatter_cuda.launches += 1
    return out


def segagg_narrow_cuda(keys: torch.Tensor, values: torch.Tensor,
                       num_groups: int) -> torch.Tensor:
    """As ``segagg_scatter_cuda`` through per-block shared-memory tables;
    needs ``num_groups * V * 4 <= NARROW_TABLE_BYTES``."""
    _check(keys, values, num_groups, "segagg_narrow")
    if num_groups * values.shape[1] * 4 > NARROW_TABLE_BYTES:
        raise ValueError(
            f"segagg_narrow: a ({num_groups}, {values.shape[1]}) f32 table "
            f"exceeds {NARROW_TABLE_BYTES} bytes of shared memory; use scatter")
    out = _zeros(values, num_groups)
    if values.shape[0]:
        _launch("segagg_narrow", keys, values, out)
        segagg_narrow_cuda.launches += 1
    return out


segagg_scatter_cuda.launches = 0
segagg_narrow_cuda.launches = 0
