"""Public segagg op: GROUP-BY partial aggregation, its combine steps and its
pane variant.

Dispatch follows the tensors: a CUDA tensor launches one of the two Hopper
kernels (``segagg_narrow`` or ``segagg_scatter``, chosen by
``tuning.pick_formulation``) or raises; a CPU tensor takes the plain
PyTorch version in ``ref.py``.  ``backend=`` accepts ``"auto"`` (the
default: chosen by the tensor's device) and ``"cuda"`` (raises on a CPU
tensor).  No backend runs the plain version on a CUDA tensor.

Nothing is padded: the kernels mask the ragged edge of N themselves, V is
used as given, and keys outside ``[0, num_groups)`` are dropped.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import tuning
from .ref import segagg_ref
from .segagg import segagg_narrow_cuda, segagg_scatter_cuda

BACKENDS = ("auto", "cuda")

_INT32_MAX = 2**31 - 1


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """``"cuda"`` (launch a kernel) or ``"plain"`` (``ref.py``) for tensors
    on ``device``."""
    if backend is None:
        backend = "auto"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown segagg backend: {backend!r} (expected one of {BACKENDS})")
    if device.type == "cuda":
        return "cuda"
    if backend == "cuda":
        raise ValueError(
            f"backend='cuda' launches a CUDA kernel and needs CUDA tensors "
            f"(got a {device.type} tensor)")
    if device.type != "cpu":
        raise ValueError(f"segagg runs on CUDA or CPU tensors, not {device}")
    return "plain"


def segagg(keys: torch.Tensor, values: torch.Tensor, num_groups: int, *,
           backend: Optional[str] = None) -> torch.Tensor:
    """GROUP-BY partial aggregation: (N,) keys + (N, V) values ->
    (num_groups, V) f32 sums; on the card through the kernel that
    ``tuning.pick_formulation`` picks for (num_groups, V)."""
    if num_groups <= 0:
        raise ValueError(f"num_groups must be positive, got {num_groups}")
    if values.dim() == 1:
        values = values[:, None]
    if keys.device != values.device:
        raise ValueError(f"keys on {keys.device} but values on {values.device}")
    path = resolve_backend(backend, values.device)
    keys = keys.to(torch.int32).contiguous()
    values = values.to(torch.float32).contiguous()
    if path == "plain":
        return segagg_ref(keys, values, num_groups)
    if tuning.pick_formulation(num_groups, values.shape[1]) == "narrow":
        return segagg_narrow_cuda(keys, values, num_groups)
    return segagg_scatter_cuda(keys, values, num_groups)


def group_count(keys: torch.Tensor, num_groups: int, *,
                backend: Optional[str] = None) -> torch.Tensor:
    """COUNT(*) GROUP BY — values = ones."""
    ones = torch.ones((keys.shape[0], 1), dtype=torch.float32,
                      device=keys.device)
    return segagg(keys, ones, num_groups, backend=backend)[:, 0]


def combine(partials: torch.Tensor) -> torch.Tensor:
    """Final aggregation step over per-batch partials: (B, G, V) -> (G, V)."""
    return partials.sum(dim=0)


def pane_composite_groups(num_panes: int, num_groups: int) -> int:
    """Composite segment count for the pane x group key space, guarded
    against int32 overflow: pane_segagg keys are ``pane * num_groups +
    group`` in int32, so the product must stay addressable."""
    total = num_panes * num_groups  # Python ints: no silent wraparound
    if total > _INT32_MAX:
        raise ValueError(
            f"pane_segagg composite key space num_panes*num_groups = "
            f"{num_panes}*{num_groups} = {total} exceeds int32 "
            f"({_INT32_MAX}); split the pane run into "
            f"<= {_INT32_MAX // max(num_groups, 1)} panes per scan")
    return total


def pane_segagg(keys: torch.Tensor, values: torch.Tensor,
                pane_ids: torch.Tensor, num_panes: int, num_groups: int, *,
                backend: Optional[str] = None) -> torch.Tensor:
    """Pane-partial aggregation: one scan over (N,) keys + (N, V) values
    with per-row pane assignments -> (num_panes, num_groups, V) per-pane
    group sums, through the same kernels via composite keys
    ``pane * num_groups + group``."""
    if values.dim() == 1:
        values = values[:, None]
    total = pane_composite_groups(num_panes, num_groups)
    composite = pane_ids.to(torch.int32) * num_groups + keys.to(torch.int32)
    flat = segagg(composite, values, total, backend=backend)
    return flat.reshape(num_panes, num_groups, values.shape[1])


def merge_panes(pane_partials: torch.Tensor) -> torch.Tensor:
    """Fan-out merge of cached pane partials into one window aggregate:
    (P, G, V) -> (G, V)."""
    return pane_partials.sum(dim=0)


def flops_bytes(n: int, num_groups: int, v: int) -> Tuple[float, float]:
    """(operations, device-memory bytes) of one segagg call at the extents
    that run: one add per (row, v) element whichever kernel runs; keys and
    values read once, the (G, V) f32 output written once.  Nothing is
    padded, so these are the call's own extents."""
    return float(n * v), 4.0 * n + 4.0 * n * v + 4.0 * num_groups * v
