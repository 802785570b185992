"""Plain PyTorch version of the segagg kernels.

The CPU path of ``ops`` and the yardstick the kernels are held against on
the card.  Keys outside ``[0, num_groups)``, negative ones included, are
dropped, like the reference's ``zeros.at[keys].add(..., mode="drop")``.
Sums are taken in float32 (float64 when the values are float64, which is
how the card's parity checks get an exact yardstick).
"""
from __future__ import annotations

import torch


def _acc_dtype(values: torch.Tensor) -> torch.dtype:
    return torch.float64 if values.dtype == torch.float64 else torch.float32


def segagg_ref(keys: torch.Tensor, values: torch.Tensor,
               num_groups: int) -> torch.Tensor:
    """keys (N,) int, values (N, V) -> (num_groups, V) group sums."""
    if values.dim() == 1:
        values = values[:, None]
    values = values.to(_acc_dtype(values))
    keys = keys.to(torch.int64)
    keep = (keys >= 0) & (keys < num_groups)
    out = torch.zeros((num_groups, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, keys[keep], values[keep])


def combine_ref(partials: torch.Tensor) -> torch.Tensor:
    """Final aggregation (paper §2.1): sum the per-batch partials.
    partials: (num_batches, G, V) -> (G, V)."""
    return partials.sum(dim=0)


def pane_segagg_ref(keys: torch.Tensor, values: torch.Tensor,
                    pane_ids: torch.Tensor, num_panes: int,
                    num_groups: int) -> torch.Tensor:
    """ONE pass over (N,) keys / (N, V) values / (N,) pane assignments ->
    (num_panes, num_groups, V) per-pane group sums."""
    if values.dim() == 1:
        values = values[:, None]
    composite = pane_ids.to(torch.int64) * num_groups + keys.to(torch.int64)
    flat = segagg_ref(composite, values, num_panes * num_groups)
    return flat.reshape(num_panes, num_groups, values.shape[1])
