"""Mamba-2 SSD, state-space duality (arXiv:2405.21060), chunked form, as the
JAX package's ``layers/ssd.py``.

The recurrence per head (state N = d_state, head dim P):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T      (N x P state)
    y_t = C_t h_t + D * x_t

``ssd_chunked`` goes through ``kernels.ssd.ops``: the Hopper kernel on a
CUDA tensor, the plain chunked version on a CPU tensor; both keep xw, la, B,
C and h in f32 and round only y.  ``ssd_step`` is the single-step update of
decode.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.ssd import ops as ssd_ops


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P) input (already gated/conv'd)
    dt: torch.Tensor,       # (B, S, H)    positive step sizes
    A: torch.Tensor,        # (H,)         negative decay rates (A = -softplus(a))
    Bm: torch.Tensor,       # (B, S, H, N) input projection ("B" matrix)
    Cm: torch.Tensor,       # (B, S, H, N) output projection ("C" matrix)
    D: torch.Tensor,        # (H,)         skip gain
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, h_last (B,H,N,P) f32)."""
    return ssd_ops.ssd(x, dt, A, Bm, Cm, D, h0, chunk)


def ssd_step(
    x: torch.Tensor,        # (B, H, P)
    dt: torch.Tensor,       # (B, H)
    A: torch.Tensor,        # (H,)
    Bm: torch.Tensor,       # (B, H, N)
    Cm: torch.Tensor,       # (B, H, N)
    D: torch.Tensor,        # (H,)
    h: torch.Tensor,        # (B, H, N, P) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step; returns (y (B,H,P) in x's dtype, h_new (B,H,N,P) f32)."""
    dtf = dt.float()
    a = torch.exp(dtf * A.float()[None, :])                      # (B,H)
    xw = x.float() * dtf[..., None]                              # (B,H,P)
    h_new = a[..., None, None] * h.float() + torch.einsum(
        "bhn,bhp->bhnp", Bm.float(), xw)
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), h_new)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), h_new
