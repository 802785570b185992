"""Plain PyTorch versions of the RG-LRU recurrence.

* ``rglru_rec_ref``: the sequential recurrence h_t = exp(log_a_t) h_{t-1}
  + u_t (a copy of the JAX package's oracle).
* ``rglru_ref``: the kernel's plain version, gates and recurrence, all in
  f32 as the JAX layer (``repro/layers/rglru.py``) keeps them: y in x's
  dtype, h_last in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_C = 8.0  # Griffin decay sharpness


def rglru_rec_ref(log_a: torch.Tensor, u: torch.Tensor,
                  h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, u: (B, S, N); h0: (B, N).  Returns (y in u's dtype, h_last f32)."""
    a = torch.exp(log_a.float())
    uf = u.float()
    h = h0.float()
    ys = torch.empty_like(uf)
    for t in range(uf.shape[1]):
        h = a[:, t] * h + uf[:, t]
        ys[:, t] = h
    return ys.to(u.dtype), h


def gate_terms(r: torch.Tensor, i: torch.Tensor, x: torch.Tensor,
               a_param: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, u) in f32: log_a = -8 softplus(a_param) r and
    u = sqrt(max(1 - exp(2 log_a), 1e-12)) i x."""
    log_a = -_C * F.softplus(a_param.float()) * r.float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * (i.float() * x.float())


def rglru_ref(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
              a_param: torch.Tensor, h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i: (B, S, N); a_param: (N,); h0: (B, N) or None (zeros).
    Returns (y (B, S, N) in x's dtype, h_last (B, N) f32)."""
    B, _, N = x.shape
    log_a, u = gate_terms(r, i, x, a_param)
    if h0 is None:
        h0 = torch.zeros((B, N), dtype=torch.float32, device=x.device)
    y, h_last = rglru_rec_ref(log_a, u, h0)
    return y.to(x.dtype), h_last
