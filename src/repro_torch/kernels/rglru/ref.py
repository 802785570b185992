"""Plain PyTorch versions of the RG-LRU recurrence.

* ``rglru_rec_ref``: the sequential recurrence h_t = exp(log_a_t) h_{t-1}
  + u_t (a copy of the JAX package's oracle).
* ``rglru_ref``: the kernel's plain version, gates and recurrence, all in
  f32 as the JAX layer (``repro/layers/rglru.py``) keeps them: y in x's
  dtype, h_last in f32.
* ``rglru_chunked_ref``: the same function in the kernel's order of
  arithmetic: sub-segments scanned from h = 0, then combined with the
  carry (``csrc/rglru.cu``).
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


def rglru_chunked_ref(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                      a_param: torch.Tensor, h0: Optional[torch.Tensor] = None,
                      steps: int = 8, segments: int = 16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_ref`` in the order of the kernel's arithmetic.  Time goes in
    chunks of ``segments`` sub-segments of ``steps`` steps (past S: a = 1,
    u = 0).  Each sub-segment is scanned from h = 0 with the running product
    P of a; each gets h_in, the previous chunk's carry combined with the
    sub-segments before it (combine((P1, h1), (P2, h2)) = (P1 P2, P2 h1 +
    h2)); then y = h + P h_in.  Returns (y in x's dtype, h_last f32)."""
    B, S, N = x.shape
    log_a, u = gate_terms(r, i, x, a_param)
    a = torch.exp(log_a)
    chunk = steps * segments
    chunks = -(-S // chunk)
    pad = chunks * chunk - S
    a = torch.cat([a, a.new_ones((B, pad, N))], 1).view(B, chunks, segments, steps, N)
    u = torch.cat([u, u.new_zeros((B, pad, N))], 1).view(B, chunks, segments, steps, N)
    hs, ps = torch.empty_like(u), torch.empty_like(a)
    h, p = u[:, :, :, 0], a[:, :, :, 0]
    hs[:, :, :, 0], ps[:, :, :, 0] = h, p
    for j in range(1, steps):
        h = a[:, :, :, j] * h + u[:, :, :, j]
        p = p * a[:, :, :, j]
        hs[:, :, :, j], ps[:, :, :, j] = h, p
    carry = (torch.zeros((B, N), dtype=torch.float32, device=x.device) if h0 is None
             else h0.float())
    ys = torch.empty_like(hs)
    for c in range(chunks):
        h_in = torch.empty((B, segments, N), dtype=torch.float32, device=x.device)
        for w in range(segments):
            h_in[:, w] = carry
            carry = ps[:, c, w, -1] * carry + hs[:, c, w, -1]
        ys[:, c] = hs[:, c] + ps[:, c] * h_in[:, :, None]
    y = ys.view(B, chunks * chunk, N)[:, :S]
    return y.to(x.dtype), carry
