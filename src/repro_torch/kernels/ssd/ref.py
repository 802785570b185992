"""Plain PyTorch versions of the Mamba-2 SSD forward.

* ``ssd_rec_ref``: the sequential recurrence h_t = exp(la_t) h_{t-1}
  + B_t x_t^T, y_t = C_t h_t (the JAX package's oracle, with an initial
  state).
* ``ssd_chunked_ref``: the kernel's plain version, the chunked algorithm of
  the JAX layer (``repro/layers/ssd.py`` ``ssd_chunked``) as a Python loop
  over chunks, all in f32: y in x's dtype, h_last in f32.  The ragged last
  chunk is taken at its own length, which is what the layer's zero padding
  (la = 0, x = 0) computes.  It can also return the state entering each
  chunk, which the backward (``layers/ssd.py`` ``ssd_bwd``) starts from.
* ``ssd_chunked_bf16ops_ref``: the bf16 kernel's arithmetic, the same
  chunked algorithm with the operands of its tensor-core products split
  into bf16 parts as the kernel splits them (the probe and the card tests hold the kernel
  to it; nothing on the model's path calls it).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_rec_ref(x: torch.Tensor, la: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) dt-weighted, la (B, S, H) log-decay, Bm/Cm (B, S, H, N),
    h0 (B, H, N, P) or None (zeros).  Returns (y (B, S, H, P) in x's dtype,
    h_last (B, H, N, P) f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    a = torch.exp(la.float())
    ys = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = a[:, t, :, None, None] * h + torch.einsum(
            "bhn,bhp->bhnp", Bm[:, t].float(), x[:, t].float())
        ys[:, t] = torch.einsum("bhn,bhnp->bhp", Cm[:, t].float(), h)
    return ys.to(x.dtype), h


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                    chunk: int = 128, h0: Optional[torch.Tensor] = None,
                    return_states: bool = False):
    """x (B, S, H, P), dt (B, S, H) positive, A (H,) negative, Bm/Cm
    (B, S, H, N) (stride-0 head views are read as they are), D (H,), h0
    (B, H, N, P) or None.  Returns (y (B, S, H, P) in x's dtype, h_last
    (B, H, N, P) f32), and with ``return_states`` the f32 state entering
    each chunk of min(chunk, S) steps, (B, H, chunks, N, P)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = max(min(chunk, S), 1)
    Af = A.float()
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((B, H, -(-S // Q), N, P), dtype=torch.float32, device=x.device)
    for lo in range(0, S, Q):
        states[:, :, lo // Q] = h
        hi = min(lo + Q, S)
        dtq = dt[:, lo:hi].float()                                # (B,q,H)
        xq = x[:, lo:hi].float() * dtq[..., None]                  # dt-weighted
        Bq, Cq = Bm[:, lo:hi].float(), Cm[:, lo:hi].float()
        cum = torch.cumsum(dtq * Af, dim=1)                        # (B,q,H)
        total = cum[:, -1]                                         # (B,H)
        # decay(t, s) = exp(cum_t - cum_s) for s <= t; the exponential is
        # taken only there (above the diagonal the exponent is positive)
        q = hi - lo
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        dmat = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~tri[None, :, :, None], float("-inf")).exp()          # (B,q,q,H)
        g = torch.einsum("bqhn,bshn->bqsh", Cq, Bq) * dmat
        y_intra = torch.einsum("bqsh,bshp->bqhp", g, xq)
        y_inter = torch.einsum("bqhn,bhnp->bqhp", Cq, h) * torch.exp(cum)[..., None]
        w = torch.exp(total[:, None, :] - cum)                     # (B,q,H)
        h = torch.exp(total)[..., None, None] * h + torch.einsum(
            "bqhn,bqhp->bhnp", Bq * w[..., None], xq)
        y[:, lo:hi] = y_intra + y_inter
    y = y + x.float() * D.float()[None, None, :, None]
    if return_states:
        return y.to(x.dtype), h, states
    return y.to(x.dtype), h


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ssd_chunked_bf16ops_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                            chunk: int = 128, h0: Optional[torch.Tensor] = None,
                            split: Tuple[str, ...] = ("g", "h", "bw")
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked_ref`` with the operands of the bf16 kernel's tensor-core
    products: per chunk, G = (C B^T) o exp(cum_t - cum_s)[s <= t] o dt_s,
    the state's copy h that C h reads, and Bw = B o exp(cum_Q - cum) o dt
    are each taken as a bf16 part plus the bf16 part of its remainder (the
    kernel's two mmas).  x, B and C enter as they are (bf16 values), every
    product accumulates in f32, x is never multiplied by dt before a
    product, and the f32 state carries from chunk to chunk.  Same arguments
    and results as ``ssd_chunked_ref``; an operand left out of ``split``
    ("g", "h", "bw") is rounded once to bf16 instead, to measure what each
    split is worth."""
    def operand(name: str, t: torch.Tensor) -> torch.Tensor:
        hi = _bf16(t)
        return hi + _bf16(t - hi) if name in split else hi

    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = max(min(chunk, S), 1)
    Af = A.float()
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    for lo in range(0, S, Q):
        hi = min(lo + Q, S)
        dtq = dt[:, lo:hi].float()                                 # (B,q,H)
        xq = x[:, lo:hi].float()
        Bq, Cq = Bm[:, lo:hi].float(), Cm[:, lo:hi].float()
        cum = torch.cumsum(dtq * Af, dim=1)                         # (B,q,H)
        total = cum[:, -1]                                          # (B,H)
        q = hi - lo
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        dmat = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~tri[None, :, :, None], float("-inf")).exp()           # (B,q,q,H)
        g = operand("g", torch.einsum("bqhn,bshn->bqsh", Cq, Bq) * dmat * dtq[:, None])
        y_intra = torch.einsum("bqsh,bshp->bqhp", g, xq)
        y_inter = (torch.einsum("bqhn,bhnp->bqhp", Cq, operand("h", h))
                   * torch.exp(cum)[..., None])
        fw = torch.exp(total[:, None, :] - cum) * dtq               # (B,q,H)
        h = torch.exp(total)[..., None, None] * h + torch.einsum(
            "bqhn,bqhp->bhnp", operand("bw", Bq * fw[..., None]), xq)
        y[:, lo:hi] = y_intra + y_inter
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h
