"""RG-LRU: the Real-Gated Linear Recurrent Unit (Griffin / RecurrentGemma,
arXiv:2402.19427), as the JAX package's ``layers/rglru.py``.

    r_t = sigmoid(W_r x_t + b_r)                    (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)                    (input gate)
    a_t = exp(-c * softplus(a_param) * r_t)         (per-channel decay, c=8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``rglru_scan`` goes through ``kernels.rglru.ops``: the Hopper kernel on a
CUDA tensor, the plain sequential version on a CPU tensor; both keep log_a,
u and h in f32.  When a gradient is wanted (grad mode on and an input
requiring it) it runs as ``_RGLRU``: the forward also returns the state
entering each chunk, and the backward is ``ops.rglru_bwd`` (the backward
kernel on the card, the plain reverse recurrence on the CPU), where the
JAX package differentiates its associative scan.  Under ``no_grad`` (prefill)
nothing of that runs.  On DTensors the scan runs on the local shards
(``local_region``): batch on the data-parallel axes, channels on "model".
``rglru_step`` is the single-step update of decode.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..dist.context import act_placements, dtensor_mesh, local_region
from ..kernels.rglru import ops as rglru_ops
from ..kernels.rglru.ref import gate_terms


class _RGLRU(torch.autograd.Function):
    """The RG-LRU scan with an explicit backward: x, r, i, a_param, h0 and
    the chunk carries are saved (never h at every step); the backward
    recomputes h from the carries."""

    @staticmethod
    def forward(ctx, x, r, i, a_param, h0):
        y, h_last, carries = rglru_ops.rglru(x, r, i, a_param, h0, return_carries=True)
        ctx.save_for_backward(x, r, i, a_param, carries)
        ctx.h0_dtype = None if h0 is None else h0.dtype
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, r, i, a_param, carries = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, dr, di, da, dh0 = rglru_ops.rglru_bwd(x, r, i, a_param, carries, dy, dh_last)
        dh0 = None if ctx.h0_dtype is None else dh0.to(ctx.h0_dtype)
        return dx, dr.to(r.dtype), di.to(i.dtype), da.to(a_param.dtype), dh0


def rglru_scan(
    x: torch.Tensor,        # (B, S, N) gated input
    r: torch.Tensor,        # (B, S, N) recurrence gate, in (0,1)
    i: torch.Tensor,        # (B, S, N) input gate, in (0,1)
    a_param: torch.Tensor,  # (N,)
    h0: Optional[torch.Tensor] = None,  # (B, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,N) in x's dtype, h_last (B,N) f32)."""
    mesh = dtensor_mesh(x, r, i, a_param, h0)
    if mesh is not None:
        px = act_placements(mesh, x.shape, "batch", None, "model")
        ph = act_placements(mesh, (x.shape[0], x.shape[2]), "batch", "model")
        pa = act_placements(mesh, a_param.shape, "model")
        return local_region(rglru_scan, (x, r, i, a_param, h0), (px, px, px, pa, ph),
                            (px, ph))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, r, i, a_param, h0)):
        return _RGLRU.apply(x, r, i, a_param, h0)
    return rglru_ops.rglru(x, r, i, a_param, h0)


def rglru_step(
    x: torch.Tensor,        # (B, N)
    r: torch.Tensor,        # (B, N)
    i: torch.Tensor,        # (B, N)
    a_param: torch.Tensor,  # (N,)
    h: torch.Tensor,        # (B, N) carried state (f32)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step; returns (y (B,N) in x's dtype, h_new (B,N) f32)."""
    log_a, u = gate_terms(r, i, x, a_param)
    h_new = torch.exp(log_a) * h.float() + u
    return h_new.to(x.dtype), h_new


def short_conv1d(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv of width T.  x: (B,S,N), w: (T,N),
    state: (B,T-1,N) carried inputs (zeros when None).  Returns (y in x's
    dtype, new_state = the last T-1 inputs).  Products and sums run in x's
    dtype, tap by tap, as the reference does."""
    B, S, N = x.shape
    T = w.shape[0]
    if state is None:
        state = torch.zeros((B, T - 1, N), dtype=x.dtype, device=x.device)
    xx = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+T-1, N)
    y = xx[:, 0:S] * w[0]
    for t in range(1, T):
        y = y + xx[:, t:t + S] * w[t]
    # clone: a view would keep all of xx alive inside the cache
    return y.to(x.dtype), xx[:, -(T - 1):].clone()
