"""Mamba-2 SSD, state-space duality (arXiv:2405.21060), chunked form, as the
JAX package's ``layers/ssd.py``.

The recurrence per head (state N = d_state, head dim P):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T      (N x P state)
    y_t = C_t h_t + D * x_t

``ssd_chunked`` goes through ``kernels.ssd.ops``: the Hopper kernel on a
CUDA tensor, the plain chunked version on a CPU tensor; both keep xw, la, B,
C and h in f32 and round only y.  When a gradient is wanted (grad mode on
and an input requiring it) it runs as ``_SSD``: the forward also returns
the state entering each chunk, and the backward is ``ssd_bwd``, explicit
gradients in PyTorch ops on both devices (the JAX package differentiates
its layer's jnp code; it has no backward kernel).  Under ``no_grad``
(prefill) nothing of that runs.  On DTensors the scan runs on the local
shards (``local_region``): batch on the data-parallel axes, heads on
"model".  ``ssd_step`` is the single-step update of decode.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.context import act_placements, dtensor_mesh, local_region
from ..kernels.ssd import ops as ssd_ops


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """B or C as (B, S, H, N): a (B, S, N) tensor shared by the heads as a
    stride-0 view, a 4-D one as it is."""
    return t[:, :, None, :].expand(t.shape[0], t.shape[1], H, t.shape[2]) if t.dim() == 3 else t


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, D: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
            dh_last: Optional[torch.Tensor] = None, chunk: int = 128
            ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_chunked`` from its inputs, the f32 state
    entering each chunk of ``chunk`` steps (``states`` (B, H, chunks, N, P),
    which the forward returns; the first is h0), dy (B, S, H, P) and dh_last
    (B, H, N, P) or None.  Bm and Cm are (B, S, H, N), or (B, S, N) shared
    by the heads: their gradients are then summed over the heads inside the
    products, never formed per head.  Returns (dx, ddt, dA, dBm, dCm, dD,
    dh0): each in its input's shape and dtype, dA, dD and dh0 in f32.

    Per chunk (padded past S with zeros, which is exact: la = 0, x = B = C
    = dy = 0 there), with L = exp(cum_t - cum_s) for s <= t (the exponential
    taken only there: above the diagonal it could overflow, and 0 * inf is
    NaN), G = (C B^T) o L and dhout the gradient of the state leaving it:
    dG = dy xw^T; dxw = G^T dy + w B^T dhout; dcum gets the row sums less
    the column sums of dG o G, exp(cum_t) dy_t (C_t h), and the state
    update's decay terms; dC = (dG o L) B + exp(cum) dy h^T; dB = (dG o
    L)^T C + w dhout xw.  The carry dh_c = exp(total_c) dh_{c+1} + sum_t
    exp(cum_t) C_t^T dy_t runs over the chunks in reverse, one multiply-add
    each, from increments formed for all chunks in one product.  dla is
    the reverse cumulative sum of dcum within the chunk; then ddt = dla A +
    dxw . x, dA = sum dla dt, dx = dxw dt + dy D.  Everything is f32, as
    the JAX layer widens xw, la, B and C; the products take f32 operands,
    and TF32 stays off (PyTorch's default
    ``torch.backends.cuda.matmul.allow_tf32 = False``, which
    ``chip_smoke.py`` also sets), so they are full f32 products."""
    Bsz, S, H, P = x.shape
    shared = Bm.dim() == 3
    Q = max(min(chunk, S), 1)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunked(t):  # (B, S, ...) -> f32 (B, nc, Q, ...), zeros past S
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    def unchunked(t, like):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S].to(like.dtype)

    xf, dtf, dyf = chunked(x), chunked(dt), chunked(dy)         # (b,c,q,h[,p])
    Bf, Cf = chunked(Bm), chunked(Cm)                            # (b,c,q[,h],n)
    Af = A.float()
    xw = xf * dtf[..., None]
    cum = torch.cumsum(dtf * Af, dim=2)                          # (b,c,q,h)
    total = cum[:, :, -1]                                        # (b,c,h)
    hc = states.float().permute(0, 2, 1, 3, 4)                   # (b,c,h,n,p)
    cum_h = cum.transpose(2, 3)                                  # (b,c,h,q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill(
        ~tri, float("-inf")).exp()                               # (b,c,h,t,s)
    del cum_h
    if shared:
        G = torch.einsum("bctn,bcsn->bcts", Cf, Bf)[:, :, None] * L
    else:
        G = torch.einsum("bcthn,bcshn->bchts", Cf, Bf) * L

    # intra-chunk: y_intra = G xw
    dG = torch.einsum("bcthp,bcshp->bchts", dyf, xw)
    dxw = torch.einsum("bchts,bcthp->bcshp", G, dyf)
    M = G.mul_(dG)                                               # dG o G
    dcum = M.sum(-1) - M.sum(-2)                                 # (b,c,h,q)
    del G, M
    dCB = dG.mul_(L)                                             # dG o L
    del dG, L
    if shared:
        dCB = dCB.sum(2)                                         # (b,c,t,s)
        dC = torch.einsum("bcts,bcsn->bctn", dCB, Bf)
        dB = torch.einsum("bcts,bctn->bcsn", dCB, Cf)
        Ch = torch.einsum("bctn,bchnp->bcthp", Cf, hc)
    else:
        dC = torch.einsum("bchts,bcshn->bcthn", dCB, Bf)
        dB = torch.einsum("bchts,bcthn->bcshn", dCB, Cf)
        Ch = torch.einsum("bcthn,bchnp->bcthp", Cf, hc)
    del dCB

    # inter-chunk: y_inter = exp(cum) (C h)
    dye = dyf * cum.exp()[..., None]                             # (b,c,q,h,p)
    dcum += (dye * Ch).sum(-1).transpose(2, 3)
    del Ch
    if shared:
        dC += torch.einsum("bcthp,bchnp->bctn", dye, hc)
        inc = torch.einsum("bctn,bcthp->bchnp", Cf, dye)
    else:
        dC += torch.einsum("bcthp,bchnp->bcthn", dye, hc)
        inc = torch.einsum("bcthn,bcthp->bchnp", Cf, dye)
    del dye

    # the state's gradient, carried over the chunks in reverse
    decay = total.exp()                                          # (b,c,h)
    dhout = torch.empty_like(inc)
    dh = (torch.zeros_like(inc[:, 0]) if dh_last is None else dh_last.float())
    for c in range(nc - 1, -1, -1):
        dhout[:, c] = dh
        dh = decay[:, c, :, None, None] * dh + inc[:, c]
    del inc

    # the state update: h' = exp(total) h + sum_s B_s w_s xw_s^T
    w = torch.exp(total[:, :, None, :] - cum)                    # (b,c,q,h)
    dtotal = decay * (dhout * hc).sum((-1, -2))                  # (b,c,h)
    xww = xw * w[..., None]
    if shared:
        Bd = torch.einsum("bcsn,bchnp->bcshp", Bf, dhout)
        dB += torch.einsum("bcshp,bchnp->bcsn", xww, dhout)
    else:
        Bd = torch.einsum("bcshn,bchnp->bcshp", Bf, dhout)
        dB += torch.einsum("bcshp,bchnp->bcshn", xww, dhout)
    del dhout, xww
    dww = (xw * Bd).sum(-1) * w                                  # dw_s w_s (b,c,q,h)
    dxw += w[..., None] * Bd
    del Bd
    dtotal += dww.sum(2)
    dcum -= dww.transpose(2, 3)
    dcum[..., -1] += dtotal

    dla = dcum.flip(-1).cumsum(-1).flip(-1).transpose(2, 3)      # (b,c,q,h)
    ddt = dla * Af + (dxw * xf).sum(-1)
    dA = (dla * dtf).sum((0, 1, 2))
    dx = dxw * dtf[..., None] + dyf * D.float()[:, None]
    dD = (dyf * xf).sum((0, 1, 2, 4))
    return (unchunked(dx, x), unchunked(ddt, dt), dA, unchunked(dB, Bm),
            unchunked(dC, Cm), dD, dh)


class _SSD(torch.autograd.Function):
    """The chunked SSD with an explicit backward: the inputs and the f32
    state entering each chunk are saved (never the per-chunk products);
    ``ssd_bwd`` recomputes the rest."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, h0, chunk):
        H = x.shape[2]
        y, h_last, states = ssd_ops.ssd(x, dt, A, _heads(Bm, H), _heads(Cm, H), D, h0, chunk,
                                        return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, states)
        ctx.chunk = ssd_ops.state_chunk(x, chunk)
        ctx.h0_dtype = None if h0 is None else h0.dtype
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, Bm, Cm, D, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dx, ddt, dA, dB, dC, dD, dh0 = ssd_bwd(x, dt, A, Bm, Cm, D, states, dy, dh_last,
                                               ctx.chunk)
        dh0 = None if ctx.h0_dtype is None else dh0.to(ctx.h0_dtype)
        # contiguous gradients: inside a program they cross a local_map
        # boundary, where torch 2.11 gives a DTensor gradient the strides of
        # its forward value (a later view of a non-contiguous one fails)
        grads = (dx, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype), dh0)
        return (*(None if g is None else g.contiguous() for g in grads), None)


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P) input (already gated/conv'd)
    dt: torch.Tensor,       # (B, S, H)    positive step sizes
    A: torch.Tensor,        # (H,)         negative decay rates (A = -softplus(a))
    Bm: torch.Tensor,       # (B, S, H, N) input projection ("B" matrix), or (B, S, N)
    Cm: torch.Tensor,       # (B, S, H, N) output projection ("C" matrix), or (B, S, N)
    D: torch.Tensor,        # (H,)         skip gain
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, h_last (B,H,N,P) f32).  A 3-D Bm
    or Cm is shared by the heads (the kernel reads it through a stride-0
    view; its gradient is summed over the heads in ``ssd_bwd``)."""
    mesh = dtensor_mesh(x, dt, A, Bm, Cm, D, h0)
    if mesh is not None:
        B_, _, H, P = x.shape
        px = act_placements(mesh, x.shape, "batch", None, "model", None)
        pdt = act_placements(mesh, dt.shape, "batch", None, "model")
        pa = act_placements(mesh, A.shape, "model")
        pbc = act_placements(mesh, Bm.shape, "batch", None,
                             *(("model",) if Bm.dim() == 4 else ()), None)
        ph = act_placements(mesh, (B_, H, Bm.shape[-1], P), "batch", "model", None, None)
        return local_region(ssd_chunked, (x, dt, A, Bm, Cm, D, chunk, h0),
                            (px, pdt, pa, pbc, pbc, pa, None, ph), (px, ph))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, D, h0)):
        return _SSD.apply(x, dt, A, Bm, Cm, D, h0, chunk)
    H = x.shape[2]
    return ssd_ops.ssd(x, dt, A, _heads(Bm, H), _heads(Cm, H), D, h0, chunk)


def ssd_step(
    x: torch.Tensor,        # (B, H, P)
    dt: torch.Tensor,       # (B, H)
    A: torch.Tensor,        # (H,)
    Bm: torch.Tensor,       # (B, H, N)
    Cm: torch.Tensor,       # (B, H, N)
    D: torch.Tensor,        # (H,)
    h: torch.Tensor,        # (B, H, N, P) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step; returns (y (B,H,P) in x's dtype, h_new (B,H,N,P) f32).
    On DTensors it runs on the local shards, as ``ssd_chunked`` does."""
    mesh = dtensor_mesh(x, dt, A, Bm, Cm, D, h)
    if mesh is not None:
        px = act_placements(mesh, x.shape, "batch", "model", None)
        pdt = act_placements(mesh, dt.shape, "batch", "model")
        pa = act_placements(mesh, A.shape, "model")
        ph = act_placements(mesh, h.shape, "batch", "model", None, None)
        return local_region(ssd_step, (x, dt, A, Bm, Cm, D, h),
                            (px, pdt, pa, px, px, pa, ph), (px, ph))
    dtf = dt.float()
    a = torch.exp(dtf * A.float()[None, :])                      # (B,H)
    xw = x.float() * dtf[..., None]                              # (B,H,P)
    h_new = a[..., None, None] * h.float() + torch.einsum(
        "bhn,bhp->bhnp", Bm.float(), xw)
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), h_new)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), h_new
