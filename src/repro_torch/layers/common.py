"""Shared layer primitives: norms, RoPE, MLPs (the JAX package's
``layers/common.py`` in PyTorch).

Conventions kept from the reference: both norms scale by ``(1 + scale)``
(zero-initialised scales are the identity), RoPE rotates interleaved pairs
``x[..., 0::2]`` / ``x[..., 1::2]``, and ``"gelu"`` is the tanh
approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * (1.0 + scale.float()) + bias.float()
    return out.to(dt)


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies for the rotating half of the head dim."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0, rotary_frac: float = 1.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, D); positions: broadcastable to
    (..., S).  ``rotary_frac`` < 1 rotates only the leading fraction of the
    head dim (ChatGLM's "2d RoPE")."""
    d = x.shape[-1]
    rot_d = int(d * rotary_frac)
    if rot_d == 0:
        return x
    rot_d -= rot_d % 2
    x_rot, x_pass = x[..., :rot_d], x[..., rot_d:]
    inv = rope_frequencies(rot_d, theta, device=x.device)
    ang = positions.float()[..., None, None] * inv  # (..., S, 1, rot_d/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x_rot[..., 0::2].float(), x_rot[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K), w (K, N).  On DTensors x's middle dims are
    gathered first (only its leading and last dims stay split), the product
    runs on x's rows flattened, and its result's rows are laid out as x's
    were (gathered where DTensor split rows that x keeps whole), its
    gradient's rows likewise: so the rows fold back into x's leading dims
    even when those do not divide by the split (a batch that stays
    replicated), and no flattened split is a strided one.  Where K is
    split (a row-parallel product), ``_contracted`` sums the partial
    products in f32."""
    if not hasattr(x, "placements"):
        return x @ w
    from torch.distributed.tensor import Replicate, Shard

    whole = tuple(p if not p.is_shard() or type(p) is Shard and p.dim in (0, x.ndim - 1)
                  else Replicate() for p in x.placements)
    xf = x.redistribute(x.device_mesh, whole).flatten(0, -2)
    rows = xf.placements
    y = _contracted(xf, w)
    keep = tuple(p if p.is_shard(0) else Replicate() if q.is_shard(0) else q
                 for p, q in zip(rows, y.placements))
    return y.redistribute(y.device_mesh, keep).unflatten(0, x.shape[:-1])


def _contracted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for DTensors x (M, K) and w (K, N).  Where a mesh dim splits
    x's K (w split there too, or replicated and taken in the same slices),
    each rank's partial product is formed in f32, the partials are added in
    f32 and the sum rounded once to x's dtype, as one card's product
    accumulates and rounds it (DTensor's own product rounds each partial to
    bf16 and adds them in bf16; ``tests/test_torch_ranks.py`` holds a
    (1, 2) prefill bit-equal to one card's on the CPU).  Any other layout
    is DTensor's ``x @ w``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..dist.context import local_region

    if not hasattr(w, "placements"):
        return x @ w
    out, w_in = [], []
    for p, q in zip(x.placements, w.placements):
        if p.is_shard(1) and (q.is_shard(0) or q.is_replicate()):
            out.append(Partial())
            w_in.append(Shard(0))
        elif p.is_replicate() and q.is_replicate():
            out.append(Replicate())
            w_in.append(q)
        elif p.is_shard(0) and q.is_replicate():
            out.append(Shard(0))
            w_in.append(q)
        elif p.is_replicate() and q.is_shard(1):
            out.append(Shard(1))
            w_in.append(q)
        else:
            return x @ w  # a layout DTensor redistributes first
    if not any(p.is_partial() for p in out):
        return x @ w
    y = local_region(_mm_f32, (x, w), (x.placements, tuple(w_in)), tuple(out))
    done = tuple(Replicate() if p.is_partial() else p for p in out)
    return y.redistribute(y.device_mesh, done).to(x.dtype)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of bf16 matrices (or batches of them) on the card with an
    f32 result (the tensor cores' f32 accumulator, ``out_dtype``); the
    gradients are the bf16 products a plain ``a @ b`` forms."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return (torch.bmm if a.ndim == 3 else torch.mm)(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None,
                a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batches) with an f32 result, the products
    summed in f32: bf16 on the card (and fake tensors, which stand for the
    card's in the dry run) through ``_MatmulF32``, elsewhere widened to f32
    first (exact for bf16)."""
    from ..kernels import is_fake

    if (a.is_cuda or is_fake(a)) and a.dtype == b.dtype == torch.bfloat16:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU/GeGLU feed-forward: down( act(x@gate) * (x@up) )."""
    h = _activate(matmul(x, w_gate), act) * matmul(x, w_up)
    return matmul(h, w_down)


def mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        b_up: Optional[torch.Tensor] = None, b_down: Optional[torch.Tensor] = None,
        act: str = "gelu") -> torch.Tensor:
    """Plain two-matrix feed-forward (whisper, starcoder-style)."""
    h = matmul(x, w_up)
    if b_up is not None:
        h = h + b_up
    out = matmul(_activate(h, act), w_down)
    if b_down is not None:
        out = out + b_down
    return out


def sinusoidal_at(positions: torch.Tensor, d_model: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal absolute-position embeddings: (S,) -> (S, d_model)."""
    pos = positions.float()[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / max(d_model // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act in ("gelu", "gelu_tanh"):
        return F.gelu(x, approximate="tanh")
    if act == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {act!r}")
