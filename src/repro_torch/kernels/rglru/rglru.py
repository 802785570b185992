"""ctypes wrapper of the Hopper RG-LRU scan (``csrc/rglru.cu``).

``rglru_cuda`` replaces the JAX package's ``_rglru_kernel``
(``repro/kernels/rglru/rglru.py:27``) together with the gate math of its
public op: one thread per (b, n) channel walks time with h in an f32
register.  It checks device, dtype, shape and contiguity, allocates the
outputs, launches on the current stream, raises on a launch error and
counts its launches in ``.launches`` (a plain int, reset by the caller).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build

DTYPES = (torch.bfloat16, torch.float32)


def _check(x, r, i, a_param, h0) -> None:
    what = "rglru"
    tensors = [("x", x), ("r", r), ("i", i), ("a_param", a_param)]
    if h0 is not None:
        tensors.append(("h0", h0))
    if x.device.type != "cuda" or any(t.device != x.device for _, t in tensors):
        raise ValueError(f"{what}: all inputs must be on one CUDA device "
                         f"(got {[str(t.device) for _, t in tensors]})")
    if x.dtype not in DTYPES or r.dtype != x.dtype or i.dtype != x.dtype:
        raise TypeError(f"{what}: x, r and i must share one dtype of {DTYPES} "
                        f"(got {x.dtype}, {r.dtype}, {i.dtype})")
    if a_param.dtype != torch.float32 or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"{what}: a_param and h0 must be float32")
    if x.dim() != 3 or r.shape != x.shape or i.shape != x.shape:
        raise ValueError(f"{what}: needs x, r, i of one (B, S, N) shape "
                         f"(got {tuple(x.shape)}, {tuple(r.shape)}, {tuple(i.shape)})")
    B, _, N = x.shape
    if a_param.shape != (N,) or (h0 is not None and h0.shape != (B, N)):
        raise ValueError(f"{what}: needs a_param ({N},) and h0 ({B}, {N})")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def rglru_cuda(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               a_param: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i (B, S, N) bf16 or f32 on the card, a_param (N,) f32, h0
    (B, N) f32 or None (zeros) -> (y (B, S, N) in x's dtype, h_last (B, N)
    f32) of h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t x_t with
    a_t = exp(-8 softplus(a_param) r_t)."""
    _check(x, r, i, a_param, h0)
    B, S, N = x.shape
    y = torch.empty_like(x)
    h_last = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0 or N == 0:
        return y, h_last
    lib = _build.load("rglru")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.rglru_scan(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), a_param.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            B, S, N, int(x.dtype == torch.bfloat16), stream)
    _build.check("rglru", code, "rglru_scan")
    rglru_cuda.launches += 1
    return y, h_last


rglru_cuda.launches = 0


def flops_bytes(B: int, S: int, N: int, itemsize: int = 2) -> tuple:
    """(operations, device-memory bytes) of one call: about 10 f32
    operations per element (gate math and the recurrence, three of them
    transcendental), x, r, i read once and y written once (a_param, h0 and
    h_last are N and B·N, counted too)."""
    ops = 10.0 * B * S * N
    nbytes = 4.0 * itemsize * B * S * N + 4.0 * N + 8.0 * B * N
    return ops, nbytes
