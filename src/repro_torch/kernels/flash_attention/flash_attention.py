"""ctypes wrapper of the Hopper flash-attention forward
(``csrc/flash_attention.cu``).

``flash_attention_cuda`` replaces the JAX package's ``_flash_fwd_kernel``
(``repro/kernels/flash_attention/flash_attention.py:29``).  It reads the
model's (B, S, H, D) layout through strides: only the head dim must be
contiguous.  It checks device, dtype, shape and layout, allocates the
output, launches on the current stream, raises on a launch error and counts
its launches in ``.launches`` (a plain int, reset by the caller).
``flash_attention_sync_cuda`` launches the earlier design (synchronous K/V
loads, no ldmatrix) on the same terms; no model path calls it, it is the
yardstick ``chip_smoke.py`` times.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    what = "flash_attention"
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k and v must be on one CUDA device "
                         f"(got {q.device}, {k.device}, {v.device})")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{what}: the kernel takes bfloat16 q, k and v "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: needs q (B, Sq, H, D) and k, v (B, Sk, Hkv, D) "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[2] <= 0 or H % k.shape[2]:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         f"(same B and D, H a multiple of Hkv)")
    if B > 65535:
        raise ValueError(f"{what}: batch {B} above the grid's 65,535")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"{what}: head dim {D} must be a multiple of 8 "
                         f"and at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous head dim, "
                             f"strides that are multiples of 8 and a 16-byte "
                             f"aligned start (got strides {t.stride()})")


def _launch(library: str, fn: str, q, k, v, causal, window, logit_cap):
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out, False
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    lib = _build.load(library)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, Sq, Sk, H, Hkv, D, 1.0 / math.sqrt(D), int(bool(causal)),
            int(window), float(logit_cap), stream)
    _build.check(library, code, fn)
    return out, True


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) bf16 on the card -> (B, Sq, H, D)
    bf16: softmax(q k^T / sqrt(D)) v with optional tanh soft-cap
    ``cap * tanh(s / cap)``, causal mask ``k <= q`` and window mask
    ``k > q - window``; query head h reads KV head ``h // (H / Hkv)``."""
    out, launched = _launch("flash_attention", "flash_attention_fwd", q, k, v,
                            causal, window, logit_cap)
    flash_attention_cuda.launches += launched
    return out


flash_attention_cuda.launches = 0


def flash_attention_sync_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, window: int = 0,
                              logit_cap: float = 0.0) -> torch.Tensor:
    """``flash_attention_cuda``'s function through the earlier kernel
    (``csrc/flash_attention_sync.cu``)."""
    out, launched = _launch("flash_attention_sync", "flash_attention_sync_fwd", q, k, v,
                            causal, window, logit_cap)
    flash_attention_sync_cuda.launches += launched
    return out


flash_attention_sync_cuda.launches = 0


def flops_bytes(B: int, Sq: int, Sk: int, H: int, Hkv: int, D: int, causal: bool,
                window: int, itemsize: int = 2) -> tuple:
    """(operations, device-memory bytes) of one call: 4·D flops (q·k and
    p·v) for every (b, h, q, k) pair the masks let through, and q, k, v
    read once and o written once."""
    live = 0
    for qp in range(Sq):
        hi = min(Sk, qp + 1) if causal else Sk
        lo = max(0, qp - window + 1) if window > 0 else 0
        live += max(0, hi - lo)
    ops = 4.0 * B * H * D * live
    nbytes = itemsize * (2.0 * B * Sq * H * D + 2.0 * B * Sk * Hkv * D)
    return ops, nbytes
