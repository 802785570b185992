"""ctypes wrapper of the Hopper flash-attention forward
(``csrc/flash_attention.cu``).

``flash_attention_cuda`` replaces the JAX package's ``_flash_fwd_kernel``
(``repro/kernels/flash_attention/flash_attention.py:29``).  It reads the
model's (B, S, H, D) layout through strides: only the head dim must be
contiguous.  It takes the JAX layer's ``q_offset`` (the absolute position of
query row 0, for a prefill continuation) and ``kv_valid_len`` (a (B,) count
of live keys a batch row), and with ``return_lse`` also writes each row's
log-sum-exp, the residual that the training backward
(``layers/attention.py``) reads.  It checks device, dtype, shape and layout,
allocates the outputs, launches on the current stream, raises on a launch
error and counts its launches in ``.launches`` (a plain int, reset by the
caller).  ``flash_attention_sync_cuda`` launches the earlier design
(synchronous K/V loads, no ldmatrix, neither ``q_offset`` nor
``kv_valid_len``) on the same terms; no model path calls it, it is the
yardstick ``chip_smoke.py`` times.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build, is_fake, register_cost

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


def _launch(library: str, fn: str, q, k, v, causal, window, logit_cap, *extra):
    """``extra``: the launcher's arguments between the soft-cap and the
    stream."""
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
            int(window), float(logit_cap), *extra, stream)
    _build.check(library, code, fn)
    return out, True


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         logit_cap: float = 0.0, q_offset: int = 0,
                         kv_valid_len: Optional[torch.Tensor] = None,
                         return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) bf16 on the card -> (B, Sq, H, D)
    bf16: softmax(q k^T / sqrt(D)) v with optional tanh soft-cap
    ``cap * tanh(s / cap)``, causal mask ``k <= q`` and window mask
    ``k > q - window`` at query position ``q = q_offset + row``, and keys at
    or past ``kv_valid_len[b]`` masked; query head h reads KV head
    ``h // (H / Hkv)``.  A row that sees no key gets zeros.  With
    ``return_lse`` returns (out, lse): lse (B, H, Sq) f32, each row's
    ``m + log(l)`` of the logits as the kernel forms them (q/sqrt(D)
    rounded to bf16, soft-capped, masked); a row that sees no key gets
    ``log(1e-20)``.  The launch is the op ``repro_torch::flash_attention_fwd``
    (CUDA only; its fake gives the shapes)."""
    if q.device.type == "cpu" and not is_fake(q):  # no CPU kernel: refuse as a launch would
        _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0")
    kv_len = None
    if kv_valid_len is not None:
        if tuple(kv_valid_len.shape) != (q.shape[0],):
            raise ValueError(f"flash_attention: kv_valid_len must be ({q.shape[0]},), "
                             f"got {tuple(kv_valid_len.shape)}")
        kv_len = kv_valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    out, lse = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, bool(causal), int(window), float(logit_cap), int(q_offset), kv_len,
        bool(return_lse))
    return (out, lse) if return_lse else out


def _lse_shape(q: torch.Tensor, return_lse: bool) -> tuple:
    return (q.shape[0], q.shape[2], q.shape[1]) if return_lse else (0,)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  window: int, logit_cap: float, q_offset: int,
                  kv_len: Optional[torch.Tensor], return_lse: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    lse = torch.empty(_lse_shape(q, return_lse), dtype=torch.float32, device=q.device)
    out, launched = _launch("flash_attention", "flash_attention_fwd", q, k, v,
                            causal, window, logit_cap, q_offset,
                            None if kv_len is None else kv_len.data_ptr(),
                            lse.data_ptr() if return_lse else None)
    flash_attention_cuda.launches += launched
    return out, lse


@_flash_fwd_op.register_fake
def _(q, k, v, causal, window, logit_cap, q_offset, kv_len, return_lse):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(_lse_shape(q, return_lse), dtype=torch.float32))


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
                window: int, itemsize: int = 2, q_offset: int = 0,
                kv_valid_len: Optional[Sequence[int]] = None) -> tuple:
    """(operations, device-memory bytes) of one call: 4·D flops (q·k and
    p·v) for every (b, h, q, k) pair the masks let through, and q, o and
    each row's live keys and values moved once."""
    lens = [Sk] * B if kv_valid_len is None else [min(Sk, max(0, int(n)))
                                                   for n in kv_valid_len]
    qp = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    live = 0
    for n in lens:
        hi = np.minimum(n, qp + 1) if causal else np.full_like(qp, n)
        lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros_like(qp)
        live += int(np.maximum(0, hi - lo).sum())
    ops = 4.0 * H * D * live
    nbytes = itemsize * (2.0 * B * Sq * H * D + 2.0 * sum(lens) * Hkv * D)
    return ops, nbytes


def _op_cost(q, k, v, causal, window, logit_cap, q_offset, kv_len, return_lse):
    """(operations, bytes) of one op call from its shapes, every key taken
    as live (``kv_valid_len``'s values are data), the lse's f32 written."""
    B, Sq, H, D = q
    ops, nbytes = flops_bytes(B, Sq, k[1], H, k[2], D, causal, window,
                              q_offset=q_offset)
    return ops, nbytes + (4.0 * B * H * Sq if return_lse else 0.0)


register_cost(torch.ops.repro_torch.flash_attention_fwd, _op_cost)
