"""ctypes wrapper of the Hopper SSD kernel (``csrc/ssd.cu``).

``ssd_cuda`` replaces the JAX package's ``_ssd_kernel``
(``repro/kernels/ssd/ssd.py:26``) together with the dt weighting and the D
skip of its public op: one block per (batch, head, P-tile) loops over
128-step chunks with the (N, P) state in shared memory.  With
``return_states=True`` it also returns the f32 state entering each chunk,
which the backward (``layers/ssd.py`` ``ssd_bwd``) starts from.  B and C are read
through their strides, so the model's head-shared projections come as
stride-0 ``expand`` views.  It checks device, dtype, shape and layout,
allocates the outputs, launches on the current stream, raises on a launch
error and counts its launches in ``.launches`` (a plain int, reset by the
caller).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build, is_fake, register_cost

DTYPES = (torch.bfloat16, torch.float32)
CHUNK = 128      # the kernel's chunk length
MAX_STATE = 128  # the largest N its shared-memory plan holds


def _check(x, dt, A, Bm, Cm, D, h0) -> None:
    what = "ssd"
    tensors = [("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D)]
    if h0 is not None:
        tensors.append(("h0", h0))
    if x.device.type != "cuda" or any(t.device != x.device for _, t in tensors):
        raise ValueError(f"{what}: all inputs must be on one CUDA device "
                         f"(got {[str(t.device) for _, t in tensors]})")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"{what}: x, dt, Bm and Cm must share one dtype of {DTYPES} "
                        f"(got {x.dtype}, {dt.dtype}, {Bm.dtype}, {Cm.dtype})")
    if any(t is not None and t.dtype != torch.float32 for t in (A, D, h0)):
        raise TypeError(f"{what}: A, D and h0 must be float32")
    if x.dim() != 4:
        raise ValueError(f"{what}: needs x (B, S, H, P) (got {tuple(x.shape)})")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 4 else -1
    if dt.shape != (B, S, H) or Bm.dim() != 4 or Bm.shape[:3] != (B, S, H) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"{what}: needs dt (B, S, H) and Bm, Cm (B, S, H, N) for x "
                         f"{tuple(x.shape)} (got {tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)})")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"{what}: state size N = {N} must be in [1, {MAX_STATE}]")
    if A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"{what}: needs A and D ({H},) (got {tuple(A.shape)}, "
                         f"{tuple(D.shape)})")
    if h0 is not None and h0.shape != (B, H, N, P):
        raise ValueError(f"{what}: needs h0 ({B}, {H}, {N}, {P}) (got {tuple(h0.shape)})")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.stride(3) != 1 and N > 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim "
                             f"(got strides {t.stride()})")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None,
             return_states: bool = False):
    """x (B, S, H, P), dt (B, S, H), Bm/Cm (B, S, H, N) (any (b, s, h)
    strides), all bf16 or all f32 on the card; A, D (H,) f32; h0 (B, H, N, P)
    f32 or None (zeros) -> (y (B, S, H, P) in x's dtype, h_last (B, H, N, P)
    f32) of h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t + D x_t; with ``return_states`` also the f32 state
    entering each ``CHUNK``-step chunk, (B, H, chunks, N, P) (serving
    passes a null pointer: nothing more is written).  The launch is the op
    ``repro_torch::ssd_fwd`` (CUDA only; its fake gives the shapes)."""
    if x.device.type == "cpu" and not is_fake(x):  # no CPU kernel: refuse as a launch would
        _check(x, dt, A, Bm, Cm, D, h0)
    y, h_last, states = torch.ops.repro_torch.ssd_fwd(x, dt, A, Bm, Cm, D, h0,
                                                      bool(return_states))
    return (y, h_last, states) if return_states else (y, h_last)


def _out_shapes(x: torch.Tensor, Bm: torch.Tensor, return_states: bool) -> tuple:
    """(h_last, states) shapes; states (0,) when not asked for."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    return (B, H, N, P), ((B, H, -(-S // CHUNK), N, P) if return_states else (0,))


@torch.library.custom_op("repro_torch::ssd_fwd", mutates_args=(), device_types="cuda")
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor],
            return_states: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check(x, dt, A, Bm, Cm, D, h0)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    h_shape, s_shape = _out_shapes(x, Bm, return_states)
    h_last = torch.empty(h_shape, dtype=torch.float32, device=x.device)
    states = torch.empty(s_shape, dtype=torch.float32, device=x.device)
    if B == 0 or H == 0 or P == 0:
        return y, h_last, states
    strides = (ctypes.c_int64 * 6)(*Bm.stride()[:3], *Cm.stride()[:3])
    lib = _build.load("ssd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), states.data_ptr() if return_states else None, strides,
            B, S, H, P, N, int(x.dtype == torch.bfloat16), stream)
    _build.check("ssd", code, "ssd_fwd")
    ssd_cuda.launches += 1
    return y, h_last, states


@_ssd_op.register_fake
def _(x, dt, A, Bm, Cm, D, h0, return_states):
    h_shape, s_shape = _out_shapes(x, Bm, return_states)
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty(h_shape, dtype=torch.float32),
            x.new_empty(s_shape, dtype=torch.float32))


ssd_cuda.launches = 0


def flops_bytes(B: int, S: int, H: int, P: int, N: int, itemsize: int = 2) -> tuple:
    """(operations, device-memory bytes) of one call.  Operations: per
    (b, h) and chunk of q steps, the causal half of C B^T (q(q+1)/2 · N
    multiply-adds) and of G xw (q(q+1)/2 · P), and C h and B^T xw
    (q · N · P each), two operations a multiply-add.  Bytes: x and dt read
    and y written in ``itemsize``, B and C read once each (shared by the H
    heads), A and D, and h0 read and h_last written in f32."""
    mac = 0.0
    for lo in range(0, S, CHUNK):
        q = min(CHUNK, S - lo)
        mac += q * (q + 1) / 2 * (N + P) + 2.0 * q * N * P
    ops = 2.0 * B * H * mac
    nbytes = (itemsize * (2.0 * B * S * H * P + B * S * H + 2.0 * B * S * N)
              + 4.0 * 2 * H + 4.0 * 2 * B * H * N * P)
    return ops, nbytes


def bwd_flops_bytes(B: int, S: int, H: int, P: int, N: int, shared: bool = True,
                    itemsize: int = 2) -> tuple:
    """(operations, device-memory bytes) of one ``layers/ssd.py`` ``ssd_bwd``
    call on the kernel's chunks.  Operations, per (b, h) and chunk of q
    steps: dG = dy xw^T and G^T dy over the causal half (q(q+1)/2 · P
    multiply-adds each), the state's four (q · N · P: C h, C^T dy, dh^T
    xw and B dh), dC and dB through C B^T over the causal half (q(q+1)/2 ·
    N each; once per b when B and C are ``shared`` by the heads); two
    operations a multiply-add.  Bytes: x, dt, B, C and dy read and dx, ddt,
    dB and dC written in ``itemsize`` (B and C once when shared), the
    states read and dh0 written in f32."""
    mac = mac_bc = 0.0
    for lo in range(0, S, CHUNK):
        q = min(CHUNK, S - lo)
        mac += q * (q + 1) / 2 * 2 * P + 4.0 * q * N * P
        mac_bc += q * (q + 1) / 2 * 2 * N
    ops = 2.0 * B * (H * mac + (1 if shared else H) * mac_bc)
    bc = 4.0 * B * S * N * (1 if shared else H)
    nbytes = (itemsize * (4.0 * B * S * H * P + 2.0 * B * S * H + bc)
              + 4.0 * B * H * N * P * (-(-S // CHUNK) + 1))
    return ops, nbytes


def _op_cost(x, dt, A, Bm, Cm, D, h0, return_states):
    """``flops_bytes`` from the op's shapes, and the states' f32 writes when
    they are asked for."""
    B, S, H, P = x
    ops, nbytes = flops_bytes(B, S, H, P, Bm[-1])
    states = 4.0 * B * H * -(-S // CHUNK) * Bm[-1] * P if return_states else 0.0
    return ops, nbytes + states


register_cost(torch.ops.repro_torch.ssd_fwd, _op_cost)
