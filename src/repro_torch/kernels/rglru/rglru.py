"""ctypes wrappers of the Hopper RG-LRU scan and its backward
(``csrc/rglru.cu``).

``rglru_cuda`` replaces the JAX package's ``_rglru_kernel``
(``repro/kernels/rglru/rglru.py:27``) together with the gate math of its
public op: a time-parallel scan (sub-segments of a chunk scanned from
h = 0, then combined with the carry; f32 state).  With
``return_carries=True`` it also returns the state entering each
``CHUNK``-step chunk, which ``rglru_bwd_cuda`` (the gradient, the same scan
run in reverse; the JAX package differentiates its layer's associative
scan) recomputes h from.  Each wrapper checks device, dtype, shape and
contiguity, allocates the outputs, launches on the current stream, raises
on a launch error and counts its launches in ``.launches`` (a plain int,
reset by the caller).  ``rglru_serial_cuda`` launches the earlier design
(one thread per channel walking time) on the same terms; no model path
calls it, it is the yardstick ``chip_smoke.py`` times.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build, is_fake, register_cost

DTYPES = (torch.bfloat16, torch.float32)
CHUNK = 128  # the kernels' chunk: one carry a chunk


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


def _chunks(S: int) -> int:
    return -(-S // CHUNK)


def _launch(library: str, fn: str, x, r, i, a_param, h0, extra=()):
    """Launch ``fn`` with the forward's arguments, ``extra`` (pointers or
    None) after h_last."""
    _check(x, r, i, a_param, h0)
    B, S, N = x.shape
    y = torch.empty_like(x)
    h_last = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0 or N == 0:
        return y, h_last, False
    lib = _build.load(library)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), a_param.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            *extra, B, S, N, int(x.dtype == torch.bfloat16), stream)
    _build.check(library, code, fn)
    return y, h_last, True


def rglru_cuda(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               a_param: torch.Tensor, h0: Optional[torch.Tensor] = None,
               return_carries: bool = False):
    """x, r, i (B, S, N) bf16 or f32 on the card, a_param (N,) f32, h0
    (B, N) f32 or None (zeros) -> (y (B, S, N) in x's dtype, h_last (B, N)
    f32) of h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t x_t with
    a_t = exp(-8 softplus(a_param) r_t); with ``return_carries`` also the
    f32 state entering each chunk, (B, ceil(S / CHUNK), N) (serving passes
    a null pointer: nothing more is written).  The launch is the op
    ``repro_torch::rglru_scan`` (CUDA only; its fake gives the shapes)."""
    if x.device.type == "cpu" and not is_fake(x):  # no CPU kernel: refuse as a launch would
        _check(x, r, i, a_param, h0)
    y, h_last, carries = torch.ops.repro_torch.rglru_scan(x, r, i, a_param, h0,
                                                          bool(return_carries))
    return (y, h_last, carries) if return_carries else (y, h_last)


def _carries_shape(x: torch.Tensor, return_carries: bool) -> tuple:
    B, S, N = x.shape
    return (B, _chunks(S), N) if return_carries else (0,)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(), device_types="cuda")
def _rglru_op(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, a_param: torch.Tensor,
              h0: Optional[torch.Tensor], return_carries: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    carries = torch.empty(_carries_shape(x, return_carries), dtype=torch.float32,
                          device=x.device)
    y, h_last, launched = _launch("rglru", "rglru_scan", x, r, i, a_param, h0,
                                  (carries.data_ptr() if return_carries else None,))
    rglru_cuda.launches += launched
    return y, h_last, carries


@_rglru_op.register_fake
def _(x, r, i, a_param, h0, return_carries):
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((x.shape[0], x.shape[2]), dtype=torch.float32),
            x.new_empty(_carries_shape(x, return_carries), dtype=torch.float32))


rglru_cuda.launches = 0


def rglru_bwd_cuda(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                   a_param: torch.Tensor, carries: torch.Tensor, dy: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``rglru_cuda`` from its inputs, its ``carries`` (the
    initial state is the first chunk's), dy (B, S, N) in x's dtype and
    dh_last (B, N) f32 or None: (dx, dr, di in x's dtype, d a_param (N,)
    f32, dh0 (B, N) f32).  The kernel writes d a_param as (B, chunks, N)
    partials, summed here.  The launch is the op
    ``repro_torch::rglru_scan_bwd`` (CUDA only; its fake gives the shapes)."""
    return tuple(torch.ops.repro_torch.rglru_scan_bwd(x, r, i, a_param, carries, dy,
                                                      dh_last))


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _rglru_bwd_op(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, a_param: torch.Tensor,
                  carries: torch.Tensor, dy: torch.Tensor, dh_last: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    _check(x, r, i, a_param, None)
    B, S, N = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"rglru_bwd: dy must be contiguous {tuple(x.shape)} {x.dtype}")
    if carries.shape != (B, _chunks(S), N) or carries.dtype != torch.float32 \
            or carries.device != x.device or not carries.is_contiguous():
        raise ValueError(f"rglru_bwd: carries must be contiguous f32 "
                         f"({B}, {_chunks(S)}, {N}) on {x.device}")
    if dh_last is not None and (dh_last.shape != (B, N) or dh_last.dtype != torch.float32
                                or not dh_last.is_contiguous()):
        raise ValueError(f"rglru_bwd: dh_last must be contiguous f32 ({B}, {N})")
    dx, dr, di = (torch.empty_like(x) for _ in range(3))
    dh0 = torch.empty((B, N), **f32)
    part = torch.empty((B, _chunks(S), N), **f32)
    if B == 0 or N == 0:
        return dx, dr, di, torch.zeros((N,), **f32), dh0
    lib = _build.load("rglru")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.rglru_scan_bwd(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), a_param.data_ptr(), carries.data_ptr(),
            dy.data_ptr(), None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
            dr.data_ptr(), di.data_ptr(), dh0.data_ptr(), part.data_ptr(), B, S, N,
            int(x.dtype == torch.bfloat16), stream)
    _build.check("rglru", code, "rglru_scan_bwd")
    rglru_bwd_cuda.launches += 1
    return dx, dr, di, part.sum((0, 1)), dh0


@_rglru_bwd_op.register_fake
def _(x, r, i, a_param, carries, dy, dh_last):
    B, S, N = x.shape
    grads = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(3)]
    return (*grads, x.new_empty((N,), dtype=torch.float32),
            x.new_empty((B, N), dtype=torch.float32))


rglru_bwd_cuda.launches = 0


def bwd_resources(dtype: torch.dtype) -> Tuple[int, int]:
    """(registers a thread, blocks an SM) of the backward kernel for x's
    ``dtype`` on the current card, as its build gives them (for the
    record; no launch)."""
    if dtype not in DTYPES:
        raise TypeError(f"rglru_bwd: dtype must be one of {DTYPES} (got {dtype})")
    registers, blocks = ctypes.c_int32(0), ctypes.c_int32(0)
    code = _build.load("rglru").rglru_bwd_resources(int(dtype == torch.bfloat16),
                                                   ctypes.byref(registers),
                                                   ctypes.byref(blocks))
    _build.check("rglru", code, "rglru_bwd_resources")
    return registers.value, blocks.value


def rglru_serial_cuda(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                      a_param: torch.Tensor, h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_cuda``'s function through the earlier one-thread-per-channel
    kernel (``csrc/rglru_serial.cu``)."""
    y, h_last, launched = _launch("rglru_serial", "rglru_serial_scan", x, r, i,
                                  a_param, h0)
    rglru_serial_cuda.launches += launched
    return y, h_last


rglru_serial_cuda.launches = 0


def flops_bytes(B: int, S: int, N: int, itemsize: int = 2) -> tuple:
    """(operations, device-memory bytes) of one call: about 10 f32
    operations per element (gate math and the recurrence, three of them
    transcendental), x, r, i read once and y written once (a_param, h0 and
    h_last are N and B·N, counted too)."""
    ops = 10.0 * B * S * N
    nbytes = 4.0 * itemsize * B * S * N + 4.0 * N + 8.0 * B * N
    return ops, nbytes


def bwd_flops_bytes(B: int, S: int, N: int, itemsize: int = 2) -> tuple:
    """(operations, device-memory bytes) of one ``rglru_bwd_cuda`` call:
    about 30 f32 operations per element (the forward's recomputed, the
    reverse scan and the gate gradients, five of them transcendental); x,
    r, i and dy read and dx, dr and di written once, the carries and the
    d a_param partials (B x chunks x N f32 each), dh_last and dh0."""
    ops = 30.0 * B * S * N
    nbytes = 7.0 * itemsize * B * S * N + 8.0 * B * _chunks(S) * N + 4.0 * N + 8.0 * B * N
    return ops, nbytes


register_cost(torch.ops.repro_torch.rglru_scan,
              lambda x, r, i, a, h0, carries: _with_carries(flops_bytes(*x), x, carries))
register_cost(torch.ops.repro_torch.rglru_scan_bwd,
              lambda x, r, i, a, carries, dy, dh_last: bwd_flops_bytes(*x))


def _with_carries(cost: tuple, x, return_carries: bool) -> tuple:
    """``flops_bytes`` plus the carries' f32 writes when they are asked for."""
    B, S, N = x
    return cost[0], cost[1] + (4.0 * B * _chunks(S) * N if return_carries else 0.0)
