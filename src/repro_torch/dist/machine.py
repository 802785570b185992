"""The card's roofs: published peaks and a measured probe.

The torch twin of the JAX package's ``benchmarks/bench_roofline.py``
``measure_machine_spec``:

* ``PUBLISHED_H100_SXM`` — NVIDIA's data-sheet peaks of one H100 SXM
  (dense, at its full 700 W power limit), one ``MachineSpec`` per dtype:
  3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in
  float32 outside them.  Roofline shares are stated against these.
* ``measure_machine_spec`` — what the card sustains: a copy ``x + 1.0``
  (bytes read plus bytes written over its time) and a square matmul
  ``a @ a`` in float32 (TF32 off, the reference's dtype) and in bf16, timed
  with CUDA events after a warm-up.  A reading printed beside the published
  peaks, not a roof to grade against.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from ..device import DeviceLike, resolve_device
from .roofline import MachineSpec

_PUBLISHED = "published H100 SXM data sheet, dense, 700 W"
PUBLISHED_H100_SXM: Dict[str, MachineSpec] = {
    "float32": MachineSpec(peak_flops=67e12, peak_bw=3.35e12,
                           source=f"{_PUBLISHED}, float32 outside the tensor cores"),
    "bfloat16": MachineSpec(peak_flops=989e12, peak_bw=3.35e12,
                            source=f"{_PUBLISHED}, bf16 tensor cores"),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _seconds(fn, device: torch.device, reps: int) -> float:
    """Mean seconds of ``fn()`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measure_machine_spec(device: DeviceLike = None, *,
                         copy_bytes: int = 256 * 2**20,
                         matmul_n: int = 8192,
                         reps: int = 5) -> Dict[str, MachineSpec]:
    """Achievable peaks of ``device`` (the card unless the caller names the
    CPU), one ``MachineSpec`` per matmul dtype with the copy bandwidth
    shared: ``{"float32": ..., "bfloat16": ...}``.  The float32 product runs
    with TF32 off (the previous setting is restored)."""
    device = resolve_device(device)
    x = torch.ones(copy_bytes // 4, dtype=torch.float32, device=device)
    copy_s = _seconds(lambda: x + 1.0, device, reps)
    bw = 2 * x.numel() * 4 / copy_s
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, dtype in _DTYPES.items():
            a = torch.ones((matmul_n, matmul_n), dtype=dtype, device=device)
            mm_s = _seconds(lambda: a @ a, device, reps)
            out[name] = MachineSpec(
                peak_flops=2 * matmul_n**3 / mm_s, peak_bw=bw,
                source=(f"measured on {device}: copy of {copy_bytes} bytes, "
                        f"{name} matmul {matmul_n}^2"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out
