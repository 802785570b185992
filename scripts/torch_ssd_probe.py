#!/usr/bin/env python3
"""Probe of the port's Mamba-2 SSD kernel on one CUDA card.

    python3 scripts/torch_ssd_probe.py

1. builds the kernels (``src/repro_torch/csrc``) and holds the SSD kernel
   against its plain version (f32) over a small grid, at the JAX package's
   SSD tolerances;
2. times the kernel (CUDA events, mean of 3 after a warm-up) at mamba2-370m's
   prefill shape (S 32,768, H 32, P 64, N 128, bf16, B and C head-shared)
   for B in {1, 2, 4, 8}, one launch each of the P-tile widths;
3. sweeps depth: one batch of 2 prompts of 32,768 tokens through the first
   1, 2, 4, ..., 48 layers of the seeded full-width mamba2-370m, with the
   kernel and with the plain SSD (chunk 128), and at 1, 8 and 48 layers the
   plain SSD with chunk 64 against chunk 128 (the same arithmetic in another
   f32 summation order): the logits' relative L2 distance of each pair.

Exits non-zero if a parity check fails or there is no card.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ssd_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd.ssd import ssd_cuda
    from repro_torch.models import lm
    from repro_torch.models.base import get_config
    from repro_torch.models.config import Segment
    from repro_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, P, N, dtype, shared):
        r = lambda *s: torch.randn(s, device="cuda", generator=gen)  # noqa: E731
        x = (0.5 * r(B, S, H, P)).to(dtype)
        dt = torch.nn.functional.softplus(r(B, S, H)).to(dtype)
        A = -r(H).abs() - 0.1
        if shared:
            Bm = (0.3 * r(B, S, N)).to(dtype)[:, :, None].expand(B, S, H, N)
            Cm = (0.3 * r(B, S, N)).to(dtype)[:, :, None].expand(B, S, H, N)
        else:
            Bm, Cm = (0.3 * r(B, S, H, N)).to(dtype), (0.3 * r(B, S, H, N)).to(dtype)
        return x, dt, A, Bm, Cm, r(H), r(B, H, N, P)

    # 1. parity
    for B, S, H, P, N in [(1, 256, 2, 16, 8), (2, 200, 4, 32, 16), (2, 77, 3, 40, 5),
                          (1, 1000, 32, 64, 128), (2, 300, 32, 64, 128),
                          (8, 300, 32, 64, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            for shared in (True, False):
                x, dt, A, Bm, Cm, D, h0 = inputs(B, S, H, P, N, dtype, shared)
                y, h = ssd_cuda(x, dt, A, Bm, Cm, D, h0)
                yr, hr = ssd_chunked_ref(x.float(), dt.float(), A, Bm, Cm, D, 128, h0)
                tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
                h_atol = 5e-3 if dtype == torch.bfloat16 else 2e-3
                ok = (torch.allclose(y.float(), yr, rtol=tol, atol=tol)
                      and torch.allclose(h, hr, rtol=2e-3, atol=h_atol))
                print(f"parity B={B} S={S} H={H} P={P} N={N} {dtype} shared={shared}: "
                      f"y max abs err {(y.float() - yr).abs().max().item():.3e}, h_last "
                      f"{(h - hr).abs().max().item():.3e}", flush=True)
                if not ok:
                    return 1

    # 2. times at the path's shape
    x, dt, A, Bm, Cm, D, h0 = inputs(8, 32768, 32, 64, 128, torch.bfloat16, True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for B in (8, 4, 2, 1):
        args = (x[:B], dt[:B], A, Bm[:B], Cm[:B], D, h0[:B])
        ssd_cuda(*args)
        start.record()
        for _ in range(3):
            ssd_cuda(*args)
        end.record()
        torch.cuda.synchronize()
        print(f"ssd B={B} S=32768 H=32 P=64 N=128 bf16: {start.elapsed_time(end) / 3:.4f} ms",
              flush=True)
    del x, dt, Bm, Cm, h0, args

    # 3. depth sweep
    cfg = get_config("mamba2_370m")
    params = init_params(lm.build_specs(cfg), seed=0, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32768)).astype(np.int32)).cuda()

    def plain(chunk):
        return lambda x, dt, A, Bm, Cm, D, h0: ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk, h0)

    def logits(units, impl):
        c = dataclasses.replace(cfg, segments=(Segment(("ssm",), units),))
        p = {k: (v[:units] if k.startswith("seg0/") else v) for k, v in params.items()}
        ssd_ops.ssd_cuda = impl
        try:
            return lm.prefill(c, p, toks, toks.shape[1])[0].float()
        finally:
            ssd_ops.ssd_cuda = ssd_cuda

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for units in (1, 2, 4, 8, 16, 32, 48):
        lk, lp = logits(units, ssd_cuda), logits(units, plain(128))
        line = (f"depth {units:2d}: kernel against plain logits rel L2 {rel(lk, lp):.3e}, "
                f"argmax agreement {(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.2f}")
        if units in (1, 8, 48):
            line += f"; plain chunk 64 against chunk 128 {rel(logits(units, plain(64)), lp):.3e}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
