#!/usr/bin/env python3
"""Probe of the port's Mamba-2 SSD kernel on one CUDA card.

    python3 scripts/torch_ssd_probe.py

1. builds the kernels (``src/repro_torch/csrc``), prints what ``ptxas``
   says of the SSD kernels (registers, spills, shared memory), and holds the
   SSD kernel against its plain version (f32) over a small grid, at the JAX
   package's SSD tolerances, and the bf16 kernel against the plain version
   of its own arithmetic (``ssd_chunked_bf16ops_ref``) within 1e-2;
2. times the kernel (CUDA events, mean of 3 after a warm-up) at mamba2-370m's
   prefill shape (S 32,768, H 32, P 64, N 128, bf16, B and C head-shared)
   for B in {1, 2, 4, 8}, one launch each of the P-tile widths;
3. sweeps depth: one batch of 2 prompts of 32,768 tokens through the first
   1, 2, 4, ..., 48 layers of the seeded full-width mamba2-370m, with the
   kernel and with the plain SSD (chunk 128), and at 1, 8 and 48 layers the
   plain SSD with chunk 64 against chunk 128 (the same arithmetic in another
   f32 summation order): the logits' relative L2 distance of each pair.  At
   8 layers also the kernel against the plain version of its arithmetic,
   and that version with one split operand at a time rounded once instead
   (G, the state's copy h, Bw) against the plain f32 SSD;
4. on the inputs the model gives its first SSD layer (the depth-1 run),
   the kernel and the variants of its arithmetic (every operand split, one
   rounded once, all rounded once) against the plain f32 SSD: y's largest
   error as a share of the bf16 tolerance (3e-2 absolute plus relative),
   and h_last's largest error.  This is what decides which operands the
   kernel splits.

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
    from repro_torch.kernels.ssd.ref import ssd_chunked_bf16ops_ref, ssd_chunked_ref
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
    for line in _build.build_logs.get("ssd", "").splitlines():
        if "ssd" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
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
                line = (f"parity B={B} S={S} H={H} P={P} N={N} {dtype} shared={shared}: "
                        f"y max abs err {(y.float() - yr).abs().max().item():.3e}, h_last "
                        f"{(h - hr).abs().max().item():.3e}")
                if dtype == torch.bfloat16:
                    # as tests/test_torch_cuda.py holds it: a millionth of y
                    # may pass 1e-2 (G rounded one ulp apart), none 3e-2
                    yo, ho = ssd_chunked_bf16ops_ref(x, dt, A, Bm, Cm, D, 128, h0)
                    err = (y.float() - yo.float()).abs()
                    beyond = (err > 1e-2 + 1e-2 * yo.float().abs()).float().mean().item()
                    ok = ok and beyond <= 1e-6 and torch.allclose(
                        y.float(), yo.float(), rtol=tol, atol=tol)
                    line += (f"; against its arithmetic: y {err.max().item():.3e} "
                             f"({beyond:.1e} beyond 1e-2), h_last "
                             f"{(h - ho).abs().max().item():.3e}")
                print(line, flush=True)
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

    splits = {"every operand split": ("g", "h", "bw"), "G rounded once": ("h", "bw"),
              "h rounded once": ("g", "bw"), "Bw rounded once": ("g", "h"),
              "all rounded once": ()}

    def bf16ops(split=splits["every operand split"]):
        return lambda x, dt, A, Bm, Cm, D, h0: ssd_chunked_bf16ops_ref(
            x, dt, A, Bm, Cm, D, 128, h0, split)

    first = []

    def recorded(*a):
        if not first:
            first.extend(t.clone() if torch.is_tensor(t) else t for t in a)
        return ssd_cuda(*a)

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
        lk, lp = logits(units, recorded if units == 1 else ssd_cuda), logits(units, plain(128))
        line = (f"depth {units:2d}: kernel against plain logits rel L2 {rel(lk, lp):.3e}, "
                f"argmax agreement {(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.2f}")
        if units in (1, 8, 48):
            line += f"; plain chunk 64 against chunk 128 {rel(logits(units, plain(64)), lp):.3e}"
        if units == 8:
            lo = logits(units, bf16ops())
            line += (f"; kernel against the plain version of its arithmetic {rel(lk, lo):.3e}"
                     f", that version against plain {rel(lo, lp):.3e}; against plain with ")
            line += ", ".join(f"{k} {rel(logits(units, bf16ops(v)), lp):.3e}"
                              for k, v in list(splits.items())[1:])
        print(line, flush=True)

    # 4. the first layer's own inputs
    x, dt, A, Bm, Cm, D, h0 = first
    yr, hr = ssd_chunked_ref(x.float(), dt.float(), A, Bm, Cm, D, 128, h0)

    def share(name, y, h):
        err = (y.float() - yr).abs()
        print(f"first layer's inputs, {name}: y max abs err {err.max().item():.3e}, "
              f"{(err / (3e-2 + 3e-2 * yr.abs())).max().item():.3f} of the bf16 tolerance; "
              f"h_last max abs err {(h - hr).abs().max().item():.3e}", flush=True)

    print(f"first layer's inputs: x rms {x.float().pow(2).mean().sqrt().item():.3f}, B rms "
          f"{Bm.float().pow(2).mean().sqrt().item():.3f}, C rms "
          f"{Cm.float().pow(2).mean().sqrt().item():.3f}, dt rms "
          f"{dt.float().pow(2).mean().sqrt().item():.4f}, |y| max {yr.abs().max().item():.2f}",
          flush=True)
    share("kernel", *ssd_cuda(x, dt, A, Bm, Cm, D, h0))
    for name, split in splits.items():
        share(name, *bf16ops(split)(x, dt, A, Bm, Cm, D, h0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
