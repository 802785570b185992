#!/usr/bin/env python3
"""The serving launches of the LM kernels in several checkouts, on one CUDA
card: flash attention, the RG-LRU scan and the SSD.

    python3 scripts/torch_flash_ab.py build/parent . . build/parent \
        --labels parent change1 change2 parent2

Each checkout is timed in a process of its own, one after the other (in
the order given: parent, change, change, parent compares two versions in
one call), through that checkout's wrappers as the serving paths call them
(no log-sum-exp, RG-LRU carries or SSD states asked for).  Flash at the
paths' shapes: the recurrentgemma-9b prefill (B 8, S 4,096, 16 heads, one
KV head, D 256, causal, window 2,048), whisper-medium's encoder (B 8,
1,500 x 1,500, 16 heads of 64, not causal) and cross-attention (224 x
1,500), and yi-6b's training shape (B 4, S 2,048, 32 heads of 128, 4 KV
heads, causal).  The RG-LRU at recurrentgemma's prefill (B 8 and 1, S
4,096, N 4,096) and training (B 2) shapes, bf16.  The SSD at mamba2-370m's
prefill (B 8, S 32,768, H 32, P 64, N 128, B and C head-shared) and
training (B 8, S 2,048) shapes, bf16.  CUDA events, mean of 20 launches
after two warm-ups, three rounds a process.  Prints one JSON line a
checkout and exits non-zero if any failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (label, B, Sq, Sk, H, Hkv, D, causal, window)
SHAPES = (("recurrentgemma B=8", 8, 4096, 4096, 16, 1, 256, True, 2048),
          ("whisper encoder", 8, 1500, 1500, 16, 16, 64, False, 0),
          ("whisper cross", 8, 224, 1500, 16, 16, 64, False, 0),
          ("yi-6b training", 4, 2048, 2048, 32, 4, 128, True, 0))
# (label, B, S, N)
RGLRU_SHAPES = (("rglru B=8", 8, 4096, 4096), ("rglru B=1", 1, 4096, 4096),
                ("rglru training B=2", 2, 4096, 4096))
# (label, B, S, H, P, N)
SSD_SHAPES = (("ssd B=8 S=32768", 8, 32768, 32, 64, 128),
              ("ssd training B=8 S=2048", 8, 2048, 32, 64, 128))
REPS, ROUNDS = 20, 3


def worker(root: str) -> dict:
    """Times in the checkout at ``root`` (its ``src`` first on the path)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru.rglru import rglru_cuda
    from repro_torch.kernels.ssd.ssd import ssd_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    calls = []  # (label, a call with its inputs bound)
    for label, B, Sq, Sk, H, Hkv, D, causal, window in SHAPES:
        q, k, v = randn(B, Sq, H, D), randn(B, Sk, Hkv, D), randn(B, Sk, Hkv, D)
        calls.append((label, lambda q=q, k=k, v=v, c=causal, w=window:
                      flash_attention_cuda(q, k, v, c, w)))
    for label, B, S, N in RGLRU_SHAPES:
        x, r, i = randn(B, S, N), torch.sigmoid(randn(B, S, N)), torch.sigmoid(randn(B, S, N))
        a = torch.randn(N, device="cuda", generator=gen)
        calls.append((label, lambda x=x, r=r, i=i, a=a: rglru_cuda(x, r, i, a)))
    for label, B, S, H, P, N in SSD_SHAPES:
        x, dt = 0.5 * randn(B, S, H, P), torch.nn.functional.softplus(randn(B, S, H) - 4.0)
        bc = [0.3 * randn(B, S, N) for _ in range(2)]
        Bh, Ch = (t[:, :, None].expand(B, S, H, N) for t in bc)
        A = -(0.5 + torch.rand(H, device="cuda", generator=gen))
        D = torch.randn(H, device="cuda", generator=gen)
        calls.append((label, lambda x=x, dt=dt, A=A, Bh=Bh, Ch=Ch, D=D:
                      ssd_cuda(x, dt, A, Bh, Ch, D)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {label: [] for label, _ in calls}
    for _ in range(ROUNDS):
        for label, call in calls:
            for _ in range(2):
                call()
            start.record()
            for _ in range(REPS):
                call()
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / REPS)
    return {"root": root, "device": torch.cuda.get_device_name(0), "ms": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts, timed in this order")
    ap.add_argument("--labels", nargs="*", help="one label a checkout")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.roots[0])), flush=True)
        return 0
    labels = args.labels or args.roots
    failed = 0
    for root, label in zip(args.roots, labels):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            failed += 1
            print(f"{label}: exit {proc.returncode}\n{proc.stdout}{proc.stderr}", flush=True)
            continue
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["label"] = label
        print(json.dumps(r), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
