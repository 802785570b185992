#!/usr/bin/env python3
"""The flash-attention kernel's time in several checkouts, on one CUDA card.

    python3 scripts/torch_flash_ab.py build/parent . . build/parent \
        --labels parent change1 change2 parent2

Each checkout is timed in a process of its own, one after the other (in
the order given: parent, change, change, parent compares two versions in
one call), through that checkout's ``flash_attention_cuda`` as the serving
paths call it (no log-sum-exp asked for), at the paths' shapes: the
recurrentgemma-9b prefill (B 8, S 4,096, 16 heads, one KV head, D 256,
causal, window 2,048), whisper-medium's encoder (B 8, 1,500 x 1,500, 16
heads of 64, not causal) and cross-attention (224 x 1,500), and yi-6b's
training shape (B 4, S 2,048, 32 heads of 128, 4 KV heads, causal).  CUDA
events, mean of 20 launches after two warm-ups, three rounds a process.
Prints one JSON line a checkout and exits non-zero if any failed.
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
REPS, ROUNDS = 20, 3


def worker(root: str) -> dict:
    """Times in the checkout at ``root`` (its ``src`` first on the path)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for label, B, Sq, Sk, H, Hkv, D, causal, window in SHAPES:
        q = torch.randn((B, Sq, H, D), device="cuda", generator=gen).bfloat16()
        k = torch.randn((B, Sk, Hkv, D), device="cuda", generator=gen).bfloat16()
        v = torch.randn((B, Sk, Hkv, D), device="cuda", generator=gen).bfloat16()
        inputs.append((label, q, k, v, causal, window))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {label: [] for label, *_ in inputs}
    for _ in range(ROUNDS):
        for label, q, k, v, causal, window in inputs:
            for _ in range(2):
                flash_attention_cuda(q, k, v, causal, window)
            start.record()
            for _ in range(REPS):
                flash_attention_cuda(q, k, v, causal, window)
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
