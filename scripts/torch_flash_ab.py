#!/usr/bin/env python3
"""The serving launches of the LM kernels, the RG-LRU backward and the
analytics path's narrow GROUP-BY kernel in several checkouts, on one CUDA
card: flash attention, the RG-LRU scan, the SSD, ``rglru_scan_bwd`` and
``segagg_narrow``.

    python3 scripts/torch_flash_ab.py build/parent . . build/parent \
        --labels parent change1 change2 parent2 [--kernels narrow rglru_bwd]

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
after two warm-ups, three rounds a process.

Narrow (``segagg_narrow_cuda``, the wrapper's allocation, and a zeroing
launch where a checkout has one, included) at the analytics path's narrow
shapes, V = 1: TPC-Q6-like's largest batch (N 34,957,000, G 1: keys all 0,
values uniform in [0, 1)), CQ2's (N 8,748,300, G 5, uniform keys, values
1), the shared-table path at CQ2's N (G 2,048, uniform keys), and Q6's
shape with keys and values from row 1 (off a 16-byte boundary).  CUDA
events, mean of 5 launches after one warm-up (as ``chip_smoke.py`` times
its kernel table), three rounds, all before any of ``index_add_``'s into a
zeroed output.  Each result is first held against ``segagg_ref`` (counts
exact, sums within 1e-4).  Beside them: the byte bound (4N + 4NV + 4GV
bytes at 3.35 TB/s) and the host's time to issue one wrapper call (200
calls at CQ2's shape on the host clock, none synchronised).

RG-LRU backward (``rglru_bwd_cuda``, wrapper included: its allocations
and the sum of the d a_param partials) at recurrentgemma-9b's training
shape (B 2, S 4,096, N 4,096, bf16, no h0 or dh_last) and a ragged one (B
2, S 1,000, N 80, bf16, with h0 and dh_last), from the carries of that
checkout's forward.  Each result is first held against ``rglru_bwd_ref``
to ``chip_smoke.py`` phase 20a's tolerances (relative L2: dx, dr and di
1e-2, d a_param and dh0 1e-4).  Beside them: the byte bound (14 bytes an
element and the f32 carries, partials and ends, at 3.35 TB/s) and, where
the checkout exports it, the kernel's registers and blocks an SM.  CUDA
events, mean of 20 launches after two warm-ups, three rounds.

``--kernels`` picks the families (default all).  Prints one JSON line a
checkout, the card's name and power limit in it, and exits non-zero if any
failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
# (label, rows, groups, key kind, first row)
NARROW_SHAPES = (("TPC-Q6-like", 34_957_000, 1, "zero", 0),
                 ("CQ2", 8_748_300, 5, "uniform", 0),
                 ("G=2048 at CQ2's N", 8_748_300, 2048, "uniform", 0),
                 ("TPC-Q6-like from row 1", 34_957_000, 1, "zero", 1))
# (label, B, S, N, with h0 and dh_last)
RGLRU_BWD_SHAPES = (("rglru_bwd training B=2", 2, 4096, 4096, False),
                    ("rglru_bwd ragged", 2, 1000, 80, True))
RGLRU_BWD_TOL = 1e-2  # dx, dr, di in bf16; d a_param and dh0 1e-4
KERNELS = ("flash", "rglru", "ssd", "rglru_bwd", "narrow")
REPS, ROUNDS = 20, 3
NARROW_REPS = 5
HOST_CALLS = 200
HBM_BYTES_PER_S = 3.35e12


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def worker(root: str, kernels) -> dict:
    """Times in the checkout at ``root`` (its ``src`` first on the path)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    calls = []  # (label, a call with its inputs bound, launches timed, warm-ups)
    library = []  # the same, timed after every kernel round
    out = {"root": root, "device": torch.cuda.get_device_name(0), "smi": smi()}
    if "flash" in kernels:
        from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

        for label, B, Sq, Sk, H, Hkv, D, causal, window in SHAPES:
            q, k, v = randn(B, Sq, H, D), randn(B, Sk, Hkv, D), randn(B, Sk, Hkv, D)
            calls.append((label, lambda q=q, k=k, v=v, c=causal, w=window:
                          flash_attention_cuda(q, k, v, c, w), REPS, 2))
    if "rglru" in kernels:
        from repro_torch.kernels.rglru.rglru import rglru_cuda

        for label, B, S, N in RGLRU_SHAPES:
            x = randn(B, S, N)
            r, i = torch.sigmoid(randn(B, S, N)), torch.sigmoid(randn(B, S, N))
            a = torch.randn(N, device="cuda", generator=gen)
            calls.append((label, lambda x=x, r=r, i=i, a=a: rglru_cuda(x, r, i, a), REPS, 2))
    if "ssd" in kernels:
        from repro_torch.kernels.ssd.ssd import ssd_cuda

        for label, B, S, H, P, N in SSD_SHAPES:
            x, dt = 0.5 * randn(B, S, H, P), torch.nn.functional.softplus(randn(B, S, H) - 4.0)
            bc = [0.3 * randn(B, S, N) for _ in range(2)]
            Bh, Ch = (t[:, :, None].expand(B, S, H, N) for t in bc)
            A = -(0.5 + torch.rand(H, device="cuda", generator=gen))
            D = torch.randn(H, device="cuda", generator=gen)
            calls.append((label, lambda x=x, dt=dt, A=A, Bh=Bh, Ch=Ch, D=D:
                          ssd_cuda(x, dt, A, Bh, Ch, D), REPS, 2))
    parts = []  # each family's records by key (bounds, errors), merged below
    if "rglru_bwd" in kernels:
        parts.append(rglru_bwd_calls(gen, calls))
    if "narrow" in kernels:
        parts.append(narrow_calls(gen, calls, library))
    for part in parts:
        for key, record in part.items():
            out.setdefault(key, {}).update(record)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {label: [] for label, *_ in calls + library}
    for group in (calls, library):
        for _ in range(ROUNDS):
            for label, call, reps, warm in group:
                for _ in range(warm):
                    call()
                start.record()
                for _ in range(reps):
                    call()
                end.record()
                torch.cuda.synchronize()
                times[label].append(start.elapsed_time(end) / reps)
    if "narrow" in kernels:
        out["host_us_a_call"] = narrow_host_us(calls)
    out["ms"] = times
    out["median_ms"] = {label: sorted(t)[len(t) // 2] for label, t in times.items()}
    return out


def rglru_bwd_calls(gen, calls) -> dict:
    """Adds the RG-LRU backward's calls at ``RGLRU_BWD_SHAPES``, each result
    first held against ``rglru_bwd_ref``; returns their byte bounds and the
    kernel's resources where the checkout reports them."""
    import torch

    from repro_torch.kernels.rglru import rglru as rg
    from repro_torch.kernels.rglru.ref import rglru_bwd_ref

    def rel_l2(got, want):
        return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()

    bound, errors = {}, {}
    for label, B, S, N, ends in RGLRU_BWD_SHAPES:
        f = lambda *shape: torch.randn(shape, device="cuda", generator=gen)  # noqa: E731
        x, dy = f(B, S, N).bfloat16(), f(B, S, N).bfloat16()
        r, i = torch.sigmoid(f(B, S, N)).bfloat16(), torch.sigmoid(f(B, S, N)).bfloat16()
        a, (h0, dh_last) = f(N), ((f(B, N), f(B, N)) if ends else (None, None))
        carries = rg.rglru_cuda(x, r, i, a, h0, return_carries=True)[2]
        got = rg.rglru_bwd_cuda(x, r, i, a, carries, dy, dh_last)
        want = rglru_bwd_ref(x, r, i, a, h0, dy, dh_last)
        errs = {n: rel_l2(g, w) for n, g, w in zip(("dx", "dr", "di", "da_param", "dh0"),
                                                   got, want)}
        if any(e > (RGLRU_BWD_TOL if n in ("dx", "dr", "di") else 1e-4)
               for n, e in errs.items()):
            raise AssertionError(f"{label}: the kernel differs from rglru_bwd_ref: {errs}")
        errors[label] = errs
        calls.append((label, lambda x=x, r=r, i=i, a=a, c=carries, dy=dy, dh=dh_last:
                      rg.rglru_bwd_cuda(x, r, i, a, c, dy, dh), REPS, 2))
        bound[label] = rg.bwd_flops_bytes(B, S, N, 2)[1] / HBM_BYTES_PER_S * 1e3
    out = {"bound_ms": bound, "rel_l2": errors}
    if hasattr(rg, "bwd_resources"):
        out["registers_blocks_per_sm"] = {str(t)[6:]: rg.bwd_resources(t)
                                          for t in (torch.bfloat16, torch.float32)}
    return out


def narrow_calls(gen, calls, library) -> dict:
    """Adds narrow's calls and ``index_add_``'s at ``NARROW_SHAPES``, each
    result first held against ``segagg_ref``; returns their byte bounds."""
    import torch

    from repro_torch.kernels.segagg.ref import segagg_ref
    from repro_torch.kernels.segagg.segagg import segagg_narrow_cuda

    def index_add(keys, vals, g):
        return torch.zeros((g, vals.shape[1]), device="cuda").index_add_(0, keys, vals)

    bound = {}
    for label, rows, g, kind, first in NARROW_SHAPES:
        n = rows + first
        if kind == "zero":
            keys = torch.zeros(n, dtype=torch.int32, device="cuda")
            vals = torch.rand((n, 1), device="cuda", generator=gen)
        else:
            keys = torch.randint(0, g, (n,), device="cuda", generator=gen, dtype=torch.int32)
            vals = torch.ones((n, 1), device="cuda")
        keys, vals = keys[first:], vals[first:]
        got, want = segagg_narrow_cuda(keys, vals, g).double(), segagg_ref(keys, vals.double(), g)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"narrow {label}: the kernel differs from segagg_ref")
        calls.append((f"narrow {label}", lambda keys=keys, vals=vals, g=g:
                      segagg_narrow_cuda(keys, vals, g), NARROW_REPS, 1))
        library.append((f"index_add_ {label}", lambda keys=keys, vals=vals, g=g:
                        index_add(keys, vals, g), NARROW_REPS, 1))
        bound[f"narrow {label}"] = (4 * rows * 2 + 4 * g) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": bound}


def narrow_host_us(calls) -> float:
    """The host's µs to issue one narrow call at CQ2's shape."""
    import torch

    call = next(c for label, c, *_ in calls if label == "narrow CQ2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        call()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return host_us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts, timed in this order")
    ap.add_argument("--labels", nargs="*", help="one label a checkout")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the families to time")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.roots[0], args.kernels)), flush=True)
        return 0
    labels = args.labels or args.roots
    failed = 0
    for root, label in zip(args.roots, labels):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               "--kernels", *args.kernels], capture_output=True, text=True)
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
