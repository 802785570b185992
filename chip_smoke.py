#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # the paper's scale: 4,500 files, StreamScale(1.0)

Phases (any failure exits non-zero and prints no result line):

1. environment: torch, the card, its power limit; TF32 off;
2. build: every kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a, one
   process per source, started together), the earlier flash and RG-LRU
   designs among them;
3. kernel parity: each kernel against its plain PyTorch version on the card
   (counts by ``torch.equal``, float sums within ``FLOAT_RTOL`` of the plain
   version taken in float64), for G in {1, 5, 360K, 1.5M, 16M}, V in {1, 3},
   N a batch of paper files, keys out of range on both sides, empty input;
   the cluster-table scatter (with the plan ``tuning.scatter_plan`` takes at
   each G) and the global-atomic scatter also under Zipf keys at 360K;
4. single-query path (the main path, part 1): for CQ3, CQ4, CQ2 and
   TPC-Q6-like, ``measure_cost_model`` on the card at batch sizes that
   span the plans' batches (``CALIBRATION_FILES``), ``Planner("single")``
   under a deadline of ``wind_end + 0.6 * cost(n)``, each of the plan's
   batch sizes run once, then ``run_plan`` on the card, result against a
   float64 host one-shot (counts exact); the modelled and the measured
   finish (each batch's measured seconds in place of its modelled cost)
   beside the deadline, with the miss in ms (a reading, not a gate);
5. multi-query path (the main path, part 2): ``Planner("llf-dynamic").run``
   over the six paper queries on one ``AnalyticsRuntimeExecutor`` with the
   paper's cost models, every result against its host one-shot;
6. launch counts of phases 4-5: the narrow kernel, the cluster-table
   scatter (CQ3) and the global-atomic scatter (CQ4, the plan's route for a
   table that needs two key ranges) launched, the plain version never
   called on a CUDA tensor;
7. at the main path's largest batch per query: where a batch's time goes
   (host concat, copy in, kernel, spill), the kernel the path runs against
   its plain version at that shape (as in phase 3), and its time beside the
   plain version's, ``index_add_``'s and its byte bound; the cluster-table
   scatter also beside the global-atomic kernel it replaced (``old_ms``), at
   CQ4 the cluster design forced to two key ranges beside the route taken,
   and at CQ3's shape both again under Zipf keys (parity gated, times a
   reading); then the narrow/scatter crossover table behind
   ``tuning.MATMUL_MAX_G``;
8. LM kernel parity: the flash-attention kernel (causal or not, window,
   soft-cap, GQA and MQA, ragged S, D in {64, 128, 256}), the RG-LRU
   kernel (ragged S and N, B in {1, 8}) and the SSD kernel (B in {1, 2, 8},
   ragged S, with and without h0, B and C head-shared by stride 0 or per
   head, mamba2's H 32, P 64, N 128 and a smaller set, bf16 and f32)
   against their plain versions on the card, taken in f32;
9. the serving path (the main path, part 3) at recurrentgemma-9b's full
   width and depth (10,444,664,832 bf16 parameters from ``--seed``):
   ``PrefillExecutor`` with buckets (1, 2, 4, 8) over prompts of 4,096
   tokens, ``calibrate``, ``serve_single_job`` (24 prompts, ``single``) and
   ``serve_multi_jobs`` (three jobs, LLF); logits finite and (n, 256000);
   launches flash = 12 and RG-LRU = 26 per prefill call, plain versions
   never called on a CUDA tensor, and the launches by batch size; then one
   batch of 8 with the plain
   versions swapped in at 3, 9 and 38 layers of the same weights: at 3
   layers its logits within a relative L2 error of 5e-2 of the kernels'
   (the deeper ones are reported: the seeded model's attention is nearly
   one-hot, since the reference's init gives q rms 16 and k rms 64, so a
   rounding difference can flip a near-tie, and depth amplifies it), the
   RG-LRU kernel against its plain version on the inputs the model gave its
   first call, and the flash kernel's reading on those of its first call;
10. the LM kernels at their paths' shapes: flash attention and RG-LRU at
   each batch size of the serving path (B in 1, 2, 4, 8), each held
   against the plain version together with the earlier design it
   replaced (``flash_attention_sync_cuda``, ``rglru_serial_cuda``), the
   two times, ``scaled_dot_product_attention``'s (flash) and the bound,
   and the plain version's time at B = 8; the SSD at B = 8 against the
   plain version, kernel and plain times beside the bound; the bf16 SSD
   kernel also against the plain version of its own
   arithmetic (``ssd_chunked_bf16ops_ref``), and its time beside that of
   the earlier f32 CUDA-core kernel at the same shape;
11. the serving path (the main path, part 4) at mamba2-370m's full width
   and depth (368,178,688 bf16 parameters from ``--seed``, 48 SSM layers):
   the same entry points over prompts of 32,768 tokens (``prefill_32k``'s
   length; its batch of 32 is cut to buckets up to 8); logits finite and
   (n, 50280), every modelled deadline met, 48 SSD launches per prefill
   call (by batch size) and the plain versions never called on a CUDA
   tensor; then one
   batch of 2 with the plain SSD swapped in: at 8 layers the logits within
   a relative L2 error of 5e-2 of the kernels', at all 48 within twice the
   distance between two plain paths that differ only in chunk (the seeded
   model amplifies bf16 roundings with depth); the kernel against its plain
   version on the inputs the model gave its first call, and a profile of
   one batch of 8;
12. pane-shared scans at the paper's scale (run after phase 7, on its
   stream): ``run_shared_jobs`` for CQ3 and TPC-Q6-like over four sliding
   windows of 3,000 files (slide 500, so GCD panes of 500 files), each with
   phase 4's measured cost model under ``llf-dynamic``, shared and
   unshared; every window's aggregate against its float64 host one-shot
   and shared against unshared, pane-cache hits, and ``pane_segagg`` run on
   the card with the plain version never called on a CUDA tensor; wall
   seconds, rows scanned, the pane store's counters and the kernel each
   composite key space (panes x G) took are readings;
13. a recurring session over the real backend (after phase 12):
   ``run_session`` for CQ4 over three tumbling windows of 1,500 files with
   the files' own arrival times, phase 4's CQ4 model and ``calibrate=True``;
   each window's aggregate against its float64 one-shot, all three windows
   complete, three ``window_open`` events; modelled finishes, refits and
   batch seconds are readings;
14. online admission on the LM path (after phase 9, on its executor and
   calibrated model): ``serve_session`` with two feasible jobs (4 and 6
   prompts) submitted at staggered instants and one whose deadline lies
   below its least cost; the two admitted and completed with finite (n,
   256000) logits, the third rejected with no prefill run for it, and
   flash-attention and RG-LRU launched once per layer of their kind in every
   prefill call, with no plain version called on a CUDA tensor.

Phases 12-14 count their launches apart from phases 4-5 (phase 6's counts)
and the serving paths; the result line carries them under
``launches_by_phase``.

Each parity line prints the largest absolute error and its worst ratio to
the ``torch.allclose`` limit ``atol + rtol |want|`` (the check passes up to
1).  The line before the last is a JSON object with one entry per kernel
(flash and RG-LRU at B = 8, with ``old_ms``, the earlier design's time; the
cluster-table scatter at CQ3 with ``old_ms`` and its plan); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
# Float sums: f32 atomics add in an order that changes from run to run; a
# group summing m terms drifts by about sqrt(m) * 2^-24 relative (observed up
# to 2e-5 for 13M rows into one group through scatter).  Counts are exact.
FLOAT_RTOL = 1e-4
PARITY_FILES = 97           # N = 97 lineitem files = 1,261,000 rows, no block multiple
PANE_GROUPS = 16_000_000    # a pane scan's composite key space (panes x groups)
# Phase 4's calibration batch sizes in files: measure_cost_model's default
# (1, 4, 16, 64) and sizes that span the single-query plans' batches.
CALIBRATION_FILES = (1, 4, 16, 64, 256, 1024, 2048, 3072)
CROSSOVER_GROUPS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                    8192, 12288)
# LM kernels: bf16 output against the plain version in f32 (bf16 rounds the
# inputs, p and the output); the RG-LRU state stays f32 in both.
BF16_TOL = 2e-2
STATE_TOL = 2e-4
LOGITS_REL_L2 = 5e-2        # kernel path against plain path, full width
# mamba2-370m at 48 layers: the kernel path within twice the distance between
# two plain paths that differ only in their chunk (64 against 128), that is
# in f32 summation order (PERF.md: the seeded model amplifies bf16 roundings
# of y with depth, to a relative L2 of 0.2 at 48 layers for either pair).
NOISE_RATIO = 2.0
SSM_GATE_UNITS = 8          # the absolute LOGITS_REL_L2 gate: 8 of the 48 layers
# SSD: the JAX package's tolerances (tests/test_kernels.py TestSSD): y 2e-4 in
# f32 and 3e-2 in bf16; h_last rtol 2e-3 with atol 2e-3 (f32), 5e-3 (bf16).
SSD_Y_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
SSD_H_ATOL = {torch.float32: 2e-3, torch.bfloat16: 5e-3}
SSD_H_RTOL = 2e-3
# The bf16 SSD kernel against the plain version of its own arithmetic
# (tests/test_torch_cuda.py): y within 1e-2.
SSD_BF16OPS_Y_TOL = 1e-2
SSD_CUDA_CORE_MS = 45.6586  # PERF.md row 4: the CUDA-core kernel at the path's shape
SSD_DESIGN = "CUDA C++ sm_90a, mma.sync bf16 (f32: CUDA cores)"
SERVE_ARCH = "recurrentgemma_9b"
SERVE_SEQ = 4096            # twice the local-attention window
SERVE_BUCKETS = (1, 2, 4, 8)
LM_BATCHES = SERVE_BUCKETS  # phase 10 times flash and RG-LRU at each
KERNEL_REPS = 20            # phase 10's launches per timing of those two (0.07-8 ms each)
SSM_ARCH = "mamba2_370m"
SSM_SEQ = 32768             # models/base.py SHAPES["prefill_32k"].seq_len
SSM_SWAP_BATCH = 2          # the plain SSD's f32 intermediates at 48 layers
# examples/multi_query_serving.py's jobs: (prompts, window s, slack)
MULTI_JOBS = ((24, 30.0, 3.0), (16, 20.0, 2.0), (32, 40.0, 2.5))
# Phase 12: benchmarks/bench_shared_panes.py's sliding regime at the paper's
# window: (stream offset, files), slide 500, range 3,000, 6x overlap.
SHARED_WINDOWS = ((0, 3000), (500, 3000), (1000, 3000), (1500, 3000))
SHARED_QUERIES = ("CQ3", "TPC-Q6-like")
SESSION_FILES = 1500        # phase 13: three tumbling windows of the stream
# Phase 14: (job, prompts, window start s, window s, deadline slack in
# cost(n) units, submit instant s); the last one's deadline lies below the
# cost(1) its final prompt needs after the window closes.
ADMISSION_JOBS = (("feasible-4", 4, 0.0, 10.0, 2.0, 0.0),
                  ("feasible-6", 6, 5.0, 10.0, 2.0, 5.0),
                  ("infeasible", 3, 2.0, 10.0, None, 2.0))


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 3 -----------------------------------------------------------------

def kernel_parity(kernels, segagg_ref, rows: int) -> None:
    gen = torch.Generator().manual_seed(0)
    for name, fn, groups in kernels:
        for g in groups:
            for v in (1, 3):
                keys = torch.randint(0, g, (rows,), generator=gen, dtype=torch.int32)
                bad = torch.rand(rows, generator=gen) < 0.01
                wild = torch.randint(1, g + 2, (rows,), generator=gen, dtype=torch.int32)
                keys = torch.where(bad & (wild % 2 == 0), -wild, keys)
                keys = torch.where(bad & (wild % 2 == 1), g - 1 + wild, keys).cuda()
                ones = torch.ones((rows, v), device="cuda")
                vals = torch.rand((rows, v), generator=gen).cuda()
                got, want = fn(keys, ones, g), segagg_ref(keys, ones, g)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} G={g} V={v}: counts differ")
                got = fn(keys, vals, g).double()
                want = segagg_ref(keys, vals.double(), g)
                if not torch.allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
                    raise AssertionError(f"{name} G={g} V={v}: float sums differ")
                err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
                log(f"  parity {name:21s} N={rows} G={g:>9} V={v}: counts equal, "
                    f"float rel err {err:.3e}")
        empty = fn(torch.zeros(0, dtype=torch.int32, device="cuda"),
                   torch.zeros((0, 3), device="cuda"), 5)
        if empty.shape != (5, 3) or empty.abs().sum().item() != 0.0:
            raise AssertionError(f"{name}: empty input must give zeros")
        log(f"  parity {name:21s} empty input: zeros (5, 3)")


def zipf_parity(kernels, segagg_ref, zipf_keys, rows: int, g: int) -> None:
    """Each kernel against the plain version under Zipf keys (7.5% of the
    rows in one group at 360K groups): counts exact, float sums within
    ``FLOAT_RTOL``."""
    keys = zipf_keys(rows, g, seed=2, device="cuda")
    ones = torch.ones((rows, 1), device="cuda")
    vals = torch.rand((rows, 1), generator=torch.Generator().manual_seed(2)).cuda()
    for name, fn in kernels:
        if not torch.equal(fn(keys, ones, g), segagg_ref(keys, ones, g)):
            raise AssertionError(f"{name} G={g} Zipf keys: counts differ")
        got, want = fn(keys, vals, g).double(), segagg_ref(keys, vals.double(), g)
        if not torch.allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
            raise AssertionError(f"{name} G={g} Zipf keys: float sums differ")
        err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        log(f"  parity {name:21s} N={rows} G={g:>9} V=1, Zipf keys: counts equal, "
            f"float rel err {err:.3e}")


# -- phases 4-5 --------------------------------------------------------------

def host_oneshot(aq, files, num_groups: int) -> np.ndarray:
    """The whole window aggregated at once on the host in float64."""
    keys = np.concatenate([np.asarray(aq.key_fn(f)) for f in files])
    vals = np.concatenate([np.asarray(aq.value_fn(f), np.float64) for f in files])
    out = np.zeros((num_groups, vals.shape[1]), np.float64)
    for j in range(vals.shape[1]):
        np.add.at(out[:, j], keys, vals[:, j])
    return out


def check_result(qid: str, got: np.ndarray, want: np.ndarray) -> str:
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{qid}: result shape {got.shape}, want {want.shape}")
    if qid == "TPC-Q6-like":  # a float sum
        if not np.allclose(got, want, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(f"{qid}: {got.ravel()} vs host {want.ravel()}")
        return f"rel err {np.abs(got - want).max() / np.abs(want).max():.2e}"
    if not np.array_equal(got.astype(np.float64), want):
        raise AssertionError(f"{qid}: counts differ from the host one-shot")
    return "counts exact"


def finish_time(plan, batch_seconds, agg_s: float) -> float:
    """Completion instant of ``plan`` with these batch seconds (measured, or
    the cost model's): a batch starts at its trigger or when the last
    ended, and the final aggregation follows the last batch."""
    t = 0.0
    for point, secs in zip(plan.sch_points, batch_seconds):
        t = max(t, point) + secs
    return t + agg_s


def outcome(finish: float, deadline: float) -> str:
    return ("met" if finish <= deadline
            else f"MISSED by {(finish - deadline) * 1e3:.3f} ms")


def staggered(queries, delta: float, c_max: float, seed: int = 0):
    """§7.4's staggered deadlines (as ``repro.core.simulator`` makes them)."""
    qs = list(queries)
    random.Random(seed).shuffle(qs)
    out, prev = [], None
    for q in qs:
        c1 = q.cost_model.cost(q.num_tuples_total)
        d = (q.wind_end + delta * c1 + c_max if prev is None or q.wind_end > prev
             else prev + delta * c1)
        out.append(dataclasses.replace(q, deadline=d))
        prev = d
    return out


# -- phase 7 -----------------------------------------------------------------

def kernel_times(name: str, fn, keys, vals, g: int, exact: bool, segagg_ref,
                 flops_bytes) -> dict:
    """Holds ``fn`` against the plain version at this shape (counts by
    ``torch.equal`` when ``exact``, else float sums within ``FLOAT_RTOL`` of
    the plain version in float64), then times both and ``index_add_``."""
    def library():
        out = torch.zeros((g, vals.shape[1]), device="cuda")
        out.index_add_(0, keys, vals)

    if exact and not torch.equal(fn(keys, vals, g), segagg_ref(keys, vals, g)):
        raise AssertionError(f"{name} N={keys.shape[0]} G={g}: counts differ")
    got = fn(keys, vals, g).double()
    want = segagg_ref(keys, vals.double(), g)
    if not torch.allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
        raise AssertionError(f"{name} N={keys.shape[0]} G={g}: float sums differ")
    ops, nbytes = flops_bytes(keys.shape[0], g, vals.shape[1])
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {
        "max_abs_err": (got - want).abs().max().item(),
        "ms": cuda_ms(lambda: fn(keys, vals, g)),
        "plain_ms": cuda_ms(lambda: segagg_ref(keys, vals, g)),
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": cuda_ms(library),
    }


# -- phase 8 -----------------------------------------------------------------

def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / (1 + |want|)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (1.0 + want.abs())).max().item()


def worst_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|): ``torch.allclose``
    holds exactly when it is at most 1."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def check_close(what: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple:
    """``got`` within ``tol`` of ``want`` (absolute plus relative, as
    ``torch.allclose``); returns the largest absolute error and the worst
    ratio of |got - want| to ``tol + tol |want|``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite values")
    ratio = worst_ratio(got, want, tol, tol)
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max abs err {(got - want).abs().max().item():.3e}, "
                             f"worst ratio {ratio:.3f} to {tol} + {tol} |want|")
    return (got - want).abs().max().item(), ratio


def shown(err: tuple) -> str:
    """A ``check_close`` result as printed: the largest absolute error, then
    the worst ratio to the allclose limit (which passes up to 1)."""
    return f"{err[0]:.3e} ({err[1]:.3f} of the allclose limit)"


def sharpness(q: torch.Tensor, k: torch.Tensor, window: int) -> str:
    """Attention-score statistics of batch row 0, head 0 (causal, windowed):
    the share of query rows whose softmax puts over 0.99 on one key."""
    s = (q[0, :, 0].float() @ k[0, :, 0].float().T) / q.shape[-1] ** 0.5
    pos = torch.arange(q.shape[1], device=q.device)
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return (f"first attention layer's inputs: q rms {q.float().pow(2).mean().sqrt().item():.1f}, "
            f"k rms {k.float().pow(2).mean().sqrt().item():.1f}, score |max| "
            f"{s[ok].abs().max().item():.0f}, rows with max p > 0.99: "
            f"{(p.amax(-1) > 0.99).float().mean().item():.1%}")


def lm_kernel_parity(flash_cuda, flash_plain, rglru_cuda, rglru_plain) -> None:
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    # (B, S, H, Hkv, D, causal, window, cap)
    cases = [(2, 1000, 8, 8, 64, True, 0, 0.0), (2, 1000, 8, 8, 64, False, 0, 0.0),
             (1, 777, 16, 2, 128, True, 256, 0.0), (1, 777, 16, 2, 128, True, 0, 50.0),
             (2, 1500, 16, 1, 256, True, 512, 0.0), (1, 1500, 16, 1, 256, False, 0, 30.0),
             (1, 4096, 16, 1, 256, True, 2048, 0.0)]
    for B, S, H, Hkv, D, causal, window, cap in cases:
        sc = 3.0 if cap else 1.0
        q = randn(B, S, H, D, scale=sc).bfloat16()
        k = randn(B, S, Hkv, D, scale=sc).bfloat16()
        v = randn(B, S, Hkv, D).bfloat16()
        got = flash_cuda(q, k, v, causal, window, cap)
        want = flash_plain(q.float(), k.float(), v.float(), causal, window, cap)
        err = check_close(f"flash B={B} S={S} H={H}/{Hkv} D={D}", got, want, BF16_TOL)
        log(f"  parity flash_attention B={B} S={S:>4} H={H:>2} Hkv={Hkv} D={D:>3} "
            f"causal={causal!s:5} window={window:>4} cap={cap:>4}: max abs err {shown(err)}")
    for B, S, N in ((1, 1000, 4096), (8, 777, 4096), (1, 333, 1000), (8, 129, 33)):
        x = randn(B, S, N)
        r, i = torch.sigmoid(randn(B, S, N)), torch.sigmoid(randn(B, S, N))
        a_param, h0 = randn(N), randn(B, N)
        xb, rb, ib = x.bfloat16(), r.bfloat16(), i.bfloat16()
        y, h = rglru_cuda(xb, rb, ib, a_param, h0)
        y_ref, h_ref = rglru_plain(xb.float(), rb.float(), ib.float(), a_param, h0)
        err_y = check_close(f"rglru y B={B} S={S} N={N}", y, y_ref, BF16_TOL)
        err_h = check_close(f"rglru h_last B={B} S={S} N={N}", h, h_ref, STATE_TOL)
        y32, h32 = rglru_cuda(x, r, i, a_param, None)
        y_ref, h_ref = rglru_plain(x, r, i, a_param, None)
        check_close(f"rglru f32 B={B} S={S} N={N}", y32, y_ref, STATE_TOL)
        check_close(f"rglru f32 h_last B={B} S={S} N={N}", h32, h_ref, STATE_TOL)
        log(f"  parity rglru           B={B} S={S:>4} N={N:>4}: bf16 y max abs err "
            f"{shown(err_y)}, h_last {shown(err_h)}; f32 within {STATE_TOL}")


def ssd_inputs(gen, B, S, H, P, N, dtype, shared, with_h0):
    """Seeded SSD inputs on the card, drawn as the JAX package's SSD test
    draws them; B and C head-shared (stride-0 views, as the model passes
    them) or per head."""
    import torch.nn.functional as F

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    x = randn(B, S, H, P, scale=0.5).to(dtype)
    dt = F.softplus(randn(B, S, H)).to(dtype)
    A = -randn(H).abs() - 0.1
    if shared:
        Bm = randn(B, S, N, scale=0.3).to(dtype)[:, :, None].expand(B, S, H, N)
        Cm = randn(B, S, N, scale=0.3).to(dtype)[:, :, None].expand(B, S, H, N)
    else:
        Bm, Cm = randn(B, S, H, N, scale=0.3).to(dtype), randn(B, S, H, N, scale=0.3).to(dtype)
    return x, dt, A, Bm, Cm, randn(H), (randn(B, H, N, P) if with_h0 else None)


def check_ssd(what, ssd_cuda, ssd_plain, args):
    """The SSD kernel against its plain version taken in f32 on the same
    inputs (B and C are widened chunk by chunk inside it); returns the
    largest absolute errors of y and h_last."""
    x, dt, A, Bm, Cm, D, h0 = args
    y, h = ssd_cuda(*args)
    y_ref, h_ref = ssd_plain(x.float(), dt.float(), A, Bm, Cm, D, 128, h0)
    err_y = check_close(f"{what} y", y, y_ref, SSD_Y_TOL[x.dtype])
    if h.shape != h_ref.shape or not torch.allclose(h, h_ref, rtol=SSD_H_RTOL,
                                                    atol=SSD_H_ATOL[x.dtype]):
        raise AssertionError(f"{what} h_last: max abs err "
                             f"{(h - h_ref).abs().max().item():.3e} above rtol "
                             f"{SSD_H_RTOL}, atol {SSD_H_ATOL[x.dtype]}")
    return err_y, ((h - h_ref).abs().max().item(),
                   worst_ratio(h, h_ref, SSD_H_RTOL, SSD_H_ATOL[x.dtype]))


def worst(errs) -> tuple:
    """The largest absolute error and the worst ratio of several
    ``check_close`` results (each taken over all of them)."""
    errs = list(errs)
    return max(e[0] for e in errs), max(e[1] for e in errs)


def ssd_kernel_parity(ssd_cuda, ssd_plain) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4)
    for H, P, N in ((32, 64, 128), (4, 40, 16)):
        for B in (1, 2, 8):  # P-tiles of 16, 32 and 64 columns at mamba2's shape
            for S in (1000, 512):
                for dtype in (torch.bfloat16, torch.float32):
                    errs = []
                    for shared in (True, False):
                        for with_h0 in (False, True):
                            args = ssd_inputs(gen, B, S, H, P, N, dtype, shared, with_h0)
                            errs.append(check_ssd(
                                f"ssd B={B} S={S} H={H} P={P} N={N} {dtype} "
                                f"shared={shared} h0={with_h0}", ssd_cuda, ssd_plain, args))
                    log(f"  parity ssd             B={B} S={S:>4} H={H:>2} P={P} N={N:>3} "
                        f"{str(dtype)[6:]:8s} (B, C shared or per head; h0 or none): "
                        f"y max abs err {shown(worst(e[0] for e in errs))}, h_last "
                        f"{shown(worst(e[1] for e in errs))}")


# -- phase 9 -----------------------------------------------------------------

def serving_path(args, cfg, seq, lm, engine, core, counters):
    """The LM serving main path at full width over prompts of ``seq``
    tokens; fails unless every job meets its modelled deadline with finite
    (n, V) logits.  Returns the prefill executor, its calibrated cost model,
    one batch of prompts and the launch counts of the path."""
    from repro_torch.models.params import init_params, num_params

    specs = lm.build_specs(cfg)
    t0 = time.perf_counter()
    params = init_params(specs, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"    {cfg.name}: {num_params(specs):,} parameters, bf16, seeded init on the "
        f"card in {time.perf_counter() - t0:.1f} s; {len(cfg.segments)} segments, "
        f"{cfg.num_layers} layers, window {cfg.window}, prompts of {seq} tokens")
    ex = engine.PrefillExecutor(cfg, params, buckets=SERVE_BUCKETS, device="cuda")
    batches = []   # (n, wall s) of every run_batch call
    run_batch = ex.run_batch

    def recorded(prompts):
        out, dt = run_batch(prompts)
        if prompts.shape[0] <= SERVE_BUCKETS[-1]:
            batches.append((prompts.shape[0], dt))
        return out, dt

    ex.run_batch = recorded
    rng = np.random.default_rng(args.seed)
    mk = lambda n: rng.integers(0, cfg.vocab_size, (n, seq)).astype(np.int32)  # noqa: E731

    counters.reset()
    t0 = time.perf_counter()
    cm = ex.calibrate(seq, cfg.vocab_size)
    t_cal = time.perf_counter() - t0
    log(f"  calibrate {t_cal:.1f} s: cost(b) = "
        + ", ".join(f"{b}: {cm.cost(b) * 1e3:.1f} ms" for b in SERVE_BUCKETS)
        + f"; batch walls {[round(dt * 1e3, 1) for _, dt in batches]} ms")
    jobs_out = []
    n1 = MULTI_JOBS[0][0]
    job = engine.WindowJob("single", mk(n1), core.UniformWindowArrival(0.0, 30.0, n1),
                           deadline=30.0 + 1.0 * cm.cost(n1))
    del batches[:]
    t0 = time.perf_counter()
    r = engine.serve_single_job(job, ex, cm, policy="single")
    log(f"  serve_single_job {time.perf_counter() - t0:.1f} s: {r['num_batches']} batches "
        f"{[b for b, _ in batches]}, walls {[round(dt * 1e3, 1) for _, dt in batches]} ms; "
        f"modelled finish {r['modelled_finish']:.2f} vs deadline {r['deadline']:.2f}: "
        f"{'met' if r['met_modelled'] else 'MISSED'}; processed {r['processed']}/{n1}")
    jobs_out.append((job, r["met_modelled"]))
    jobs = [engine.WindowJob(f"job{i}", mk(n), core.UniformWindowArrival(0.0, w, n),
                             deadline=w + slack * cm.cost(n))
            for i, (n, w, slack) in enumerate(MULTI_JOBS)]
    del batches[:]
    t0 = time.perf_counter()
    report = engine.serve_multi_jobs(jobs, ex, cm, core.Strategy.LLF, delta_rsf=0.5)
    log(f"  serve_multi_jobs (LLF) {time.perf_counter() - t0:.1f} s: "
        f"{len(batches)} batches {[b for b, _ in batches]}, "
        f"walls {[round(dt * 1e3, 1) for _, dt in batches]} ms")
    for j in jobs:
        o = report[j.job_id]
        log(f"    {j.job_id}: {o['num_batches']} batches, modelled finish "
            f"{o['completion']:.2f} vs deadline {o['deadline']:.2f}: "
            f"{'met' if o['met_modelled'] else 'MISSED'}; processed "
            f"{o['processed']}/{j.num_requests}; wall {o['wall_exec_seconds']:.2f} s")
        jobs_out.append((j, o["met_modelled"]))
    launches = counters.read()
    met = sum(m for _, m in jobs_out)
    log(f"  modelled deadlines met {met}/{len(jobs_out)}")
    if met != len(jobs_out):
        raise AssertionError(f"{cfg.name}: {len(jobs_out) - met} jobs missed their "
                             f"modelled deadlines")
    for j, _ in jobs_out:
        out = np.concatenate(j.results)
        if j.processed != j.num_requests or out.shape != (j.num_requests, cfg.vocab_size) \
                or not np.isfinite(out).all():
            raise AssertionError(f"{j.job_id}: processed {j.processed}, logits {out.shape}")
    return ex, cm, mk(SERVE_BUCKETS[-1]), launches


# -- phases 12-13 ------------------------------------------------------------

def pane_oneshots(aq, files, width: int, num_groups: int) -> list:
    """Float64 host aggregates of each run of ``width`` files, by
    ``np.bincount``; a window made of whole panes sums its panes'."""
    out = []
    for lo in range(0, len(files), width):
        keys = np.concatenate([np.asarray(aq.key_fn(f)) for f in files[lo:lo + width]])
        vals = np.concatenate([np.asarray(aq.value_fn(f), np.float64)
                               for f in files[lo:lo + width]])
        out.append(np.stack([np.bincount(keys, weights=vals[:, j], minlength=num_groups)
                             for j in range(vals.shape[1])], axis=1))
    return out


class SegaggRecorder:
    """Rows scanned by the analytics executors' ``segagg`` and
    ``pane_segagg`` calls, the kernel each call launched by composite key
    space, the calls on CUDA tensors, the plain version's calls on CUDA
    tensors, and the host seconds spent in ``concat_files`` and in the two
    calls (synchronised: the caller's spill waits for the card anyway), over
    one phase (the module attributes are swapped for recorders while the
    phase runs)."""

    def __init__(self, analytics, ops, segagg_ref, kernels):
        self.analytics, self.ops, self.segagg_ref, self.kernels = (
            analytics, ops, segagg_ref, kernels)
        self.real = {n: getattr(analytics, n)
                     for n in ("segagg", "pane_segagg", "concat_files")}

    def counts(self) -> dict:
        return {n: k.launches for n, k in self.kernels.items()}

    def __enter__(self):
        self.rows = {"segagg": 0, "pane_segagg": 0}
        self.cuda_calls = {"segagg": 0, "pane_segagg": 0}
        self.seconds = {"segagg": 0.0, "pane_segagg": 0.0, "concat_files": 0.0}
        self.plain_cuda = 0
        self.routes = {}   # (call, panes, composite G) -> {kernel: launches}
        for k in self.kernels.values():
            k.launches = 0

        def plain(keys, values, num_groups):
            self.plain_cuda += values.is_cuda
            return self.segagg_ref(keys, values, num_groups)

        def concat(files):
            t0 = time.perf_counter()
            out = self.real["concat_files"](files)
            self.seconds["concat_files"] += time.perf_counter() - t0
            return out

        def recorder(name):
            def call(keys, values, *a, **kw):
                before = self.counts()
                t0 = time.perf_counter()
                out = self.real[name](keys, values, *a, **kw)
                if out.is_cuda:
                    torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                self.rows[name] += keys.shape[0]
                self.cuda_calls[name] += keys.is_cuda
                panes, g = (a[1], a[2]) if name == "pane_segagg" else (1, a[0])
                row = self.routes.setdefault((name, panes, panes * g), {})
                for n, c in self.counts().items():
                    if c > before[n]:
                        row[n] = row.get(n, 0) + c - before[n]
                return out
            return call

        self.ops.segagg_ref = plain
        for n in ("segagg", "pane_segagg"):
            setattr(self.analytics, n, recorder(n))
        self.analytics.concat_files = concat
        return self

    def __exit__(self, *exc):
        self.ops.segagg_ref = self.segagg_ref
        for n, fn in self.real.items():
            setattr(self.analytics, n, fn)
        self.launches = self.counts()
        return False


def shared_scans(aq, files, model, sc, rec, run_shared_jobs) -> None:
    """Phase 12 for one query: ``run_shared_jobs`` shared and unshared over
    ``SHARED_WINDOWS``; every window against its float64 host one-shot, and
    shared against unshared."""
    g = aq.num_groups(sc)
    slide = SHARED_WINDOWS[1][0] - SHARED_WINDOWS[0][0]
    panes = pane_oneshots(aq, files[:max(lo + n for lo, n in SHARED_WINDOWS)], slide, g)
    runs = {}
    for share in (True, False):
        rows_before, secs_before = dict(rec.rows), dict(rec.seconds)
        t0 = time.perf_counter()
        results, trace, book = run_shared_jobs(aq, files, SHARED_WINDOWS, sc, model,
                                               policy="llf-dynamic", share=share,
                                               device="cuda")
        wall = time.perf_counter() - t0
        verdicts = []
        for i, (lo, n) in enumerate(SHARED_WINDOWS):
            want = np.sum(panes[lo // slide:(lo + n) // slide], axis=0)
            verdicts.append(check_result(aq.query_id, results[f"{aq.query_id}-w{i}"], want))
        batches = [e.num_tuples for e in trace.executions if e.kind == "batch"]
        st = book.store.stats
        scanned = {k: rec.rows[k] - rows_before[k] for k in rec.rows}
        secs = {k: rec.seconds[k] - secs_before[k] for k in rec.seconds}
        device_s = secs["segagg"] + secs["pane_segagg"]
        log(f"  {aq.query_id:12s} share={share!s:5}: {wall:.3f} s wall ({secs['concat_files']:.3f} "
            f"in concat_files, {device_s:.3f} in segagg and pane_segagg calls, "
            f"{wall - secs['concat_files'] - device_s:.3f} else), {len(batches)} batches "
            f"(files: {sorted(set(batches))}), rows scanned {sum(scanned.values())} "
            f"({scanned['pane_segagg']} by pane_segagg); pane width "
            f"{book.widths.get(f'{aq.query_id}-stream', 'none')}; store scans {st.scans}, "
            f"hits {st.hits}, fragment scans {st.fragment_scans}, evictions "
            f"{st.evictions}, peak resident {st.peak_resident}; windows {verdicts}; "
            f"modelled deadlines met {sum(o.met_deadline for o in trace.outcomes)}/"
            f"{len(trace.outcomes)}")
        runs[share] = (results, wall, sum(scanned.values()), st)
    (shared, wall_s, rows_s, st), (unshared, wall_u, rows_u, _) = runs[True], runs[False]
    for key in shared:
        check_result(aq.query_id, shared[key], unshared[key].astype(np.float64))
    if st.hits <= 0:
        raise AssertionError(f"{aq.query_id}: the shared run never hit the pane cache")
    log(f"  {aq.query_id:12s} shared against unshared: wall {wall_s:.3f} / {wall_u:.3f} s "
        f"({wall_u / wall_s:.2f}x), rows scanned {rows_s} / {rows_u} "
        f"({rows_u / rows_s:.2f}x); results equal")


def pane_id_cost(aq, files, count: int, width: int) -> str:
    """The host cost of ``_scan_panes``'s pane ids for ``count`` panes of
    ``width`` files (its own arithmetic), and their copy to the card."""
    chunk = files[:count * width]
    t0 = time.perf_counter()
    sizes = [len(next(iter(f.values()))) for f in chunk]
    pane_of_file = np.repeat(np.arange(count, dtype=np.int32), width)[: len(chunk)]
    pane_ids = np.repeat(pane_of_file, sizes).astype(np.int32)
    t1 = time.perf_counter()
    torch.from_numpy(pane_ids).cuda()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (f"{count} pane(s) of {width} files: {pane_ids.size} pane ids, "
            f"{pane_ids.nbytes / 1e6:.1f} MB, np.repeat {(t1 - t0) * 1e3:.2f} ms, "
            f"copy in {(t2 - t1) * 1e3:.2f} ms")


def session_windows(aq, files, times, model, sc, run_session, analytics) -> None:
    """Phase 13: ``run_session`` over three tumbling windows of
    ``SESSION_FILES`` files with their own arrival times, calibrating."""
    g = aq.num_groups(sc)
    nw = len(files) // SESSION_FILES
    windows = [files[w * SESSION_FILES:(w + 1) * SESSION_FILES] for w in range(nw)]
    stamps = [times[w * SESSION_FILES:(w + 1) * SESSION_FILES] for w in range(nw)]
    wants = [np.sum(pane_oneshots(aq, w, SESSION_FILES, g), axis=0) for w in windows]
    batches = []   # (rows, wall s) of every process_batch call
    process = analytics.AnalyticsExecutor.process_batch

    def recorded(self, *a, **kw):
        res = process(self, *a, **kw)
        batches.append((res.num_records, res.seconds))
        return res

    analytics.AnalyticsExecutor.process_batch = recorded
    try:
        t0 = time.perf_counter()
        results, trace = run_session(aq, windows, stamps, sc, model,
                                     period=float(SESSION_FILES), calibrate=True,
                                     device="cuda")
        wall = time.perf_counter() - t0
    finally:
        analytics.AnalyticsExecutor.process_batch = process
    if sorted(results) != list(range(nw)):
        raise AssertionError(f"session windows completed: {sorted(results)} of {nw}")
    series = trace.outcome_series(aq.query_id)
    opened = [e.kind for e in trace.events].count("window_open")
    if len(series) != nw or not all(o.complete for o in series) or opened != nw:
        raise AssertionError(f"session: {len(series)} outcomes, {opened} window_open events")
    refits = trace.events_for("recalibrate")
    log(f"  {aq.query_id} {nw} windows of {SESSION_FILES} files: {wall:.2f} s wall, "
        f"{len(batches)} batches, {len(refits)} recalibrate events")
    for w, o in enumerate(series):
        log(f"    window {w}: {check_result(aq.query_id, results[w], wants[w])}; "
            f"{o.num_batches} batches, modelled finish {o.completion_time:.4f} vs deadline "
            f"{o.deadline:.4f}: {outcome(o.completion_time, o.deadline)}")
    secs = sorted(dt for _, dt in batches)
    log(f"    batch seconds: min {secs[0] * 1e3:.3f}, median {secs[len(secs) // 2] * 1e3:.3f}, "
        f"max {secs[-1] * 1e3:.3f} ms over batches of {min(r for r, _ in batches)}-"
        f"{max(r for r, _ in batches)} rows; refits: "
        + "; ".join(f"t={e.time:.3f} {e.detail}" for e in refits[:4]))


# -- phase 14 ----------------------------------------------------------------

def admission_path(args, cfg, ex, cm, engine, core, counters) -> dict:
    """``serve_session`` over ``ADMISSION_JOBS``: the feasible jobs
    admitted and served in full, the infeasible one rejected with no prefill
    run for it, every prefill call through the LM kernels.  Returns the
    launch counts of the phase."""
    rng = np.random.default_rng(args.seed + 1)
    jobs, submits = [], []
    for job_id, n, start, span, slack, at in ADMISSION_JOBS:
        deadline = start + span + (0.5 * cm.cost(1) if slack is None else slack * cm.cost(n))
        jobs.append(engine.WindowJob(
            job_id, rng.integers(0, cfg.vocab_size, (n, SERVE_SEQ)).astype(np.int32),
            core.UniformWindowArrival(start, start + span, n), deadline=deadline))
        submits.append(at)
    counters.reset()
    t0 = time.perf_counter()
    report, session = engine.serve_session(jobs, ex, cm, policy="llf-dynamic",
                                           submit_times=submits)
    wall = time.perf_counter() - t0
    got = counters.read()
    for job, (_, _, _, _, slack, _) in zip(jobs, ADMISSION_JOBS):
        row = report[job.job_id]
        log(f"  {job.job_id}: {row}")
        if slack is None:
            if row != {"admitted": False} or job.processed or job.results:
                raise AssertionError(f"{job.job_id} must be rejected and never run")
            continue
        out = np.concatenate(job.results) if job.results else np.zeros((0, 0))
        if not (row["admitted"] and row["completed"]) or job.processed != job.num_requests \
                or out.shape != (job.num_requests, cfg.vocab_size) or not np.isfinite(out).all():
            raise AssertionError(f"{job.job_id}: {row}, logits {out.shape}")
    rejected = [e for e in session.trace.events if e.kind == "reject"]
    log(f"  reject events {[(e.query_id, round(e.time, 3)) for e in rejected]}; session "
        f"clock {session.now:.3f}")
    check_launches(cfg, got, wall)
    return got


# -- phase 10 ----------------------------------------------------------------

def bound(ops: float, nbytes: float, ops_per_s: float):
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def lm_kernel_times(flash_cuda, flash_sync, flash_plain, flash_fb, rglru_cuda,
                    rglru_serial, rglru_plain, rglru_fb) -> dict:
    """Flash attention and RG-LRU at recurrentgemma-9b's prefill shapes for
    each batch size of the serving path (``LM_BATCHES``): the kernel and
    the earlier design it replaced, each held against the plain version,
    their times, SDPA's (flash) and the bound.  Returns the entries of the
    result line at the largest batch."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    Bmax, S, H, Hkv, D, W, N = LM_BATCHES[-1], SERVE_SEQ, 16, 1, 256, 2048, 4096
    q = torch.randn((Bmax, S, H, D), device="cuda", generator=gen).bfloat16()
    k = torch.randn((Bmax, S, Hkv, D), device="cuda", generator=gen).bfloat16()
    v = torch.randn((Bmax, S, Hkv, D), device="cuda", generator=gen).bfloat16()
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    out = {}
    for B in LM_BATCHES:
        qb, kb, vb = q[:B], k[:B], v[:B]
        want = flash_plain(qb, kb, vb, True, W)
        err = check_close(f"flash B={B} at the path's shape", flash_cuda(qb, kb, vb, True, W),
                          want, BF16_TOL)
        err_old = check_close(f"the earlier flash kernel B={B} at the path's shape",
                              flash_sync(qb, kb, vb, True, W), want, BF16_TOL)
        qt, kt, vt = qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        # the yardstick computes the same function (logged, not a gate of the port)
        sdpa_err = (sdpa().transpose(1, 2).float() - want.float()).abs().max().item()
        b_ms, b_by = bound(*flash_fb(B, S, S, H, Hkv, D, True, W), BF16_OPS_PER_S)
        r = {"max_abs_err": err[0],
             "ms": cuda_ms(lambda: flash_cuda(qb, kb, vb, True, W), reps=KERNEL_REPS),
             "old_ms": cuda_ms(lambda: flash_sync(qb, kb, vb, True, W), reps=KERNEL_REPS),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": cuda_ms(sdpa, reps=KERNEL_REPS)}
        log(f"  flash_attention B={B}: kernel {r['ms']:.4f} ms, earlier kernel "
            f"{r['old_ms']:.4f} ({r['old_ms'] / r['ms']:.2f}x), SDPA {r['library_ms']:.4f} "
            f"({r['library_ms'] / r['ms']:.2f}x), bound {b_ms:.4f} by {b_by} "
            f"({b_ms / r['ms']:.1%} of it reached; earlier {b_ms / r['old_ms']:.1%}); max abs "
            f"err {shown(err)}, earlier kernel {shown(err_old)}, SDPA {sdpa_err:.3e}")
        if B == Bmax:
            r["plain_ms"] = cuda_ms(lambda: flash_plain(qb, kb, vb, True, W), reps=2)
            out["flash_attention"] = r
        del want, qt, kt, vt
    del q, k, v
    x = torch.randn((Bmax, S, N), device="cuda", generator=gen).bfloat16()
    r_ = torch.sigmoid(torch.randn((Bmax, S, N), device="cuda", generator=gen)).bfloat16()
    i = torch.sigmoid(torch.randn((Bmax, S, N), device="cuda", generator=gen)).bfloat16()
    a_param = torch.randn((N,), device="cuda", generator=gen)
    h0 = torch.zeros((Bmax, N), device="cuda")
    for B in LM_BATCHES:
        args = (x[:B], r_[:B], i[:B], a_param, h0[:B])
        y_ref, h_ref = rglru_plain(*args)
        errs = []
        for what, fn in (("rglru", rglru_cuda), ("the earlier rglru kernel", rglru_serial)):
            y, h = fn(*args)
            errs.append((check_close(f"{what} B={B} at the path's shape", y, y_ref, BF16_TOL),
                         check_close(f"{what} h_last B={B} at the path's shape", h, h_ref,
                                     STATE_TOL)))
        b_ms, b_by = bound(*rglru_fb(B, S, N), F32_OPS_PER_S)
        r = {"max_abs_err": errs[0][0][0],
             "ms": cuda_ms(lambda: rglru_cuda(*args), reps=KERNEL_REPS),
             "old_ms": cuda_ms(lambda: rglru_serial(*args), reps=KERNEL_REPS),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        log(f"  rglru B={B}: kernel {r['ms']:.4f} ms, earlier kernel {r['old_ms']:.4f} "
            f"({r['old_ms'] / r['ms']:.2f}x), bound {b_ms:.4f} by {b_by} "
            f"({b_ms / r['ms']:.1%} of it reached; earlier {b_ms / r['old_ms']:.1%}); y max "
            f"abs err {shown(errs[0][0])}, h_last {shown(errs[0][1])}; earlier kernel y "
            f"{shown(errs[1][0])}, h_last {shown(errs[1][1])}")
        if B == Bmax:
            r["plain_ms"] = cuda_ms(lambda: rglru_plain(*args), reps=2)
            out["rglru"] = r
    return out


def ssd_kernel_times(ssd_cuda, ssd_plain, ssd_bf16ops, ssd_fb) -> dict:
    """The SSD at mamba2-370m's prefill shape (B 8, S 32,768, H 32, P 64,
    N 128, bf16, B and C head-shared, a zero h0 as prefill passes it):
    parity with the plain version in f32 and with the plain version of the
    bf16 kernel's arithmetic, then kernel and plain times."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, H, P, N = SERVE_BUCKETS[-1], SSM_SEQ, 32, 64, 128
    x, dt, A, Bm, Cm, D, _ = ssd_inputs(gen, B, S, H, P, N, torch.bfloat16, True, False)
    h0 = torch.zeros((B, H, N, P), device="cuda")  # prefill's zeroed cache state
    args = (x, dt, A, Bm, Cm, D, h0)
    err, err_h = check_ssd("ssd at the path's shape", ssd_cuda, ssd_plain, args)
    log(f"  ssd at the path's shape: y max abs err {shown(err)}, h_last {shown(err_h)}")
    err_ops = check_close("ssd at the path's shape against its arithmetic", ssd_cuda(*args)[0],
                          ssd_bf16ops(*args[:6], 128, h0)[0], SSD_BF16OPS_Y_TOL)
    log(f"  ssd against the plain version of its arithmetic: y max abs err {shown(err_ops)} "
        f"(limit {SSD_BF16OPS_Y_TOL})")
    b_ms, b_by = bound(*ssd_fb(B, S, H, P, N), BF16_OPS_PER_S)
    return {"design": SSD_DESIGN, "max_abs_err": err[0], "ms": cuda_ms(lambda: ssd_cuda(*args)),
            "plain_ms": cuda_ms(lambda: ssd_plain(x, dt, A, Bm, Cm, D, 128, h0), reps=2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def plain_swap(ex, batch, units, swaps, first_impls=None):
    """One batch through the first ``units`` units of segment 0 (all
    segments when None), with the kernels (or ``first_impls``, one per
    swap) and again with their plain versions swapped in.  ``swaps`` lists
    (ops module, kernel attribute, plain version).  Returns (relative L2
    error of the logits, argmax agreement, first run s, plain s, the inputs
    of each kernel's first call by attribute)."""
    from repro_torch.models.config import Segment
    from repro_torch.serve.engine import PrefillExecutor

    cfg, params = ex.cfg, ex.params
    if units is not None:
        cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, units),))
        params = {k: (v[:units] if k.startswith("seg0/") else v)
                  for k, v in params.items() if not k.startswith("seg") or
                  k.startswith("seg0/")}
    cut = PrefillExecutor(cfg, params, buckets=(batch.shape[0],), device="cuda")
    kernels = [getattr(mod, attr) for mod, attr, _ in swaps]
    impls = kernels if first_impls is None else first_impls
    first = {}

    def recorder(attr, kernel):
        def rec(*a):
            first.setdefault(attr, tuple(t.clone() if torch.is_tensor(t) else t for t in a))
            return kernel(*a)
        return rec

    for (mod, attr, _), impl in zip(swaps, impls):
        setattr(mod, attr, recorder(attr, impl))
    try:
        logits_k, t_k = cut.run_batch(batch)
        for mod, attr, plain in swaps:
            setattr(mod, attr, plain)
        logits_p, t_p = cut.run_batch(batch)
    finally:
        for (mod, attr, _), kernel in zip(swaps, kernels):
            setattr(mod, attr, kernel)
    if not (np.isfinite(logits_k).all() and np.isfinite(logits_p).all()):
        raise AssertionError("non-finite logits in the kernel/plain comparison")
    rel = float(np.linalg.norm(logits_k - logits_p) / np.linalg.norm(logits_p))
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).mean())
    return rel, agree, t_k, t_p, first


def profile_batch(ex, batch) -> None:
    """Where one prefill batch's device time goes, by kernel class, and the
    device's idle share of the batch's wall time (``torch.profiler``; the
    kernels run on one stream, so busy time is the sum of kernel times).
    Logged only: a profiler that records no device time is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ex.run_batch(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.run_batch(batch)
        wall_us = (time.perf_counter() - t0) * 1e6
    ours = {"flash_fwd_kernel": "flash_attention", "rglru_kernel": "rglru",
            "ssd_kernel": "ssd", "ssd_mma_kernel": "ssd"}
    classes = dict.fromkeys([*ours.values(), "matmul", "other"], 0.0)
    count = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name, dt = evt.name, evt.time_range.elapsed_us()
        count += 1
        mine = [c for tag, c in ours.items() if tag in name]
        if mine:
            classes[mine[0]] += dt
        elif any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
            classes["matmul"] += dt
        else:
            classes["other"] += dt
    busy = sum(classes.values())
    if not count or busy <= 0:
        log("    profiler: no device time recorded")
        return
    log(f"    profile of one batch of {batch.shape[0]}: wall {wall_us / 1e3:.1f} ms, "
        f"{count} kernels, device busy {busy / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_us):.1%}; by class (ms, share of busy): " + ", ".join(
            f"{k} {v / 1e3:.1f} ({v / busy:.1%})" for k, v in classes.items() if v))


KIND_KERNEL = {"attn": "flash_attention", "rglru": "rglru", "ssm": "ssd"}


def check_launches(cfg, got: dict, wall_s: float) -> None:
    """Each LM kernel launched once per layer of its kind in every prefill
    call of the path, and no plain version called on a CUDA tensor."""
    calls = got["prefill_calls"]
    want = {k: calls * sum(seg.pattern.count(kind) * seg.num_units for seg in cfg.segments)
            for kind, k in KIND_KERNEL.items()}
    by_batch = got.pop("by_batch")
    log(f"  serving path {wall_s:.1f} s wall; launches {got}; expected {want}")
    log("  by batch size: " + "; ".join(
        f"B={b}: {row['calls']} calls, " + ", ".join(
            f"{k} {n}" for k, n in row.items() if k != "calls" and n)
        for b, row in by_batch.items()))
    if calls <= 0 or got["plain_on_cuda"] or any(got[k] != n for k, n in want.items()):
        raise AssertionError(f"the {cfg.name} serving path must run through its LM "
                             f"kernels only")


class LaunchCounters:
    """Launch counts of the LM kernels (``kernels``: name -> wrapper) and of
    prefill calls, and calls of the plain versions (``plains``: (ops module,
    attribute)) on CUDA tensors, over one run of a main path."""

    def __init__(self, lm, kernels, plains):
        self.kernels = kernels
        self.prefills = self.plain_cuda = 0
        self.by_batch = {}  # batch size -> prefill calls and launches in them
        prefill = lm.prefill

        def counted_prefill(cfg, params, tokens, *a, **kw):
            self.prefills += 1
            before = {n: k.launches for n, k in self.kernels.items()}
            out = prefill(cfg, params, tokens, *a, **kw)
            row = self.by_batch.setdefault(tokens.shape[0],
                                           dict.fromkeys(["calls", *self.kernels], 0))
            row["calls"] += 1
            for n, k in self.kernels.items():
                row[n] += k.launches - before[n]
            return out

        def counted(plain):
            def call(t, *a, **kw):
                self.plain_cuda += t.is_cuda
                return plain(t, *a, **kw)
            return call

        lm.prefill = counted_prefill
        for mod, attr in plains:
            setattr(mod, attr, counted(getattr(mod, attr)))

    def reset(self):
        for k in self.kernels.values():
            k.launches = 0
        self.prefills = self.plain_cuda = 0
        self.by_batch = {}

    def read(self) -> dict:
        return {**{n: k.launches for n, k in self.kernels.items()},
                "prefill_calls": self.prefills, "plain_on_cuda": self.plain_cuda,
                "by_batch": {b: dict(row) for b, row in sorted(self.by_batch.items())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=4500,
                    help="files per stream (the paper's window: 4500)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.core import Planner, Query, TraceArrival, plan_cost
    from repro_torch.data.tpch import (
        NUM_FILES, PAPER_QUERIES, StreamScale, paper_cost_model, stream_files)
    from repro_torch.kernels import _build
    from repro_torch.kernels.segagg import ops, tuning
    from repro_torch.kernels.segagg.ref import segagg_ref, zipf_keys
    from repro_torch.kernels.segagg.segagg import (
        scatter_plan_for, segagg_narrow_cuda, segagg_scatter_atomic_cuda, segagg_scatter_cuda)
    from repro_torch.serve import analytics
    from repro_torch.serve.analytics import (
        AnalyticsRuntimeExecutor, concat_files, measure_cost_model, run_batched, run_plan,
        run_session, run_shared_jobs)
    from repro_torch import core
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flash_attention_sync_cuda, flops_bytes as flash_flops_bytes)
    from repro_torch.kernels.flash_attention.ref import chunked_attention_ref
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.rglru.rglru import (
        flops_bytes as rglru_flops_bytes, rglru_cuda, rglru_serial_cuda)
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bf16ops_ref, ssd_chunked_ref
    from repro_torch.kernels.ssd.ssd import flops_bytes as ssd_flops_bytes, ssd_cuda
    from repro_torch.models import lm
    from repro_torch.models.base import SHAPES, get_config
    from repro_torch.serve import engine

    t_start = time.perf_counter()
    # 1. environment
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}), {name}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[2] built {sorted(_build.LIBRARIES)} in {time.perf_counter() - t0:.2f} s "
        f"into {_build.build_dir()}")
    for lib_name, build_log in _build.build_logs.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {lib_name}: " + line.strip())

    # 3. kernel parity
    sc = StreamScale(1.0)
    log(f"[3] kernel parity against the plain version (float rtol {FLOAT_RTOL})")
    wide = (sc.num_suppkeys, sc.num_partkeys, PANE_GROUPS)
    for g in (1, 5) + wide:
        for v in (1, 3):
            log(f"    G={g:>9} V={v}: scatter plan {scatter_plan_for(g, v, 'cuda')}")
    kernel_parity([("segagg_narrow", segagg_narrow_cuda, (1, 5)),
                   ("segagg_scatter", segagg_scatter_cuda, (1, 5) + wide),
                   ("segagg_scatter_atomic", segagg_scatter_atomic_cuda, (5,) + wide)],
                  segagg_ref, PARITY_FILES * sc.lineitems_per_file)
    zipf_parity([("segagg_scatter", segagg_scatter_cuda),
                 ("segagg_scatter_atomic", segagg_scatter_atomic_cuda)],
                segagg_ref, zipf_keys, PARITY_FILES * sc.lineitems_per_file, sc.num_suppkeys)
    torch.cuda.synchronize()

    # data: the paper's window, made from the seed
    n = args.files
    if n < NUM_FILES:
        log(f"CUT: {n} files per stream instead of the paper's {NUM_FILES}")
    t0 = time.perf_counter()
    streams = {"orders": [], "lineitem": []}
    times = []
    for t, orders, lineitem in stream_files(args.seed, n, sc):
        streams["orders"].append(orders)
        streams["lineitem"].append(lineitem)
        times.append(t)
    rows = {s: sum(len(f["ts"]) for f in fs) for s, fs in streams.items()}
    log(f"    made {n} files per stream in {time.perf_counter() - t0:.1f} s: "
        f"{rows['lineitem']} lineitem rows, {rows['orders']} order rows")
    by_id = {aq.query_id: aq for aq in PAPER_QUERIES}
    oneshot = {aq.query_id: host_oneshot(aq, streams[aq.stream], aq.num_groups(sc))
               for aq in PAPER_QUERIES}
    arrival = TraceArrival(timestamps=tuple(times))

    # The main path: counts from here to the end of phase 5.
    plain_cuda_calls = [0]

    def counted_ref(keys, values, num_groups):
        plain_cuda_calls[0] += values.is_cuda
        return segagg_ref(keys, values, num_groups)

    ops.segagg_ref = counted_ref
    segagg_narrow_cuda.launches = 0
    segagg_scatter_cuda.launches = 0
    segagg_scatter_atomic_cuda.launches = 0
    largest = {}   # query id -> its largest batch in rows on the main path
    models = {}    # query id -> phase 4's measured cost model

    # 4. single-query path
    log(f"[4] single-query path, {n} files, Planner('single')")
    # Calibrated at batch sizes that span the plans' batches (1,800-2,700
    # files at the paper's window), not only at measure_cost_model's default
    # (1, 4, 16, 64), from which the plans' batches are a 30-40x
    # extrapolation; each of a plan's batch sizes is run once before
    # run_plan times it, as the calibration warms each of its sizes.
    log(f"    calibration batch sizes {CALIBRATION_FILES} files; each plan's batch sizes "
        f"warmed up once before run_plan")
    for qid in ("CQ3", "CQ4", "CQ2", "TPC-Q6-like"):
        aq, files = by_id[qid], streams[by_id[qid].stream]
        t0 = time.perf_counter()
        cm = measure_cost_model(aq, files, sc, batch_sizes=CALIBRATION_FILES, device="cuda")
        t_cal = time.perf_counter() - t0
        models[qid] = cm
        deadline = arrival.wind_end + 0.6 * cm.cost(n)
        q = Query(f"{qid}-deadline", arrival.wind_start, arrival.wind_end,
                  deadline, n, cm, arrival)
        plan = Planner(policy="single").schedule(q)
        for size in sorted(set(plan.sch_tuples)):
            run_batched(aq, files[:size], size, sc, device="cuda")
        t0 = time.perf_counter()
        result, blog, agg_s = run_plan(aq, files, plan, sc, device="cuda")
        t_run = time.perf_counter() - t0
        verdict = check_result(qid, result, oneshot[qid])
        largest[qid] = max(largest.get(qid, 0), max(b.num_records for b in blog))
        finish = finish_time(plan, [b.seconds for b in blog], agg_s)
        modelled = finish_time(plan, [cm.cost(k) for k in plan.sch_tuples],
                               cm.agg_cost(len(plan.sch_tuples)))
        log(f"  {qid:12s} G={aq.num_groups(sc):>8} calibrate {t_cal:.1f} s, "
            f"cost(1)={cm.cost(1) * 1e3:.3f} ms cost({n})={cm.cost(n) * 1e3:.2f} ms; "
            f"plan {plan.sch_tuples} files (modelled {plan_cost(q, plan) * 1e3:.2f} ms); "
            f"run_plan {t_run:.2f} s wall, batches "
            f"{[round(b.seconds * 1e3, 3) for b in blog]} ms (modelled "
            f"{[round(cm.cost(k) * 1e3, 3) for k in plan.sch_tuples]}), agg "
            f"{agg_s * 1e3:.3f} ms (modelled {cm.agg_cost(len(plan.sch_tuples)) * 1e3:.3f}); "
            f"deadline {deadline:.4f}: modelled finish {modelled:.4f} "
            f"{outcome(modelled, deadline)}, measured finish {finish:.4f} "
            f"{outcome(finish, deadline)}; {verdict}")

    # 5. multi-query path
    log(f"[5] multi-query path, six queries, Planner('llf-dynamic'), paper cost models")
    queries = staggered(
        [Query(aq.query_id, arrival.wind_start, arrival.wind_end, 0.0, n,
               paper_cost_model(aq.query_id), arrival) for aq in PAPER_QUERIES],
        delta=1.0, c_max=30.0)
    rex = AnalyticsRuntimeExecutor(
        {aq.query_id: (aq, streams[aq.stream]) for aq in PAPER_QUERIES}, sc,
        device="cuda")
    t0 = time.perf_counter()
    trace = Planner(policy="llf-dynamic").run(queries, executor=rex)
    t_multi = time.perf_counter() - t0
    for aq in PAPER_QUERIES:
        qid = aq.query_id
        verdict = check_result(qid, rex.results[qid], oneshot[qid])
        blog = rex.physical(qid).batch_log
        largest[qid] = max(largest.get(qid, 0), max(b.num_records for b in blog))
        o = trace.outcome(qid)
        log(f"  {qid:12s} {len(blog):3d} batches, wall {rex.wall_seconds[qid]:.3f} s; "
            f"modelled finish {o.completion_time:.1f} vs deadline {o.deadline:.1f}: "
            f"{'met' if o.met_deadline else 'MISSED'}; {verdict}")
    log(f"  multi-query run {t_multi:.2f} s wall, deadlines met "
        f"{sum(o.met_deadline for o in trace.outcomes)}/{len(trace.outcomes)}")

    # 6. launch counts of the main path
    launches = {"segagg_narrow": segagg_narrow_cuda.launches,
                "segagg_scatter": segagg_scatter_cuda.launches,
                "segagg_scatter_atomic": segagg_scatter_atomic_cuda.launches}
    ops.segagg_ref = segagg_ref
    log(f"[6] main-path launches {launches}, plain version on CUDA tensors "
        f"{plain_cuda_calls[0]} times")
    if min(launches.values()) <= 0 or plain_cuda_calls[0]:
        raise AssertionError("the main path must run through the three kernels only")
    by_phase = {k: {"4-5": n} for k, n in launches.items()}

    # 7. kernel times at the main path's largest batch per query
    log("[7] kernel parity and times at each query's largest main-path batch "
        "(ms; bound = bytes at 3.35 TB/s)")
    fns = {"narrow": ("segagg_narrow", segagg_narrow_cuda),
           "cluster": ("segagg_scatter", segagg_scatter_cuda),
           "atomic": ("segagg_scatter_atomic", segagg_scatter_atomic_cuda)}
    report = {}
    for aq in PAPER_QUERIES:
        qid, g = aq.query_id, aq.num_groups(sc)
        files = streams[aq.stream]
        per_file = len(files[0]["ts"])
        # one batch of process_batch's work, step by step (host clock)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = concat_files(files[: largest[qid] // per_file])
        keys_np = np.asarray(aq.key_fn(records), np.int32)
        vals_np = np.asarray(aq.value_fn(records), np.float32)
        t1 = time.perf_counter()
        keys, vals = torch.from_numpy(keys_np).cuda(), torch.from_numpy(vals_np).cuda()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        form = tuning.pick_formulation(g, vals.shape[1])
        plan = scatter_plan_for(g, vals.shape[1], "cuda") if form == "scatter" else None
        kname, fn = fns["narrow" if plan is None else plan.route]
        out = ops.segagg(keys, vals, g)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        log(f"  {qid:12s} batch of {keys.shape[0]} rows (ms): host concat+keys "
            f"{(t1 - t0) * 1e3:.2f}, copy in {(t2 - t1) * 1e3:.2f} "
            f"({(keys_np.nbytes + vals_np.nbytes) / (t2 - t1) / 1e9:.2f} GB/s), "
            f"kernel {(t3 - t2) * 1e3:.3f}, spill {(t4 - t3) * 1e3:.3f}")
        r = kernel_times(kname, fn, keys, vals, g, qid != "TPC-Q6-like",
                         segagg_ref, ops.flops_bytes)
        extra = ""
        if kname == "segagg_scatter":
            r["old_ms"] = cuda_ms(lambda: segagg_scatter_atomic_cuda(keys, vals, g))
            r["plan"] = {"route": plan.route, "cluster": plan.cluster,
                         "ranges": [list(x) for x in plan.ranges]}
            extra = (f", global-atomic kernel {r['old_ms']:.4f} "
                     f"({r['old_ms'] / r['ms']:.2f}x); plan {r['plan']}")
        elif kname == "segagg_scatter_atomic":
            # the cluster design forced to the key ranges this table needs
            forced = scatter_plan_for(g, vals.shape[1], "cuda", max_ranges=4)
            got = segagg_scatter_cuda(keys, vals, g, plan=forced)
            if not torch.equal(got, segagg_ref(keys, vals, g)):
                raise AssertionError(f"{qid}: forced cluster plan: counts differ")
            t_forced = cuda_ms(lambda: segagg_scatter_cuda(keys, vals, g, plan=forced))
            extra = (f"; the cluster design forced to {len(forced.ranges)} key ranges of "
                     f"{forced.cluster} blocks {t_forced:.4f}")
        log(f"  {qid:12s} {kname:21s} N={keys.shape[0]:>9} G={g:>8} "
            f"({tuning.shape_class(keys.shape[0], g)}): kernel {r['ms']:.4f}, "
            f"plain {r['plain_ms']:.4f}, index_add_ {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%} of it reached), "
            f"max abs err {r['max_abs_err']:.3g}{extra}")
        if kname not in report or keys.shape[0] > report[kname][0]:
            report[kname] = (keys.shape[0], qid, r)
        if qid == "CQ3":
            zipf_shape = (keys.shape[0], g)
    # CQ3's shape under Zipf keys: a reading (parity gated)
    rows_z, g = zipf_shape
    keys = zipf_keys(rows_z, g, seed=3, device="cuda")
    vals = torch.ones((rows_z, 1), device="cuda")
    r = kernel_times("segagg_scatter", segagg_scatter_cuda, keys, vals, g, True,
                     segagg_ref, ops.flops_bytes)
    r_old = kernel_times("segagg_scatter_atomic", segagg_scatter_atomic_cuda, keys, vals, g,
                         True, segagg_ref, ops.flops_bytes)
    top = torch.bincount(keys, minlength=g).max().item() / rows_z
    log(f"  CQ3 shape, Zipf keys ({top:.2%} of rows in one group), N={rows_z} G={g}: "
        f"cluster table {r['ms']:.4f}, global-atomic kernel {r_old['ms']:.4f}, index_add_ "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}")
    del keys, vals
    gen = torch.Generator(device="cuda").manual_seed(1)
    crossings = []
    for files_x in (PARITY_FILES, 2250):  # a small batch and half the window
        rows_x = files_x * sc.lineitems_per_file
        log(f"    crossover at N={rows_x}, V=1, uniform keys (ms): G, narrow, scatter")
        ones = torch.ones((rows_x, 1), device="cuda")
        faster = []
        for g in CROSSOVER_GROUPS:
            keys = torch.randint(0, g, (rows_x,), device="cuda", generator=gen,
                                 dtype=torch.int32)
            t_n = cuda_ms(lambda: segagg_narrow_cuda(keys, ones, g), reps=3)
            t_s = cuda_ms(lambda: segagg_scatter_cuda(keys, ones, g), reps=3)
            faster.append(t_n < t_s)
            log(f"    crossover N={rows_x} G={g:>6}: narrow {t_n:.4f} scatter {t_s:.4f}")
        crossing = 0  # the largest G up to which narrow wins at every G
        for g, narrow_wins in zip(CROSSOVER_GROUPS, faster):
            if not narrow_wins:
                break
            crossing = g
        crossings.append(crossing)
    log(f"    narrow wins up to G={min(crossings)} (per N: {crossings}); "
        f"tuning.MATMUL_MAX_G = {tuning.MATMUL_MAX_G}")

    # 12. pane-shared scans on the same stream; counts from the first
    # run_shared_jobs to the last
    seg_kernels = {"segagg_narrow": segagg_narrow_cuda, "segagg_scatter": segagg_scatter_cuda,
                   "segagg_scatter_atomic": segagg_scatter_atomic_cuda}
    recorder = SegaggRecorder(analytics, ops, segagg_ref, seg_kernels)
    log(f"[12] pane-shared scans: run_shared_jobs over windows {list(SHARED_WINDOWS)} "
        f"(offset, files), llf-dynamic, phase 4's cost models")
    with recorder:
        for qid in SHARED_QUERIES:
            shared_scans(by_id[qid], streams[by_id[qid].stream], models[qid], sc, recorder,
                         run_shared_jobs)
    log(f"  launches {recorder.launches}; pane_segagg calls on CUDA tensors "
        f"{recorder.cuda_calls['pane_segagg']}, segagg {recorder.cuda_calls['segagg']}; "
        f"plain version on CUDA tensors {recorder.plain_cuda} times")
    for (call, p, total), row in sorted(recorder.routes.items()):
        log(f"    {call:11s} panes {p} x G = {total:>9}: {row}")
    width = SHARED_WINDOWS[1][0] - SHARED_WINDOWS[0][0]
    for count in sorted({p for call, p, _ in recorder.routes if call == "pane_segagg"}):
        log("    pane ids of " + pane_id_cost(by_id["CQ3"], streams["lineitem"], count, width))
    if recorder.cuda_calls["pane_segagg"] <= 0 or recorder.plain_cuda \
            or sum(recorder.launches.values()) <= 0:
        raise AssertionError("the pane-shared path must run pane_segagg through the kernels")
    for k, v in recorder.launches.items():
        by_phase[k]["12"] = v

    # 13. a recurring session over the real backend; counts over run_session
    log(f"[13] recurring session: run_session for CQ4, {n // SESSION_FILES} tumbling windows "
        f"of {SESSION_FILES} files, the files' own arrival times, calibrate=True")
    with recorder:
        session_windows(by_id["CQ4"], streams["lineitem"], times, models["CQ4"], sc,
                        run_session, analytics)
    log(f"  launches {recorder.launches}; plain version on CUDA tensors "
        f"{recorder.plain_cuda} times")
    if sum(recorder.launches.values()) <= 0 or recorder.plain_cuda \
            or recorder.cuda_calls["segagg"] <= 0:
        raise AssertionError("the session path must run through the segagg kernels only")
    for k, v in recorder.launches.items():
        by_phase[k]["13"] = v

    # 8. LM kernel parity
    del streams, oneshot, rex
    torch.cuda.empty_cache()
    log(f"[8] LM kernel parity against the plain version (bf16 within {BF16_TOL} of "
        f"the plain version in f32, f32 RG-LRU and h_last within {STATE_TOL}; SSD y "
        f"within {SSD_Y_TOL[torch.float32]} (f32) and {SSD_Y_TOL[torch.bfloat16]} (bf16), "
        f"h_last rtol {SSD_H_RTOL} and atol {SSD_H_ATOL[torch.float32]} (f32), "
        f"{SSD_H_ATOL[torch.bfloat16]} (bf16))")
    lm_kernel_parity(flash_attention_cuda, chunked_attention_ref, rglru_cuda, rglru_ref)
    ssd_kernel_parity(ssd_cuda, ssd_chunked_ref)
    torch.cuda.synchronize()

    # 9. the recurrentgemma-9b serving path; counts from the calibration to
    # the last job
    log(f"[9] serving path: {SERVE_ARCH} at full width, prompts of {SERVE_SEQ} tokens")
    counters = LaunchCounters(
        lm, {"flash_attention": flash_attention_cuda, "rglru": rglru_cuda, "ssd": ssd_cuda},
        [(fa_ops, "chunked_attention_ref"), (rg_ops, "rglru_ref"),
         (ssd_ops, "ssd_chunked_ref")])
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    ex, cm, batch8, lm_launches = serving_path(args, cfg, SERVE_SEQ, lm, engine, core,
                                               counters)
    check_launches(cfg, lm_launches, time.perf_counter() - t0)
    launches.update({k: lm_launches[k] for k in ("flash_attention", "rglru")})
    by_phase.update({k: {"9": lm_launches[k]} for k in ("flash_attention", "rglru")})

    # 14. online admission on the same executor and model
    log(f"[14] online admission: serve_session on {SERVE_ARCH}, jobs "
        f"{[(j, n, sub) for j, n, _, _, _, sub in ADMISSION_JOBS]} (id, prompts, submit s)")
    adm_launches = admission_path(args, cfg, ex, cm, engine, core, counters)
    for k in ("flash_attention", "rglru"):
        by_phase[k]["14"] = adm_launches[k]
    # The same batch of 8 with the plain versions swapped in, at three depths
    # of the same weights; the gate is the first unit (both kernels, 3
    # layers), since this random-weight model amplifies any rounding
    # difference with depth (the deeper readings are reported, not gated).
    log("  kernel path against the plain versions on one batch of 8, by depth: "
        "logits relative L2 error, argmax agreement, wall ms (kernels / plain)")
    swaps = [(fa_ops, "flash_attention_cuda", chunked_attention_ref),
             (rg_ops, "rglru_cuda", rglru_ref)]
    for units in (1, 3, None):
        rel, agree, t_k, t_p, first = plain_swap(ex, batch8, units, swaps)
        layers = cfg.num_layers if units is None else 3 * units
        log(f"    {layers:2d} layers: rel L2 {rel:.3e}, argmax agreement {agree:.3f}, "
            f"{t_k * 1e3:.1f} / {t_p * 1e3:.1f} ms")
        if units == 1:
            if not rel < LOGITS_REL_L2:
                raise AssertionError(f"kernel path and plain path disagree at 3 layers: "
                                     f"rel L2 {rel:.3e} (limit {LOGITS_REL_L2})")
            # each kernel against its plain version on the inputs the model gave it
            q, k, v, causal, window, cap = first["flash_attention_cuda"]
            got = flash_attention_cuda(q, k, v, causal, window, cap).float()
            want = chunked_attention_ref(q.float(), k.float(), v.float(), causal, window, cap)
            if not torch.isfinite(got).all():
                raise AssertionError("flash on the model's inputs: non-finite output")
            share = ((got - want).abs() > BF16_TOL + BF16_TOL * want.abs()).any(-1)
            share = share.float().mean().item()
            rel_o = ((got - want).norm() / want.norm()).item()
            log("    " + sharpness(q, k, window))
            x, r, i, a_param, h0 = first["rglru_cuda"]
            y, h = rglru_cuda(x, r, i, a_param, h0)
            y_ref, h_ref = rglru_ref(x.float(), r.float(), i.float(), a_param, h0)
            err_y = check_close("rglru y on the model's inputs", y, y_ref, BF16_TOL)
            err_h = check_close("rglru h_last on the model's inputs", h, h_ref, STATE_TOL)
            log(f"    on the first layers' own inputs: rglru y max abs err {shown(err_y)}, "
                f"h_last {shown(err_h)}; flash (a reading, not a gate: the softmax is "
                f"nearly one-hot) relative L2 {rel_o:.3e}, {share:.2e} of rows beyond "
                f"{BF16_TOL}")
    try:
        profile_batch(ex, batch8)
    except Exception as exc:  # the profiler is a reading, not a gate
        log(f"    profiler failed: {exc!r}")
    del ex, first
    torch.cuda.empty_cache()

    # 10. LM kernel times at the paths' shapes
    log(f"[10] LM kernels at the paths' shapes: flash (B in {LM_BATCHES}, S=4096, H=16, "
        f"Hkv=1, D=256, window 2048), rglru (B in {LM_BATCHES}, S=4096, N=4096), ssd (B=8, "
        f"S=32768, H=32, P=64, N=128); ms, CUDA events")
    lm_times = lm_kernel_times(flash_attention_cuda, flash_attention_sync_cuda,
                               chunked_attention_ref, flash_flops_bytes, rglru_cuda,
                               rglru_serial_cuda, rglru_ref, rglru_flops_bytes)
    lm_times["ssd"] = ssd_kernel_times(ssd_cuda, ssd_chunked_ref, ssd_chunked_bf16ops_ref,
                                       ssd_flops_bytes)
    for kname, r in lm_times.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {kname:15s} kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {lib}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%} "
            f"of it reached), max abs err {r['max_abs_err']:.3g}")
    r = lm_times["ssd"]
    log(f"  ssd ({SSD_DESIGN}) {r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} of its bound; "
        f"the earlier f32 CUDA-core kernel {SSD_CUDA_CORE_MS} ms "
        f"({r['bound_ms'] / SSD_CUDA_CORE_MS:.1%}), {SSD_CUDA_CORE_MS / r['ms']:.2f}x")
    torch.cuda.empty_cache()

    # 11. the mamba2-370m serving path; counts from the calibration to the
    # last job
    n_prompts = MULTI_JOBS[0][0] + sum(n for n, _, _ in MULTI_JOBS)
    log(f"[11] serving path: {SSM_ARCH} at full width and depth, prompts of {SSM_SEQ} "
        f"tokens; CUT: {n_prompts} prompts, batches of at most {SERVE_BUCKETS[-1]} "
        f"(prefill_32k's batch is {SHAPES['prefill_32k'].global_batch}), no decode")
    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    ex, _, batch8, ssm_launches = serving_path(args, cfg, SSM_SEQ, lm, engine, core,
                                               counters)
    check_launches(cfg, ssm_launches, time.perf_counter() - t0)
    launches["ssd"] = ssm_launches["ssd"]
    by_phase["ssd"] = {"11": ssm_launches["ssd"]}
    # A batch of 2 with the plain SSD swapped in, at 8 and at all 48 layers.
    # The seeded model amplifies a 1-ulp bf16 rounding difference of y with
    # depth (PERF.md), so at 48 layers the kernel path is held against the
    # distance between two plain paths that differ only in summation order.
    def ssd_plain(chunk):
        return lambda x, dt, A, Bm, Cm, D, h0: ssd_chunked_ref(x, dt, A, Bm, Cm, D,
                                                               chunk, h0)

    batch2 = batch8[:SSM_SWAP_BATCH]
    swap = [(ssd_ops, "ssd_cuda", ssd_plain(128))]
    log(f"  kernel path against the plain SSD on one batch of {SSM_SWAP_BATCH}: logits "
        f"relative L2 error, argmax agreement, wall ms (kernels / plain)")
    rel, agree, t_k, t_p, first = plain_swap(ex, batch2, SSM_GATE_UNITS, swap)
    log(f"    {SSM_GATE_UNITS:2d} layers: rel L2 {rel:.3e}, argmax agreement {agree:.3f}, "
        f"{t_k * 1e3:.1f} / {t_p * 1e3:.1f} ms")
    if not rel < LOGITS_REL_L2:
        raise AssertionError(f"kernel path and plain path disagree at {SSM_GATE_UNITS} "
                             f"layers: rel L2 {rel:.3e} (limit {LOGITS_REL_L2})")
    rel, agree, t_k, t_p, _ = plain_swap(ex, batch2, None, swap)
    floor, agree_p, _, _, _ = plain_swap(ex, batch2, None, swap, [ssd_plain(64)])
    log(f"    {cfg.num_layers:2d} layers: rel L2 {rel:.3e}, argmax agreement {agree:.3f}, "
        f"{t_k * 1e3:.1f} / {t_p * 1e3:.1f} ms; plain with chunk 64 against chunk 128: "
        f"rel L2 {floor:.3e}, argmax agreement {agree_p:.3f}")
    if not rel <= NOISE_RATIO * floor:
        raise AssertionError(f"kernel path and plain path disagree at {cfg.num_layers} "
                             f"layers: rel L2 {rel:.3e}, above {NOISE_RATIO} x the "
                             f"plain paths' {floor:.3e}")
    err_y, err_h = check_ssd("ssd on the model's inputs", ssd_cuda, ssd_chunked_ref,
                             first["ssd_cuda"])
    log(f"    on the first layer's own inputs: ssd y max abs err {shown(err_y)}, h_last "
        f"{shown(err_h)}")
    del first
    try:
        profile_batch(ex, batch8)
    except Exception as exc:  # the profiler is a reading, not a gate
        log(f"    profiler failed: {exc!r}")
    del ex
    torch.cuda.empty_cache()

    replaces = {"segagg_narrow": "src/repro/kernels/segagg/segagg.py:48",
                "segagg_scatter": "src/repro/kernels/segagg/segagg.py:75",
                "segagg_scatter_atomic": "src/repro/kernels/segagg/segagg.py:75"}
    kernels = []
    for kname in ("segagg_scatter", "segagg_scatter_atomic", "segagg_narrow"):
        rows_k, qid, r = report[kname]
        log(f"    {kname} reported at {qid}'s largest batch, N={rows_k}")
        kernels.append({"name": kname, "route": "cuda",
                        "source": "src/repro_torch/csrc/segagg.cu",
                        "replaces": replaces[kname], "launches": launches[kname],
                        "launches_by_phase": by_phase[kname], **r})
    lm_sources = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:29"),
        "rglru": ("src/repro_torch/csrc/rglru.cu", "src/repro/kernels/rglru/rglru.py:27"),
        "ssd": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd/ssd.py:26")}
    for kname, (source, replaced) in lm_sources.items():
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaced, "launches": launches[kname],
                        "launches_by_phase": by_phase[kname], **lm_times[kname]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
