#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # the paper's scale: 4,500 files, StreamScale(1.0)

Phases (any failure exits non-zero and prints no result line):

1. environment: torch, the card, its power limit; TF32 off;
2. build: the segagg kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
3. kernel parity: each kernel against its plain PyTorch version on the card
   (counts by ``torch.equal``, float sums within ``FLOAT_RTOL`` of the plain
   version taken in float64), for G in {1, 5, 360K, 1.5M}, V in {1, 3},
   N a batch of paper files, keys out of range on both sides, empty input;
4. single-query path (the main path, part 1): for CQ3, CQ4, CQ2 and
   TPC-Q6-like, ``measure_cost_model`` on the card, ``Planner("single")``
   under a deadline of ``wind_end + 0.6 * cost(n)``, ``run_plan`` on the
   card, result against a float64 host one-shot (counts exact);
5. multi-query path (the main path, part 2): ``Planner("llf-dynamic").run``
   over the six paper queries on one ``AnalyticsRuntimeExecutor`` with the
   paper's cost models, every result against its host one-shot;
6. launch counts of phases 4-5: both kernels launched, the plain version
   never called on a CUDA tensor;
7. at the main path's largest batch per query: where a batch's time goes
   (host concat, copy in, kernel, spill), the kernel against its plain
   version at that shape (as in phase 3), and its time beside the plain
   version's, ``index_add_``'s and its byte bound; then the
   narrow/scatter crossover table behind ``tuning.MATMUL_MAX_G``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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
# Float sums: f32 atomics add in an order that changes from run to run; a
# group summing m terms drifts by about sqrt(m) * 2^-24 relative (observed up
# to 2e-5 for 13M rows into one group through scatter).  Counts are exact.
FLOAT_RTOL = 1e-4
PARITY_FILES = 97           # N = 97 lineitem files = 1,261,000 rows, no block multiple
CROSSOVER_GROUPS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                    8192, 12288)


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
                log(f"  parity {name:15s} N={rows} G={g:>9} V={v}: counts equal, "
                    f"float rel err {err:.3e}")
        empty = fn(torch.zeros(0, dtype=torch.int32, device="cuda"),
                   torch.zeros((0, 3), device="cuda"), 5)
        if empty.shape != (5, 3) or empty.abs().sum().item() != 0.0:
            raise AssertionError(f"{name}: empty input must give zeros")
        log(f"  parity {name:15s} empty input: zeros (5, 3)")


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


def measured_finish(plan, batch_log, agg_s: float) -> float:
    """Completion instant with each batch's measured seconds in place of its
    modelled cost: a batch starts at its trigger or when the last ended."""
    t = 0.0
    for point, b in zip(plan.sch_points, batch_log):
        t = max(t, point) + b.seconds
    return t + agg_s


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
    from repro_torch.kernels.segagg.ref import segagg_ref
    from repro_torch.kernels.segagg.segagg import (
        segagg_narrow_cuda, segagg_scatter_cuda)
    from repro_torch.serve.analytics import (
        AnalyticsRuntimeExecutor, concat_files, measure_cost_model, run_plan)

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
    log(f"[2] built the kernels in {time.perf_counter() - t0:.2f} s "
        f"into {_build.build_dir()}")
    for line in _build.build_logs.get("segagg", "").splitlines():
        if "registers" in line or "spill" in line:
            log("    " + line.strip())

    # 3. kernel parity
    sc = StreamScale(1.0)
    log(f"[3] kernel parity against the plain version (float rtol {FLOAT_RTOL})")
    kernel_parity([("segagg_narrow", segagg_narrow_cuda, (1, 5)),
                   ("segagg_scatter", segagg_scatter_cuda,
                    (1, 5, sc.num_suppkeys, sc.num_partkeys))],
                  segagg_ref, PARITY_FILES * sc.lineitems_per_file)
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
    largest = {}   # query id -> its largest batch in rows on the main path

    # 4. single-query path
    log(f"[4] single-query path, {n} files, Planner('single')")
    for qid in ("CQ3", "CQ4", "CQ2", "TPC-Q6-like"):
        aq, files = by_id[qid], streams[by_id[qid].stream]
        t0 = time.perf_counter()
        cm = measure_cost_model(aq, files, sc, device="cuda")
        t_cal = time.perf_counter() - t0
        deadline = arrival.wind_end + 0.6 * cm.cost(n)
        q = Query(f"{qid}-deadline", arrival.wind_start, arrival.wind_end,
                  deadline, n, cm, arrival)
        plan = Planner(policy="single").schedule(q)
        t0 = time.perf_counter()
        result, blog, agg_s = run_plan(aq, files, plan, sc, device="cuda")
        t_run = time.perf_counter() - t0
        verdict = check_result(qid, result, oneshot[qid])
        largest[qid] = max(largest.get(qid, 0), max(b.num_records for b in blog))
        finish = measured_finish(plan, blog, agg_s)
        log(f"  {qid:12s} G={aq.num_groups(sc):>8} calibrate {t_cal:.1f} s, "
            f"cost(1)={cm.cost(1) * 1e3:.3f} ms cost({n})={cm.cost(n) * 1e3:.2f} ms; "
            f"plan {plan.sch_tuples} files (modelled {plan_cost(q, plan) * 1e3:.2f} ms); "
            f"run_plan {t_run:.2f} s wall, batches "
            f"{[round(b.seconds * 1e3, 3) for b in blog]} ms, agg {agg_s * 1e3:.3f} ms; "
            f"finish {finish:.4f} vs deadline {deadline:.4f}: "
            f"{'met' if finish <= deadline else 'MISSED'}; {verdict}")

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
                "segagg_scatter": segagg_scatter_cuda.launches}
    ops.segagg_ref = segagg_ref
    log(f"[6] main-path launches {launches}, plain version on CUDA tensors "
        f"{plain_cuda_calls[0]} times")
    if min(launches.values()) <= 0 or plain_cuda_calls[0]:
        raise AssertionError("the main path must run through both kernels only")

    # 7. kernel times at the main path's largest batch per query
    log("[7] kernel parity and times at each query's largest main-path batch "
        "(ms; bound = bytes at 3.35 TB/s)")
    fns = {"narrow": ("segagg_narrow", segagg_narrow_cuda),
           "scatter": ("segagg_scatter", segagg_scatter_cuda)}
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
        kname, fn = fns[tuning.pick_formulation(g, vals.shape[1])]
        out = fn(keys, vals, g)
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
        log(f"  {qid:12s} {kname:15s} N={keys.shape[0]:>9} G={g:>8} "
            f"({tuning.shape_class(keys.shape[0], g)}): kernel {r['ms']:.4f}, "
            f"plain {r['plain_ms']:.4f}, index_add_ {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.1%} of it reached), "
            f"max abs err {r['max_abs_err']:.3g}")
        if kname not in report or keys.shape[0] > report[kname][0]:
            report[kname] = (keys.shape[0], qid, r)
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

    replaces = {"segagg_narrow": "src/repro/kernels/segagg/segagg.py:48",
                "segagg_scatter": "src/repro/kernels/segagg/segagg.py:75"}
    kernels = []
    for kname in ("segagg_scatter", "segagg_narrow"):
        rows_k, qid, r = report[kname]
        log(f"    {kname} reported at {qid}'s largest batch, N={rows_k}")
        kernels.append({"name": kname, "route": "cuda",
                        "source": "src/repro_torch/csrc/segagg.cu",
                        "replaces": replaces[kname], "launches": launches[kname],
                        **r})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
