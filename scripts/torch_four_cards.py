#!/usr/bin/env python3
"""The port across the cards of one host: the analytics mesh on four cards,
the train, prefill and decode programs on (4, 1) and (1, 4) NCCL meshes,
internvl2-76b prefilled at full size on (1, 4), and mixtral-8x22b served at
full size on (1, 4).

    python3 scripts/torch_four_cards.py --world 4    # four cards: parts (a)-(e)
    python3 scripts/torch_four_cards.py --world 1    # one card: the rendezvous, the
                                                     # init, parts (b) and (e) at (1, 1)

The script is its own launcher: it starts ``--world`` ranks of itself
(``--worker``), each with the environment ``torch.distributed.run`` gives
its ranks (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, a free
``MASTER_PORT``), so each rank joins the group through ``make_host_mesh``'s
``env://`` rendezvous on the card ``LOCAL_RANK`` names.  Without CUDA, or
with fewer cards than ``--world``, it exits 2 with one line on stderr; a
failed rank fails the run (the others are killed), and the run never falls
back to fewer cards or to the CPU.

Parts, each gated (every gate is checked, the run goes on, and an unmet
gate exits 1 at its end):

(a) (launcher process, four cards) the analytics main path at the paper's
    scale (4,500 files per stream): for CQ3, CQ4, CQ2 and TPC-Q6-like, a
    ``Planner("single")`` plan under phase 4's deadline (``wind_end + 0.6
    cost(n)``) on a cost model measured on the first card at phase 4's
    batch sizes, ``run_plan`` over ``DeviceMesh(["cuda:0"])`` and
    ``DeviceMesh(4)``, then ``MeshAnalyticsBackend`` under ``llf-dynamic``
    over one card and over ``DeviceMesh(4)`` (``shard_across=4``,
    ``ShardedCostModel(model, 4)``).
    Every aggregate equals the float64 host one-shot (counts exact, float
    sums within ``FLOAT_RTOL``), and over four cards shard groups are fused.
    Readings: walls, dispatch seconds, launches by route and by card.
(b) the train program (``build_train_program``) for yi-6b at full width and
    8 of 32 layers, B 4 x S 2,048, ``TRAIN_STEPS`` AdamW steps, on a (4, 1)
    and a (1, 4) mesh, the state drawn leaf by leaf into its shards
    (``init_params_sharded``, every leaf's ``full_tensor()`` bit-equal to
    ``init_params``), then each ``wq`` and ``wk`` divided by ``TEMPER`` (the
    smoke's phase 19b: on the seeded init one card's own ``train_step``
    with its batch in 4 microbatches parts from ``train_step`` by up to 1.7
    relative L2 after the second step, ``scripts/torch_train_floor.py``, so
    no state comparison could tell a fault from the init's chaos).  Rank 0 gathers the state to the host,
    frees it, then runs ``train_step`` on its one card, and beside it the
    floors (``reference_steps``): for a mesh with data ranks
    ``train_step`` with the batch in as many microbatches (summation order
    alone), for a mesh split on "model" the same steps in f32 (how far bf16
    rounding alone moves them): the loss and every leaf within ``REL_L2``
    relative L2, or within ``NOISE_RATIO`` x the floor's distance where
    that is larger.  Each rank launches the flash kernel 16
    times a step and no plain version on the card.  The peak a card is
    held against the dry run's (``launch/dryrun.py`` ``run_cell(...,
    mesh_shape=...)``, in the launcher): at least ``PEAK_FLOOR`` of it, and
    it at least ``PEAK_FLOOR`` of the measured one.  Readings: ms a step,
    NCCL kernels' device ms by kind on the mesh's one axis of size 4
    (``torch.profiler`` on the last rank, one more step), the idle share.
    Then, on (1, 4) only and under the key ``SPLIT_ARCH`` of (b)'s record,
    chatglm3-6b at full width and ``SPLIT_UNITS`` (4) of 28 layers, with
    the same batch, steps and gates: its 2 KV heads do not divide "model",
    so each rank runs the attention core on its S / 4 = 512 query rows at
    ``q_offset`` = 512 x rank (``layers/attention.py`` ``_row_split``),
    2 x 4 x 3 = 24 flash launches a rank.  More readings: the last rank's
    (the most keys a row) flash kernels' device ms in its profiled step
    against one card's ``train_step`` (every row); the worst leaf's
    elements whose sign departs from ``train_step``'s, and where they sit
    among its ``|m|``.  Every flash call's query rows and offset
    are gated on every run of (b).
(c) the prefill and decode programs for recurrentgemma-9b at one (rglru,
    rglru, attn) unit and mamba2-370m at 8 layers, B 4 x S 4,096, on the
    same two meshes: logits, every cache leaf and one decode step's logits
    within ``REL_L2`` of the unsharded port on the rank's card, each kernel
    launched as often as the unsharded port launches it, no plain version
    on the card; gated on the copy with ``wq`` and ``wk`` divided by
    ``TEMPER`` (mamba2 has none), the seeded init's distances a reading.
    Bit-equality and the ``sharding_fallback`` events are readings.
(d) internvl2-76b through ``build_prefill_program`` on (1, 4), B 2 x S
    4,096 (3,840 tokens after the config's 256 stub patches): at 2 layers of
    full width, the leaf-wise init bit-equal to ``init_params``, and the
    logits and every cache leaf within ``REL_L2`` of the unsharded port on
    the rank's card (the tempered copy gated, the seeded init a reading, as
    in (c)), each kernel launched as often as there; at all 80 layers
    (70.55B parameters, seeded through ``init_params_sharded``), logits
    finite, 80 flash launches a rank (the unsharded port's a layer), a peak
    a card under 80 GB and within ``PEAK_FLOOR`` of the dry run's both
    ways.  Readings: init s and its peak, prefill ms (the first call, then
    one more), tokens/s, rank 0's busy, idle and NCCL ms of one more.
(e) mixtral-8x22b as (d), with ``build_decode_program`` too, B 2 x S
    4,096, its 8 experts split on "model" (2 a rank, their partial
    combines summed in f32): at 2 layers one decode step from the cache is
    held against the unsharded port's beside the logits and cache; at all
    56 layers (140.63B parameters) ``MOE_DECODE_STEPS`` decode steps follow
    the second prefill, and the flash launches a prefill are 112 a rank
    (56 layers x the config's 2 row chunks).  More readings: ms a decode
    step, token-choices dropped by capacity (``moe_ffn.dropped``).  Part
    (e) runs in ranks of its own, started after the others', with
    ``PYTORCH_CUDA_ALLOC_CONF`` = ``ALLOC_CONF["e"]``.

At ``--world 1`` (one card, as ``chip_smoke.py``'s phase 22 runs it) the
rank joins a one-rank group through the same rendezvous; part (b) runs at
(1, 1) for 2 steps and part (e) at 2 layers (e2) at (1, 1), bit-equal to
the unsharded port (a (1, 1) run of (c)-(e) is gated bit for bit); a line
says which four-card parts were not run and why.  ``--parts`` picks parts:
at ``--world 1`` of b, c, d2 and e2 (parts (d) and (e) at 2 layers), for
debugging on one card; at ``--world 4`` of a-e, to rerun what a change
touched.  ``--cpu`` rehearses
parts (b)-(e) on gloo ranks on the CPU at the configs' reduced widths (2
yi-6b layers, sequences of 32, internvl2-76b and mixtral-8x22b at 3
layers; no peak or launch gate), as a four-card change is tried before it
takes the cards:

    OMP_NUM_THREADS=2 python3 scripts/torch_four_cards.py --world 4 --cpu

The last line of standard output is a JSON object ``{"four_cards": ...}``:
the world size, the card, the parts run and skipped, each part's readings
and the launches of the programs' runs by kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

SEED = 22
REL_L2 = 2e-2               # the 2-rank CPU tests' rule (tests/test_torch_steps.py)
NOISE_RATIO = 2.0           # chip_smoke.py's rule: or twice a one-card pair's distance
TEMPER = 16.0               # (b): wq and wk divided by this (chip_smoke.py phase 19b)
FLOAT_RTOL = 1e-4           # chip_smoke.py's float-sum rule
PEAK_FLOOR = 0.75           # chip_smoke.py phase 21b's rule, both ways here
HBM_LIMIT = 80e9            # bytes of one H100's HBM3
ANALYTICS_FILES = 4500      # the paper's window
ANALYTICS_QUERIES = ("CQ3", "CQ4", "CQ2", "TPC-Q6-like")
CALIBRATION_FILES = (1, 4, 16, 64, 256, 1024, 2048, 3072)   # chip_smoke.py phase 4's
TRAIN_ARCH, TRAIN_UNITS, TRAIN_BATCH, TRAIN_SEQ = "yi_6b", 8, 4, 2048
TRAIN_STEPS = {1: 2, 4: 3}  # by world size
# (b) on (1, 4) only: a config whose KV heads (2) do not divide "model", so
# that each rank runs the attention core on its S / 4 query rows
SPLIT_ARCH, SPLIT_UNITS = "chatglm3_6b", 4
SERVE = (("recurrentgemma_9b", 1), ("mamba2_370m", 8))   # (arch, units)
SERVE_BATCH, SERVE_SEQ = 4, 4096
VLM_ARCH, VLM_GATE_UNITS, VLM_BATCH, VLM_SEQ = "internvl2_76b", 2, 2, 4096
VLM_UNITS = None            # None: the config's depth (80)
MOE_ARCH, MOE_GATE_UNITS, MOE_BATCH, MOE_SEQ = "mixtral_8x22b", 2, 2, 4096
MOE_UNITS = None            # None: the config's depth (56)
MOE_DECODE_STEPS = 4        # (e) at full depth: decode steps from the prefill's cache
REDUCED = False             # the configs' reduced widths (--cpu)
RANK_TIMEOUT = 1500         # seconds for all ranks together
PARTS = {1: ("b", "e2"), 4: ("a", "b", "c", "d", "e")}
# Part (e) at full depth runs in ranks of its own whose allocator grows its
# segments in place: at 65.49 GiB of weights a card, the third 21 GiB
# expert leaf of the init found 19.19 GiB free on each H100 80GB HBM3 beside
# 7.52 GiB of cached pieces (torch 2.11's default allocator).
ALLOC_CONF = {"e": "expandable_segments:True"}
ONE_CARD_PARTS = ("b", "c", "d2", "e2")   # --parts at --world 1


FAILED: list = []           # the gates this process found unmet


def log(*args) -> None:
    print(*args, flush=True)


def gate(ok: bool, what: str) -> bool:
    """Record an unmet gate (the run goes on, so that one run reads every
    part, and exits 1 at its end)."""
    if not ok:
        FAILED.append(what)
        log(f"  GATE FAILED: {what}")
    return ok


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def full(t):
    """A DTensor's full value; anything else as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def tempered(params: dict) -> dict:
    """``params`` with each ``wq`` and ``wk`` divided by ``TEMPER``: yi's
    seeded scores (rms ~360) are nearly one-hot, ~1.4 after."""
    return {k: (v.float() / TEMPER).to(v.dtype) if k.endswith(("/wq", "/wk")) else v
            for k, v in params.items()}


def smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: none"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def config(arch: str, units=None):
    """``arch`` at its published widths (the reduced ones under
    ``REDUCED``), cut to ``units`` units of its first segment's pattern."""
    from repro_torch.models.base import get_config
    from repro_torch.models.config import Segment

    cfg = get_config(arch)
    if REDUCED:
        cfg = cfg.reduced()
    if units is None:
        units = get_config(arch).segments[0].num_units
    return dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, units),))


def rehearse() -> None:
    """``--cpu``'s sizes: the configs' reduced widths, short sequences, a
    few layers."""
    global REDUCED, TRAIN_UNITS, TRAIN_SEQ, SPLIT_UNITS, SERVE, SERVE_SEQ, VLM_SEQ, \
        VLM_UNITS, MOE_SEQ, MOE_UNITS
    REDUCED, TRAIN_UNITS, TRAIN_SEQ, SPLIT_UNITS = True, 2, 32, 2
    SERVE, SERVE_SEQ = (("recurrentgemma_9b", 1), ("mamba2_370m", 2)), 32
    VLM_SEQ, VLM_UNITS = 16, 3
    MOE_SEQ, MOE_UNITS = 32, 3


def meshes(world: int) -> list:
    """The (data, model) shapes a part runs on."""
    return [(1, 1)] if world == 1 else [(world, 1), (1, world)]


def axis_of(shape) -> str:
    return "model" if shape[1] > 1 else "data" if shape[0] > 1 else "none"


# -- counts ---------------------------------------------------------------------

class Counters:
    """The LM kernels' launches (their wrappers' ``.launches``) and the
    plain versions' calls on CUDA tensors, over one run."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
        from repro_torch.kernels.rglru import ops as rg_ops
        from repro_torch.kernels.rglru.rglru import rglru_bwd_cuda, rglru_cuda
        from repro_torch.kernels.ssd import ops as ssd_ops
        from repro_torch.kernels.ssd.ssd import ssd_cuda

        self.kernels = {"flash_attention": flash_attention_cuda, "rglru": rglru_cuda,
                        "ssd": ssd_cuda, "rglru_bwd": rglru_bwd_cuda}
        self.plain_cuda = 0
        for mod, attr in ((fa_ops, "chunked_attention_ref"), (rg_ops, "rglru_ref"),
                          (rg_ops, "rglru_bwd_ref"), (ssd_ops, "ssd_chunked_ref")):
            setattr(mod, attr, self._counted(getattr(mod, attr)))

    def _counted(self, plain):
        def call(t, *a, **kw):
            self.plain_cuda += t.is_cuda
            return plain(t, *a, **kw)
        return call

    def reset(self) -> None:
        for k in self.kernels.values():
            k.launches = 0
        self.plain_cuda = 0

    def read(self) -> dict:
        return {**{n: k.launches for n, k in self.kernels.items()},
                "plain_on_cuda": self.plain_cuda}


@contextlib.contextmanager
def fallbacks():
    """The ``sharding_fallback`` events sent inside the block."""
    from repro_torch.dist.sharding import on_fallback

    got = []
    unsubscribe = on_fallback(got.append)
    try:
        yield got
    finally:
        unsubscribe()


def device_profile(fn, on: bool):
    """``fn()`` under ``torch.profiler`` when ``on`` (one rank on the card):
    host wall ms, device-busy ms (the union of kernel intervals), idle share
    the flash kernel's and NCCL kernels' device ms (these by collective);
    None when off or when the
    profiler saw no device kernel."""
    if not on:
        fn()
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, nccl, flash = [], {}, 0.0
    for e in prof.events():  # kernels only: the "nccl:*" annotations span them
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or ":" in e.name.split("(")[0]:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        if "flash_fwd_kernel" in e.name:
            flash += (end - start) / 1e3
        if e.name.lower().startswith("nccl"):
            m = re.match(r"nccl(?:Dev)?Kernel_([A-Za-z]+)", e.name)
            kind = m.group(1) if m else e.name.split("(")[0]
            nccl[kind] = nccl.get(kind, 0.0) + (end - start) / 1e3
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    kernel_ms = sum(e - s for s, e in spans) / 1e3
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
            "kernel_ms": kernel_ms, "flash_ms": flash, "nccl_ms": nccl,
            "nccl_total_ms": sum(nccl.values()),
            "nccl_share_of_kernel_ms": sum(nccl.values()) / kernel_ms}


def memory_mark(dev) -> int:
    if dev.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def peak_since(dev, before: int):
    return None if dev.type != "cuda" else torch.cuda.max_memory_allocated(dev) - before


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- part (a): the analytics mesh, in the launcher ------------------------------

def analytics_part(world: int) -> dict:
    from repro_torch import core
    from repro_torch.data.tpch import PAPER_QUERIES, StreamScale, stream_files
    from repro_torch.dist import DeviceMesh
    from repro_torch.kernels.segagg import ops
    from repro_torch.kernels.segagg.segagg import (segagg_narrow_cuda,
                                                   segagg_scatter_atomic_cuda,
                                                   segagg_scatter_cuda)
    from repro_torch.serve.analytics import MeshAnalyticsBackend, measure_cost_model, run_plan

    sc = StreamScale(1.0)
    n = ANALYTICS_FILES
    t0 = time.perf_counter()
    streams = {"orders": [], "lineitem": []}
    times = []
    for t, orders, lineitem in stream_files(SEED, n, sc):
        streams["orders"].append(orders)
        streams["lineitem"].append(lineitem)
        times.append(t)
    arrival = core.TraceArrival(timestamps=tuple(times))
    by_id = {aq.query_id: aq for aq in PAPER_QUERIES}
    log(f"[a] {n} files per stream made in {time.perf_counter() - t0:.1f} s")

    kernels = {"segagg_narrow": segagg_narrow_cuda, "segagg_scatter": segagg_scatter_cuda,
               "segagg_scatter_atomic": segagg_scatter_atomic_cuda}
    by_card, plain_cuda = {}, [0]
    real_segagg, real_ref = ops.segagg, ops.segagg_ref

    def counted_segagg(keys, values, num_groups, **kw):
        before = {k: f.launches for k, f in kernels.items()}
        out = real_segagg(keys, values, num_groups, **kw)
        card = f"cuda:{values.get_device()}" if values.is_cuda else "cpu"
        row = by_card.setdefault(card, dict.fromkeys(kernels, 0))
        for k, f in kernels.items():
            row[k] += f.launches - before[k]
        return out

    def counted_ref(keys, values, num_groups):
        plain_cuda[0] += values.is_cuda
        return real_ref(keys, values, num_groups)

    ops.segagg, ops.segagg_ref = counted_segagg, counted_ref
    out, totals = {}, dict.fromkeys(kernels, 0)
    try:
        one, four = DeviceMesh(["cuda:0"]), DeviceMesh(world)
        for qid in ANALYTICS_QUERIES:
            aq = by_id[qid]
            files = streams[aq.stream]
            want = host_oneshot(aq, files, aq.num_groups(sc))
            cm = measure_cost_model(aq, files, sc, batch_sizes=CALIBRATION_FILES,
                                    device="cuda")
            deadline = arrival.wind_end + 0.6 * cm.cost(n)
            q = core.Query(qid, arrival.wind_start, arrival.wind_end, deadline, n, cm, arrival)
            plan = core.Planner(policy="single").schedule(q)
            rec = {"plan_files": list(plan.sch_tuples)}
            for label, mesh in (("run_plan_1", one), ("run_plan_4", four)):
                by_card.clear()
                t0 = time.perf_counter()
                got, blog, _ = run_plan(aq, files, plan, sc, mesh=mesh)
                wall = time.perf_counter() - t0
                rec[label] = {"wall_s": wall, "batches": len(blog),
                              "check": check_result(qid, got, want),
                              "launches_by_card": {c: dict(r) for c, r in by_card.items()}}
            for ways, mesh in ((1, one), (world, four)):
                by_card.clear()
                wb = MeshAnalyticsBackend({qid: (aq, files)}, sc, mesh)
                model = core.ShardedCostModel(cm, ways) if ways > 1 else cm
                qq = core.Query(qid, arrival.wind_start, arrival.wind_end, deadline, n, model,
                                arrival)
                t0 = time.perf_counter()
                trace = core.run(core.get_policy("llf-dynamic", shard_across=ways), [qq],
                                 core.ExecutorPool(worker_backend=wb))
                wall = time.perf_counter() - t0
                o = trace.outcome(qid)
                gate(o.complete, f"(a) {qid}: the run over {ways} card(s) did not complete")
                batches = [e for e in trace.executions if e.kind == "batch"]
                calls = len({(e.start, e.end) for e in batches})
                gate(ways == 1 or calls < len(batches),
                     f"(a) {qid}: no shard group was fused over {ways} cards")
                rec[f"backend_{ways}"] = {
                    "wall_s": wall, "dispatch_s": sum(wb.wall_seconds.values()),
                    "batches": len(batches), "mesh_calls": calls,
                    "check": check_result(qid, wb.results[qid], want),
                    "met_deadline": o.completion_time <= o.deadline,
                    "launches_by_card": {c: dict(r) for c, r in by_card.items()}}
            r1, r4 = rec["backend_1"], rec[f"backend_{world}"]
            log(f"  (a) {qid:12s} run_plan {rec['run_plan_1']['wall_s']:.3f} s on one card, "
                f"{rec['run_plan_4']['wall_s']:.3f} s on {world} ({rec['run_plan_4']['check']}); "
                f"MeshAnalyticsBackend wall {r1['wall_s']:.3f} / {r4['wall_s']:.3f} s, "
                f"dispatch {r1['dispatch_s']:.3f} / {r4['dispatch_s']:.3f} s, "
                f"{r4['batches']} batches in {r4['mesh_calls']} mesh calls ({r4['check']}); "
                f"launches over {world} cards {r4['launches_by_card']}")
            gate(len(rec["run_plan_4"]["launches_by_card"]) == world,
                 f"(a) {qid}: run_plan launched on "
                 f"{sorted(rec['run_plan_4']['launches_by_card'])}")
            out[qid] = rec
            for run in rec.values():
                for row in (run["launches_by_card"].values() if isinstance(run, dict) else ()):
                    for k, c in row.items():
                        totals[k] += c
    finally:
        ops.segagg, ops.segagg_ref = real_segagg, real_ref
    gate(not plain_cuda[0], f"(a) the plain version ran on CUDA tensors {plain_cuda[0]} times")
    out["launches"] = totals
    return out


def host_oneshot(aq, files, num_groups: int) -> np.ndarray:
    """The whole window aggregated at once on the host in float64."""
    keys = np.concatenate([np.asarray(aq.key_fn(f)) for f in files])
    vals = np.concatenate([np.asarray(aq.value_fn(f), np.float64) for f in files])
    out = np.zeros((num_groups, vals.shape[1]), np.float64)
    for j in range(vals.shape[1]):
        np.add.at(out[:, j], keys, vals[:, j])
    return out


def check_result(qid: str, got: np.ndarray, want: np.ndarray) -> str:
    """``got`` against the host one-shot: counts exact, a float sum within
    ``FLOAT_RTOL``; the verdict."""
    if not gate(got.shape == want.shape and bool(np.isfinite(got).all()),
                f"(a) {qid}: result shape {got.shape}, want {want.shape}"):
        return "wrong shape"
    if qid == "TPC-Q6-like":  # a float sum
        gate(np.allclose(got, want, rtol=FLOAT_RTOL, atol=0.0),
             f"(a) {qid}: {got.ravel()} vs host {want.ravel()}")
        return f"rel err {np.abs(got - want).max() / np.abs(want).max():.2e}"
    exact = gate(np.array_equal(got.astype(np.float64), want),
                 f"(a) {qid}: counts differ from the host one-shot")
    return "counts exact" if exact else "counts DIFFER"


# -- the dry run's predictions, in the launcher ---------------------------------

def predictions(world: int, parts) -> dict:
    """``run_cell``'s peak a card for each program cell of the run."""
    from repro_torch.launch import dryrun
    from repro_torch.models.base import ShapeCell

    out = {}
    if "b" in parts:
        for arch, shape in train_runs(world):
            rec = dryrun.run_cell(config(*arch),
                                  ShapeCell("b", "train", TRAIN_SEQ, TRAIN_BATCH),
                                  mesh_shape={"data": shape[0], "model": shape[1]})
            key = f"b{shape}" if arch[0] == TRAIN_ARCH else f"b {arch[0]}{shape}"
            out[key] = rec["memory"]["peak_bytes_per_chip"]
    if "d" in parts:
        rec = dryrun.run_cell(config(VLM_ARCH, VLM_UNITS),
                              ShapeCell("d", "prefill", VLM_SEQ, VLM_BATCH),
                              mesh_shape={"data": 1, "model": world})
        out[f"d(1, {world})"] = rec["memory"]["peak_bytes_per_chip"]
    if "e" in parts:
        rec = dryrun.run_cell(config(MOE_ARCH, MOE_UNITS),
                              ShapeCell("e", "prefill", MOE_SEQ, MOE_BATCH),
                              mesh_shape={"data": 1, "model": world})
        out[f"e(1, {world})"] = rec["memory"]["peak_bytes_per_chip"]
    return out


# -- the ranks --------------------------------------------------------------------

def train_runs(world: int) -> list:
    """Part (b)'s ((arch, units), (data, model)) runs: ``TRAIN_ARCH`` on
    each mesh of ``meshes(world)``, and ``SPLIT_ARCH`` on (1, world) where
    there is more than one rank."""
    runs = [((TRAIN_ARCH, TRAIN_UNITS), shape) for shape in meshes(world)]
    return runs + ([((SPLIT_ARCH, SPLIT_UNITS), (1, world))] if world > 1 else [])


def core_rows(cfg, shape, seq: int) -> int:
    """The query rows of each flash call of a rank on a (data, model) mesh:
    S / model where the training core splits its rows
    (``layers/attention.py`` ``row_split_applies``), else S."""
    from repro_torch.layers.attention import row_split_applies

    return seq // shape[1] if row_split_applies(shape[1], cfg.num_kv_heads, seq) else seq


def train_part(dev, world: int, rank: int, counters: Counters) -> dict:
    """Part (b): each arch's runs (``train_runs``), then rank 0 holds their
    gathered states against ``train_step`` on its own card; ``TRAIN_ARCH``'s
    records by mesh, ``SPLIT_ARCH``'s under a key of its own."""
    import torch.distributed as dist

    out = {}
    for arch in dict.fromkeys(a for a, _ in train_runs(world)):
        runs = {}
        for a, shape in train_runs(world):
            if a == arch:
                runs.update(train_arch(dev, world, rank, counters, *arch, shape))
        if rank == 0:  # train_step on this one card, the programs' state freed
            kept = {name: run.pop("_kept") for name, run in runs.items()}
            runs.update(reference_steps(*arch, kept, runs, dev))
            del kept
            memory_mark(dev)
        dist.barrier()
        if arch[0] == TRAIN_ARCH:
            out.update(runs)
        else:
            out[arch[0]] = runs
    return out


def train_arch(dev, world: int, rank: int, counters: Counters, arch: str, units: int,
               shape) -> dict:
    """One run of part (b): ``arch`` at ``units`` units on the (data, model)
    mesh ``shape``; rank 0 keeps the gathered state (``_kept``) for
    ``reference_steps``."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.base import ShapeCell
    from repro_torch.models.params import init_params, init_params_sharded
    from repro_torch.train.optimizer import AdamWConfig, init_state

    cfg = config(arch, units)
    nsteps = TRAIN_STEPS.get(world, 3)
    cell = ShapeCell("b", "train", TRAIN_SEQ, TRAIN_BATCH)
    specs = steps.model_specs(cfg)
    batches = train_batches(cfg, nsteps, dev)
    want_flash = 2 * cfg.num_layers * nsteps if dev.type == "cuda" else 0
    rows = core_rows(cfg, shape, TRAIN_SEQ)
    name = str(shape)
    mesh = make_host_mesh(model_parallel=shape[1], device=dev.type)
    flash_calls, plain_flash = [], fa_ops.flash_attention

    def recorded(q, *args, q_offset=0, **kw):
        flash_calls.append((q.shape[1], q_offset))
        return plain_flash(q, *args, q_offset=q_offset, **kw)

    with fallbacks() as events:
        prog = steps.build_train_program(cfg, cell, mesh, adamw=AdamWConfig())
        before = memory_mark(dev)
        t0 = time.perf_counter()
        params = init_params_sharded(specs, SEED, mesh, prog.in_placements[0].params)
        sync(dev)
        t_init = time.perf_counter() - t0
        want = init_params(specs, SEED, device=dev)
        unequal = [k for k in want if not torch.equal(full(params[k]), want[k])]
        del want
        gate(not unequal, f"(b) {arch} {name}: the leaf-wise init departs from init_params "
                          f"in {unequal[:5]}")
        state = init_state(tempered(params))
        del params
        state, = prog.distribute(state)
        reset_peak(dev)
        counters.reset()
        walls, losses = [], []
        fa_ops.flash_attention = recorded
        try:
            for i, batch in enumerate(batches):
                sync(dev)
                t0 = time.perf_counter()
                state, metrics = prog.run(state, batch)
                losses.append(full(metrics["loss"]).item())
                walls.append(time.perf_counter() - t0)
                if i == 0:  # every rank gathers; rank 0 keeps it
                    first = first_update(state, full)
        finally:
            fa_ops.flash_attention = plain_flash
        got = counters.read()
        peak = peak_since(dev, before)
    gate(not got["plain_on_cuda"] and got["flash_attention"] == want_flash,
         f"(b) {arch} {name} rank {rank}: launches {got} (want {want_flash} flash, no plain "
         f"version on the card)")
    start = rank % shape[1] * rows if rows < TRAIN_SEQ else 0
    gate(len(flash_calls) == 2 * cfg.num_layers * nsteps
         and set(flash_calls) == {(rows, start)},
         f"(b) {arch} {name} rank {rank}: flash calls (query rows, q_offset) "
         f"{sorted(set(flash_calls))} x {len(flash_calls)} (want ({rows}, {start}) x "
         f"{2 * cfg.num_layers * nsteps})")
    # the state to the host, leaf by leaf; rank 0 keeps it
    kept = {}
    for p in ("params", "m", "v"):
        for k, v in getattr(state, p).items():
            leaf = full(v)
            if rank == 0:  # a copy: the profiled step below updates the state in place
                kept[f"{p}/{k}"] = leaf.to("cpu", copy=True)
            del leaf
    prof = device_profile(lambda: full(prog.run(state, batches[0])[1]["loss"]),
                          rank == world - 1 and dev.type == "cuda")
    del state, metrics
    memory_mark(dev)
    ms = 1e3 * sum(walls[1:]) / max(len(walls) - 1, 1)
    rec = {"losses": losses, "first_ms": walls[0] * 1e3, "ms_per_step": ms,
           "peak_bytes": peak, "init_s": t_init, "launches": got,
           "flash_rows": rows, "flash_q_offset": start, "flash_calls": len(flash_calls),
           "fallback_events": events, "profile": prof, "nccl_axis": axis_of(shape)}
    log(f"  (b) {arch} rank {rank} {name}: losses {[round(x, 5) for x in losses]}, first step "
        f"{walls[0] * 1e3:.1f} ms, then {ms:.1f} ms a step; peak "
        f"{(peak or 0) / 2 ** 30:.2f} GiB; init {t_init:.2f} s; launches {got}, flash on "
        f"{rows} query rows at q_offset {start}; fallback events {len(events)}")
    if prof is not None:
        log(f"  (b) {arch} rank {rank} {name} one more step profiled: {prof['wall_ms']:.1f} ms "
            f"wall, busy {prof['busy_ms']:.1f} ms (idle {prof['idle_share']:.1%}), flash "
            f"{prof['flash_ms']:.3f} ms, NCCL on '{axis_of(shape)}' "
            f"{prof['nccl_total_ms']:.2f} ms {prof['nccl_ms']}")
    dist.barrier()
    if rank == 0:
        rec.update(_kept=kept, _first=first)
    return {name: rec}


def train_batches(cfg, nsteps: int, dev) -> list:
    from repro_torch.launch.train import synthetic_batches

    data = synthetic_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    return [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
            for _ in range(nsteps)]


def reference_steps(arch: str, units: int, kept: dict, runs: dict, dev) -> dict:
    """Rank 0's one-card references for part (b): ``train_step`` from the
    same tempered init, and the floors of each kept program state, a leaf
    at a time: for a mesh with data ranks, the distance from it of
    ``train_step`` with the batch in as many microbatches (summation order
    alone); for a mesh split on "model", each parameter's sign floor
    (``sign_floor``: the part of its update carried by elements whose
    gradient average is within the program's measured rounding of it).
    Each kept state is gated leaf by leaf: within ``REL_L2``, or within
    ``NOISE_RATIO`` x its floor where that is larger; the loss likewise.
    Readings: the worst leaf's elements whose sign departs from
    ``train_step``'s, where they sit among its ``|m|``, and, for a
    parameter kept after the first step (``first_update``), the same of the
    first update.  For ``SPLIT_ARCH`` one more ``train_step`` is profiled
    (its flash kernels' device ms: the whole core's rows)."""
    from repro_torch.launch import steps
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    cfg = config(arch, units)
    specs, adamw = steps.model_specs(cfg), AdamWConfig()
    nsteps = len(next(iter(runs.values()))["losses"])
    batches = train_batches(cfg, nsteps, dev)
    shapes = {name: tuple(int(x) for x in name.strip("()").split(",")) for name in kept}

    def run(c):
        state = init_state(tempered(init_params(specs, SEED, device=dev)))
        start = {k: v.to("cpu", copy=True) for k, v in state.params.items()}
        losses, walls, first = [], [], {}
        for i, batch in enumerate(batches):
            sync(dev)
            t0 = time.perf_counter()
            state, metrics = steps.train_step(c, state, batch, adamw)
            losses.append(metrics["loss"].item())
            walls.append(time.perf_counter() - t0)
            if i == 0:
                first = first_update(state, full)
        return state, start, losses, walls, first

    def leaves(state) -> dict:
        return {f"{p}/{k}": v for p in ("params", "m", "v") for k, v in getattr(state, p).items()}

    state, start, ref_losses, walls, ref_first = run(cfg)
    ref = leaves(state)
    out = {"train_step": {"losses": ref_losses,
                          "ms_per_step": 1e3 * sum(walls[1:]) / max(len(walls) - 1, 1)},
           "floors": {}}
    floors, loss_floors = {}, {}
    for dp in sorted({dp for dp, _ in shapes.values()} - {1}):  # one state beside ref's
        other, _, losses, _, _ = run(dataclasses.replace(cfg, train_microbatches=dp))
        floors[dp] = {k: rel_l2(v, ref[k]) for k, v in leaves(other).items()}
        del other
        memory_mark(dev)
        loss_floors[dp] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        out["floors"][str(dp)] = {"losses": losses, "loss_rel_err": loss_floors[dp],
                                  "worst": max(floors[dp].items(), key=lambda kv: kv[1]),
                                  "above_rel_l2": sum(e > REL_L2 for e in floors[dp].values())}
        log(f"  (b) {arch} one-card floor, train_step with {dp} microbatches against 1: losses "
            f"{[round(x, 6) for x in losses]}, {out['floors'][str(dp)]['above_rel_l2']} of "
            f"{len(ref)} leaves above {REL_L2}, worst {out['floors'][str(dp)]['worst']}")
    for name, got in kept.items():
        dp, mp = shapes[name]
        floor = dict(floors.get(dp, dict.fromkeys(ref, 0.0)))
        if mp > 1:
            signs = {k: sign_floor(got, ref, start, k) for k in ref if k.startswith("params/")}
            floor.update({k: max(floor[k], f) for k, f in signs.items()})
            runs[name]["sign_floors"] = {k: f for k, f in signs.items() if f}
        loss_limit = max(REL_L2, NOISE_RATIO * loss_floors.get(dp, 0.0))
        errs = {k: rel_l2(got[k], ref[k]) for k in ref}
        limits = {k: max(REL_L2, NOISE_RATIO * floor[k]) for k in ref}
        beyond = {k: (errs[k], limits[k]) for k in ref if errs[k] > limits[k]}
        worst = max(errs.items(), key=lambda kv: kv[1])
        same = sum(torch.equal(ref[k], got[k].to(ref[k].device)) for k in ref)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs[name]["losses"], ref_losses))
        leaf = worst[0].split("/", 1)[1]
        signs = {"final": sign_departures(got[worst[0]], ref[worst[0]], ref["m/" + leaf])}
        first = runs[name].pop("_first", {})
        if worst[0].startswith("params/") and leaf in first:
            signs["first_update"] = sign_departures(first[leaf][0], ref_first[leaf][0],
                                                    ref_first[leaf][1])
        runs[name].update(worst_leaf=worst, worst_limit=limits[worst[0]],
                          lifted_limits={k: (errs[k], v) for k, v in limits.items() if v > REL_L2},
                          bit_equal_leaves=same, leaves=len(ref),
                          within_rel_l2=sum(e <= REL_L2 for e in errs.values()),
                          beyond_limit=beyond, loss_rel_err=loss_err, worst_signs=signs)
        log(f"  (b) {arch} {name} against train_step on one card (losses "
            f"{[round(x, 5) for x in ref_losses]}): {same} of {len(ref)} leaves bit-equal, "
            f"{runs[name]['within_rel_l2']} within {REL_L2}, worst {worst[0]} at "
            f"{worst[1]:.3e} (limit {limits[worst[0]]:.3e}), its signs {signs}; limits above "
            f"{REL_L2}: {runs[name]['lifted_limits']}; loss {loss_err:.3e}")
        gate(not beyond and loss_err <= loss_limit,
             f"(b) {arch} {name}: the program departs from train_step beyond the limit "
             f"({REL_L2}, or {NOISE_RATIO} x the floor): {beyond}, loss {loss_err:.3e} "
             f"(limit {loss_limit:.3e})")
    if arch == SPLIT_ARCH:
        prof = device_profile(lambda: steps.train_step(cfg, state, batches[0], adamw)[1]
                              ["loss"].item(), dev.type == "cuda")
        out["train_step"]["profile"] = prof
        if prof is not None:
            log(f"  (b) {arch} one more train_step on one card profiled: {prof['wall_ms']:.1f} "
                f"ms wall, busy {prof['busy_ms']:.1f} ms, flash {prof['flash_ms']:.3f} ms")
    return out


FIRST_UPDATE_NUMEL = 1 << 16   # parameters this small are kept after the first step


def first_update(state, gather) -> dict:
    """name -> (parameter, m) on the host after the first step, for every
    parameter of at most ``FIRST_UPDATE_NUMEL`` elements (the norms: their
    zero init makes the first update a sign per element)."""
    return {k: (gather(v).to("cpu", copy=True), gather(state.m[k]).to("cpu", copy=True))
            for k, v in state.params.items() if v.numel() <= FIRST_UPDATE_NUMEL}


def sign_floor(got: dict, ref: dict, start: dict, key: str) -> float:
    """A parameter's sign floor for a program split on "model": the
    relative L2 size of the part of ``train_step``'s update (its value less
    ``start``, the init) carried by elements whose ``|m|`` is within
    ``NOISE_RATIO`` x the program's departure from it on this leaf (its
    RMS; the m leaf is itself gated).  Adam's update there is a sign the
    rounding decides; reversing all of them moves the leaf by twice this,
    which ``NOISE_RATIO`` allows."""
    leaf = key.split("/", 1)[1]
    m_ref = ref["m/" + leaf]
    noise = (got["m/" + leaf].to(m_ref.device).float() - m_ref.float()).square().mean().sqrt()
    unsettled = m_ref.float().abs() <= NOISE_RATIO * noise
    update = ref[key].float() - start[leaf].to(m_ref.device).float()
    return float(update[unsettled].norm() / ref[key].float().norm().clamp(min=1e-30))


def sign_departures(got: torch.Tensor, want: torch.Tensor, m: torch.Tensor) -> dict:
    """The elements of ``got`` whose sign departs from ``want``'s, and where
    they sit among the one-card ``|m|`` of the same leaf (the gradients'
    moving average): their quantiles there (0: the smallest)."""
    got, m = got.to(want.device), m.to(want.device)
    flipped = (torch.sign(got) != torch.sign(want)).flatten()
    order = m.abs().flatten().float().argsort()
    quantile = torch.empty_like(order, dtype=torch.float64)
    quantile[order] = torch.arange(order.numel(), device=order.device,
                                   dtype=torch.float64) / order.numel()
    at = quantile[flipped]
    return {"flipped": int(flipped.sum()), "of": flipped.numel(),
            "quantile_max": float(at.max()) if at.numel() else None,
            "quantile_median": float(at.median()) if at.numel() else None}


def variants(specs) -> list:
    """(name, weights transform) of a part's runs: the seeded init, and for a
    model with attention the tempered copy after it, the one gated."""
    runs = [("seeded", lambda p: p)]
    if any(k.endswith("/wq") for k in specs):
        runs.append(("tempered", tempered))
    return runs


def serve_part(dev, world: int, rank: int, counters: Counters) -> dict:
    """Part (c): the prefill and decode programs against the unsharded port
    on this rank's card, for each of ``variants``; the last is gated, the
    seeded init's distances (nearly one-hot attention) are readings."""
    from repro_torch.launch import steps

    out = {}
    for arch, units in SERVE:
        cfg = config(arch, units)
        specs = steps.model_specs(cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ), device=dev,
                               generator=gen, dtype=torch.int32)
        nxt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, 1), device=dev,
                            generator=gen, dtype=torch.int32)
        runs = variants(specs)
        out[cfg.name] = {
            label: serve_variant(cfg, specs, transform, tokens, nxt, dev, world, rank,
                                 counters, gated=(label == runs[-1][0]), label=label)
            for label, transform in runs}
    return out


def serve_variant(cfg, specs, transform, tokens, nxt, dev, world, rank, counters,
                  gated: bool, label: str) -> dict:
    """One set of weights of part (c) on each mesh of ``meshes(world)``."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.base import ShapeCell
    from repro_torch.models.params import init_params, init_params_sharded

    memory_mark(dev)
    batch = {"tokens": tokens}
    ref = unsharded(cfg, transform(init_params(specs, SEED, device=dev)), batch, SERVE_SEQ,
                    nxt, counters)
    rec = {}
    for shape in meshes(world):
        name = str(shape)
        mesh = make_host_mesh(model_parallel=shape[1], device=dev.type)
        with fallbacks() as events:
            pprog = steps.build_prefill_program(
                cfg, ShapeCell("c", "prefill", SERVE_SEQ, SERVE_BATCH), mesh)
            dprog = steps.build_decode_program(
                cfg, ShapeCell("c", "decode", SERVE_SEQ, SERVE_BATCH), mesh)
            params = transform(init_params_sharded(specs, SEED, pprog.mesh,
                                                   pprog.in_placements[0]))
            r = rec[name] = against(ref, pprog, dprog, params, batch, nxt, counters, dev)
        r["fallback_events"] = events
        gate_against(r, dev, f"(c) rank {rank} {cfg.name} at {cfg.num_layers} layers, "
                             f"{label}, on {name}", gated, shape == (1, 1))
        del params
    return rec


def unsharded(cfg, params, batch, seq, nxt, counters) -> dict:
    """The unsharded port on this rank's card, what a program's run is held
    against: ``lm.prefill`` and, with ``nxt``, one ``lm.decode_step`` from
    a copy of its cache; the launches and the dropped token-choices."""
    from repro_torch.layers.moe import moe_ffn
    from repro_torch.models import lm

    counters.reset()
    moe_ffn.dropped = 0
    logits, cache, clen = lm.prefill(cfg, params, batch["tokens"], seq,
                                     **{k: v for k, v in batch.items() if k != "tokens"})
    ref = {"logits": logits, "cache": cache, "clen": int(clen), "launches": counters.read(),
           "dropped": int(moe_ffn.dropped)}
    if nxt is not None:
        counters.reset()
        ref["step"], _ = lm.decode_step(cfg, params, {k: v.clone() for k, v in cache.items()},
                                        clen, nxt)
        ref["decode_launches"] = counters.read()
    return ref


def against(ref, pprog, dprog, params, batch, nxt, counters, dev) -> dict:
    """The prefill program's logits and every cache leaf and, with
    ``dprog``, one decode step from that cache, on ``params``, against
    ``ref`` (``unsharded``): bit-equality, relative L2 distances and the
    worst of them, finiteness, launches and dropped token-choices on both
    sides, and the calls' host ms."""
    from repro_torch.layers.moe import moe_ffn

    counters.reset()
    moe_ffn.dropped = 0
    sync(dev)
    t0 = time.perf_counter()
    logits, cache, clen = pprog.run(params, batch)
    logits = full(logits)
    sync(dev)
    rec = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "launches": counters.read(),
           "unsharded_launches": ref["launches"], "dropped": int(moe_ffn.dropped),
           "unsharded_dropped": ref["dropped"]}
    errs = {"logits": rel_l2(logits, ref["logits"])}
    same = torch.equal(logits, ref["logits"]) and int(clen) == ref["clen"]
    for k, v in ref["cache"].items():
        leaf = full(cache[k])
        errs[k] = rel_l2(leaf, v)
        same = same and torch.equal(leaf, v)
    finite = bool(torch.isfinite(logits).all())
    if dprog is not None:
        counters.reset()
        sync(dev)
        t0 = time.perf_counter()
        step, _ = dprog.run(params, cache, clen, nxt)
        step = full(step)
        sync(dev)
        errs["decode_logits"] = rel_l2(step, ref["step"])
        finite = finite and bool(torch.isfinite(step).all())
        rec.update(decode_ms=(time.perf_counter() - t0) * 1e3,
                   decode_launches=counters.read(),
                   unsharded_decode_launches=ref["decode_launches"],
                   decode_bit_equal=torch.equal(step, ref["step"]),
                   decode_rel_l2=errs["decode_logits"])
    rec.update(prefill_bit_equal=same, logits_rel_l2=errs["logits"],
               worst=max(errs.items(), key=lambda kv: kv[1]), finite=finite)
    return rec


LM_KERNELS = ("flash_attention", "rglru", "ssd")


def gate_against(r: dict, dev, what: str, gated: bool, one_rank: bool) -> None:
    """Log ``against``'s record and gate it: finite; on one rank bit for bit
    (the program is then the unsharded port's ops); else, where ``gated``,
    the worst distance within ``REL_L2``; on the card each LM kernel launched
    as often as the unsharded port launches it, some kernel at all, and no
    plain version."""
    decode = "decode_launches" in r
    dist, runs, ms = ((f", decode {r['decode_rel_l2']:.3e}", f", decode {r['decode_launches']}",
                       f", decode {r['decode_ms']:.1f} ms") if decode else ("", "", ""))
    log(f"  {what}: prefill bit-equal {r['prefill_bit_equal']}, decode bit-equal "
        f"{r.get('decode_bit_equal')}, worst {r['worst'][0]} at {r['worst'][1]:.3e} (logits "
        f"{r['logits_rel_l2']:.3e}{dist}); launches {r['launches']} (unsharded "
        f"{r['unsharded_launches']}){runs}; token-choices dropped {r['dropped']} (unsharded "
        f"{r['unsharded_dropped']}); prefill {r['prefill_ms']:.1f} ms{ms} (first calls); "
        f"fallback events {[e.get('detail') for e in r['fallback_events']]}")
    gate(r["finite"], f"{what}: non-finite logits")
    if one_rank:
        gate(r["prefill_bit_equal"] and r.get("decode_bit_equal", True),
             f"{what}: not bit-equal to the unsharded port ({r['worst']})")
    elif gated:
        gate(r["worst"][1] <= REL_L2, f"{what}: {r['worst']} beyond {REL_L2}")
    pairs = [(r["launches"], r["unsharded_launches"])]
    if decode:
        pairs.append((r["decode_launches"], r["unsharded_decode_launches"]))
    gate(dev.type != "cuda" or (
        all(got[k] == want[k] for got, want in pairs for k in LM_KERNELS)
        and not any(got["plain_on_cuda"] for got, _ in pairs)
        and any(r["launches"][k] for k in LM_KERNELS)),
        f"{what}: launches {pairs} (the program's, the unsharded port's)")


def vlm_batch(cfg, dev):
    """Part (d)'s batch: text tokens after the config's stub patches; no
    decode."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_SEQ - cfg.num_patches),
                           device=dev, generator=gen, dtype=torch.int32)
    patches = (0.02 * torch.randn((VLM_BATCH, cfg.num_patches, cfg.d_model), device=dev,
                                  generator=gen)).to(torch.bfloat16)
    return {"tokens": tokens, "patches": patches}, None


def moe_batch(cfg, dev):
    """Part (e)'s batch and the tokens of its ``MOE_DECODE_STEPS`` decode
    steps."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ), device=dev,
                           generator=gen, dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_DECODE_STEPS), device=dev,
                        generator=gen, dtype=torch.int32)
    return {"tokens": tokens}, nxt


def model_part(part: str, arch: str, gate_units: int, units, seq: int, make_batch, dev,
               world: int, rank: int, counters: Counters, full_depth: bool) -> dict:
    """Parts (d) and (e): ``arch`` at full width on (1, world) through the
    prefill program, and the decode program where ``make_batch`` gives the
    decode steps' tokens.  First at ``gate_units`` units against the
    unsharded port on this rank's card: the leaf-wise init bit-equal to
    ``init_params``, then for each of ``variants`` ``against``'s comparison,
    gated by ``gate_against`` (the last variant).  Then at ``units`` (None:
    the config's depth): the init's seconds and peak, two prefills, the
    decode steps from the second's cache, the peak since the init, and rank
    0's profile of one more prefill."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.layers.moe import moe_ffn
    from repro_torch.models.base import ShapeCell
    from repro_torch.models.params import init_params, init_params_sharded, num_params

    mesh = make_host_mesh(model_parallel=world, device=dev.type)
    cfg2 = config(arch, gate_units)
    batch, nxt = make_batch(cfg2, dev)
    B = batch["tokens"].shape[0]

    def programs(cfg):
        pprog = steps.build_prefill_program(cfg, ShapeCell(part, "prefill", seq, B), mesh)
        return pprog, None if nxt is None else steps.build_decode_program(
            cfg, ShapeCell(part, "decode", seq, B), mesh)

    # at gate_units: the init, then each variant against the unsharded port
    memory_mark(dev)
    specs = steps.model_specs(cfg2)
    with fallbacks() as events:
        pprog, dprog = programs(cfg2)
        params = init_params_sharded(specs, SEED, pprog.mesh, pprog.in_placements[0])
    want = init_params(specs, SEED, device=dev)
    unequal = [k for k in want if not torch.equal(full(params[k]), want[k])]
    gate(not unequal, f"({part}) the leaf-wise init departs from init_params in {unequal[:5]}")
    out = {"init_bit_equal_leaves": len(want) - len(unequal)}
    log(f"  ({part}) rank {rank} {cfg2.name} at {cfg2.num_layers} layers on (1, {world}): "
        f"{out['init_bit_equal_leaves']} of {len(want)} leaves bit-equal to init_params")
    runs = variants(specs)
    first = None if nxt is None else nxt[:, :1]
    for label, transform in runs:
        ref = unsharded(cfg2, transform(want), batch, seq, first, counters)
        with fallbacks() as more:
            r = out[label] = against(ref, pprog, dprog, transform(params), batch, first,
                                     counters, dev)
        del ref
        r.update(layers=cfg2.num_layers, fallback_events=events + more)
        gate_against(r, dev, f"({part}) rank {rank} {cfg2.name} at {cfg2.num_layers} layers, "
                             f"{label}, on (1, {world})", label == runs[-1][0], world == 1)
    del params, want
    memory_mark(dev)
    if not full_depth:
        return out

    # at full depth
    cfg = config(arch, units)
    specs = steps.model_specs(cfg)
    before = memory_mark(dev)
    with fallbacks() as events:
        pprog, dprog = programs(cfg)
        reset_peak(dev)
        t0 = time.perf_counter()
        params = init_params_sharded(specs, SEED, pprog.mesh, pprog.in_placements[0])
        sync(dev)
        t_init = time.perf_counter() - t0
        init_peak = peak_since(dev, before)
        reset_peak(dev)
        walls, launches, finite = [], [], True
        moe_ffn.dropped = 0
        for _ in range(2):
            cache = None  # the first call's cache freed before the second
            counters.reset()
            sync(dev)
            t0 = time.perf_counter()
            logits, cache, clen = pprog.run(params, batch)
            logits = full(logits)
            sync(dev)
            walls.append(time.perf_counter() - t0)
            launches.append(counters.read())
            finite = finite and bool(torch.isfinite(logits).all())
        dropped = int(moe_ffn.dropped)
        counters.reset()
        steps_ms = []
        for t in range(0 if nxt is None else nxt.shape[1]):
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = dprog.run(params, cache, clen + t, nxt[:, t:t + 1])
            logits = full(logits)
            sync(dev)
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            finite = finite and bool(torch.isfinite(logits).all())
        dec = counters.read()
        peak = peak_since(dev, before)
        del logits, cache
        prof = device_profile(lambda: pprog.run(params, batch),
                              rank == 0 and dev.type == "cuda")
    del params
    memory_mark(dev)
    # as many flash launches a layer as the unsharded port's at gate_units
    # (mixtral's prefill takes its 2 rows in 2 chunks: 2 a layer)
    want_flash = (out[runs[-1][0]]["unsharded_launches"]["flash_attention"]
                  * cfg.num_layers // cfg2.num_layers)
    tokens_per_s = B * seq / walls[1]
    decode_ms = sum(steps_ms[1:]) / (len(steps_ms) - 1) if len(steps_ms) > 1 else None
    out["full"] = {"layers": cfg.num_layers, "params": num_params(specs), "init_s": t_init,
                   "init_peak_bytes": init_peak, "first_ms": walls[0] * 1e3,
                   "prefill_ms": walls[1] * 1e3, "tokens_per_s": tokens_per_s,
                   "decode_ms": steps_ms, "decode_ms_per_step": decode_ms,
                   "peak_bytes": peak, "launches": launches, "decode_launches": dec,
                   "dropped": dropped, "finite": finite, "profile": prof,
                   "fallback_events": events}
    log(f"  ({part}) rank {rank} {cfg.name} at {cfg.num_layers} layers on (1, {world}), "
        f"{num_params(specs):,} parameters: init {t_init:.2f} s (peak "
        f"{(init_peak or 0) / 2 ** 30:.2f} GiB); prefill {walls[0] * 1e3:.1f} ms first, then "
        f"{walls[1] * 1e3:.1f} ms ({tokens_per_s:.1f} tokens/s); decode "
        f"{[round(x, 1) for x in steps_ms]} ms a step; peak since the init "
        f"{(peak or 0) / 2 ** 30:.2f} GiB; launches {launches[-1]}, decode {dec}; "
        f"token-choices dropped {dropped} in the two prefills; finite {finite}")
    if prof is not None:
        log(f"  ({part}) rank 0 profiled prefill: {prof['wall_ms']:.1f} ms wall, busy "
            f"{prof['busy_ms']:.1f} ms (idle {prof['idle_share']:.1%}), NCCL "
            f"{prof['nccl_total_ms']:.2f} ms {prof['nccl_ms']} = "
            f"{prof['nccl_share_of_kernel_ms']:.1%} of kernel time")
    gate(finite, f"({part}) at {cfg.num_layers} layers: non-finite logits")
    gate(not any(r["flash_attention"] != want_flash or r["plain_on_cuda"] for r in launches)
         and not dec["plain_on_cuda"],
         f"({part}) at {cfg.num_layers} layers rank {rank}: launches {launches}, decode {dec} "
         f"(want {want_flash} flash a prefill call)")
    return out


def worker(args) -> int:
    """One rank: joins the launcher's group and runs the ranks' parts."""
    sys.path.insert(0, SRC)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    device = "cpu" if args.cpu else None
    t0 = time.perf_counter()
    make_host_mesh(device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device()) if device is None
           else torch.device("cpu"))
    rendezvous = {"rank": rank, "world": world, "backend": dist.get_backend(),
                  "device": str(dev), "local_rank": int(os.environ["LOCAL_RANK"]),
                  "seconds": time.perf_counter() - t0}
    if world != int(os.environ["WORLD_SIZE"]) or rank != int(os.environ["RANK"]) or (
            dev.type == "cuda" and dev.index != rendezvous["local_rank"]):
        raise AssertionError(f"the rendezvous gave {rendezvous}")
    log(f"  rank {rank}: joined {world} rank(s) through env:// on {dev} "
        f"({rendezvous['backend']}) in {rendezvous['seconds']:.2f} s")
    counters = Counters()
    parts = args.parts.split(",")
    out = {"rendezvous": rendezvous}
    if "b" in parts:
        out["b"] = train_part(dev, world, rank, counters)
    if "c" in parts:
        out["c"] = serve_part(dev, world, rank, counters)
    if "d" in parts or "d2" in parts:
        out["d"] = model_part("d", VLM_ARCH, VLM_GATE_UNITS, VLM_UNITS, VLM_SEQ, vlm_batch, dev,
                              world, rank, counters, full_depth="d" in parts)
    if "e" in parts or "e2" in parts:
        out["e"] = model_part("e", MOE_ARCH, MOE_GATE_UNITS, MOE_UNITS, MOE_SEQ, moe_batch, dev,
                              world, rank, counters, full_depth="e" in parts)
    out["failed"] = FAILED
    with open(os.path.join(args.out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# -- the launcher -------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(world: int, parts, out_dir: str, extra=(), alloc_conf=None) -> list:
    """``world`` ranks of this script, started as ``torch.distributed.run``
    starts them (with ``PYTORCH_CUDA_ALLOC_CONF`` = ``alloc_conf`` where
    given); each rank's log is printed; a rank that fails ends them all.
    Returns each rank's results."""
    port = str(free_port())
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        if alloc_conf:
            env["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        logf = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        logs.append(logf)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", "--world", str(world),
             "--parts", ",".join(parts), "--out-dir", out_dir, *extra],
            env=env, stdout=logf, stderr=subprocess.STDOUT))
    t0, failed = time.perf_counter(), None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.perf_counter() - t0 > RANK_TIMEOUT:
                failed = f"the ranks did not finish within {RANK_TIMEOUT} s"
                break
            time.sleep(0.5)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            text = f.read()
        if failed or r == 0:
            for line in text.splitlines()[-400 if failed else None:]:
                log(f"[rank {r}] {line}")
    if failed:
        raise AssertionError(f"the ranks failed: {failed}")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def check_peaks(results: list, predicted: dict) -> dict:
    """Each rank's measured peak against the dry run's prediction: at least
    ``PEAK_FLOOR`` of it and it at least ``PEAK_FLOOR`` of the measured one;
    parts (d)'s and (e)'s also under ``HBM_LIMIT``."""
    out = {}
    for key, pred in predicted.items():
        part, shape = key[0], key[1:]
        if part == "b":  # "b(1, 4)" (TRAIN_ARCH) or "b chatglm3_6b(1, 4)"
            arch, _, mesh = shape.partition("(")
            peaks = [(r["b"][arch.strip()] if arch.strip() else r["b"])["(" + mesh]["peak_bytes"]
                     for r in results]
        else:
            peaks = [r[part]["full"]["peak_bytes"] for r in results]
        ratios = [p / pred for p in peaks]
        out[key] = {"predicted": pred, "measured": peaks, "measured_over_predicted": ratios}
        log(f"  peak a card {key}: measured {[round(p / 2 ** 30, 2) for p in peaks]} GiB, "
            f"the dry run {pred / 2 ** 30:.2f} GiB, measured / predicted "
            f"{[round(x, 4) for x in ratios]}")
        gate(min(ratios) >= PEAK_FLOOR and pred >= PEAK_FLOOR * max(peaks),
             f"{key}: measured peaks {peaks} against the dry run's {pred}")
        gate(part == "b" or max(peaks) < HBM_LIMIT,
             f"{key}: a peak {max(peaks)} bytes reaches {HBM_LIMIT}")
    return out


def launched(results: list) -> dict:
    """Launches by kernel of the programs' runs on every rank (the unsharded
    references' not counted)."""
    total = {}

    def add(row):
        for k, n in row.items():
            if k != "plain_on_cuda":
                total[k] = total.get(k, 0) + n

    for r in results:
        b = r.get("b", {})
        for rec in [*b.values(), *b.get(SPLIT_ARCH, {}).values()]:
            if "launches" in rec:  # a mesh's run (not rank 0's one-card references)
                add(rec["launches"])
        for arch in r.get("c", {}).values():
            for rec in arch.values():
                for m in rec.values():
                    add(m["launches"])
                    add(m["decode_launches"])
        for part in ("d", "e"):
            if part in r:
                for label in ("seeded", "tempered"):
                    add(r[part][label]["launches"])
                    add(r[part][label].get("decode_launches", {}))
                rows = r[part].get("full", {})
                for row in rows.get("launches", []) + [rows.get("decode_launches", {})]:
                    add(row)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4, choices=(1, 4),
                    help="cards (ranks): 4, parts (a)-(e); 1, parts (b) and (e) at 2 "
                         "layers (e2) at (1, 1)")
    ap.add_argument("--parts", default=None,
                    help=f"a comma list of parts: at --world 1 of {', '.join(ONE_CARD_PARTS)}, "
                         f"at --world 4 of {', '.join(PARTS[4])} (default: every part)")
    ap.add_argument("--cpu", action="store_true",
                    help="a rehearsal of the ranks' parts on gloo ranks on the CPU at the "
                         "configs' reduced widths (not the cell: no card, no timing gate)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.cpu:
        rehearse()
    elif not torch.cuda.is_available():
        print("torch_four_cards: no CUDA device; the run needs the cards", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"torch_four_cards: no {os.path.join(SRC, 'repro_torch')}: run the script "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not args.cpu and visible < args.world:
        print(f"torch_four_cards: --world {args.world} needs {args.world} CUDA devices; "
              f"torch sees {visible}", file=sys.stderr)
        return 2
    if args.parts is None:
        parts = ("b", "c", "d", "e") if args.cpu else PARTS[args.world]
    else:
        parts = tuple(args.parts.split(","))
        allowed = ONE_CARD_PARTS if args.world == 1 else PARTS[4]
        if not set(parts) <= set(allowed):
            print(f"torch_four_cards: --parts at --world {args.world} takes "
                  f"{', '.join(allowed)}, got {args.parts}", file=sys.stderr)
            return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    name = "cpu (rehearsal)" if args.cpu else torch.cuda.get_device_name(0)
    smi = "" if args.cpu else smi_line()
    log(f"[four cards] torch {torch.__version__} (CUDA {torch.version.cuda}), {visible} x "
        f"{name}; --world {args.world}, parts {list(parts)}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    skipped = sorted(set(PARTS[4]) - set(parts))
    if skipped:
        why = (f"--parts {args.parts}" if args.world == 4 else
               f"--world 1: {'the run asked for one card' if visible >= 4 else f'{visible} card(s) visible'}; "
               f"the four-card parts need --world 4 and four cards")
        log(f"[four cards] not run: parts {skipped} ({why})")
    summary = {"world": args.world, "device": name, "smi": smi, "parts": list(parts),
               "skipped": skipped}
    if not args.cpu:
        t0 = time.perf_counter()
        _build.build_all()
        log(f"[four cards] kernels built in {time.perf_counter() - t0:.1f} s")
    if "a" in parts:
        t0 = time.perf_counter()
        summary["a"] = analytics_part(args.world)
        summary["launches"] = dict(summary["a"]["launches"])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[a] {time.perf_counter() - t0:.1f} s")
    predicted = {}
    if not args.cpu:
        t0 = time.perf_counter()
        predicted = predictions(args.world, parts)
        log(f"[four cards] dry-run predictions {predicted} in "
            f"{time.perf_counter() - t0:.1f} s")
    rank_parts = [p for p in parts if p != "a"]
    if rank_parts:
        out_dir = tempfile.mkdtemp(prefix="four_cards_")
        try:
            t0 = time.perf_counter()
            results = []
            for group in ([p for p in rank_parts if p not in ALLOC_CONF],
                          [p for p in rank_parts if p in ALLOC_CONF]):
                if not group:
                    continue
                got = launch_ranks(args.world, group, out_dir, ("--cpu",) if args.cpu else (),
                                   ALLOC_CONF.get(group[0]))
                results = got if not results else [
                    {**a, **b, "failed": a["failed"] + b["failed"]}
                    for a, b in zip(results, got)]
            log(f"[four cards] ranks done in {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        for r in results:
            FAILED.extend(f for f in r["failed"] if f not in FAILED)
        summary["peaks"] = check_peaks(results, predicted)
        summary["ranks"] = results
        summary.setdefault("launches", {}).update(launched(results))
    summary["seconds"] = time.perf_counter() - t_start
    summary["failed"] = FAILED
    if FAILED:
        log(f"[four cards] {len(FAILED)} gate(s) unmet in {summary['seconds']:.1f} s: {FAILED}")
    else:
        log(f"[four cards] every gate met in {summary['seconds']:.1f} s")
    log(json.dumps({"four_cards": summary}, default=str))
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
