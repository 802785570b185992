#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # the paper's scale: 4,500 files, StreamScale(1.0)

Phases (any failure exits non-zero and prints no result line; run where
``src/repro_torch`` is not beside the script, or without a CUDA card, it
exits 2 with one line on stderr that says which):

1. environment: torch, the card, its power limit; TF32 off; the probe
   (``repro_torch.dist.measure_machine_spec``): copy bandwidth and f32 and
   bf16 matmul rates measured on the card, each beside its published peak;
2. build: every kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a, one
   process per source, started together), the earlier flash and RG-LRU
   designs among them;
3. kernel parity: each kernel against its plain PyTorch version on the card
   (counts by ``torch.equal``, float sums within ``FLOAT_RTOL`` of the plain
   version taken in float64), for G in {1, 5, 360K, 1.5M, 16M}, V in {1, 3},
   N a batch of paper files, keys out of range on both sides, empty input;
   the cluster-table scatter (with the plan ``tuning.scatter_plan`` takes at
   each G) and the global-atomic scatter also under Zipf keys at 360K; the
   narrow kernel's edges (``narrow_parity``): G in {1, 5, 32, 33, 2,048,
   12,288}, V in {1, 3}, keys and values from row 0 or 1 (one offset from a
   16-byte boundary) or at different offsets, N a multiple of 4 or not, N
   in {1, 2, 3, 5, 7}; each call one launch (``one_call_on_card``: one
   kernel, no fill before it) and its workspace left zero;
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
   ``tuning.matmul_max_g("cuda")``, and the dispatch at the tuned table's
   boundary: the table in force (``tuned_blocks.json`` or the defaults),
   the route each paper query takes at its largest batch beside the
   untuned route, and ``ops.segagg`` at ``matmul_max_g`` and one past it,
   by the table's choice and with each forced formulation, counts exact
   against the plain version and each call through the kernel expected
   (a forced ``"matmul"`` that does not fit must raise and launch nothing);
8. LM kernel parity: the flash-attention kernel (causal or not, window,
   soft-cap, GQA and MQA, ragged S, D in {64, 128, 256}; then prefill
   continuations, Sq < Sk with ``q_offset = Sk - Sq``, causal with and
   without a window, ragged per-row ``kv_valid_len`` of at least 1, D in
   {128, 256}, GQA and MQA, and whisper-medium's shapes at B 8, 16 heads of
   64, not causal: 1,500 frames attending to themselves, and 224 and 4
   queries to them: the rows that see a key against the plain version, the
   rows that see none exactly zero), the RG-LRU
   kernel (ragged S and N, B in {1, 8}) and the SSD kernel (B in {1, 2, 8},
   ragged S, with and without h0, B and C head-shared by stride 0 or per
   head, mamba2's H 32, P 64, N 128 and a smaller set, bf16 and f32)
   against their plain versions on the card, taken in f32 (the flash
   kernel's with q/sqrt(D) rounded to bf16 first, as the JAX layer and
   the kernel round it: ``chunked_attention_f32_ref``);
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
   the earlier f32 CUDA-core kernel at the same shape; the flash kernel
   also at a continuation shape (olmoe-1b-7b's heads, 512 new queries
   after 4,096 keys, full and ragged valid lengths) and at whisper-medium's
   encoder (1,500 x 1,500) and cross-attention (224 x 1,500) shapes at B 8,
   and at one (1, 4) rank's heads of mixtral-8x22b's prefill (B 2, S 4,096,
   12 and 2 heads of 128, causal, window 4,096: SDPA with ``is_causal``),
   and at the last (1, 4) rank's query rows of chatglm3-6b's training core
   (B 4, 512 rows at ``q_offset`` 1,536 over 2,048 keys, 32 and 2 heads of
   128, causal: SDPA with the lower-right causal bias), each beside its
   plain version, SDPA and its bound;
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

15. the device mesh (after phase 13, on phase 4's stream, one-shots and
   models), for CQ3, CQ4 and TPC-Q6-like: ``run_plan`` with
   ``mesh=DeviceMesh(["cuda:0"])`` over phase 4's plan, its aggregate
   against phase 4's (counts exact; the float sum within ``FLOAT_RTOL``, its
   bitwise equality a reading) with the same launches by route; then
   ``MeshAnalyticsBackend`` in ``ExecutorPool(worker_backend=...)`` under
   ``llf-dynamic`` over ``DeviceMesh(["cuda:0"] * W)`` for W = 1 and 2
   (``shard_across=W``, ``ShardedCostModel(phase 4's model, W)``), each
   aggregate against its float64 one-shot, W = 2 with at least one fused
   shard group; wall seconds, batches and launches by route are readings.

16. the serving path (the main path, part 5) at olmoe-1b-7b's full width
   and depth (6,919,096,320 bf16 parameters from ``--seed``, 16 ``moe``
   layers, 64 experts, top-8): ``PrefillExecutor`` with buckets (1, 2, 4,
   8) over prompts of 4,096 tokens (two routing groups of 2,048),
   ``calibrate``, ``serve_single_job`` and ``serve_multi_jobs`` as in
   phase 9; logits finite and (n, 50304), 16 flash launches per prefill
   call, plain versions never called on a CUDA tensor; one batch of 8
   with the plain flash (``chunked_attention_f32_ref``) swapped in at 2
   layers of the same weights within a relative L2 error of 5e-2 of the
   kernels' (16 layers reported); the token-choices dropped by capacity
   (``moe_ffn.dropped``), the card's peak memory and the batch walls are
   readings;
17. decode on each LM while its phase holds it (recurrentgemma-9b after
   phase 14, mamba2-370m after phase 11, olmoe-1b-7b after phase 16):
   at full depth, 8 prompts of the phase's length prefilled into a cache
   of P + 32, then 32 greedy ``CausalLM.decode_step`` calls: logits finite
   and (8, 1, V), no kernel launched and no plain version called on a
   CUDA tensor by the steps; ms a step and tokens/s are readings. Then
   teacher-forced at the phase's gate depth (3, 8 and 2 layers), 2 rows,
   8 steps: each step's logits against the last logits of a prefill of
   the same P + t + 1 tokens (recurrentgemma's P exceeds its window, so
   the ring has wrapped; olmoe takes ``capacity_factor = num_experts`` and
   P = 512, one routing group, so that nothing is dropped). Two gates on
   the relative L2 error of every step: the bf16 kernel path within 5e-2,
   or within twice the distance of the same step with the plain flash
   swapped in where that exceeds 5e-2 (recurrentgemma's seeded attention
   is nearly one-hot, scores up to about 5,000, and a bf16 rounding that
   differs between a one-token and a whole-prompt projection flips a
   near-tie with the kernel or without it); and f32 weights (the RG-LRU
   and SSD kernels in f32, the plain flash, since the kernel takes bf16
   only) within 5e-4, the JAX package's prefill/decode tolerance. The
   bf16 path with the plain flash on inputs widened to f32 (the Pallas
   kernel's arithmetic) is a reading.

18. whisper-medium served (after phase 17, the main path, part 6) at full
   width and depth (24 encoder and 24 decoder layers, 758,550,528 bf16
   parameters from ``--seed``): 8 seeded segments of 1,500 frame
   embeddings (the frontend is a stub, as in the JAX package), prompts of
   224 tokens, a cache of 448. Encode, the decoder's prefill and
   ``encdec_prefill`` timed at b = 1, 2, 4, 8; then ``EncDecLM.prefill``
   and 32 greedy ``decode_step`` calls: logits finite, (8, 51872) and (8,
   1, 51872); 72 flash launches in the prefill (24 encoder, 24 decoder
   self- and 24 cross-attention), none and no plain version on a CUDA
   tensor in the steps; ms a step, tokens/s and peak memory are readings.
   The plain flash (f32 but q/sqrt(D)) swapped in at 2 encoder and 2
   decoder layers: the encoder's output, the decoder's logits on the same
   encoder output and the logits end to end each within a relative L2
   error of 5e-2 of the kernels', or of twice the distance of the plain
   flash on bf16 inputs where that is larger (the seeded cross-attention
   is nearly one-hot, so two plain paths part end to end; full depth a
   reading), and the kernel on the model's own inputs of the first encoder,
   decoder and cross-attention call within 2e-2 of the plain version in
   f32, both divided by v's rms; phase 17's teacher-forced gates on 2 of
   the segments at 1 encoder and 1 decoder layer (the seeded model parts
   fast with depth: the JAX package's own f32 decode is 4.3e-4 from its
   prefill at 2 + 2 layers).

19. training (after phase 18, the main path, part 7): 19a, at yi-6b's
   training shape (B 4, S 2,048, 32 heads of 128, 4 KV heads, causal) and
   whisper-medium's encoder (B 8, 1,500 x 1,500, 16 heads of 64, not
   causal) and cross-attention (224 x 1,500) shapes, the flash kernel's
   log-sum-exp against the f32 reference's within 1e-3, its output the
   same with and without the lse, and dq, dk, dv of ``chunked_attention``
   (the kernel's forward, then ``flash_bwd`` in PyTorch ops) against
   ``flash_bwd`` fed the f32 reference's output and lse within a relative
   L2 error of 2e-2; the kernel's time with and without the lse beside its
   bound, the plain version's and SDPA's, and the backward's beside SDPA's
   backward.  19b, the loss and every gradient leaf (f32 masters cast to
   bf16, seeded init) of yi-6b at full width and 2 layers (B 2 x S 2,048,
   ``lm_loss``) and whisper-medium at 2 + 2 layers (B 2, 1,500 frames, 224
   tokens, ``encdec_loss``), the kernel path against the plain flash
   swapped in, each within 5e-2 or twice the distance of two plain
   flashes that differ in rounding only.  19c, the trainer
   (``repro_torch.launch.train.main``) at its defaults (yi-6b reduced and
   widened, 4 layers) for 20 steps with a checkpoint every 10, then
   ``--resume`` to 25: resumed at step 20, losses finite, the last below
   the first, two flash launches a layer a step.  19d, yi-6b at full width
   cut to 8 of its 32 layers (its AdamW state at 32 does not fit one card),
   5 AdamW steps on ``synthetic_batches`` of 4 x 2,048: loss and gradient
   norm finite, 16 flash launches a step and no RG-LRU, SSD or plain
   flash; ms a step, tokens/s, peak memory, model FLOPs over the measured
   bf16 peak and a profile of one more step by class are readings.  First,
   the guard: a ``kv_valid_len`` flash call (no backward) raises on a CUDA
   input that needs a gradient.
20. training the recurrent kinds (after phase 19, the main path, part 8):
   20a, the RG-LRU kernel with carries bit-equal to without, and the
   backward kernel (``rglru_bwd_cuda``) against ``rglru_bwd_ref`` at
   recurrentgemma-9b's training shape (B 2, S 4,096, N 4,096) and a ragged
   one (S 1,000, N 80, h0 and dh_last), bf16 and f32; its time beside its
   byte bound.  20b, the SSD kernel with states bit-equal to without, its
   states against the plain version's, and ``ssd_bwd`` (PyTorch ops) fed
   them against autograd through ``ssd_chunked_ref`` in f32 at mamba2's
   training shape (B 8, S 2,048, H 32, P 64, N 128, B and C head-shared)
   and at a ragged S with h0; its time beside the forward's.  20c, the loss
   and every gradient leaf of mamba2-370m at 2 layers and recurrentgemma-9b
   at one period (3 layers), the kernel path against the plain versions on
   the card, 19b's rule (and its tempering of wq and wk).  20d, the trainer
   with ``--arch mamba2_370m`` at its other defaults, resumed (two SSD
   launches a layer a step).  20e, 5 AdamW steps of mamba2-370m at full
   width and 48 layers (B 8 x S 2,048) and of recurrentgemma-9b at full
   width cut to 3 layers (B 2 x S 4,096): losses and gradient norms finite,
   the kernels launched as the layers say (the RG-LRU backward once a
   ``rglru`` layer a step), no plain version on the card; ms a step,
   tokens/s, model FLOPs (the SSD's, attention's and the RG-LRU's terms
   counted) over the measured bf16 peak, peak GiB and a profile by class
   are readings.
21. the sharded programs (after phase 20, the main path, part 9;
   ``launch/steps.py`` on ``launch/mesh.py``'s ``make_host_mesh``, a
   one-rank NCCL group): 21a, ``build_train_program`` for yi-6b at full
   width and 8 layers, B 4 x S 2,048 (phase 19d's cell), 3 steps beside
   ``train_step`` on the same seed and batches: every leaf of the state
   bit-equal (else the worst leaf within 2e-2 relative L2), 16 flash
   launches a step in the program and no plain version on the card; ms a
   step and peak GiB of each path are readings.  21c, the prefill program
   and one decode program on recurrentgemma-9b at 3 layers and mamba2-370m
   at 8 (B 2, S 4,096): logits and cache bit-equal to ``lm.prefill`` and
   ``lm.decode_step``, the same flash, RG-LRU and SSD launches.  Then the
   group is destroyed and the dry run (``launch/dryrun.py``, a fake group,
   fake CUDA tensors) traces: 21b, 21a's cell on a (1, 1) mesh, its
   predicted peak beside 21a's measured one (fail below 0.75 of it); 21d,
   yi-6b ``train_4k`` on the single production mesh (data 32 x model 8),
   whose peak a card must be below the 16.64 GiB it had with the residual
   stream's sequence whole between units (``models/lm.py`` ``UNIT_AXES``).

22. the port across cards (after phase 21, the main path, part 10):
   ``scripts/torch_four_cards.py`` in a process group of its own, which
   starts its ranks as ``torch.distributed.run`` does (``make_host_mesh``
   joins them through ``env://``, one card a rank): with four cards visible
   ``--world 4``, its parts (a)-(e) (the analytics mesh over
   ``DeviceMesh(4)``, the train program on (4, 1) and (1, 4), the prefill
   and decode programs there, internvl2-76b prefilled at 80 layers on (1,
   4), mixtral-8x22b served at 56 layers on (1, 4)); with fewer, ``--world
   1``: one rank through the same rendezvous, ``init_params_sharded``
   against ``init_params`` and 21a's train program (wq and wk divided by
   16, as in 19b) at (1, 1) for 2 steps against ``train_step`` within
   2e-2, its peak against the dry run's both ways (0.75); then part (e) at
   2 layers of full-width mixtral-8x22b on (1, 1): the leaf-wise init, the
   prefill program's logits and cache and one decode step bit-equal to the
   unsharded port, the same flash launches; and a line that names the
   parts not run.  A failure there fails the smoke.

23. the example twins (after phase 22, the main path, part 11), each run
   as a user runs it, ``PYTHONPATH=src`` and no ``--device``, in a process
   of its own: ``examples/torch_deadline_analytics.py --scale 1.0 --files
   4500`` (CQ3 at the paper's scale: calibration, the ``single`` plan,
   ``run_plan`` on the card, the aggregate equal to the plain version's
   one-shot on the host) and ``examples/torch_multi_query_serving.py
   --full`` (yi-6b at 32 layers: ``calibrate``, three jobs under LLF, every
   job met and every prompt processed); each exits 0, the first through
   segagg's ``cuda`` route with the cluster-table scatter launched, the
   second with 32 flash launches a prefill call; their lines and seconds
   are logged.

Phases 12-15 count their launches apart from phases 4-5 (phase 6's counts)
and the serving paths; the result line carries them under
``launches_by_phase`` (flash's ``launches`` is phases 9, 16, 18, 19 (19c
and 19d), 20 (20e), 21 (the programs' runs in 21a and 21c), 22 (its
programs' runs on every rank) and 23 (the serving twin) together; the
segagg kernels' is phases 4-5, 22 and 23 (the analytics twin);
``rglru_bwd`` is 20e's).

Each parity line prints the largest absolute error and its worst ratio to
the ``torch.allclose`` limit ``atol + rtol |want|`` (the check passes up to
1).  The line before the last is a JSON object with one entry per kernel
(flash and RG-LRU at B = 8, with ``old_ms``, the earlier design's time; the
cluster-table scatter at CQ3 with ``old_ms`` and its plan); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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
# The narrow kernel's edges: register slots (1, 5, 32), the shared table
# (33, 2,048, 12,288 = NARROW_TABLE_BYTES / 4).
NARROW_GROUPS = (1, 5, 32, 33, 2048, 12288)
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
MOE_ARCH = "olmoe_1b_7b"
MOE_SEQ = 4096              # two routing groups of 2,048 a prompt
MOE_GATE_UNITS = 2
RG_GATE_UNITS = 1           # one (rglru, rglru, attn) unit: 3 layers
DECODE_STEPS = 32           # phase 17 at full depth, greedy
TF_BATCH, TF_STEPS = 2, 8   # phase 17's teacher-forced gate
MOE_TF_SEQ = 512            # one routing group: olmoe's teacher-forced prompt
# Phase 17's gates on the logits' relative L2 error: the bf16 kernel path at
# LOGITS_REL_L2 at each step, or within NOISE_RATIO x the distance of the
# same step with the plain flash swapped in where that exceeds it (a near-tie
# of the seeded model that the kernel does not cause); f32 weights at the JAX
# package's own prefill/decode tolerance (tests/test_arch_smoke.py).
DECODE_F32_REL_L2 = 5e-4
# Phase 8, prefill continuations: (B, Sq, Sk, H, Hkv, D, causal, window,
# ragged kv_valid_len); q_offset = Sk - Sq.
CONTINUATIONS = ((2, 333, 1000, 16, 2, 128, True, 0, False),
                 (3, 200, 1500, 16, 1, 256, True, 512, True),
                 (2, 128, 4224, 16, 16, 128, True, 0, True),
                 (4, 1, 777, 8, 2, 128, True, 0, True),
                 (2, 500, 2500, 16, 1, 256, True, 2048, False),
                 (2, 300, 900, 8, 8, 128, False, 0, True),
                 # whisper-medium at B 8: the encoder's self-attention over
                 # 1,500 frames (23 full 64-key tiles and one of 28), the
                 # cross-attention of a 224-token prompt, and of the 4-token
                 # start sequence alone
                 (8, 1500, 1500, 16, 16, 64, False, 0, False),
                 (8, 224, 1500, 16, 16, 64, False, 0, False),
                 (8, 4, 1500, 16, 16, 64, False, 0, False))
# Phase 18, whisper-medium: 8 segments of 1,500 frames; a prompt of 224
# tokens (the start sequence and previous-text conditioning); a cache of 448,
# the decoder's text context.
WHISPER_ARCH = "whisper_medium"
WHISPER_PROMPT = 224
WHISPER_CACHE = 448
WHISPER_GATE_UNITS = 2      # the plain-flash swap: 2 encoder and 2 decoder layers
# The teacher-forced gates: 1 encoder and 1 decoder layer.  The seeded model
# parts fast with depth: in f32 the JAX package's own decode is 1.6e-5 from
# its prefill at 1 + 1 layers and 4.3e-4 at 2 + 2, near DECODE_F32_REL_L2
# (scripts/reference_decode_check.py, PERF.md).
WHISPER_TF_UNITS = 1
# Phase 19, training.  yi-6b at full width cut to 8 of its 32 layers: at 32
# the f32 masters and AdamW moments alone (6.06B x 12 B = 73 GB) do not fit
# one card beside the gradients; 8 layers hold 1.91B parameters.
TRAIN_ARCH = "yi_6b"
TRAIN_UNITS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 2048     # 8,192 tokens a step
TRAIN_STEPS = 5
SHARDED_STEPS = 3           # phase 21a: program and train_step, step by step
SHARDED_REL_L2 = 2e-2       # 21a's gate where a leaf is not bit-equal
SHARDED_SERVE = ((SERVE_ARCH, 1), (SSM_ARCH, 8))   # 21c: (arch, units)
SHARDED_BATCH, SHARDED_SEQ = 2, SERVE_SEQ
PEAK_FLOOR = 0.75           # 21b: predicted / measured peak at least this
# 21d: yi-6b train_4k's peak a card on the single mesh with the residual
# stream's sequence whole between units (the dry run, derived, not measured:
# 16.64 GiB); with it split on "model" the peak must stay below this.
TRAIN_4K_WHOLE_PEAK = 17_861_699_346
FOUR_CARDS_TIMEOUT = 900    # phase 22: seconds for scripts/torch_four_cards.py
# Phase 23: the analytics twin at the paper's Section 7.1 scale, and the
# seconds each twin may take
TWIN_ANALYTICS_ARGS = ("--scale", "1.0", "--files", "4500")
TWIN_TIMEOUT = 300
TWIN_SEQ = 64               # the serving twin's prompt length (examples/torch_multi_query_serving.py)
TWIN_FLASH_BATCHES = (1, 16)  # phase 10: its smallest and largest prefill buckets
# 19a: the kernel's lse against the f32 reference's (the same f32 logits
# summed in another order) and dq, dk, dv against flash_bwd fed the f32
# reference's output and lse (bf16 gradients, and delta = rowsum(dO O) from
# the kernel's bf16 output).  (label, B, Sq, Sk, H, Hkv, D, causal)
LSE_ATOL = 1e-3
GRAD_REL_L2 = 2e-2
TRAIN_FLASH_SHAPES = (("yi-6b training", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 4, 128, True),
                      ("whisper encoder", 8, 1500, 1500, 16, 16, 64, False),
                      ("whisper cross-attention", 8, WHISPER_PROMPT, 1500, 16, 16, 64, False))
# 19b: the loss and each gradient leaf with the kernel against the plain
# flash, at 2 layers (whisper 2 + 2), within TRAIN_REL_L2 or NOISE_RATIO x the
# distance of two plain flashes (phase 17's rule); a leaf under ZERO_LEAF of
# the whole gradient's norm is measured against that floor.
TRAIN_GATE_UNITS = 2
TRAIN_GATE_BATCH = 2
TRAIN_REL_L2 = 5e-2
ZERO_LEAF = 1e-3
# ... and again with each wq and wk divided by TEMPER[arch], so that the
# scores are not nearly one-hot: yi's seeded scores (q rms 11, k rms 32) have
# rms ~360, 1.4 after 16 x 16; whisper's (q and k rms 8) ~64, 4 after 4 x 4
# (at 16 x 16, 0.25, its 1,500-frame cross-attention is nearly uniform and
# its wq and wk gradients as noisy as the seeded ones: 0.34 against a plain
# pair's 0.38).  The same rule as above.
TEMPER = {"yi_6b": 16.0, "whisper_medium": 4.0, "recurrentgemma_9b": 16.0}
# 19c: the trainer at its defaults, a checkpoint every 10 steps, then resumed.
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_RESUME_STEPS = 20, 10, 25
# Phase 20, training the recurrent kinds.  recurrentgemma-9b at full width
# cut to one (rglru, rglru, attn) period: its two untied 256,000 x 4,096
# tables alone hold 2.1B parameters, and at ~18.4 bytes a parameter for
# masters, AdamW moments, gradients and bf16 copies two periods (3.3B) would
# need ~63 GB before activations; prompts of SERVE_SEQ, so the 2,048 window
# is live.  mamba2-370m at full width and depth, the Mamba-2 paper's
# training length.
RG_TRAIN_UNITS = 1
RG_TRAIN_BATCH, RG_TRAIN_SEQ = 2, SERVE_SEQ
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 8, 2048
# 20a: the RG-LRU backward kernel against rglru_bwd_ref (sequential, f32) at
# recurrentgemma's training shape (timed), a ragged one with h0 and dh_last
# (N 80: the element path), S below one chunk, and rows off a 16-byte
# boundary (contiguous views at storage offset 1: the element path at N
# 4,096): (B, S, N, with h0 and dh_last, storage offset).  Relative L2
# error of each gradient: in
# f32 1e-4 (the CPU tests' tolerance against the JAX package's autodiff;
# the two differ in summation order, expf and fused multiply-adds); in bf16
# dx, dr and di are rounded once to bf16 (relative L2 ~1e-3): 1e-2; d
# a_param and dh0 stay f32: 1e-4.
RGLRU_BWD_SHAPES = ((RG_TRAIN_BATCH, RG_TRAIN_SEQ, 4096, False, 0), (2, 1000, 80, True, 0),
                    (2, 127, 4096, True, 0), (2, 1000, 4096, True, 1))
RGLRU_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# 20b: the SSD's states against the plain version's (SSD_H_RTOL and
# SSD_H_ATOL), and ssd_bwd fed the f32 kernel's states against autograd
# through ssd_chunked_ref in f32 within 2e-4 relative L2 (the JAX package's
# SSD tolerance), at mamba2's training shape with B and C head-shared and
# at a ragged S with h0 and dh_last: (B, S, H, P, N, with h0 and dh_last).
SSD_BWD_SHAPES = ((SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, 32, 64, 128, False),
                  (2, 1000, 32, 64, 128, True))
SSD_BWD_TOL = 2e-4
# 20c: mamba2 at 2 layers (B 2 x S 2,048), recurrentgemma at one period (B 1
# x S 4,096), phase 19b's rule.
SSM_TRAIN_GATE_UNITS = 2
RG_TRAIN_GATE_BATCH = 1
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
MESH_QUERIES = ("CQ3", "CQ4", "TPC-Q6-like")   # phase 15: the three segagg routes
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
                keys = wild_keys(rows, g, gen).cuda()
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


def wild_keys(n: int, g: int, gen) -> torch.Tensor:
    """(n,) int32 keys uniform in [0, g), 1% of them outside on either side
    (negative ones included, down to -(g + 1))."""
    keys = torch.randint(0, g, (n,), generator=gen, dtype=torch.int32)
    bad = torch.rand(n, generator=gen) < 0.01
    wild = torch.randint(1, g + 2, (n,), generator=gen, dtype=torch.int32)
    keys = torch.where(bad & (wild % 2 == 0), -wild, keys)
    return torch.where(bad & (wild % 2 == 1), g - 1 + wild, keys)


def narrow_parity(fn, work, fits, segagg_ref, rows: int) -> int:
    """The narrow kernel's paths against the plain version: counts by
    ``torch.equal``, float sums within ``FLOAT_RTOL`` of the plain version in
    float64.  For each G of ``NARROW_GROUPS`` and V in (1, 3): N ``rows`` and
    ``rows`` + 3, keys and values both from row 0 or both from row 1 of
    longer tensors (the vector path with 0 or 3 head rows), and at V = 1
    keys from row 1 beside values from row 0 (the element path); then N in
    {1, 2, 3, 5, 7} from rows 0-3; a (G, V) table that does not ``fits``
    is left out.  After each call the stream's workspace
    (``work()``) must be zero again.  Then one call must run one kernel on
    the card, the narrow one, and count one launch (``one_call_on_card``).
    Returns the cases."""
    gen = torch.Generator().manual_seed(7)

    def check(what, keys, vals, g):
        ones = torch.ones_like(vals)
        if not torch.equal(fn(keys, ones, g), segagg_ref(keys, ones, g)):
            raise AssertionError(f"segagg_narrow {what}: counts differ")
        got, want = fn(keys, vals, g).double(), segagg_ref(keys, vals.double(), g)
        if not torch.allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
            raise AssertionError(f"segagg_narrow {what}: float sums differ")
        if work().any():
            raise AssertionError(f"segagg_narrow {what}: workspace not left zero")
        return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()

    cases = 0
    worst = 0.0
    for g in NARROW_GROUPS:
        for v in (v for v in (1, 3) if fits(g, v)):
            for n in (rows, rows + 3):
                keys = wild_keys(n + 4, g, gen).cuda()
                vals = torch.rand((n + 4, v), generator=gen).cuda()
                layouts = [(0, 0), (1, 1)] + ([(1, 0)] if v == 1 else [])
                for ko, vo in layouts:
                    worst = max(worst, check(f"G={g} V={v} N={n} rows from {ko}/{vo}",
                                             keys[ko:ko + n], vals[vo:vo + n], g))
                    cases += 1
        log(f"  parity segagg_narrow         G={g:>9} V={'1, 3' if fits(g, 3) else '1'}, "
            f"N={rows}, {rows + 3}, "
            f"aligned, offset 1, keys and values apart: counts equal, workspace zero")
    for g in (1, 5, 33):
        for v in (1, 3):
            for n in (1, 2, 3, 5, 7):
                for off in range(4):
                    keys = wild_keys(n + 4, g, gen).cuda()
                    vals = torch.rand((n + 4, v), generator=gen).cuda()
                    worst = max(worst, check(f"G={g} V={v} N={n} from row {off}",
                                             keys[off:off + n], vals[off:off + n], g))
                    cases += 1
    keys = wild_keys(rows, 5, gen).cuda()
    vals = torch.rand((rows, 1), generator=gen).cuda()
    fn(keys, vals, 5)
    torch.cuda.synchronize()
    how, on_card, launched = one_call_on_card(lambda: fn(keys, vals, 5), fn)
    # a graph's nodes carry no names: there the wrapper's count names the kernel
    one = (on_card == ["kernel"] if how == "graph"
           else len(on_card) == 1 and "segagg_narrow" in on_card[0])
    if not one or launched != 1:
        raise AssertionError(f"segagg_narrow: one call ran {on_card} on the card ({how}), "
                             f"{launched} launches counted")
    log(f"  parity segagg_narrow         {cases} cases (N 1-7 too): counts equal, float rel "
        f"err {worst:.3e}; one call = one kernel on the card ({how}: {on_card[0][:60]})")
    return cases


def one_call_on_card(call, wrapper, tries: int = 3) -> tuple[str, list, int]:
    """What one ``call()`` runs on the card, and the launches ``wrapper``
    counted in it: ``("profiler", [kernel names], n)`` from the first of
    ``tries`` ``torch.profiler`` sessions that records any device activity;
    where none does (CUPTI can deliver nothing in a session), ``("graph",
    [node types], n)``, the call captured once into a CUDA graph and the
    graph's device nodes read through the driver (kernel, memcpy, memset;
    the nodes carry no kernel names).  ``call`` must have run once before, so
    that nothing it makes once (a stream's workspace) falls in the record."""
    import ctypes

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if on_card:
            return "profiler", on_card, wrapper.launches - before
    log(f"  the profiler recorded no device activity in {tries} sessions; "
        f"reading one call from a CUDA graph instead")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # once on the capture stream, for what it makes once
        call()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = wrapper.launches
    with torch.cuda.graph(graph, stream=stream):
        call()
    launched = wrapper.launches - before
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType; the rest do no work
    on_card = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value in kinds:
            on_card.append(kinds[kind.value])
    del graph
    torch.cuda.synchronize()
    return "graph", on_card, launched


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
    bound_ms, bound_by = bound(*flops_bytes(keys.shape[0], g, vals.shape[1]), "float32")
    return {
        "max_abs_err": (got - want).abs().max().item(),
        "ms": cuda_ms(lambda: fn(keys, vals, g)),
        "plain_ms": cuda_ms(lambda: segagg_ref(keys, vals, g)),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": cuda_ms(library),
    }


ROUTE_KERNEL = {"narrow": "segagg_narrow", "cluster": "segagg_scatter",
                "atomic": "segagg_scatter_atomic"}


def segagg_route(tuning, scatter_plan_for, n: int, g: int, form=None, untuned=False) -> str:
    """``narrow``, ``cluster`` or ``atomic``: the route of an (n, g, V = 1)
    call by the table in force (or, ``untuned``, by the compiled-in
    defaults), or with formulation ``form`` forced."""
    if untuned:
        if g <= tuning.DEFAULT_MATMUL_MAX_G and tuning.narrow_fits(g, 1):
            return "narrow"
        return scatter_plan_for(g, 1, "cuda", n=n, max_ranges=tuning.SCATTER_MAX_RANGES,
                                sizes=tuning.SCATTER_CLUSTER_SIZES).route
    if tuning.pick_formulation("cuda", n, g, 1, form) == "narrow":
        return "narrow"
    return scatter_plan_for(g, 1, "cuda", n=n).route


def tuned_dispatch(ops, tuning, scatter_plan_for, segagg_ref, kernels, queries: dict,
                   rows: int) -> None:
    """The dispatch at the tuned table's boundary (phase 7's last lines):
    the table in force and each paper query's route at its largest batch
    (``queries``: id -> (rows, G)), then ``ops.segagg`` at ``matmul_max_g``
    and one past it over ``rows`` uniform keys, by the table's choice and
    with each forced formulation: counts exact, one launch of the kernel
    the route names, and a forced ``"matmul"`` whose table does not fit
    refused with no launch."""
    path = tuning.TUNED_PATH
    max_g = tuning.matmul_max_g("cuda")
    log(f"    dispatch: table {path.relative_to(path.parents[4]) if path.is_file() else 'none'}"
        f" ({'tuned' if path.is_file() else 'the compiled-in defaults'}); "
        f"matmul_max_g('cuda') = {max_g}; tuned_blocks('cuda') small-wide "
        f"{tuning.tuned_blocks('cuda', 26_000, 360_000)}, large-wide "
        f"{tuning.tuned_blocks('cuda', rows, 360_000)}")
    for qid, (n, g) in queries.items():
        log(f"    dispatch: {qid:12s} N={n:>9} G={g:>8} ({tuning.shape_class(n, g)}): "
            f"{segagg_route(tuning, scatter_plan_for, n, g)} (untuned "
            f"{segagg_route(tuning, scatter_plan_for, n, g, untuned=True)})")
    gen = torch.Generator(device="cuda").manual_seed(2)
    ones = torch.ones((rows, 1), device="cuda")
    for g in (max_g, max_g + 1):
        if g < 1:
            continue
        keys = torch.randint(0, g, (rows,), device="cuda", generator=gen, dtype=torch.int32)
        want = segagg_ref(keys, ones, g)
        for form in (None, "matmul", "scatter"):
            before = {k: fn.launches for k, fn in kernels.items()}
            if form == "matmul" and not tuning.narrow_fits(g, 1):
                try:
                    ops.segagg(keys, ones, g, formulation=form)
                except ValueError as exc:
                    refused = str(exc)
                else:
                    raise AssertionError(f"dispatch G={g}: a forced 'matmul' that does not "
                                         f"fit ran")
                if {k: fn.launches for k, fn in kernels.items()} != before:
                    raise AssertionError(f"dispatch G={g}: a refused call launched")
                log(f"    dispatch G={g:>6} formulation='matmul': refused ({refused})")
                continue
            route = segagg_route(tuning, scatter_plan_for, rows, g, form)
            if form is None and (route == "narrow") != (g <= max_g):
                raise AssertionError(f"dispatch G={g}: route {route} against "
                                     f"matmul_max_g {max_g}")
            got = ops.segagg(keys, ones, g, formulation=form)
            launched = {k: fn.launches - before[k] for k, fn in kernels.items()}
            if launched != {k: int(k == ROUTE_KERNEL[route]) for k in kernels}:
                raise AssertionError(f"dispatch G={g} formulation={form}: launches "
                                     f"{launched}, route {route}")
            if not torch.equal(got, want):
                raise AssertionError(f"dispatch G={g} formulation={form}: counts differ")
            log(f"    dispatch G={g:>6} formulation={form!r}: {ROUTE_KERNEL[route]}, "
                f"N={rows}, counts equal")


# -- phase 8 -----------------------------------------------------------------

def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error |got - want| / |want|."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


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


def lm_kernel_parity(flash_cuda, flash_f32, rglru_cuda, rglru_plain) -> None:
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
        want = flash_f32(q, k, v, causal, window, cap)
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


def flash_continuation_parity(flash_cuda, flash_f32, rows_with_keys) -> None:
    """The flash kernel with ``q_offset`` and ``kv_valid_len`` against its
    plain version in f32 (``flash_f32``) on the rows that see a key; the
    rows that see none are zeros (the plain version gives them a softmax
    over masked keys)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for B, Sq, Sk, H, Hkv, D, causal, window, ragged in CONTINUATIONS:
        q = torch.randn((B, Sq, H, D), device="cuda", generator=gen).bfloat16()
        k = torch.randn((B, Sk, Hkv, D), device="cuda", generator=gen).bfloat16()
        v = torch.randn((B, Sk, Hkv, D), device="cuda", generator=gen).bfloat16()
        valid = (torch.randint(1, Sk + 1, (B,), device="cuda", generator=gen,
                               dtype=torch.int32) if ragged else None)
        off = Sk - Sq
        got = flash_cuda(q, k, v, causal, window, 0.0, off, valid)
        want = flash_f32(q, k, v, causal, window, 0.0, q_offset=off, kv_valid_len=valid)
        live = rows_with_keys(B, Sq, Sk, causal, window, off, valid, device="cuda")
        if got[~live].any():
            raise AssertionError(f"flash continuation B={B} Sq={Sq} Sk={Sk}: rows that "
                                 f"see no key are not zero")
        err = check_close(f"flash continuation B={B} Sq={Sq} Sk={Sk}", got[live],
                          want[live], BF16_TOL)
        lens = "none" if valid is None else str(valid.tolist())
        log(f"  parity flash_attention B={B} Sq={Sq:>3} Sk={Sk:>4} q_offset={off:>4} "
            f"H={H:>2} Hkv={Hkv:>2} D={D:>3} causal={causal!s:5} window={window:>4} "
            f"kv_valid_len={lens}: {int(live.sum())} of {B * Sq} rows see a key, max abs "
            f"err {shown(err)}")


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


# -- phase 15 ----------------------------------------------------------------

def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def same_as(qid: str, got: np.ndarray, want: np.ndarray, what: str) -> str:
    """``got`` against ``want`` (both f32 aggregates of one run): counts
    bitwise, the float sum within ``FLOAT_RTOL`` (its atomics add in an
    order that changes from run to run), its bitwise equality a reading."""
    if np.array_equal(got, want):
        return f"equal to {what} bitwise"
    if qid != "TPC-Q6-like" or not np.allclose(got, want, rtol=FLOAT_RTOL, atol=0.0):
        raise AssertionError(f"{qid}: differs from {what}")
    return (f"within rel {np.abs(got - want).max() / np.abs(want).max():.2e} of {what} "
            f"(not bitwise)")


def mesh_path(aq, files, arrival, oneshot, model, phase4, sc, rec) -> None:
    """Phase 15 for one query: ``run_plan`` over a one-slot mesh against
    phase 4's run of the same plan, then ``MeshAnalyticsBackend`` under
    ``llf-dynamic`` over one and two slots of the card."""
    from repro_torch import core
    from repro_torch.dist import DeviceMesh
    from repro_torch.serve.analytics import MeshAnalyticsBackend, run_plan

    qid, n = aq.query_id, len(files)
    q4, plan, want, want_launches = phase4
    before = rec.counts()
    t0 = time.perf_counter()
    got, blog, _ = run_plan(aq, files, plan, sc, mesh=DeviceMesh(["cuda:0"]))
    wall = time.perf_counter() - t0
    launched = diff(rec.counts(), before)
    if launched != want_launches:
        raise AssertionError(f"{qid}: run_plan over a one-slot mesh launched {launched}, "
                             f"phase 4's run_plan {want_launches}")
    log(f"  {qid:12s} run_plan, mesh ['cuda:0']: {len(blog)} batches, {wall:.2f} s wall, "
        f"launches {launched} (phase 4: the same); {same_as(qid, got, want, 'phase 4')}")
    for ways in (1, 2):
        mesh = DeviceMesh(["cuda:0"] * ways)
        wb = MeshAnalyticsBackend({qid: (aq, files)}, sc, mesh)
        cm = core.ShardedCostModel(model, ways) if ways > 1 else model
        q = core.Query(qid, arrival.wind_start, arrival.wind_end, q4.deadline, n, cm, arrival)
        before = rec.counts()
        t0 = time.perf_counter()
        trace = core.run(core.get_policy("llf-dynamic", shard_across=ways), [q],
                         core.ExecutorPool(worker_backend=wb))
        wall = time.perf_counter() - t0
        o = trace.outcome(qid)
        if not o.complete:
            raise AssertionError(f"{qid}: the mesh run over {ways} slot(s) did not complete")
        verdict = check_result(qid, wb.results[qid], oneshot)
        batches = [e for e in trace.executions if e.kind == "batch"]
        calls = len({(e.start, e.end) for e in batches})
        if ways > 1 and calls >= len(batches):
            raise AssertionError(f"{qid}: no shard group was fused over {ways} slots")
        files_per = sorted({e.num_tuples for e in batches})
        log(f"  {qid:12s} MeshAnalyticsBackend, {ways} slot(s) of cuda:0: {wall:.2f} s wall "
            f"({sum(wb.wall_seconds.values()):.2f} in dispatches), {len(batches)} batches "
            f"in {calls} mesh calls (files a batch {files_per[0]}-{files_per[-1]}), "
            f"stragglers {len(trace.stragglers)}, launches {diff(rec.counts(), before)}; "
            f"measured finish {o.completion_time:.4f} vs deadline {o.deadline:.4f}: "
            f"{outcome(o.completion_time, o.deadline)}; {verdict}")


# -- phase 16 ----------------------------------------------------------------

def widened(flash_plain):
    """The plain flash on its inputs widened to f32, its output in their
    dtype: the Pallas kernel's arithmetic (q K^T scaled in f32, p in f32),
    which the port's kernel does not follow (it rounds q/sqrt(D) as the
    JAX layer does)."""
    def call(q, k, v, *a, **kw):
        return flash_plain(q.float(), k.float(), v.float(), *a, **kw).to(q.dtype)
    return call


def moe_path(args, cfg, lm, engine, core, counters, fa_ops, flash_f32, moe_layer):
    """The olmoe-1b-7b serving path (``serving_path``) with its readings
    (token-choices dropped by capacity, from ``moe_ffn.dropped``, and peak
    memory) and the plain-flash swap.  Returns the prefill executor, a
    batch of 8 prompts and the launch counts of the path."""
    moe_layer.moe_ffn.dropped = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex, _, batch8, moe_launches = serving_path(args, cfg, MOE_SEQ, lm, engine, core,
                                               counters)
    routed = (sum(b * row["calls"] for b, row in moe_launches["by_batch"].items())
              * MOE_SEQ * cfg.top_k * cfg.num_layers)
    check_launches(cfg, moe_launches, time.perf_counter() - t0)
    dropped = int(moe_layer.moe_ffn.dropped)
    log(f"  token-choices dropped by capacity (capacity_factor {cfg.capacity_factor}): "
        f"{dropped} of {routed} ({dropped / routed:.3%}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}")
    # The same batch of 8 with the plain flash swapped in, in f32 but for
    # q/sqrt(D)'s rounding (the standard phase 8 holds the kernel to): the
    # gate at MOE_GATE_UNITS layers, all 16 reported (seeded weights drift
    # with depth).
    log("  kernel path against the plain flash (f32 but q/sqrt(D)) on one batch of 8, by "
        "depth: logits relative L2 error, argmax agreement, wall ms (kernels / plain)")
    swap = [(fa_ops, "flash_attention_cuda",
             lambda q, k, v, *a, **kw: flash_f32(q, k, v, *a, **kw).to(q.dtype))]
    for units in (MOE_GATE_UNITS, None):
        rel, agree, t_k, t_p, _ = plain_swap(ex, batch8, units, swap)
        layers = cfg.num_layers if units is None else units
        log(f"    {layers:2d} layers: rel L2 {rel:.3e}, argmax agreement {agree:.3f}, "
            f"{t_k * 1e3:.1f} / {t_p * 1e3:.1f} ms")
        if units is not None and not rel < LOGITS_REL_L2:
            raise AssertionError(f"kernel path and plain path disagree at {layers} layers: "
                                 f"rel L2 {rel:.3e} (limit {LOGITS_REL_L2})")
    try:
        profile_batch(lambda: ex.run_batch(batch8), "one batch of 8")
    except Exception as exc:  # the profiler is a reading, not a gate
        log(f"    profiler failed: {exc!r}")
    return ex, batch8, moe_launches


# -- phase 17 ----------------------------------------------------------------

@contextlib.contextmanager
def swapped(mod, attr, fn):
    """``mod.attr`` replaced by ``fn`` inside the block (left alone when
    ``fn`` is None)."""
    kept = getattr(mod, attr)
    if fn is not None:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, kept)


def teacher_forced(prefill, decode_step, cfg, params, P, seed) -> list:
    """Relative L2 distance of each of ``TF_STEPS`` decode steps' logits
    (``TF_BATCH`` rows, after a prefill of ``P`` tokens) to the last logits
    of a prefill of the same ``P + t + 1`` tokens.  ``prefill(cfg, params,
    tokens, cache_size)`` returns (logits, cache, cache_len)."""
    rng = np.random.default_rng(seed + 17)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TF_BATCH, P + TF_STEPS))
                            .astype(np.int32)).to("cuda")
    _, cache, clen = prefill(cfg, params, toks[:, :P], P + TF_STEPS)
    rels = []
    for t in range(TF_STEPS):
        step, cache = decode_step(cfg, params, cache, clen + t, toks[:, P + t:P + t + 1])
        want, _, _ = prefill(cfg, params, toks[:, :P + t + 1], P + t + 1)
        rels.append(rel_l2(step[:, 0], want))
    return rels


def teacher_forced_gates(cfg, params, P, seed, flash_swap, prefill, decode_step,
                         note="") -> dict:
    """The teacher-forced check on ``cfg`` (already cut to its gate depth):
    the bf16 kernel path; where the model has attention, the same with the
    plain flash swapped in by ``flash_swap`` = (ops module, attribute, plain
    version), on the model's bf16 inputs (decode's arithmetic) and on them
    widened to f32 (the Pallas kernel's, a reading); and f32 weights (the
    RG-LRU and SSD kernels in f32, the plain flash, since the kernel takes
    bf16 only).  The bf16 kernel path is gated at ``LOGITS_REL_L2`` a step,
    or ``NOISE_RATIO`` times the plain flash's distance where that is
    larger; f32 at ``DECODE_F32_REL_L2``.  Returns the distances by run."""
    what = (f"decode {cfg.name} teacher-forced at {cfg.num_layers} layers, B={TF_BATCH}, "
            f"P={P}{note}: each step's logits against the prefill of the same P + t + 1 "
            f"tokens, rel L2")
    mod, attr, plain = flash_swap
    f32_params = {k: v.float() for k, v in params.items()}
    runs = [("bf16", None, params)]
    if any(kind in ("attn", "moe", "xattn") for seg in cfg.segments for kind in seg.pattern):
        runs += [("bf16, plain flash", plain, params),
                 ("bf16, plain flash on inputs widened to f32", widened(plain), params)]
    runs.append(("f32, plain flash", plain, f32_params))
    tf = {}
    for label, flash, p in runs:
        with swapped(mod, attr, flash):
            tf[label] = teacher_forced(prefill, decode_step, cfg, p, P, seed)
        log(f"  {what}, {label}: {[float(f'{x:.3e}') for x in tf[label]]}")
    plain_bf16 = tf.get("bf16, plain flash", [0.0] * TF_STEPS)
    limits = {"bf16": [max(LOGITS_REL_L2, NOISE_RATIO * x) for x in plain_bf16],
              "f32, plain flash": [DECODE_F32_REL_L2] * TF_STEPS}
    for label, limit in limits.items():
        bad = [(t, x, lim) for t, (x, lim) in enumerate(zip(tf[label], limit)) if not x <= lim]
        if bad:
            raise AssertionError(f"{cfg.name}: decode and the teacher-forced prefill disagree "
                                 f"at {cfg.num_layers} layers ({label}): (step, rel L2, "
                                 f"limit) {bad}")
    log(f"  gates: bf16 kernel path {[float(f'{x:.3e}') for x in limits['bf16']]} by step, "
        f"f32 {DECODE_F32_REL_L2}")
    return tf


def greedy_decode(model, prefill_args, cache_size, counters, V) -> dict:
    """``model.prefill(*prefill_args, cache_size)`` at full depth, then
    ``DECODE_STEPS`` greedy ``model.decode_step`` calls, which launch no
    kernel and call no plain version on a CUDA tensor; logits finite and
    (B, 1, V).  Returns the readings and the prefill's launch counts."""
    counters.reset()
    logits, cache, clen = model.prefill(*prefill_args, cache_size)[:3]
    before = counters.read()
    B = logits.shape[0]
    if tuple(logits.shape) != (B, V) or not torch.isfinite(logits).all():
        raise AssertionError(f"{model.cfg.name} prefill: logits {tuple(logits.shape)} "
                             f"or non-finite")
    tok = logits.argmax(-1, keepdim=True)
    finite, walls = [], []
    torch.cuda.synchronize()
    for t in range(DECODE_STEPS):
        t0 = time.perf_counter()
        step, cache = model.decode_step(tok, cache, clen + t)
        tok = step[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if tuple(step.shape) != (B, 1, V):
            raise AssertionError(f"{model.cfg.name} decode step {t}: logits "
                                 f"{tuple(step.shape)}")
        finite.append(torch.isfinite(step).all())
    after = counters.read()
    launched = {k: after[k] - before[k] for k in counters.kernels}
    if not torch.stack(finite).all():
        raise AssertionError(f"{model.cfg.name} decode: non-finite logits")
    if any(launched.values()) or after["plain_on_cuda"]:
        raise AssertionError(f"{model.cfg.name} decode steps launched {launched}, plain "
                             f"versions on CUDA tensors {after['plain_on_cuda']}: decode runs "
                             f"plain PyTorch ops only")
    steady = walls[1:]
    r = {"batch": B, "steps": DECODE_STEPS, "first_ms": walls[0] * 1e3,
         "ms_per_step": 1e3 * sum(steady) / len(steady),
         "median_ms": 1e3 * sorted(steady)[len(steady) // 2]}
    r["tokens_per_s"] = B / (r["ms_per_step"] / 1e3)
    return r, before


def decode_path(lm, cfg, params, batch, seq, units, counters, seed, flash_swap,
                tf_seq=None, **tf_over) -> dict:
    """Decode on one LM: ``batch`` (8 prompts of ``seq`` tokens) prefilled
    at full depth into a cache of ``seq + DECODE_STEPS``, then
    ``greedy_decode``; then ``teacher_forced_gates`` at ``units`` units
    (``tf_seq`` tokens, ``tf_over`` config fields).  Returns the readings."""
    model = lm.CausalLM(cfg, params)
    V = cfg.vocab_size
    r, _ = greedy_decode(model, (torch.from_numpy(batch).to("cuda"),),
                         seq + DECODE_STEPS, counters, V)
    r["prompt"] = seq
    log(f"  decode {cfg.name} at full depth ({cfg.num_layers} layers), B={r['batch']}, "
        f"prompts of {seq} tokens, cache {seq + DECODE_STEPS}: first step "
        f"{r['first_ms']:.2f} ms, then {r['ms_per_step']:.2f} ms a step (median "
        f"{r['median_ms']:.2f}), {r['tokens_per_s']:.1f} tokens/s; logits finite (B, 1, {V}); "
        f"no kernel launched by the steps")
    del model

    cut_cfg, cut_params = cut_model(cfg, params, units)
    cut_cfg = dataclasses.replace(cut_cfg, **tf_over)
    r["teacher_forced"] = teacher_forced_gates(
        cut_cfg, cut_params, seq if tf_seq is None else tf_seq, seed, flash_swap,
        lm.prefill, lm.decode_step, f" {tf_over}" if tf_over else "")
    return r


# -- phase 18 ----------------------------------------------------------------

FLASH_PER_LAYER = {"attn": 1, "moe": 1, "xattn": 2}   # xattn: self- and cross-attention


def flash_per_prefill(cfg) -> int:
    """Flash launches of one ``encdec_prefill``: one a layer of the encoder,
    one or two (``xattn``) a layer of the decoder."""
    return sum(s.num_units * FLASH_PER_LAYER.get(kind, 0)
               for s in (*cfg.encoder_segments, *cfg.segments) for kind in s.pattern)


def whisper_path(args, cfg, lm, encdec, counters, fa_ops, flash_f32, flash_swap) -> tuple:
    """whisper-medium served at full width and depth from seeded bf16
    weights: 8 seeded segments of 1,500 frames and prompts of
    ``WHISPER_PROMPT`` tokens.  Encode, the decoder's prefill and both
    (``EncDecLM.prefill``) timed at b = 1, 2, 4, 8; then the main path,
    ``greedy_decode`` on ``EncDecLM`` into a cache of ``WHISPER_CACHE``: its
    prefill launches the flash kernel once an encoder layer and twice a
    decoder layer, its steps none; the plain flash (f32 but q/sqrt(D))
    swapped in at ``WHISPER_GATE_UNITS`` encoder and decoder layers, the
    encoder's output, the decoder on the same encoder output and the logits
    each within ``LOGITS_REL_L2`` or ``NOISE_RATIO`` times the distance of
    the plain flash on bf16 inputs (full depth a reading); the kernel also
    on the model's own inputs of the first encoder, decoder and
    cross-attention call there, within ``BF16_TOL`` of the plain version in
    f32 (both over v's rms); ``teacher_forced_gates`` at
    ``WHISPER_TF_UNITS`` encoder and decoder layers on 2 of the segments.
    Returns (readings, flash launches of the main path)."""
    from repro_torch.models.params import init_params, num_params

    specs = encdec.build_encdec_specs(cfg)
    before_gib = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    params = init_params(specs, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    B, V, n_enc = SERVE_BUCKETS[-1], cfg.vocab_size, flash_per_prefill(
        dataclasses.replace(cfg, segments=()))
    log(f"    {cfg.name}: {num_params(specs):,} parameters, bf16, seeded init on the card in "
        f"{time.perf_counter() - t0:.1f} s; {n_enc} encoder and {cfg.num_layers} decoder "
        f"layers, {cfg.num_heads} heads of {cfg.head_dim}; B={B} segments of "
        f"{cfg.encoder_seq} frames, prompts of {WHISPER_PROMPT} tokens, cache {WHISPER_CACHE}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 18)
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), device="cuda",
                         generator=gen).bfloat16()
    rng = np.random.default_rng(args.seed + 18)
    tokens = torch.from_numpy(rng.integers(0, V, (B, WHISPER_PROMPT)).astype(np.int32)
                              ).to("cuda")
    model = encdec.EncDecLM(cfg, params)
    by_batch = {}
    for b in SERVE_BUCKETS:
        enc_out = model.encode(frames[:b])
        by_batch[b] = {
            "encode_ms": cuda_ms(lambda: model.encode(frames[:b]), reps=3),
            "decoder_prefill_ms": cuda_ms(lambda: lm.prefill(
                cfg, params, tokens[:b], WHISPER_CACHE, enc_out=enc_out), reps=3),
            "prefill_ms": cuda_ms(lambda: model.prefill(frames[:b], tokens[:b], WHISPER_CACHE),
                                  reps=3)}
        log(f"  b={b}: encode {by_batch[b]['encode_ms']:.2f} ms, decoder prefill "
            f"{by_batch[b]['decoder_prefill_ms']:.2f}, encdec_prefill "
            f"{by_batch[b]['prefill_ms']:.2f} (CUDA events, mean of 3)")
    del enc_out

    # The main path: counts set to 0 just before it (in greedy_decode) and
    # read just after.
    torch.cuda.reset_peak_memory_stats()
    r, at_prefill = greedy_decode(model, (frames, tokens), WHISPER_CACHE, counters, V)
    launched = at_prefill["flash_attention"]
    r.update(prompt=WHISPER_PROMPT, frames=cfg.encoder_seq, by_batch=by_batch,
             flash_per_prefill=launched,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 - before_gib)
    want = flash_per_prefill(cfg)
    log(f"  main path: encdec_prefill B={B}, then {DECODE_STEPS} greedy steps: flash "
        f"launches {launched} in the prefill (expected {want}), none in the steps; "
        f"{r['first_ms']:.2f} ms the first step, then {r['ms_per_step']:.2f} ms a step "
        f"(median {r['median_ms']:.2f}), {r['tokens_per_s']:.1f} tokens/s; logits finite, "
        f"({B}, {V}) and ({B}, 1, {V}); peak memory {r['peak_gib']:.2f} GiB above the "
        f"{before_gib:.2f} GiB allocated before the weights")
    others = [at_prefill[k] for k in counters.kernels if k != "flash_attention"]
    if launched != want or any(others):
        raise AssertionError(f"{cfg.name} prefill launched {at_prefill}, expected "
                             f"{want} flash launches only")
    try:
        profile_batch(lambda: model.prefill(frames, tokens, WHISPER_CACHE)[0].cpu(),
                      f"one encdec_prefill of {B}")
    except Exception as exc:  # the profiler is a reading, not a gate
        log(f"    profiler failed: {exc!r}")
    del model

    # The plain flash swapped in: in f32 but for q/sqrt(D)'s rounding (the
    # standard), and on the model's bf16 inputs (decode's arithmetic), a
    # second plain path that differs from the first in rounding only.  The
    # seeded cross-attention is nearly one-hot (scores of rms ~64), so a
    # 1.7e-2 difference of enc_out reorders near-tied frames and two plain
    # paths part end to end as far as the kernel path does (PERF.md).  So
    # each stage is also held on the same input: the encoder on the frames,
    # the decoder on the kernel path's enc_out.  Each distance of the kernel
    # path is gated at LOGITS_REL_L2, or at NOISE_RATIO x the two plain
    # paths' distance there where that is larger (phase 17's rule), at
    # WHISPER_GATE_UNITS layers; full depth is a reading.
    log(f"  kernel path against the plain flash (f32 but q/sqrt(D)) on the batch of {B}, by "
        f"depth and stage: relative L2 error of the kernel path, then of the plain flash on "
        f"bf16 inputs, and the gate; logits argmax agreement; wall ms (kernel / f32 / bf16)")
    plain_f32 = lambda q, k, v, *a, **kw: flash_f32(q, k, v, *a, **kw).to(q.dtype)  # noqa: E731
    stages = ("enc_out", "decoder on the kernel path's enc_out", "logits")
    kernel, first = fa_ops.flash_attention_cuda, {}

    def recorded(q, k, v, causal, *a, **kw):
        kind = "decoder self" if causal else "encoder self" if q.shape[1] == k.shape[1] \
            else "cross"
        first.setdefault(kind, (q.clone(), k.clone(), v.clone(), causal))
        return kernel(q, k, v, causal, *a, **kw)

    for units in (WHISPER_GATE_UNITS, None):
        c_cfg, c_params = cut_model(cfg, params, units)
        out, walls, enc_k = {}, [], None
        for label, flash in (("kernel", recorded if units else None), ("f32", plain_f32),
                             ("bf16", flash_swap[2])):
            with swapped(fa_ops, "flash_attention_cuda", flash):
                t0 = time.perf_counter()
                logits, _, _, enc = encdec.encdec_prefill(c_cfg, c_params, frames, tokens,
                                                          WHISPER_CACHE)
                enc_k = enc if enc_k is None else enc_k
                dec = lm.prefill(c_cfg, c_params, tokens, WHISPER_CACHE, enc_out=enc_k)[0]
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[label] = dict(zip(stages, (enc, dec, logits)))
        if not torch.isfinite(out["kernel"]["logits"]).all():
            raise AssertionError(f"{cfg.name} at {c_cfg.num_layers} + {c_cfg.num_layers} "
                                 f"layers: non-finite logits")
        agree = (out["kernel"]["logits"].argmax(-1) == out["f32"]["logits"].argmax(-1))
        log(f"    {c_cfg.num_layers} + {c_cfg.num_layers} layers: argmax agreement "
            f"{agree.float().mean().item():.3f}; " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
            + " ms")
        for stage in stages:
            got = rel_l2(out["kernel"][stage], out["f32"][stage])
            floor = rel_l2(out["bf16"][stage], out["f32"][stage])
            limit = max(LOGITS_REL_L2, NOISE_RATIO * floor)
            log(f"      {stage}: {got:.3e}, plain on bf16 inputs {floor:.3e}, gate {limit:.3e}")
            if units is not None and not got <= limit:
                raise AssertionError(f"{cfg.name}: kernel path and plain path disagree at "
                                     f"{c_cfg.num_layers} + {c_cfg.num_layers} layers "
                                     f"({stage}): rel L2 {got:.3e} (limit {limit:.3e})")
        del out, enc_k, enc, dec, logits
    # BF16_TOL is stated for values of unit scale (phase 8's inputs); the
    # model's v has rms ~8 and the kernel rounds p to bf16 (as the JAX layer
    # does), an error that grows with |v|: so both outputs are divided by
    # v's rms before the check.
    for kind, (q, k, v, causal) in first.items():
        got, want = kernel(q, k, v, causal).float(), flash_f32(q, k, v, causal)
        v_rms = v.float().pow(2).mean().sqrt()
        err = check_close(f"flash on the model's first {kind} attention inputs (over v's rms)",
                          got / v_rms, want / v_rms, BF16_TOL)
        plain = flash_swap[2](q, k, v, causal).float()
        s = (q[0, :, 0].float() @ k[0, :, 0].float().T) / q.shape[-1] ** 0.5
        top2 = s.topk(2, dim=-1).values
        log(f"    flash on the model's first {kind} attention inputs, q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v rms {v_rms.item():.2f}: over v's rms, max abs err "
            f"{shown(err)}; rel L2 {rel_l2(got, want):.3e} (the plain flash on bf16 inputs "
            f"{rel_l2(plain, want):.3e}); row 0, head 0: score rms "
            f"{s.pow(2).mean().sqrt().item():.1f}, top-2 gap median "
            f"{(top2[:, 0] - top2[:, 1]).median().item():.2f}")
    del first

    c_cfg, c_params = cut_model(cfg, params, WHISPER_TF_UNITS)
    tf_frames = frames[:TF_BATCH]

    def prefill(cfg_, params_, toks, cache_size):
        return encdec.encdec_prefill(cfg_, params_, tf_frames.to(params_["embed/tokens"].dtype),
                                     toks, cache_size)[:3]

    r["teacher_forced"] = teacher_forced_gates(
        c_cfg, c_params, WHISPER_PROMPT, args.seed, flash_swap, prefill,
        encdec.encdec_decode_step, f" and {c_cfg.num_layers} encoder layers")
    return r, launched


# -- phase 19 ----------------------------------------------------------------

def f32_standard(flash_f32):
    """``chunked_attention_f32_ref`` with its output in q's dtype (its lse,
    when asked for, in f32): a plain flash that the model can run in bf16."""
    def call(q, k, v, *a, return_lse=False, **kw):
        r = flash_f32(q, k, v, *a, return_lse=return_lse, **kw)
        return (r[0].to(q.dtype), r[1]) if return_lse else r.to(q.dtype)
    return call


def train_flash_parity(flash_cuda, flash_f32, flash_plain, flash_fb, attention) -> dict:
    """19a: at each of ``TRAIN_FLASH_SHAPES`` the kernel's lse against the
    f32 reference's (within ``LSE_ATOL``), and dq, dk, dv of
    ``chunked_attention`` (the kernel's forward, then ``flash_bwd``) against
    ``flash_bwd`` fed the f32 reference's output and lse (relative L2
    within ``GRAD_REL_L2``); the kernel's time with and without the lse
    beside the bound, the plain version's and SDPA's, and the backward's
    beside SDPA's backward.  Returns the readings by shape."""
    import torch.nn.functional as F

    out = {}
    for label, B, Sq, Sk, H, Hkv, D, causal in TRAIN_FLASH_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(19 + Sq)
        q = torch.randn((B, Sq, H, D), device="cuda", generator=gen).bfloat16()
        k = torch.randn((B, Sk, Hkv, D), device="cuda", generator=gen).bfloat16()
        v = torch.randn((B, Sk, Hkv, D), device="cuda", generator=gen).bfloat16()
        do = torch.randn((B, Sq, H, D), device="cuda", generator=gen).bfloat16()
        spec = attention.AttnSpec(causal=causal)
        o, lse = flash_cuda(q, k, v, causal, 0, 0.0, return_lse=True)
        want_o, want_lse = flash_f32(q, k, v, causal, 0, 0.0, return_lse=True)
        lse_err = (lse - want_lse).abs().max().item()
        same_o = torch.equal(o, flash_cuda(q, k, v, causal))
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        attention.chunked_attention(qg, kg, vg, spec).backward(do)
        want = attention.flash_bwd(q, k, v, want_o, want_lse, do, spec)
        rels = [rel_l2(t.grad, w) for t, w in zip((qg, kg, vg), want)]
        shape = (f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} "
                 f"{'causal' if causal else 'not causal'}")
        log(f"  {label} {shape}: lse max abs err {lse_err:.3e} (limit {LSE_ATOL}), output "
            f"with and without the lse {'equal' if same_o else 'DIFFERENT'}; dq, dk, dv rel "
            f"L2 {rels[0]:.3e}, {rels[1]:.3e}, {rels[2]:.3e} (limit {GRAD_REL_L2})")
        if not (lse_err <= LSE_ATOL and same_o and max(rels) <= GRAD_REL_L2):
            raise AssertionError(f"flash training parity failed at {label} {shape}")
        del qg, kg, vg, want
        b_ms, b_by = bound(*flash_fb(B, Sq, Sk, H, Hkv, D, causal, 0), "bfloat16")
        fwd_ops, fwd_bytes = flash_fb(B, Sq, Sk, H, Hkv, D, causal, 0)
        # the backward's least work: 2.5x the forward's products (S, dP, dV,
        # dQ, dK against Q K^T and P V) over the live pairs; q, k, v, o, dO
        # read and dq, dk, dv written in bf16, the lse read in f32
        bb_ms, bb_by = bound(2.5 * fwd_ops, 2.0 * fwd_bytes + 4.0 * B * H * Sq, "bfloat16")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=Hkv != H)
        dot = do.transpose(1, 2)
        r = {"shape": shape, "max_abs_err": max(lse_err, *rels),
             "ms": cuda_ms(lambda: flash_cuda(q, k, v, causal), reps=KERNEL_REPS),
             "ms_lse": cuda_ms(lambda: flash_cuda(q, k, v, causal, return_lse=True),
                               reps=KERNEL_REPS),
             "plain_ms": cuda_ms(lambda: flash_plain(q, k, v, causal), reps=2),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=Hkv != H), reps=KERNEL_REPS),
             "bwd_ms": cuda_ms(lambda: attention.flash_bwd(q, k, v, o, lse, do, spec),
                               reps=3),
             "bwd_bound_ms": bb_ms, "bwd_bound_by": bb_by,
             "library_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                 o_s, (qt, kt, vt), dot, retain_graph=True), reps=KERNEL_REPS)}
        log(f"    forward: kernel {r['ms']:.4f} ms, with the lse {r['ms_lse']:.4f}, plain "
            f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound {b_ms:.4f} by {b_by} "
            f"({b_ms / r['ms']:.1%} of it reached); backward (flash_bwd, PyTorch ops) "
            f"{r['bwd_ms']:.4f} ms, SDPA's backward {r['library_bwd_ms']:.4f}, bound "
            f"{bb_ms:.4f} by {bb_by} ({bb_ms / r['bwd_ms']:.1%})")
        out[label] = r
        del q, k, v, do, o, lse, want_o, want_lse, qt, kt, vt, o_s
        torch.cuda.empty_cache()
    return out


def grad_distance(got: dict, want: dict) -> dict:
    """Relative L2 distance of each gradient leaf, over the larger of the
    leaf's norm and ``ZERO_LEAF`` of the whole gradient's (a leaf that is
    0 in exact arithmetic, such as whisper's ``bk``, holds only noise)."""
    whole = torch.sqrt(sum(w.float().square().sum() for w in want.values())).item()
    return {k: (got[k].float() - w.float()).norm().item()
            / max(w.float().norm().item(), ZERO_LEAF * whole) for k, w in want.items()}


def train_model_parity(cfg, loss_fn, batch, fa_ops, flash_plain, flash_f32, opt,
                       temper: float) -> dict:
    """19b: the loss and every gradient leaf of ``loss_fn`` (f32 masters
    cast to bf16 in the graph, seeded init) with the kernel, against the
    same with the plain flash swapped in; each distance within
    ``TRAIN_REL_L2`` or ``NOISE_RATIO`` times the distance between two plain
    flashes that differ in rounding only (on bf16 inputs, and in f32 but
    for q/sqrt(D)) where that is larger (phase 17's rule: the seeded
    attention is nearly one-hot, so the gradients of both plain paths are
    dominated by near-ties).  Then the same on the weights with every
    ``wq`` and ``wk`` divided by ``TEMPER[arch]`` (scores no longer nearly
    one-hot, so the plain pair agrees closely and the limit is mostly
    ``TRAIN_REL_L2``)."""
    from repro_torch.launch.steps import model_specs
    from repro_torch.models.params import init_params

    state = opt.init_state(init_params(model_specs(cfg), seed=19, device="cuda"))
    plain = [(fa_ops, "flash_attention_cuda", flash_plain)]
    pair = [(fa_ops, "flash_attention_cuda", f32_standard(flash_f32))]
    seeded = gradient_gate(cfg, loss_fn, batch, state.params, opt.cast_params, plain, pair,
                           "seeded")
    temper_attention(state.params, temper)
    tempered = gradient_gate(cfg, loss_fn, batch, state.params, opt.cast_params, plain, pair,
                             f"wq, wk / {temper}")
    return {"seeded": seeded, "tempered": tempered}


def temper_attention(params: dict, temper: float) -> None:
    """Every ``wq`` and ``wk`` divided by ``temper``, in place."""
    for k, v in params.items():
        if k.endswith("/wq") or k.endswith("/wk"):
            v /= temper


def gradient_gate(cfg, loss_fn, batch, params, cast, plain, pair, what) -> dict:
    """One comparison of ``train_model_parity`` on the f32 masters
    ``params`` (cast to the compute dtype by ``cast`` in the graph): the
    kernel path against the plain one (``plain``: (module, attribute,
    plain version) swaps), within ``TRAIN_REL_L2`` or ``NOISE_RATIO`` times
    the distance of a second plain path (``pair``) from the first.  Two
    sets of gradients are held at a time."""

    def run(swaps):
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in swaps:
                stack.enter_context(swapped(mod, attr, fn))
            masters = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, _ = loss_fn(cfg, cast(masters), batch)
            loss.backward()
            torch.cuda.synchronize()
        return loss.detach(), {k: v.grad for k, v in masters.items()}

    p_loss, p_grads = run(plain)
    k_loss, k_grads = run([])
    finite = all(torch.isfinite(g).all() for g in k_grads.values()) and torch.isfinite(k_loss)
    n_leaves = len(k_grads)
    dist = grad_distance(k_grads, p_grads)
    del k_grads
    f_loss, f_grads = run(pair)
    floor = grad_distance(f_grads, p_grads)
    del f_grads, p_grads
    dist["loss"] = abs((k_loss - p_loss) / p_loss).item()
    floor["loss"] = abs((f_loss - p_loss) / p_loss).item()
    limit = {k: max(TRAIN_REL_L2, NOISE_RATIO * floor[k]) for k in dist}
    worst = sorted(dist, key=lambda k: dist[k] / limit[k], reverse=True)[:4]
    log(f"  {cfg.name} at {cfg.num_layers} + {sum(s.num_units for s in cfg.encoder_segments)} "
        f"layers, {what}, batch {tuple(batch['tokens'].shape)}: loss {k_loss.item():.6f} "
        f"(plain {p_loss.item():.6f}, second plain {f_loss.item():.6f}); {n_leaves} gradient "
        f"leaves, all finite: {finite}; kernel against plain (limit) for the worst of loss "
        f"and leaves: " + "; ".join(f"{k} {dist[k]:.3e} ({limit[k]:.3e}, plain pair "
                                     f"{floor[k]:.3e})" for k in worst))
    bad = [k for k in dist if not dist[k] <= limit[k]]
    if bad or not finite:
        raise AssertionError(f"{cfg.name} ({what}): kernel path and plain path disagree "
                             f"in {bad} (or non-finite)")
    return {"loss": k_loss.item(), "worst": {k: (dist[k], limit[k]) for k in worst}}


def trainer_path(train_mod, ckpt_dir, counters, arch: str, want: dict) -> dict:
    """The trainer (``launch/train.py`` ``main``) with ``--arch arch`` at its
    other defaults (``--reduced``, widened) for ``TRAINER_STEPS`` steps with
    a checkpoint every ``TRAINER_CKPT_EVERY``, then ``--resume`` to
    ``TRAINER_RESUME_STEPS``: the resumed run starts at the first run's last
    checkpoint, every loss is finite and the last below the first run's
    first; each kernel is launched as ``want`` says over both runs (name ->
    count; every other kernel not at all), and no plain version runs on the
    card."""
    argv = ["--arch", arch, "--ckpt-dir", ckpt_dir, "--ckpt-every", str(TRAINER_CKPT_EVERY)]
    counters.reset()
    t0 = time.perf_counter()
    first = train_mod.main(argv + ["--steps", str(TRAINER_STEPS)])
    again = train_mod.main(argv + ["--steps", str(TRAINER_RESUME_STEPS), "--resume"])
    wall = time.perf_counter() - t0
    got = counters.read()
    launched = {k: got[k] for k in counters.kernels}
    expected = {k: want.get(k, 0) for k in counters.kernels}
    losses = first["losses"] + again["losses"]
    log(f"  trainer --arch {arch}: {TRAINER_STEPS} steps then --resume to "
        f"{TRAINER_RESUME_STEPS} in {wall:.1f} s; checkpoints "
        f"{[p.name for p in first['checkpoints'] + again['checkpoints']]}; resumed at "
        f"{again['start_step']}; loss {losses[0]:.4f} -> {first['losses'][-1]:.4f} -> "
        f"{losses[-1]:.4f}; launches {launched} (expected {expected}), plain on CUDA "
        f"{got['plain_on_cuda']}")
    ok = (again["start_step"] == TRAINER_STEPS and len(losses) == TRAINER_RESUME_STEPS
          and all(np.isfinite(losses)) and first["losses"][-1] < losses[0]
          and losses[-1] < losses[0]
          and [p.name for p in first["checkpoints"]] == [
              f"step_{s:08d}" for s in range(TRAINER_CKPT_EVERY, TRAINER_STEPS + 1,
                                             TRAINER_CKPT_EVERY)]
          and launched == expected and not got["plain_on_cuda"])
    if not ok:
        raise AssertionError(f"the trainer (--arch {arch}) did not lower its loss, "
                             f"checkpoint, resume at its last checkpoint and launch its "
                             f"kernels as expected")
    return {"arch": arch, "steps": TRAINER_RESUME_STEPS, "first_loss": losses[0],
            "last_loss": losses[-1], "wall_s": wall, "launches": launched}


def profile_train_step(run, ranges: dict, kernels: dict) -> dict:
    """Device time of one ``run()`` (a train step, which ends on the host)
    by class: each of ``ranges`` ({class: (module, function name)}: every
    kernel launched inside that function, found under a profiler range
    that wraps it for this run, its products included), each of
    ``kernels`` ({class: a substring of the kernel's name}), the other
    matrix products and the rest; and the idle share.  Returns ms by class
    (empty when the profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def marked(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    def under(evt):
        got = list(evt.kernels)
        for child in evt.cpu_children:
            got += under(child)
        return got

    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in ranges.items():
            stack.enter_context(swapped(mod, attr, marked(name, getattr(mod, attr))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_us = (time.perf_counter() - t0) * 1e6
    classes = dict.fromkeys([*kernels, *ranges, "matmul", "other"], 0.0)
    empty = []
    for name in ranges:  # moved out of matmul and other, where the loop below counts them
        found = [k for evt in prof.events()
                 if evt.name == name and evt.device_type == DeviceType.CPU for k in under(evt)]
        mm = sum(k.duration for k in found if is_matmul(k.name))
        classes[name] += sum(k.duration for k in found)
        classes["matmul"] -= mm
        classes["other"] -= sum(k.duration for k in found) - mm
        if not found:
            empty.append(name)
    others = {}   # "other" by kernel name, the ranges' included
    for evt in prof.events():
        # a range's own span on the device timeline is no kernel
        if evt.device_type != DeviceType.CUDA or evt.name in ranges:
            continue
        dt = evt.time_range.elapsed_us()
        cls = next((c for c, tag in kernels.items() if tag in evt.name), None)
        if cls is not None:
            classes[cls] += dt
        elif is_matmul(evt.name):
            classes["matmul"] += dt
        else:
            classes["other"] += dt
            others[evt.name] = others.get(evt.name, 0.0) + dt
    busy = sum(classes.values())
    if busy <= 0:
        log("    profiler: no device time recorded")
        return {}
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    log(f"    profile of one train step: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share {max(0.0, 1 - busy / wall_us):.1%}; by class (ms, "
        f"share of busy): " + ", ".join(f"{k} {v / 1e3:.1f} ({v / busy:.1%})"
                                         for k, v in classes.items())
        + (f" (no kernel found under {empty}: counted in matmul and other)" if empty else ""))
    log("    largest kernels outside matmul and the named classes (ms, the ranges' "
        "included): " + "; ".join(f"{name.replace('void at::native::', '')[:80]} {us / 1e3:.1f}"
                                  for name, us in top))
    return {k: v / 1e3 for k, v in classes.items()} | {"wall_ms": wall_us / 1e3}


def is_matmul(name: str) -> bool:
    return any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass", "nvjet", "wgmma"))


def timed_train_path(cfg, opt, steps_mod, train_mod, counters, batch_size: int, seq: int,
                     want: dict, extra_flops: tuple, bf16_peak: float, ranges: dict,
                     kernel_classes: dict) -> dict:
    """``TRAIN_STEPS`` AdamW steps (the reference's defaults) of ``cfg`` on
    ``synthetic_batches`` of ``batch_size`` x ``seq``: loss and gradient
    norm finite at every step, each kernel launched as ``want`` says (name
    -> count over the steps; every other kernel not at all) and no plain
    version on the card; ms a step, tokens/s, peak memory, model FLOPs a
    step (6 N T, N without the embedding table, plus ``extra_flops``:
    (FLOPs a step, what they are)) over the measured bf16 peak, and a
    profile of one more step by class (``ranges``, ``kernel_classes``: as
    ``profile_train_step`` takes them) are readings."""
    from repro_torch.models.params import init_params, num_params

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    specs = steps_mod.model_specs(cfg)
    state = opt.init_state(init_params(specs, seed=19, device="cuda"))
    adamw = opt.AdamWConfig()
    data = train_mod.synthetic_batches(cfg, batch_size, seq, seed=19)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
               for _ in range(TRAIN_STEPS + 1)]
    counters.reset()
    walls, losses, gnorms = [], [], []
    torch.cuda.synchronize()
    for batch in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        state, metrics = steps_mod.train_step(cfg, state, batch, adamw)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
    got = counters.read()
    launched = {k: got[k] for k in counters.kernels}
    expected = {k: want.get(k, 0) for k in counters.kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 - before
    tokens = batch_size * seq
    n = num_params(specs) - int(np.prod(specs["embed/tokens"].shape))
    flops = 6.0 * n * tokens + extra_flops[0]
    steady = walls[1:]
    ms = 1e3 * sum(steady) / len(steady)
    r = {"arch": cfg.name, "layers": cfg.num_layers, "params": num_params(specs),
         "batch": batch_size, "seq": seq, "losses": losses, "grad_norms": gnorms,
         "first_ms": walls[0] * 1e3, "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
         "peak_gib": peak, "launches": launched, "model_flops": flops,
         "mfu": flops / (ms / 1e3) / bf16_peak}
    log(f"  {cfg.name} at {cfg.num_layers} layers ({r['params']:,} parameters), B={batch_size}"
        f" x S={seq}: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in gnorms]}; first step {r['first_ms']:.1f} ms, then "
        f"{ms:.1f} ms a step, {r['tokens_per_s']:.0f} tokens/s; peak memory {peak:.2f} GiB "
        f"above the {before:.2f} allocated before; launches {launched} (expected "
        f"{expected}), plain on CUDA {got['plain_on_cuda']}; model FLOPs a step "
        f"{flops:.4g} (6 N T, N = {n:,} without the embedding table, plus "
        f"{extra_flops[0]:.4g} for {extra_flops[1]}), {r['mfu']:.1%} of the measured bf16 "
        f"peak {bf16_peak / 1e12:.1f} TFLOP/s")
    ok = (all(np.isfinite(losses)) and all(np.isfinite(gnorms)) and launched == expected
          and not got["plain_on_cuda"])
    if not ok:
        raise AssertionError(f"{cfg.name} training: non-finite loss or grad norm, or the "
                             f"kernels not launched as expected")
    try:
        holder = [state]

        def step():
            holder[0], m = steps_mod.train_step(cfg, holder[0], batches[-1], adamw)
            m["loss"].item()

        r["profile"] = profile_train_step(step, ranges, kernel_classes)
    except Exception as exc:  # the profiler is a reading, not a gate
        log(f"    profiler failed: {exc!r}")
    return r


def guard_check() -> None:
    """A ``kv_valid_len`` flash call, which has no backward, refuses a CUDA
    input that needs a gradient (and runs under ``torch.no_grad()``)."""
    from repro_torch.layers import attention

    q = torch.randn((1, 64, 4, 64), device="cuda").bfloat16().requires_grad_(True)

    def call():
        return attention.chunked_attention(q, q.detach(), q.detach(), attention.AttnSpec(),
                                           kv_valid_len=torch.tensor([40], device="cuda"))

    try:
        call()
    except NotImplementedError:
        pass
    else:
        raise AssertionError("chunked_attention with kv_valid_len on a CUDA input that needs "
                             "a gradient did not raise")
    with torch.no_grad():
        call()
    log("  guard: chunked_attention with kv_valid_len raises NotImplementedError on a CUDA "
        "input that needs a gradient and runs under torch.no_grad()")


def training_path(args, counters, bf16_peak: float) -> tuple:
    """Phase 19: 19a ``train_flash_parity``, 19b ``train_model_parity`` on
    yi-6b and whisper-medium at ``TRAIN_GATE_UNITS`` layers, 19c
    ``trainer_path``, 19d ``timed_train_path``.  Returns (19a's readings, the
    flash launches of 19c and 19d)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flops_bytes as flash_flops_bytes)
    from repro_torch.kernels.flash_attention.ref import (
        chunked_attention_f32_ref, chunked_attention_ref)
    from repro_torch.launch import steps as train_steps
    from repro_torch.launch import train as trainer
    from repro_torch.layers import attention as attention_mod
    from repro_torch.models.base import get_config
    from repro_torch.models.config import Segment
    from repro_torch.train import optimizer

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[19] training: the flash kernel's lse and gradients at {len(TRAIN_FLASH_SHAPES)} "
        f"shapes; the loss and every gradient leaf of {TRAIN_ARCH} and {WHISPER_ARCH} at "
        f"{TRAIN_GATE_UNITS} layers against the plain flash; the trainer; {TRAIN_ARCH} at full "
        f"width, {TRAIN_UNITS} of 32 layers (CUT: the AdamW state of 32 does not fit one "
        f"card), {TRAIN_STEPS} steps of B={TRAIN_BATCH} x S={TRAIN_SEQ}")
    guard_check()
    log("[19a] flash: the kernel's lse against the f32 reference's, dq, dk, dv of the "
        "kernel path against flash_bwd fed the f32 reference's output and lse")
    train_times = train_flash_parity(flash_attention_cuda, chunked_attention_f32_ref,
                                     chunked_attention_ref, flash_flops_bytes, attention_mod)
    log(f"[19b] the loss and every gradient leaf, kernel against plain flash, at "
        f"{TRAIN_GATE_UNITS} layers (limit {TRAIN_REL_L2} or {NOISE_RATIO} x two plain "
        f"flashes' distance)")
    train_gate = {}
    for arch, units in ((TRAIN_ARCH, (TRAIN_GATE_UNITS, 0)),
                        (WHISPER_ARCH, (TRAIN_GATE_UNITS, TRAIN_GATE_UNITS))):
        cfg = get_config(arch)
        cfg = dataclasses.replace(
            cfg, segments=(Segment(cfg.segments[0].pattern, units[0]),),
            encoder_segments=tuple(Segment(e.pattern, units[1]) for e in cfg.encoder_segments))
        seq = WHISPER_PROMPT if cfg.encoder_segments else TRAIN_SEQ
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(
            trainer.synthetic_batches(cfg, TRAIN_GATE_BATCH, seq, seed=args.seed)).items()}
        train_gate[arch] = train_model_parity(cfg, train_steps.loss_fn_for(cfg), batch, fa_ops,
                                              chunked_attention_ref, chunked_attention_f32_ref,
                                              optimizer, TEMPER[arch])
        del batch
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[19c] the trainer: python -m repro_torch.launch.train at its defaults, "
        f"{TRAINER_STEPS} steps, then --resume")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # the forward and the remat recompute: two flash launches a layer a step
        layers = trainer.widened(get_config(TRAIN_ARCH)).num_layers
        trained_run = trainer_path(trainer, ckpt_dir, counters, TRAIN_ARCH,
                                   {"flash_attention": 2 * layers * TRAINER_RESUME_STEPS})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, TRAIN_UNITS),))
    log(f"[19d] {cfg.name} at full width, {TRAIN_UNITS} layers, {TRAIN_STEPS} AdamW steps on "
        f"synthetic_batches; counts from the first step to the last")
    attn = 3 * cfg.num_layers * flash_flops_bytes(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
                                                  cfg.num_heads, cfg.num_kv_heads,
                                                  cfg.head_dim, True, 0)[0]
    timed = timed_train_path(cfg, optimizer, train_steps, trainer, counters, TRAIN_BATCH,
                             TRAIN_SEQ, {"flash_attention": 2 * cfg.num_layers * TRAIN_STEPS},
                             (attn, "attention"), bf16_peak,
                             {"attention backward": (attention_mod, "flash_bwd")},
                             {"flash forward": "flash_fwd_kernel"})
    log(json.dumps({"training": {"gates": train_gate, "trainer": trained_run, "timed": timed}}))
    return (train_times, trained_run["launches"]["flash_attention"]
            + timed["launches"]["flash_attention"])

# -- phase 20 ----------------------------------------------------------------

def at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    storage (``t`` itself at 0)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def rglru_train_parity(rglru_cuda, rglru_bwd_cuda, rglru_ref, rglru_bwd_ref, fwd_fb,
                       bwd_fb) -> dict:
    """20a: at each of ``RGLRU_BWD_SHAPES``, bf16 and f32, the forward with
    carries bit-equal (y, h_last) to the forward without, its carries
    against ``rglru_ref``'s (within ``STATE_TOL``), and ``rglru_bwd_cuda``
    against ``rglru_bwd_ref`` (``RGLRU_BWD_TOL``); at the training shape in
    bf16, the backward's time beside its byte bound and the plain
    version's, and the forward's with and without carries.  Returns the
    backward's kernel record."""
    from repro_torch.kernels.rglru.rglru import bwd_resources

    resources = {t: bwd_resources(t) for t in (torch.bfloat16, torch.float32)}
    log("    backward kernel: " + ", ".join(f"{str(t)[6:]} {regs} registers, {blocks} blocks "
                                          f"an SM" for t, (regs, blocks) in resources.items()))
    rec = {}
    for B, S, N, ends, offset in RGLRU_BWD_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(20 + S + N)
        f = lambda *shape: torch.randn(shape, device="cuda", generator=gen)  # noqa: E731
        x32, r32, i32 = f(B, S, N), torch.sigmoid(f(B, S, N)), torch.sigmoid(f(B, S, N))
        a_param, dy32 = f(N), f(B, S, N)
        h0, dh_last = (f(B, N), f(B, N)) if ends else (None, None)
        for dtype in (torch.bfloat16, torch.float32):
            x, r, i, dy = (at_offset(t.to(dtype), offset) for t in (x32, r32, i32, dy32))
            y, h_last = rglru_cuda(x, r, i, a_param, h0)
            y2, h_last2, carries = rglru_cuda(x, r, i, a_param, h0, return_carries=True)
            same = torch.equal(y, y2) and torch.equal(h_last, h_last2)
            want_c = rglru_ref(x, r, i, a_param, h0, return_carries=True)[2]
            c_err = (carries - want_c).abs().max().item()
            got = rglru_bwd_cuda(x, r, i, a_param, carries, dy, dh_last)
            want = rglru_bwd_ref(x, r, i, a_param, h0, dy, dh_last)
            names = ("dx", "dr", "di", "da_param", "dh0")
            rels = {n: rel_l2(g, w) for n, g, w in zip(names, got, want)}
            tols = {n: RGLRU_BWD_TOL[dtype] if n in ("dx", "dr", "di") else 1e-4
                    for n in names}
            abs_err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want))
            finite = all(torch.isfinite(g).all() for g in got)
            log(f"  rglru B={B} S={S} N={N} {str(dtype)[6:]}"
                f"{', h0 and dh_last' if ends else ''}"
                f"{f', storage offset {offset}' if offset else ''}: forward with and without "
                f"carries "
                f"{'bit-equal' if same else 'DIFFERENT'}, carries max abs err {c_err:.3e} "
                f"(limit {STATE_TOL}); backward rel L2 "
                + ", ".join(f"{n} {rels[n]:.3e} ({tols[n]})" for n in names)
                + f"; max abs err {abs_err:.3e}")
            if not (same and c_err <= STATE_TOL and finite
                    and all(rels[n] <= tols[n] for n in names)):
                raise AssertionError(f"the RG-LRU backward kernel disagrees with "
                                     f"rglru_bwd_ref at B={B} S={S} N={N} {dtype}, "
                                     f"storage offset {offset}")
            if (B, S, N) != RGLRU_BWD_SHAPES[0][:3] or dtype != torch.bfloat16:
                continue
            b_ms, b_by = bound(*bwd_fb(B, S, N, 2), "float32")
            rec = {"shape": f"B={B} S={S} N={N} bf16", "max_abs_err": abs_err,
                   "ms": cuda_ms(lambda: rglru_bwd_cuda(x, r, i, a_param, carries, dy),
                                 reps=KERNEL_REPS),
                   "plain_ms": cuda_ms(lambda: rglru_bwd_ref(x, r, i, a_param, None, dy),
                                       reps=1),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "fwd_ms": cuda_ms(lambda: rglru_cuda(x, r, i, a_param), reps=KERNEL_REPS),
                   "fwd_carries_ms": cuda_ms(lambda: rglru_cuda(x, r, i, a_param,
                                                                return_carries=True),
                                             reps=KERNEL_REPS),
                   "fwd_bound_ms": bound(*fwd_fb(B, S, N, 2), "bfloat16")[0],
                   "registers": resources[torch.bfloat16][0],
                   "blocks_per_sm": resources[torch.bfloat16][1]}
            log(f"    backward {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, bound "
                f"{b_ms:.4f} by {b_by} ({b_ms / rec['ms']:.1%} of it reached); forward "
                f"{rec['fwd_ms']:.4f} ms, with carries {rec['fwd_carries_ms']:.4f} (bound "
                f"{rec['fwd_bound_ms']:.4f})")
        del x32, r32, i32, dy32, x, r, i, dy, y, y2, carries, got, want
        torch.cuda.empty_cache()
    return rec


def ssd_train_parity(ssd_cuda, ssd_chunked_ref, ssd_layer, fwd_fb, bwd_fb) -> dict:
    """20b: at each of ``SSD_BWD_SHAPES`` (B and C head-shared), the
    kernel's output bit-equal with and without states, in bf16 and f32, and
    its states against ``ssd_chunked_ref``'s; ``ssd_bwd`` fed the f32
    kernel's states against autograd through ``ssd_chunked_ref`` in f32
    (``SSD_BWD_TOL``).  At the training shape in bf16 (the model's dtype),
    ``ssd_bwd``'s time beside the forward's (with and without states) and
    the bytes and operations ``bwd_flops_bytes`` counts.  Steps as the
    seeded model takes them (dt = softplus(N(-4, 1)), mean ~0.03), so no
    chunk's decay passes e^-88, where the plain version's autograd, like
    the JAX layer's, would give NaN.  Returns the readings."""
    import torch.nn.functional as F

    rec = {}
    for B, S, H, P, N, ends in SSD_BWD_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(20 + S)
        f = lambda *shape: torch.randn(shape, device="cuda", generator=gen)  # noqa: E731
        x, dt = 0.5 * f(B, S, H, P), F.softplus(f(B, S, H) - 4.0)
        A, D = -(0.5 + f(H).abs()), f(H)
        Bs, Cs = 0.3 * f(B, S, N), 0.3 * f(B, S, N)
        dy = f(B, S, H, P)
        h0, dh_last = (f(B, H, N, P), f(B, H, N, P)) if ends else (None, None)

        def heads(t):
            return t[:, :, None].expand(B, S, H, N)

        shape = f"B={B} S={S} H={H} P={P} N={N}{', h0 and dh_last' if ends else ''}"
        for dtype in (torch.bfloat16, torch.float32):
            args = (x.to(dtype), dt.to(dtype), A, heads(Bs.to(dtype)), heads(Cs.to(dtype)), D,
                    h0)
            y, h_last = ssd_cuda(*args)
            y2, h_last2, states = ssd_cuda(*args, return_states=True)
            same = torch.equal(y, y2) and torch.equal(h_last, h_last2)
            want = ssd_chunked_ref(*[a.float() for a in args[:6]], 128, h0,
                                   return_states=True)[2]
            ratio = worst_ratio(states, want, SSD_H_RTOL, SSD_H_ATOL[dtype])
            log(f"  ssd {shape} {str(dtype)[6:]}: output with and without states "
                f"{'bit-equal' if same else 'DIFFERENT'}; states max abs err "
                f"{(states - want).abs().max().item():.3e}, worst ratio {ratio:.3f} (rtol "
                f"{SSD_H_RTOL}, atol {SSD_H_ATOL[dtype]})")
            if not (same and ratio <= 1.0):
                raise AssertionError(f"SSD states disagree at {shape} {dtype}")
            del y, y2, h_last, h_last2, want
        got = ssd_layer.ssd_bwd(x, dt, A, Bs, Cs, D, states, dy, dh_last, 128)
        leaves = [None if t is None else t.detach().clone().requires_grad_(True)
                  for t in (x, dt, A, Bs, Cs, D, h0)]
        y, h_last = ssd_chunked_ref(*leaves[:3], heads(leaves[3]), heads(leaves[4]), leaves[5],
                                    128, leaves[6])
        ((y * dy).sum() + (0.0 if dh_last is None else (h_last * dh_last).sum())).backward()
        names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
        rels = {n: rel_l2(g, leaf.grad) for n, g, leaf in zip(names, got, leaves)
                if leaf is not None}
        finite = all(torch.isfinite(g).all() for g in got)
        log(f"    ssd_bwd fed the f32 kernel's states against autograd of ssd_chunked_ref "
            f"(f32): rel L2 " + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
            + f" (limit {SSD_BWD_TOL})")
        if not (finite and all(v <= SSD_BWD_TOL for v in rels.values())):
            raise AssertionError(f"ssd_bwd disagrees with the plain version's autograd at "
                                 f"{shape}")
        del got, leaves, y, h_last
        if not ends:
            xb, dtb, Bb, Cb, dyb = (t.bfloat16() for t in (x, dt, Bs, Cs, dy))
            args = (xb, dtb, A, heads(Bb), heads(Cb), D)
            _, _, st = ssd_cuda(*args, return_states=True)
            b_ms, b_by = bound(*bwd_fb(B, S, H, P, N, shared=True), "float32")
            ops, nbytes = bwd_fb(B, S, H, P, N, shared=True)
            rec = {"shape": f"B={B} S={S} H={H} P={P} N={N} bf16, B and C shared",
                   "bwd_ms": cuda_ms(lambda: ssd_layer.ssd_bwd(xb, dtb, A, Bb, Cb, D, st, dyb,
                                                               None, 128), reps=3),
                   "bwd_bound_ms": b_ms, "bwd_bound_by": b_by, "bwd_ops": ops,
                   "bwd_bytes": nbytes, "max_rel_l2": max(rels.values()),
                   "fwd_ms": cuda_ms(lambda: ssd_cuda(*args), reps=KERNEL_REPS),
                   "fwd_states_ms": cuda_ms(lambda: ssd_cuda(*args, return_states=True),
                                            reps=KERNEL_REPS),
                   "fwd_bound_ms": bound(*fwd_fb(B, S, H, P, N), "bfloat16")[0]}
            log(f"    ssd_bwd (PyTorch ops, f32) {rec['bwd_ms']:.4f} ms, bound {b_ms:.4f} by "
                f"{b_by} ({ops:.4g} operations at the f32 peak, {nbytes:.4g} bytes; "
                f"{b_ms / rec['bwd_ms']:.1%} of it reached); the forward kernel "
                f"{rec['fwd_ms']:.4f} ms, with states {rec['fwd_states_ms']:.4f} (bound "
                f"{rec['fwd_bound_ms']:.4f})")
            del xb, dtb, Bb, Cb, dyb, st
        del x, dt, Bs, Cs, dy, states
        torch.cuda.empty_cache()
    return rec


def recurrent_swaps(fa_ops, rg_ops, ssd_ops, flash_plain, flash_f32, rglru_ref,
                    rglru_chunked_ref, rglru_bwd_ref, rglru_bwd_chunked_ref,
                    ssd_chunked_ref) -> tuple:
    """20c's two plain paths, as (module, attribute, plain version) swaps:
    the plain flash, ``rglru_ref`` and ``rglru_bwd_ref``, and
    ``ssd_chunked_ref`` at the kernel's chunk of 128; and a second that
    differs in summation order only: the f32 flash with q/sqrt(D) rounded,
    the kernels' order of arithmetic for the RG-LRU, and the SSD at chunk
    64 (its states taken at every other chunk start, the kernel's)."""

    def rglru_bwd_plain(x, r, i, a_param, carries, dy, dh_last):
        return rglru_bwd_ref(x, r, i, a_param, carries[:, 0], dy, dh_last)

    def ssd_at(chunk):
        def call(x, dt, A, Bm, Cm, D, h0, return_states=False):
            out = ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk, h0, return_states=return_states)
            step = 128 // chunk
            return (*out[:2], out[2][:, :, ::step].contiguous()) if return_states else out
        return call

    plain = [(fa_ops, "flash_attention_cuda", flash_plain), (rg_ops, "rglru_cuda", rglru_ref),
             (rg_ops, "rglru_bwd_cuda", rglru_bwd_plain), (ssd_ops, "ssd_cuda", ssd_at(128))]
    pair = [(fa_ops, "flash_attention_cuda", f32_standard(flash_f32)),
            (rg_ops, "rglru_cuda", rglru_chunked_ref),
            (rg_ops, "rglru_bwd_cuda", rglru_bwd_chunked_ref), (ssd_ops, "ssd_cuda", ssd_at(64))]
    return plain, pair


def recurrent_training_path(args, counters, bf16_peak: float) -> tuple:
    """Phase 20: 20a ``rglru_train_parity``, 20b ``ssd_train_parity``, 20c
    the loss and every gradient leaf of mamba2-370m at 2 layers and
    recurrentgemma-9b at one period against the plain path (phase 19b's
    rule), 20d the trainer with ``--arch mamba2_370m``, 20e the timed runs.
    Returns (20a's kernel record, 20b's readings, the launches of 20d and
    20e by kernel)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flops_bytes as flash_flops_bytes)
    from repro_torch.kernels.flash_attention.ref import (
        chunked_attention_f32_ref, chunked_attention_ref)
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import (
        rglru_bwd_chunked_ref, rglru_bwd_ref, rglru_chunked_ref, rglru_ref)
    from repro_torch.kernels.rglru.rglru import (
        bwd_flops_bytes as rglru_bwd_fb, flops_bytes as rglru_fb, rglru_bwd_cuda, rglru_cuda)
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd.ssd import (
        bwd_flops_bytes as ssd_bwd_fb, flops_bytes as ssd_fb, ssd_cuda)
    from repro_torch.launch import steps as train_steps
    from repro_torch.launch import train as trainer
    from repro_torch.layers import attention as attention_mod
    from repro_torch.layers import ssd as ssd_layer
    from repro_torch.models.base import get_config
    from repro_torch.models.config import Segment
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[20] training the recurrent kinds: the RG-LRU backward kernel and the SSD's "
        f"states and backward; the loss and every gradient leaf of {SSM_ARCH} at "
        f"{SSM_TRAIN_GATE_UNITS} layers and {SERVE_ARCH} at {3 * RG_TRAIN_UNITS} against the "
        f"plain path; the trainer with --arch {SSM_ARCH}; {SSM_ARCH} at full width and depth "
        f"(B={SSM_TRAIN_BATCH} x S={SSM_TRAIN_SEQ}) and {SERVE_ARCH} at full width, "
        f"{3 * RG_TRAIN_UNITS} of 38 layers (CUT: one period; its AdamW state at two periods "
        f"would not leave room for activations), B={RG_TRAIN_BATCH} x S={RG_TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps each")
    log(f"[20a] RG-LRU: the forward with carries, the backward kernel against rglru_bwd_ref")
    rglru_rec = rglru_train_parity(rglru_cuda, rglru_bwd_cuda, rglru_ref, rglru_bwd_ref,
                                   rglru_fb, rglru_bwd_fb)
    log(f"[20b] SSD: the kernel's states, ssd_bwd against autograd of the plain version")
    ssd_rec = ssd_train_parity(ssd_cuda, ssd_chunked_ref, ssd_layer, ssd_fb, ssd_bwd_fb)

    log(f"[20c] the loss and every gradient leaf, kernel path against plain path (limit "
        f"{TRAIN_REL_L2} or {NOISE_RATIO} x two plain paths' distance)")
    plain, pair = recurrent_swaps(fa_ops, rg_ops, ssd_ops, chunked_attention_ref,
                                  chunked_attention_f32_ref, rglru_ref, rglru_chunked_ref,
                                  rglru_bwd_ref, rglru_bwd_chunked_ref, ssd_chunked_ref)
    gates = {}
    for arch, units, batch_size, seq in (
            (SSM_ARCH, SSM_TRAIN_GATE_UNITS, TRAIN_GATE_BATCH, SSM_TRAIN_SEQ),
            (SERVE_ARCH, RG_TRAIN_UNITS, RG_TRAIN_GATE_BATCH, RG_TRAIN_SEQ)):
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, units),))
        params = init_params(train_steps.model_specs(cfg), seed=20, device="cuda")
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(
            trainer.synthetic_batches(cfg, batch_size, seq, seed=args.seed)).items()}
        gates[arch] = {"seeded": gradient_gate(cfg, train_steps.loss_fn_for(cfg), batch,
                                               params, optimizer.cast_params, plain, pair,
                                               "seeded")}
        if arch in TEMPER:
            temper_attention(params, TEMPER[arch])
            gates[arch]["tempered"] = gradient_gate(
                cfg, train_steps.loss_fn_for(cfg), batch, params, optimizer.cast_params, plain,
                pair, f"wq, wk / {TEMPER[arch]}")
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()

    log(f"[20d] the trainer: python -m repro_torch.launch.train --arch {SSM_ARCH}, "
        f"{TRAINER_STEPS} steps, then --resume")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # the forward and the remat recompute: two SSD launches a layer a step
        layers = trainer.widened(get_config(SSM_ARCH)).num_layers
        trained = trainer_path(trainer, ckpt_dir, counters, SSM_ARCH,
                               {"ssd": 2 * layers * TRAINER_RESUME_STEPS})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    log(f"[20e] timed: {TRAIN_STEPS} AdamW steps on synthetic_batches; counts from the first "
        f"step to the last")
    cfg = get_config(SSM_ARCH)
    ssd_term = 3 * cfg.num_layers * ssd_fb(SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, cfg.ssm_num_heads,
                                           cfg.ssm_head_dim, cfg.ssm_state)[0]
    timed = {SSM_ARCH: timed_train_path(
        cfg, optimizer, train_steps, trainer, counters, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ,
        {"ssd": 2 * cfg.num_layers * TRAIN_STEPS},
        (ssd_term, "the SSD's chunk products (3 x the forward's)"), bf16_peak,
        {"SSD backward": (ssd_layer, "ssd_bwd")}, {"SSD forward": "ssd_mma_kernel"})}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, RG_TRAIN_UNITS),))
    kinds = cfg.segments[0].pattern
    n_rglru, n_attn = kinds.count("rglru"), kinds.count("attn")
    rg_term = 3 * (n_attn * flash_flops_bytes(
        RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
        cfg.head_dim, True, cfg.window)[0] + n_rglru * rglru_fb(
        RG_TRAIN_BATCH, RG_TRAIN_SEQ, cfg.lru_width)[0])
    timed[SERVE_ARCH] = timed_train_path(
        cfg, optimizer, train_steps, trainer, counters, RG_TRAIN_BATCH, RG_TRAIN_SEQ,
        {"flash_attention": 2 * n_attn * TRAIN_STEPS, "rglru": 2 * n_rglru * TRAIN_STEPS,
         "rglru_bwd": n_rglru * TRAIN_STEPS},
        (rg_term, "windowed attention and the RG-LRU (3 x their forwards)"), bf16_peak,
        {"attention backward": (attention_mod, "flash_bwd")},
        {"flash forward": "flash_fwd_kernel", "RG-LRU backward": "rglru_bwd_kernel",
         "RG-LRU forward": "rglru_kernel"})
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: trained["launches"][k] + sum(t["launches"][k] for t in timed.values())
                for k in trained["launches"]}
    log(json.dumps({"recurrent_training": {"rglru_bwd": rglru_rec, "ssd": ssd_rec,
                                           "gates": gates, "trainer": trained,
                                           "timed": timed}}))
    return rglru_rec, ssd_rec, launches



# -- phase 21 ----------------------------------------------------------------

def sharded_path(args, counters) -> dict:
    """Phase 21: 21a the train program against ``train_step``, 21c the
    prefill and decode programs against the unsharded port, then (with the
    process group destroyed) 21b the dry run of 21a's cell on a (1, 1) mesh
    against 21a's measured peak and 21d yi-6b ``train_4k`` on the single
    production mesh.  Returns the programs' launches by kernel."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun, steps as steps_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import lm
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.config import Segment
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_host_mesh()
    log(f"[21] sharded programs on {mesh} (world size {dist.get_world_size()})")
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    launched = dict.fromkeys(counters.kernels, 0)

    # 21a: the train program beside train_step
    cfg = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, TRAIN_UNITS),))
    cell = ShapeCell("phase19d", "train", TRAIN_SEQ, TRAIN_BATCH)
    adamw = AdamWConfig()
    data = synthetic_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=21)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
               for _ in range(SHARDED_STEPS)]
    prog = steps_mod.build_train_program(cfg, cell, mesh, adamw=adamw)
    specs = steps_mod.model_specs(cfg)
    runs = {}
    for name in ("program", "train_step"):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        state = init_state(init_params(specs, seed=21, device="cuda"))
        if name == "program":
            state, = prog.distribute(state)
        torch.cuda.reset_peak_memory_stats()  # the steps' peak, the state included
        counters.reset()
        walls, losses = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "program":
                state, metrics = prog.run(state, batch)
            else:
                state, metrics = steps_mod.train_step(cfg, state, batch, adamw)
            losses.append(full(metrics["loss"]).item())
            walls.append(time.perf_counter() - t0)
        got = counters.read()
        if got["plain_on_cuda"] or got["flash_attention"] != 2 * TRAIN_UNITS * SHARDED_STEPS:
            raise AssertionError(f"21a {name}: launches {got} (want "
                                 f"{2 * TRAIN_UNITS * SHARDED_STEPS} flash, no plain version)")
        if name == "program":
            for k in launched:
                launched[k] += got[k]
        peak = torch.cuda.max_memory_allocated() - before
        runs[name] = {"losses": losses, "first_ms": walls[0] * 1e3,
                      "ms_per_step": 1e3 * sum(walls[1:]) / len(walls[1:]),
                      "peak_bytes": peak, "peak_gib": peak / 2 ** 30}
        log(f"  21a {name}: losses {[round(x, 5) for x in losses]}, first step "
            f"{walls[0] * 1e3:.1f} ms, then {runs[name]['ms_per_step']:.1f} ms a step, peak "
            f"{peak / 2 ** 30:.2f} GiB above the {before / 2 ** 30:.2f} allocated before")
        if name == "program":
            # the program's state kept on the host while train_step runs
            kept = {f"{p}/{k}": full(v).cpu() for p in ("params", "m", "v")
                    for k, v in getattr(state, p).items()}
        else:
            mine = {f"{p}/{k}": v for p in ("params", "m", "v")
                    for k, v in getattr(state, p).items()}
        del state, metrics
    unequal = [k for k in mine if not torch.equal(mine[k], kept[k].to("cuda"))]
    worst = max(((rel_l2(kept[k].to("cuda"), mine[k]), k) for k in unequal), default=(0.0, None))
    log(f"  21a state after {SHARDED_STEPS} steps: {len(mine) - len(unequal)} of {len(mine)} "
        f"leaves bit-equal" + (f"; worst {worst[1]} at relative L2 {worst[0]:.3e}"
                               if unequal else ""))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs["program"]["losses"],
                                                       runs["train_step"]["losses"]))
    if loss_err > SHARDED_REL_L2 or worst[0] > SHARDED_REL_L2:
        raise AssertionError(f"21a: the program's state departs from train_step's: "
                             f"{worst} (losses {runs['program']['losses']} against "
                             f"{runs['train_step']['losses']})")
    del mine, kept, batches
    ratio = runs["program"]["ms_per_step"] / runs["train_step"]["ms_per_step"]
    log(f"  21a DTensor at world size 1: {runs['program']['ms_per_step']:.1f} ms a step against "
        f"{runs['train_step']['ms_per_step']:.1f} ({ratio:.3f}x)")

    # 21c: prefill and decode programs against the unsharded port
    serve = {}
    for arch, units in SHARDED_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, units),))
        params = init_params(steps_mod.model_specs(cfg), seed=21, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(21)
        tokens = torch.randint(0, cfg.vocab_size, (SHARDED_BATCH, SHARDED_SEQ), device="cuda",
                               generator=gen, dtype=torch.int32)
        nxt = torch.randint(0, cfg.vocab_size, (SHARDED_BATCH, 1), device="cuda",
                            generator=gen, dtype=torch.int32)
        pprog = steps_mod.build_prefill_program(
            cfg, ShapeCell("p", "prefill", SHARDED_SEQ, SHARDED_BATCH), mesh)
        dprog = steps_mod.build_decode_program(
            cfg, ShapeCell("d", "decode", SHARDED_SEQ, SHARDED_BATCH), mesh)
        counters.reset()
        want_logits, want_cache, clen = lm.prefill(cfg, params, tokens, SHARDED_SEQ)
        plain_launch = counters.read()
        counters.reset()
        logits, cache, pclen = pprog.run(params, {"tokens": tokens})
        prog_launch = counters.read()
        same = (torch.equal(full(logits), want_logits) and pclen == clen
                and all(torch.equal(full(cache[k]), want_cache[k]) for k in want_cache))
        counts = {k: (prog_launch[k], plain_launch[k]) for k in counters.kernels}
        for k in launched:
            launched[k] += prog_launch[k]
        want_step, _ = lm.decode_step(cfg, params, want_cache, clen, nxt)
        counters.reset()
        step_logits, _ = dprog.run(params, cache, clen, nxt)
        dec = counters.read()
        same_step = torch.equal(full(step_logits), want_step)
        serve[arch] = {"units": units, "prefill_bit_equal": same, "decode_bit_equal": same_step,
                       "launches": counts}
        log(f"  21c {cfg.name} at {cfg.num_layers} layers: prefill logits and cache bit-equal "
            f"{same}, launches (program, port) {counts}; decode step logits bit-equal "
            f"{same_step}, launches {dec}")
        if not (same and same_step) or any(a != b for a, b in counts.values()) \
                or prog_launch["plain_on_cuda"] or dec["plain_on_cuda"] \
                or not any(a for a, _ in counts.values()):
            raise AssertionError(f"21c {cfg.name}: the programs depart from the unsharded port")
        del params, cache, want_cache, logits, want_logits
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # 21b: the dry run of 21a's cell on a (1, 1) mesh
    cfg = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, TRAIN_UNITS),))
    rec = dryrun.run_cell(cfg, cell, mesh_shape={"data": 1, "model": 1})
    predicted = rec["memory"]["peak_bytes_per_chip"]
    measured = runs["program"]["peak_bytes"]
    log(f"  21b dry run of 21a's cell on (1, 1): predicted peak {predicted / 2 ** 30:.2f} GiB, "
        f"measured {measured / 2 ** 30:.2f} GiB, ratio {predicted / measured:.3f}; traced "
        f"{rec['roofline']['flops_per_chip']:.4g} flops, {rec['lower_s']} s to trace")
    if predicted < PEAK_FLOOR * measured:
        raise AssertionError(f"21b: the dry run predicts {predicted} bytes, below {PEAK_FLOOR} "
                             f"of the {measured} measured")

    # 21d: yi-6b train_4k on the single production mesh
    rec_d = dryrun.run_cell(TRAIN_ARCH, "train_4k", False)
    if rec_d["status"] != "ok":
        raise AssertionError(f"21d: {rec_d}")
    r = rec_d["roofline"]
    log(f"  21d dry run {TRAIN_ARCH} train_4k on {rec_d['chips']} cards: peak "
        f"{rec_d['memory']['peak_bytes_per_chip'] / 2 ** 30:.2f} GiB a card (fits "
        f"{rec_d['memory']['fits_hbm']}), {r['dominant']}-bound, step {r['step_seconds']:.4f} s "
        f"(compute {r['compute_s']:.4f}, memory {r['memory_s']:.4f}, collective "
        f"{r['collective_s']:.4f}), mfu_bound {rec_d['mfu_bound']:.4f}, {rec_d['lower_s']} s "
        f"to trace (derived from the published H100 SXM peaks, not measured); the "
        f"sequence whole between units gave {TRAIN_4K_WHOLE_PEAK / 2 ** 30:.2f} GiB")
    if rec_d["memory"]["peak_bytes_per_chip"] >= TRAIN_4K_WHOLE_PEAK:
        raise AssertionError(f"21d: peak {rec_d['memory']['peak_bytes_per_chip']} bytes, not "
                             f"below the {TRAIN_4K_WHOLE_PEAK} of the unsplit sequence")
    log(json.dumps({"sharded": {"train": runs, "serve": serve,
                                "dryrun_peak": {"predicted": predicted, "measured": measured},
                                "train_4k": rec_d}}))
    return launched


# -- phase 22 ----------------------------------------------------------------

def four_cards_path() -> dict:
    """Phase 22: ``scripts/torch_four_cards.py`` in a process group of its
    own, at ``--world 4`` where four cards are visible, else at ``--world
    1``; its output is logged, a failure fails the smoke.  Returns the
    launches of its programs' runs by kernel, summed over its ranks."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_four_cards.py")
    world = 4 if torch.cuda.device_count() >= 4 else 1
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[22] the port across cards: scripts/torch_four_cards.py --world {world}")
    if world == 1:
        log(f"  not run: the four-card parts ((a) the analytics mesh over DeviceMesh(4), (b) "
            f"at (4, 1) and (1, 4), (c), (d) internvl2-76b on (1, 4), (e) mixtral-8x22b at "
            f"56 layers on (1, 4)): torch sees {torch.cuda.device_count()} card(s); --world 1 "
            f"runs the env:// rendezvous, the leaf-wise init, (b) at (1, 1) and (e) at 2 "
            f"layers on (1, 1)")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, script, "--world", str(world)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=FOUR_CARDS_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)  # the script and its ranks
        proc.communicate()
        raise AssertionError(f"phase 22 did not finish within {FOUR_CARDS_TIMEOUT} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        log(f"  | {line}")
    if proc.returncode != 0:
        log(f"  | {lines[-1] if lines else ''}")
        raise AssertionError(f"phase 22: scripts/torch_four_cards.py --world {world} exited "
                             f"{proc.returncode}")
    summary = json.loads(lines[-1])["four_cards"]
    log(f"  phase 22: every gate met at --world {world} in {time.perf_counter() - t0:.1f} s; "
        f"launches {summary['launches']}")
    return summary["launches"]


# -- phase 23 ----------------------------------------------------------------

def example_twins_path() -> dict:
    """Phase 23: the example twins as a user runs them (``examples/torch_*.py``,
    ``PYTHONPATH=src``, no ``--device``: the card), each in a process group
    of its own: the analytics twin at the paper's scale
    (``TWIN_ANALYTICS_ARGS``), the serving twin at yi-6b's full width
    (``--full``).  Each must exit 0 through the kernels its path runs (the
    launch counts it prints: segagg's route ``cuda`` and the cluster-table
    scatter for CQ3; 32 flash launches a prefill call); their lines are
    logged.  Returns their launches by kernel."""
    root = os.path.dirname(os.path.abspath(__file__))
    gc.collect()
    torch.cuda.empty_cache()
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    launches = {}
    for script, argv in (("torch_deadline_analytics.py", TWIN_ANALYTICS_ARGS),
                         ("torch_multi_query_serving.py", ("--full",))):
        log(f"[23] examples/{script} {' '.join(argv)}")
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.join(root, "examples", script), *argv],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=root, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=TWIN_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise AssertionError(f"phase 23: {script} did not finish within {TWIN_TIMEOUT} s")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        for line in out.strip().splitlines():
            log(f"  | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"phase 23: {script} exited {proc.returncode}")
        got = re.search(r"^kernel launches: (\{.*\}) in ", out, re.M)
        if got is None:
            raise AssertionError(f"phase 23: {script} printed no launch counts")
        counts = json.loads(got.group(1))
        if script.startswith("torch_deadline"):
            if "segagg route: cuda" not in out or counts["segagg_scatter"] <= 0:
                raise AssertionError(f"phase 23: CQ3 at the paper's scale must run on the "
                                     f"card through the cluster-table scatter: {counts}")
        elif counts["flash_attention"] <= 0 or counts["flash_attention"] % 32:
            raise AssertionError(f"phase 23: yi-6b's prefill calls must launch the flash "
                                 f"kernel once a layer (32): {counts}")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        log(f"  phase 23: {script} passed in {time.perf_counter() - t0:.1f} s; "
            f"launches {counts}")
    return launches


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

def bound(ops: float, nbytes: float, dtype: str):
    """The least time of the work in ms at the card's published peaks for
    ``dtype`` (``KernelRooflineManager`` over ``PUBLISHED_H100_SXM``), and
    what bounds it."""
    from repro_torch.dist import PUBLISHED_H100_SXM, KernelRooflineManager

    roof = KernelRooflineManager(PUBLISHED_H100_SXM[dtype]).get_roofline(
        {"flops": ops, "bytes": nbytes, "seconds": 0.0})
    return roof["bound_s"] * 1e3, ("bytes" if roof["memory_s"] >= roof["compute_s"]
                                   else "operations")


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
        b_ms, b_by = bound(*flash_fb(B, S, S, H, Hkv, D, True, W), "bfloat16")
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
        b_ms, b_by = bound(*rglru_fb(B, S, N), "float32")
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


def flash_continuation_times(flash_cuda, flash_plain, flash_f32, flash_fb) -> dict:
    """The flash kernel at a prefill continuation of olmoe-1b-7b's heads:
    B 8, 512 new queries after 4,096 cached keys (``q_offset`` 4,096),
    causal, with every row's keys valid and with ragged valid lengths in
    [1, 4,608]; each held against the plain version in f32 (``flash_f32``)
    on its live rows, its time beside the plain version's on the model's
    bf16 inputs (``flash_plain``), ``scaled_dot_product_attention``'s with
    the same mask and the bound of this run's live pairs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import rows_with_keys

    gen = torch.Generator(device="cuda").manual_seed(7)
    B, Sq, Sk, H, D = 8, 512, 4608, 16, 128
    q = torch.randn((B, Sq, H, D), device="cuda", generator=gen).bfloat16()
    k = torch.randn((B, Sk, H, D), device="cuda", generator=gen).bfloat16()
    v = torch.randn((B, Sk, H, D), device="cuda", generator=gen).bfloat16()
    out = {}
    for label, valid in (("full", None), ("ragged", torch.randint(
            1, Sk + 1, (B,), device="cuda", generator=gen, dtype=torch.int32))):
        off = Sk - Sq
        want = flash_f32(q, k, v, True, 0, 0.0, q_offset=off, kv_valid_len=valid)
        live = rows_with_keys(B, Sq, Sk, True, 0, off, valid, device="cuda")
        err = check_close(f"flash continuation ({label}) at B={B} Sq={Sq} Sk={Sk}",
                          flash_cuda(q, k, v, True, 0, 0.0, off, valid)[live], want[live],
                          BF16_TOL)
        lens = None if valid is None else valid.tolist()
        pos = torch.arange(Sk, device="cuda")
        mask = pos[None, :] <= off + torch.arange(Sq, device="cuda")[:, None]   # (Sq, Sk)
        if valid is not None:
            mask = mask[None, None] & (pos < valid[:, None])[:, None, None]     # (B,1,Sq,Sk)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        b_ms, b_by = bound(*flash_fb(B, Sq, Sk, H, H, D, True, 0, q_offset=off,
                                     kv_valid_len=lens), "bfloat16")
        r = {"shape": f"B={B} Sq={Sq} Sk={Sk} q_offset={off} H={H} Hkv={H} D={D} causal, "
                      f"kv_valid_len {lens or 'none'}",
             "max_abs_err": err[0],
             "ms": cuda_ms(lambda: flash_cuda(q, k, v, True, 0, 0.0, off, valid),
                           reps=KERNEL_REPS),
             "plain_ms": cuda_ms(lambda: flash_plain(q, k, v, True, 0, 0.0, q_offset=off,
                                                     kv_valid_len=valid), reps=2),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(sdpa, reps=KERNEL_REPS)}
        log(f"  flash_attention continuation ({label}) {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound {b_ms:.4f} by {b_by} "
            f"({b_ms / r['ms']:.1%} of it reached); max abs err {shown(err)}")
        out[label] = r
    return out


def flash_times_at(what: str, fns, q, k, v, causal: bool, window: int = 0,
                   q_offset: int = 0) -> dict:
    """The flash kernel on ``q``, ``k``, ``v`` ((B, S, heads, D), bf16, a
    window that reaches every key; with ``q_offset`` the last rows of a
    causal core, ``q_offset + Sq = Sk``): held against the plain version in
    f32, its time beside the plain version's on the same inputs,
    ``scaled_dot_product_attention``'s (``is_causal``, or at an offset the
    lower-right causal bias: the same function with no dense mask) and the
    bound of this call's live pairs.  ``fns``: the kernel, the plain
    version, its f32 form and the flops and bytes."""
    import torch.nn.functional as F

    flash_cuda, flash_plain, flash_f32, flash_fb = fns
    (B, Sq, H, D), (Sk, Hkv) = q.shape, k.shape[1:3]
    if window and window < Sk:
        raise ValueError(f"window {window} < {Sk} keys: SDPA would need a mask")
    if q_offset and not (causal and q_offset + Sq == Sk):
        raise ValueError(f"q_offset {q_offset}: SDPA's lower-right causal bias needs a "
                         f"causal core whose rows end at the last of the {Sk} keys")
    off = dict(q_offset=q_offset)
    err = check_close(f"flash {what} at B={B} Sq={Sq} Sk={Sk}",
                      flash_cuda(q, k, v, causal, window, **off),
                      flash_f32(q, k, v, causal, window, **off), BF16_TOL)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q_offset:
        from torch.nn.attention.bias import causal_lower_right

        mask = dict(attn_mask=causal_lower_right(Sq, Sk))
    else:
        mask = dict(is_causal=causal)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=Hkv != H, **mask)

    b_ms, b_by = bound(*flash_fb(B, Sq, Sk, H, Hkv, D, causal, window, **off), "bfloat16")
    r = {"shape": f"B={B} Sq={Sq} Sk={Sk} H={H} Hkv={Hkv} D={D} "
                  f"{'causal' if causal else 'not causal'}"
                  f"{f', window {window}' if window else ''}"
                  f"{f', q_offset {q_offset}' if q_offset else ''}",
         "max_abs_err": err[0],
         "ms": cuda_ms(lambda: flash_cuda(q, k, v, causal, window, **off), reps=KERNEL_REPS),
         "plain_ms": cuda_ms(lambda: flash_plain(q, k, v, causal, window, **off), reps=2),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(sdpa, reps=KERNEL_REPS)}
    # the yardstick computes the same function (logged, not a gate of the port)
    r["library_max_abs_err"] = (sdpa().transpose(1, 2).float()
                                - flash_f32(q, k, v, causal, window, **off)).abs().max().item()
    log(f"  flash_attention {what} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f} "
        f"({r['library_ms'] / r['ms']:.2f}x), "
        f"bound {b_ms:.4f} by {b_by} ({b_ms / r['ms']:.1%} of it reached); max abs err "
        f"{shown(err)}, SDPA's {r['library_max_abs_err']:.3e}")
    return r


def flash_whisper_times(*fns) -> dict:
    """``flash_times_at`` whisper-medium's two prefill shapes at B 8 (16
    heads of 64, not causal): the encoder's self-attention over its 1,500
    frames and the cross-attention of a ``WHISPER_PROMPT``-token prompt over
    them."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    B, Sk, H, D = 8, 1500, 16, 64
    k = torch.randn((B, Sk, H, D), device="cuda", generator=gen).bfloat16()
    v = torch.randn((B, Sk, H, D), device="cuda", generator=gen).bfloat16()
    out = {}
    for label, Sq in (("encoder", Sk), ("cross", WHISPER_PROMPT)):
        q = torch.randn((B, Sq, H, D), device="cuda", generator=gen).bfloat16()
        out[label] = flash_times_at(f"whisper {label}", fns, q, k, v, False)
    return out


def flash_mixtral_times(*fns) -> dict:
    """``flash_times_at`` one rank's heads of mixtral-8x22b's prefill on
    (1, 4) (``scripts/torch_four_cards.py`` part (e)): B 2, S 4,096, 12
    query and 2 KV heads of 128, causal, the config's window (4,096, every
    earlier key)."""
    from repro_torch.models.base import get_config

    cfg, ranks = get_config("mixtral_8x22b"), 4
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((2, 4096, h // ranks, cfg.head_dim), device="cuda",
                           generator=gen).bfloat16()
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    return flash_times_at("mixtral-8x22b (1, 4) rank", fns, q, k, v, True, cfg.window)


def flash_row_split_times(*fns) -> dict:
    """``flash_times_at`` the last rank's rows of chatglm3-6b's training core
    on (1, 4) (``scripts/torch_four_cards.py`` part (b), ``layers/
    attention.py`` ``_row_split``): B 4, the last 512 of 2,048 query rows
    (``q_offset`` 1,536) over all 2,048 keys, 32 query and 2 KV heads of
    128, causal: the rank with the most keys."""
    from repro_torch.models.base import get_config

    cfg, ranks, B, S = get_config("chatglm3_6b"), 4, 4, 2048
    gen = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn((B, S // ranks, cfg.num_heads, cfg.head_dim), device="cuda",
                    generator=gen).bfloat16()
    k, v = (torch.randn((B, S, cfg.num_kv_heads, cfg.head_dim), device="cuda",
                        generator=gen).bfloat16() for _ in range(2))
    return flash_times_at("chatglm3-6b (1, 4) last rank's rows", fns, q, k, v, True,
                          q_offset=S - S // ranks)


def flash_twin_times(*fns) -> dict:
    """``flash_times_at`` the serving twin's prefill shapes (phase 23,
    ``examples/torch_multi_query_serving.py --full``): yi-6b's 32 query and 4
    KV heads of 128, ``TWIN_SEQ`` tokens (one partial key tile), causal, at
    its smallest and largest buckets (``TWIN_FLASH_BATCHES``)."""
    from repro_torch.models.base import get_config

    cfg = get_config("yi_6b")
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for B in TWIN_FLASH_BATCHES:
        q, k, v = (torch.randn((B, TWIN_SEQ, h, cfg.head_dim), device="cuda",
                               generator=gen).bfloat16()
                   for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
        out[B] = flash_times_at("yi-6b serving twin", fns, q, k, v, True, cfg.window)
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
    b_ms, b_by = bound(*ssd_fb(B, S, H, P, N), "bfloat16")
    return {"design": SSD_DESIGN, "max_abs_err": err[0], "ms": cuda_ms(lambda: ssd_cuda(*args)),
            "plain_ms": cuda_ms(lambda: ssd_plain(x, dt, A, Bm, Cm, D, 128, h0), reps=2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def cut_model(cfg, params, units):
    """The first ``units`` units of segment 0 (and of encoder segment 0)
    and their weights (views of ``params``); the whole model when ``units``
    is None."""
    from repro_torch.models.config import Segment

    if units is None:
        return cfg, params

    def cut(segs):
        return (Segment(segs[0].pattern, units),) if segs else ()

    cfg = dataclasses.replace(cfg, segments=cut(cfg.segments),
                              encoder_segments=cut(cfg.encoder_segments))
    out = {}
    for k, v in params.items():
        head = k.split("/")[0]
        if head in ("seg0", "enc0"):
            out[k] = v[:units]
        elif not re.fullmatch(r"(seg|enc)\d+", head):
            out[k] = v
    return cfg, out


def plain_swap(ex, batch, units, swaps, first_impls=None):
    """One batch through the first ``units`` units of segment 0 (all
    segments when None), with the kernels (or ``first_impls``, one per
    swap) and again with their plain versions swapped in.  ``swaps`` lists
    (ops module, kernel attribute, plain version).  Returns (relative L2
    error of the logits, argmax agreement, first run s, plain s, the inputs
    of each kernel's first call by attribute)."""
    from repro_torch.serve.engine import PrefillExecutor

    cfg, params = cut_model(ex.cfg, ex.params, units)
    cut = PrefillExecutor(cfg, params, buckets=(batch.shape[0],), device="cuda")
    kernels = [getattr(mod, attr) for mod, attr, _ in swaps]
    impls = kernels if first_impls is None else first_impls
    first = {}

    def recorder(attr, kernel):
        def rec(*a, **kw):
            first.setdefault(attr, tuple(t.clone() if torch.is_tensor(t) else t for t in a))
            return kernel(*a, **kw)
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


def profile_batch(run, what: str) -> None:
    """Where the device time of ``run()`` (one prefill batch, which ends on
    the host) goes, by kernel class, and the device's idle share of its
    wall time (``torch.profiler``; the kernels run on one stream, so busy
    time is the sum of kernel times).  Logged only: a profiler that records
    no device time is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
        elif is_matmul(name):
            classes["matmul"] += dt
        else:
            classes["other"] += dt
    busy = sum(classes.values())
    if not count or busy <= 0:
        log("    profiler: no device time recorded")
        return
    log(f"    profile of {what}: wall {wall_us / 1e3:.1f} ms, "
        f"{count} kernels, device busy {busy / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_us):.1%}; by class (ms, share of busy): " + ", ".join(
            f"{k} {v / 1e3:.1f} ({v / busy:.1%})" for k, v in classes.items() if v))


KIND_KERNEL = {"attn": "flash_attention", "moe": "flash_attention", "rglru": "rglru",
               "ssm": "ssd"}


def check_launches(cfg, got: dict, wall_s: float) -> None:
    """Each LM kernel launched once per layer of its kind in every prefill
    call of the path, and no plain version called on a CUDA tensor."""
    calls = got["prefill_calls"]
    want = dict.fromkeys(KIND_KERNEL.values(), 0)
    for kind, k in KIND_KERNEL.items():
        want[k] += calls * sum(seg.pattern.count(kind) * seg.num_units
                               for seg in cfg.segments)
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
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no {os.path.join(src, 'repro_torch')}: run the script from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.core import Planner, Query, TraceArrival, plan_cost
    from repro_torch.data.tpch import (
        NUM_FILES, PAPER_QUERIES, StreamScale, paper_cost_model, stream_files)
    from repro_torch.kernels import _build
    from repro_torch.kernels.segagg import ops, tuning
    from repro_torch.kernels.segagg.ref import segagg_ref, zipf_keys
    from repro_torch.kernels.segagg.segagg import (
        narrow_work, scatter_plan_for, segagg_narrow_cuda, segagg_scatter_atomic_cuda,
        segagg_scatter_cuda)
    from repro_torch.serve import analytics
    from repro_torch.serve.analytics import (
        AnalyticsRuntimeExecutor, concat_files, measure_cost_model, run_batched, run_plan,
        run_session, run_shared_jobs)
    from repro_torch import core
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, flash_attention_sync_cuda, flops_bytes as flash_flops_bytes)
    from repro_torch.kernels.flash_attention.ref import (
        chunked_attention_f32_ref,
        chunked_attention_ref,
        rows_with_keys,
    )
    from repro_torch.layers import moe as moe_layer
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.rglru.rglru import (
        flops_bytes as rglru_flops_bytes, rglru_bwd_cuda, rglru_cuda, rglru_serial_cuda)
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bf16ops_ref, ssd_chunked_ref
    from repro_torch.kernels.ssd.ssd import flops_bytes as ssd_flops_bytes, ssd_cuda
    from repro_torch.models import encdec, lm
    from repro_torch.models.base import SHAPES, get_config
    from repro_torch.serve import engine
    from repro_torch.dist import PUBLISHED_H100_SXM, measure_machine_spec

    t_start = time.perf_counter()
    # 1. environment
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}), {name}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    measured = measure_machine_spec("cuda")
    pub = PUBLISHED_H100_SXM
    log(f"[1] probe: copy {measured['float32'].peak_bw / 1e12:.4f} TB/s (published "
        f"{pub['float32'].peak_bw / 1e12:.2f}), f32 matmul 8192^2 TF32 off "
        f"{measured['float32'].peak_flops / 1e12:.2f} TFLOP/s (published "
        f"{pub['float32'].peak_flops / 1e12:.0f}), bf16 matmul 8192^2 "
        f"{measured['bfloat16'].peak_flops / 1e12:.2f} TFLOP/s (published "
        f"{pub['bfloat16'].peak_flops / 1e12:.0f}); {smi}; "
        f"{time.perf_counter() - t0:.2f} s")

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
            plan = scatter_plan_for(g, v, 'cuda', n=PARITY_FILES * sc.lineitems_per_file)
            log(f"    G={g:>9} V={v}: scatter plan {plan}")
    kernel_parity([("segagg_narrow", segagg_narrow_cuda, (1, 5)),
                   ("segagg_scatter", segagg_scatter_cuda, (1, 5) + wide),
                   ("segagg_scatter_atomic", segagg_scatter_atomic_cuda, (5,) + wide)],
                  segagg_ref, PARITY_FILES * sc.lineitems_per_file)
    narrow_parity(segagg_narrow_cuda, lambda: narrow_work(torch.device("cuda", 0)),
                  tuning.narrow_fits, segagg_ref, PARITY_FILES * sc.lineitems_per_file)
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
    phase4 = {}    # query id -> (query, plan, run_plan's aggregate, its launches by kernel)
    seg_kernels = {"segagg_narrow": segagg_narrow_cuda, "segagg_scatter": segagg_scatter_cuda,
                   "segagg_scatter_atomic": segagg_scatter_atomic_cuda}

    def seg_counts():
        return {k: fn.launches for k, fn in seg_kernels.items()}

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
        before = seg_counts()
        t0 = time.perf_counter()
        result, blog, agg_s = run_plan(aq, files, plan, sc, device="cuda")
        t_run = time.perf_counter() - t0
        phase4[qid] = (q, plan, result, diff(seg_counts(), before))
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
        form = tuning.pick_formulation("cuda", keys.shape[0], g, vals.shape[1])
        plan = (scatter_plan_for(g, vals.shape[1], "cuda", n=keys.shape[0])
                if form == "scatter" else None)
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
            forced = scatter_plan_for(g, vals.shape[1], "cuda", n=keys.shape[0], max_ranges=4)
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
        f"tuning.matmul_max_g('cuda') = {tuning.matmul_max_g('cuda')}")
    tuned_dispatch(ops, tuning, scatter_plan_for, segagg_ref, seg_kernels,
                   {aq.query_id: (largest[aq.query_id], aq.num_groups(sc))
                    for aq in PAPER_QUERIES}, PARITY_FILES * sc.lineitems_per_file)

    # 12. pane-shared scans on the same stream; counts from the first
    # run_shared_jobs to the last
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

    # 15. the device mesh on the same stream; counts over the phase
    log(f"[15] the device mesh: run_plan over DeviceMesh(['cuda:0']) against phase 4, "
        f"MeshAnalyticsBackend over 1 and 2 slots of cuda:0 (llf-dynamic, shard_across=W, "
        f"ShardedCostModel of phase 4's model)")
    t0 = time.perf_counter()
    with recorder:
        for qid in MESH_QUERIES:
            aq = by_id[qid]
            mesh_path(aq, streams[aq.stream], arrival, oneshot[qid], models[qid],
                      phase4[qid], sc, recorder)
    log(f"  launches {recorder.launches}; plain version on CUDA tensors "
        f"{recorder.plain_cuda} times; {time.perf_counter() - t0:.1f} s")
    if min(recorder.launches.values()) <= 0 or recorder.plain_cuda:
        raise AssertionError("the mesh path must run through the three kernels only")
    for k, v in recorder.launches.items():
        by_phase[k]["15"] = v

    # 8. LM kernel parity
    del streams, oneshot, rex
    torch.cuda.empty_cache()
    log(f"[8] LM kernel parity against the plain version (bf16 within {BF16_TOL} of "
        f"the plain version in f32, f32 RG-LRU and h_last "
        f"within {STATE_TOL}; SSD y "
        f"within {SSD_Y_TOL[torch.float32]} (f32) and {SSD_Y_TOL[torch.bfloat16]} (bf16), "
        f"h_last rtol {SSD_H_RTOL} and atol {SSD_H_ATOL[torch.float32]} (f32), "
        f"{SSD_H_ATOL[torch.bfloat16]} (bf16))")
    lm_kernel_parity(flash_attention_cuda, chunked_attention_f32_ref, rglru_cuda, rglru_ref)
    flash_continuation_parity(flash_attention_cuda, chunked_attention_f32_ref, rows_with_keys)
    ssd_kernel_parity(ssd_cuda, ssd_chunked_ref)
    torch.cuda.synchronize()

    # 9. the recurrentgemma-9b serving path; counts from the calibration to
    # the last job
    log(f"[9] serving path: {SERVE_ARCH} at full width, prompts of {SERVE_SEQ} tokens")
    counters = LaunchCounters(
        lm, {"flash_attention": flash_attention_cuda, "rglru": rglru_cuda, "ssd": ssd_cuda,
             "rglru_bwd": rglru_bwd_cuda},
        [(fa_ops, "chunked_attention_ref"), (rg_ops, "rglru_ref"), (rg_ops, "rglru_bwd_ref"),
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
            want = chunked_attention_f32_ref(q, k, v, causal, window, cap)
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
        profile_batch(lambda: ex.run_batch(batch8), "one batch of 8")
    except Exception as exc:  # the profiler is a reading, not a gate
        log(f"    profiler failed: {exc!r}")
    del first

    # 17. decode on the same model, then free it
    log(f"[17] decode: {SERVE_ARCH}, {DECODE_STEPS} greedy steps at full depth, "
        f"teacher-forced at {3 * RG_GATE_UNITS} layers")
    flash_swap = (fa_ops, "flash_attention_cuda", chunked_attention_ref)
    decode = {SERVE_ARCH: decode_path(lm, cfg, ex.params, batch8, SERVE_SEQ, RG_GATE_UNITS,
                                      counters, args.seed, flash_swap)}
    del ex
    torch.cuda.empty_cache()

    # 10. LM kernel times at the paths' shapes
    log(f"[10] LM kernels at the paths' shapes: flash (B in {LM_BATCHES}, S=4096, H=16, "
        f"Hkv=1, D=256, window 2048), rglru (B in {LM_BATCHES}, S=4096, N=4096), ssd (B=8, "
        f"S=32768, H=32, P=64, N=128), flash at an olmoe continuation, whisper's encoder "
        f"and cross-attention, a (1, 4) rank of mixtral-8x22b, the last rank's rows of "
        f"chatglm3-6b's training core on (1, 4) and yi-6b's prefill in the serving twin "
        f"(B in {TWIN_FLASH_BATCHES}, S={TWIN_SEQ}); ms, CUDA events")
    lm_times = lm_kernel_times(flash_attention_cuda, flash_attention_sync_cuda,
                               chunked_attention_ref, flash_flops_bytes, rglru_cuda,
                               rglru_serial_cuda, rglru_ref, rglru_flops_bytes)
    lm_times["ssd"] = ssd_kernel_times(ssd_cuda, ssd_chunked_ref, ssd_chunked_bf16ops_ref,
                                       ssd_flops_bytes)
    lm_times["flash_attention"]["continuation"] = flash_continuation_times(
        flash_attention_cuda, chunked_attention_ref, chunked_attention_f32_ref, flash_flops_bytes)
    flash_fns = (flash_attention_cuda, chunked_attention_ref, chunked_attention_f32_ref,
                 flash_flops_bytes)
    lm_times["flash_attention"]["whisper"] = flash_whisper_times(*flash_fns)
    lm_times["flash_attention"]["mixtral"] = flash_mixtral_times(*flash_fns)
    lm_times["flash_attention"]["row_split"] = flash_row_split_times(*flash_fns)
    lm_times["flash_attention"]["twin"] = flash_twin_times(*flash_fns)
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
        profile_batch(lambda: ex.run_batch(batch8), "one batch of 8")
    except Exception as exc:  # the profiler is a reading, not a gate
        log(f"    profiler failed: {exc!r}")
    log(f"[17] decode: {SSM_ARCH}, {DECODE_STEPS} greedy steps at full depth, "
        f"teacher-forced at {SSM_GATE_UNITS} layers")
    decode[SSM_ARCH] = decode_path(lm, cfg, ex.params, batch8, SSM_SEQ, SSM_GATE_UNITS,
                                   counters, args.seed, flash_swap)
    del ex
    torch.cuda.empty_cache()

    # 16. the olmoe-1b-7b serving path; counts from the calibration to the
    # last job
    log(f"[16] serving path: {MOE_ARCH} at full width and depth, prompts of {MOE_SEQ} "
        f"tokens (routing groups of {get_config(MOE_ARCH).moe_group_size})")
    cfg = get_config(MOE_ARCH)
    ex, batch8, moe_launches = moe_path(args, cfg, lm, engine, core, counters, fa_ops,
                                        chunked_attention_f32_ref, moe_layer)
    launches["flash_attention"] += moe_launches["flash_attention"]
    by_phase["flash_attention"]["16"] = moe_launches["flash_attention"]
    log(f"[17] decode: {MOE_ARCH}, {DECODE_STEPS} greedy steps at full depth, "
        f"teacher-forced at {MOE_GATE_UNITS} layers")
    decode[MOE_ARCH] = decode_path(lm, cfg, ex.params, batch8, MOE_SEQ, MOE_GATE_UNITS,
                                   counters, args.seed, flash_swap, tf_seq=MOE_TF_SEQ,
                                   capacity_factor=float(cfg.num_experts))
    del ex
    torch.cuda.empty_cache()

    # 18. whisper-medium served: encode, prefill and greedy decode (the
    # executors above hold themselves in cycles through their wrapped
    # run_batch: collect them first)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    log(f"[18] serving {WHISPER_ARCH} at full width and depth: encode, encdec_prefill and "
        f"{DECODE_STEPS} greedy decode steps; the plain flash at {WHISPER_GATE_UNITS} + "
        f"{WHISPER_GATE_UNITS} layers; teacher-forced at {WHISPER_TF_UNITS} + "
        f"{WHISPER_TF_UNITS}")
    decode[WHISPER_ARCH], whisper_launches = whisper_path(
        args, cfg, lm, encdec, counters, fa_ops, chunked_attention_f32_ref, flash_swap)
    launches["flash_attention"] += whisper_launches
    by_phase["flash_attention"]["18"] = whisper_launches
    torch.cuda.empty_cache()
    log(json.dumps({"decode": decode}))

    # 19. training: the kernel's lse and the backward, the loss and its
    # gradients at 2 layers, the trainer, then yi-6b's timed steps
    lm_times["flash_attention"]["training"], trained = training_path(
        args, counters, measured["bfloat16"].peak_flops)
    launches["flash_attention"] += trained
    by_phase["flash_attention"]["19"] = trained

    # 20. training the recurrent kinds: the RG-LRU backward kernel, the SSD's
    # states and backward, the gradients at 2-3 layers, the trainer on
    # mamba2-370m, then both models' timed steps
    rglru_bwd_times, ssd_train, recurrent = recurrent_training_path(
        args, counters, measured["bfloat16"].peak_flops)
    for k, n in recurrent.items():
        launches[k] = launches.get(k, 0) + n
        by_phase.setdefault(k, {})["20"] = n
    lm_times["ssd"]["training"] = ssd_train

    # 21. the sharded programs on a one-rank group, then the dry run
    for k, n in sharded_path(args, counters).items():
        launches[k] = launches.get(k, 0) + n
        by_phase.setdefault(k, {})["21"] = n

    # 22. the port across cards, in its own ranks
    for k, n in four_cards_path().items():
        launches[k] = launches.get(k, 0) + n
        by_phase.setdefault(k, {})["22"] = n

    # 23. the example twins, as a user runs them
    for k, n in example_twins_path().items():
        launches[k] = launches.get(k, 0) + n
        by_phase.setdefault(k, {})["23"] = n

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
    notes = {"rglru": "optional f32 carries output (the state entering each 128-step "
                      "chunk) for the backward; null for serving",
             "ssd": "optional f32 states output (the state entering each 128-step chunk) "
                    "for ssd_bwd (PyTorch ops, timed under training); null for serving"}
    for kname, (source, replaced) in lm_sources.items():
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaced, "launches": launches[kname],
                        "launches_by_phase": by_phase[kname], **lm_times[kname],
                        **({"note": notes[kname]} if kname in notes else {})})
    kernels.append({"name": "rglru_bwd", "route": "cuda",
                    "source": "src/repro_torch/csrc/rglru.cu",
                    "replaces": "src/repro/layers/rglru.py:27 (jax autodiff of rglru_scan's "
                                "associative scan; the JAX package has no backward kernel)",
                    "launches": launches["rglru_bwd"],
                    "launches_by_phase": by_phase["rglru_bwd"], **rglru_bwd_times})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
