#!/usr/bin/env python3
"""Tune the port's segagg dispatch on one CUDA card and write its table.

    python3 scripts/torch_hillclimb.py --segagg [--reps 25] [--seed 0]

The port's twin of ``benchmarks/hillclimb.py --segagg``: it measures what
``repro_torch.kernels.segagg.tuning`` reads, and writes the port's own
``tuned_blocks.json`` through ``tuning.save``.  V = 1 and values 1 (the
paper's count queries), uniform keys from a seeded ``torch.Generator`` on
the card.  Each timing is the median of ``--reps`` launches, each between
two CUDA events, after three warm-up calls.  The sweep's calls start on an
idle card, so a timing there is what one call costs (the host's part
included); the hill-climb's candidates run the same host code, so it
enqueues its launches behind a ``torch.cuda._sleep`` and each event pair
then brackets the card's own time.  Every timed call's counts are
held against ``segagg_ref``'s in float64 (``counts_match``): exact where no
group counts past 2^24 (f32 holds every integer up to there, whatever the
order of the adds), else within ``FLOAT_RTOL``.  A count up to 2^24 that
differs fails the run.  Past 2^24 (29,250,000 rows at G = 1) a formulation
that misses ``FLOAT_RTOL`` is listed under ``"wrong"`` with its time and
error and cannot win at that G: one-element f32 adds of 1 into one group
stop counting at 2^24.

(b) The scatter plan, first: for each wide shape class, a hill-climb from
(cluster 8, max_ranges 1) over cluster 8 <-> 16 (16 where the card runs
such clusters) and max_ranges doubled or halved within 1-4, timing
``segagg_scatter_cuda`` with the plan the table would give
(``scatter_plan_for(..., sizes=, max_ranges=)``) at the class's
representatives: ``small-wide`` one and two lineitem files at CQ3's G
(13,000 and 26,000 x 360,000: CQ3's smallest batches), ``large-wide``
CQ3's (31,928,000 x 360,000) and CQ4's (30,732,000 x 1,500,000) largest
main-path batches.  A candidate replaces the current
entry only if it is more than ``MARGIN`` faster at one representative and
no more than ``MARGIN`` slower at any other.  These entries are saved
before (a), so the sweep's scatter runs the plan the table will give.

(a) The narrow/scatter crossover: ``ops.segagg(formulation="matmul")``
(the narrow kernel) against ``formulation="scatter"`` at 13,000 rows (one
lineitem file), 1,261,000 (97 files) and 29,250,000 (2,250 files), for G
in ``GROUPS`` (``chip_smoke.py``'s ``CROSSOVER_GROUPS``).  Narrow wins at
a G when its median is at most ``MARGIN`` above scatter's (the reference's
noise margin); ``matmul_max_g`` is the largest G up to which narrow wins
at every G of the grid and at every row count, never above what
``tuning.narrow_fits`` allows.

Beside both, the library call that computes the same counts,
``torch.zeros((G, 1)).index_add_(0, keys, ones)``, is timed at the same
shapes the same way (the card's own time at (b)'s representatives, per
call at (a)'s grid) and its counts held as the kernels' are; it is a
yardstick and never wins anything.

Prints the card's name and power limit, then one JSON report with every
median.  Exits non-zero without a card, or if a timed call's counts do not
match the plain version's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.segagg import tuning  # noqa: E402

# Rows of one, 97 (chip_smoke.py's PARITY_FILES) and 2,250 lineitem files
# of 13,000 rows (StreamScale(1.0)).
ROWS = (13_000, 1_261_000, 29_250_000)
GROUPS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 12288)
# Relative noise margin of a comparison (benchmarks/hillclimb.py's 0.97).
MARGIN = 0.03
# Representatives (rows, groups) of each wide shape class.
REPRESENTATIVES = {
    "small-wide": ((13_000, 360_000), (26_000, 360_000)),
    "large-wide": ((31_928_000, 360_000), (30_732_000, 1_500_000)),
}
START = (tuning.SCATTER_CLUSTER_SIZES[0], tuning.SCATTER_MAX_RANGES)
RANGES_SPAN = (1, 4)
WARMUP = 3
# Card cycles of sleep a timed launch, so the host enqueues them all first
# (~1 ms a launch at the H100's clock, well above the host's cost a call).
AHEAD_CYCLES = 2_000_000
# f32 holds every integer up to 2^24; past it a count is held within
# chip_smoke.py's float tolerance.
EXACT_COUNT = 2 ** 24
FLOAT_RTOL = 1e-4


def counts_match(got: torch.Tensor, want: torch.Tensor) -> bool:
    """f32 counts ``got`` against float64 counts ``want``: equal where no
    count passes ``EXACT_COUNT``, else within ``FLOAT_RTOL``."""
    if want.max().item() <= EXACT_COUNT:
        return torch.equal(got.double(), want)
    return torch.allclose(got.double(), want, rtol=FLOAT_RTOL, atol=0.0)


def counts_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative error of f32 counts against float64 ones."""
    return ((got.double() - want).abs() / want.clamp_min(1.0)).max().item()


def narrow_wins(narrow_ms: Optional[float], scatter_ms: Optional[float]) -> bool:
    """Narrow wins when it gives the counts and scatter does not, or is at
    most ``MARGIN`` above scatter (None: no right answer)."""
    if narrow_ms is None:
        return False
    return scatter_ms is None or narrow_ms <= scatter_ms * (1 + MARGIN)


def crossover_sweep(timer: Callable[[int, int, str], Optional[float]],
                    rows: Sequence[int] = ROWS, groups: Sequence[int] = GROUPS,
                    v: int = 1) -> Tuple[int, Dict[int, int], Dict[int, List[dict]]]:
    """``timer(n, g, formulation)`` -> median ms for each row count and G,
    or None where the counts are wrong (narrow only where its table fits).
    Returns ``matmul_max_g`` (0 if narrow loses at the first G), the largest
    G of each row count's unbroken run of wins, and the medians."""
    medians: Dict[int, List[dict]] = {}
    per_rows: Dict[int, int] = {}
    for n in rows:
        medians[n], per_rows[n], unbroken = [], 0, True
        for g in groups:
            t_n = timer(n, g, "matmul") if tuning.narrow_fits(g, v) else None
            t_s = timer(n, g, "scatter")
            wins = narrow_wins(t_n, t_s)
            medians[n].append({"g": g, "narrow_ms": t_n, "scatter_ms": t_s,
                               "narrow_wins": wins})
            unbroken = unbroken and wins
            if unbroken:
                per_rows[n] = g
    return min(per_rows.values()), per_rows, medians


def neighbours(cluster: int, max_ranges: int, largest_cluster: int) -> List[Tuple[int, int]]:
    """The hill-climb's moves from (cluster, max_ranges)."""
    out = [(c, max_ranges) for c in tuning.SCATTER_CLUSTER_SIZES
           if c != cluster and c <= largest_cluster]
    out += [(cluster, r) for r in (max_ranges * 2, max_ranges // 2)
            if RANGES_SPAN[0] <= r <= RANGES_SPAN[1]]
    return out


def better(cand_ms: Sequence[float], cur_ms: Sequence[float]) -> bool:
    """More than ``MARGIN`` faster at one representative and no more than
    ``MARGIN`` slower at any."""
    return (any(c < b * (1 - MARGIN) for c, b in zip(cand_ms, cur_ms))
            and all(c <= b * (1 + MARGIN) for c, b in zip(cand_ms, cur_ms)))


def hillclimb(timer: Callable[[int, int, int, int], float],
              shapes: Sequence[Tuple[int, int]], largest_cluster: int,
              start: Tuple[int, int] = START) -> Tuple[Tuple[int, int], List[dict]]:
    """``timer(n, g, cluster, max_ranges)`` -> median ms.  Returns the
    best (cluster, max_ranges) and every trial, the start's first."""
    best = start
    best_ms = [timer(n, g, *best) for n, g in shapes]
    trials = [{"cluster": best[0], "max_ranges": best[1], "ms": best_ms}]
    seen = {best}
    improved = True
    while improved:
        improved = False
        for cand in neighbours(*best, largest_cluster):
            if cand in seen:
                continue
            seen.add(cand)
            ms = [timer(n, g, *cand) for n, g in shapes]
            trials.append({"cluster": cand[0], "max_ranges": cand[1], "ms": ms})
            if better(ms, best_ms):
                best, best_ms, improved = cand, ms, True
                break
    return best, trials


def median_ms(fn: Callable[[], torch.Tensor], reps: int,
              host_ahead: bool = False) -> Tuple[float, torch.Tensor]:
    """Median ms of ``fn()`` over ``reps`` launches, each between two CUDA
    events, after ``WARMUP`` calls; and the last call's result.
    ``host_ahead``: the launches queue behind a sleep on the card, so the
    events time the card alone."""
    for _ in range(WARMUP):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    if host_ahead:
        torch.cuda.synchronize()
        torch.cuda._sleep(AHEAD_CYCLES * reps)
    for start, end in events:
        start.record()
        out = fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events), out


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segagg", action="store_true",
                    help="tune the segagg dispatch and write tuned_blocks.json")
    ap.add_argument("--reps", type=int, default=25, help="launches a median")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.segagg:
        ap.error("nothing to tune: pass --segagg")
    if not torch.cuda.is_available():
        print("torch_hillclimb: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.segagg import ops
    from repro_torch.kernels.segagg.ref import segagg_ref
    from repro_torch.kernels.segagg.segagg import (
        scatter_caps, scatter_plan_for, segagg_narrow_cuda, segagg_scatter_cuda)

    line = smi()
    print(line, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    inputs: Dict[Tuple[int, int], tuple] = {}

    def shape(n: int, g: int) -> tuple:
        """Uniform keys, ones and their counts (the plain version's, in
        float64)."""
        if (n, g) not in inputs:
            keys = torch.randint(0, g, (n,), device=device, generator=gen,
                                 dtype=torch.int32)
            ones = torch.ones((n, 1), device=device)
            inputs[(n, g)] = keys, ones, segagg_ref(keys, ones.double(), g)
        return inputs[(n, g)]

    def check_counts(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        if not counts_match(got, want):
            raise AssertionError(f"torch_hillclimb: {what}: counts differ from segagg_ref")

    plan_ms: Dict[tuple, float] = {}   # (n, g, plan) -> median ms

    def time_plan(n: int, g: int, cluster: int, max_ranges: int) -> float:
        sizes = (cluster,) + tuple(c for c in tuning.SCATTER_CLUSTER_SIZES if c != cluster)
        plan = scatter_plan_for(g, 1, device, n=n, max_ranges=max_ranges, sizes=sizes)
        if (n, g, plan) not in plan_ms:  # a move that keeps the plan keeps its time
            keys, ones, want = shape(n, g)
            ms, out = median_ms(lambda: segagg_scatter_cuda(keys, ones, g, plan=plan),
                                args.reps, host_ahead=True)
            check_counts(out, want, f"scatter N={n} G={g} plan {plan.route} {plan.cluster} "
                             f"x {len(plan.ranges)}")
            plan_ms[(n, g, plan)] = ms
        return plan_ms[(n, g, plan)]

    wrong: List[dict] = []   # formulations past 2^24 a group whose counts missed

    def time_form(n: int, g: int, form: str) -> Optional[float]:
        keys, ones, want = shape(n, g)
        before = segagg_narrow_cuda.launches
        ms, out = median_ms(lambda: ops.segagg(keys, ones, g, formulation=form), args.reps)
        launched = segagg_narrow_cuda.launches - before
        if launched != (WARMUP + args.reps if form == "matmul" else 0):
            raise AssertionError(f"torch_hillclimb: formulation={form} N={n} G={g}: "
                                 f"{launched} narrow launches")
        if want.max().item() <= EXACT_COUNT or counts_match(out, want):
            check_counts(out, want, f"formulation={form} N={n} G={g}")
            return ms
        wrong.append({"n": n, "g": g, "formulation": form, "ms": ms,
                      "max_rel_err": counts_error(out, want)})
        print(f"formulation={form} N={n} G={g}: counts past 2^24 off by "
              f"{wrong[-1]['max_rel_err']:.4g}", flush=True)
        return None

    def time_library(n: int, g: int, host_ahead: bool) -> Optional[float]:
        keys, ones, want = shape(n, g)
        ms, out = median_ms(lambda: torch.zeros((g, 1), device=device).index_add_(0, keys, ones),
                            args.reps, host_ahead=host_ahead)
        if want.max().item() <= EXACT_COUNT or counts_match(out, want):
            check_counts(out, want, f"index_add_ N={n} G={g}")
            return ms
        wrong.append({"n": n, "g": g, "formulation": "index_add_", "ms": ms,
                      "max_rel_err": counts_error(out, want)})
        return None

    _, largest_cluster = scatter_caps(device)
    table = {"version": 1, "blocks": {}, "crossover": {}}
    report = {"device": torch.cuda.get_device_name(0), "smi": line, "reps": args.reps,
              "margin": MARGIN, "blocks": {}, "crossover": {}}
    for cls, shapes in REPRESENTATIVES.items():
        (cluster, max_ranges), trials = hillclimb(time_plan, shapes, largest_cluster)
        table["blocks"][f"cuda:{cls}"] = {"cluster": cluster, "max_ranges": max_ranges}
        report["blocks"][f"cuda:{cls}"] = {
            "shapes": [list(s) for s in shapes], "best": [cluster, max_ranges],
            "trials": trials,
            "index_add_ms": [time_library(n, g, host_ahead=True) for n, g in shapes]}
        print(f"{cls}: (cluster, max_ranges) = ({cluster}, {max_ranges}) after "
              f"{len(trials)} trials", flush=True)
    tuning.save(table)  # the sweep's scatter takes the tuned plan
    inputs.clear()

    max_g, per_rows, medians = crossover_sweep(time_form)
    library = {n: [{"g": g, "ms": time_library(n, g, host_ahead=False)} for g in GROUPS]
               for n in ROWS}
    table["crossover"]["cuda"] = {"matmul_max_g": max_g}
    report["crossover"] = {"matmul_max_g": max_g, "per_rows": per_rows,
                           "medians": medians, "index_add_ms": library, "wrong": wrong}
    print(f"narrow wins up to G={max_g} (per row count: {per_rows})", flush=True)
    report["path"] = str(tuning.save(table))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
