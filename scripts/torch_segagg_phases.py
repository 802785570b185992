#!/usr/bin/env python3
"""Where the wide-G segagg kernels' time goes, on one CUDA card.

    python3 scripts/torch_segagg_phases.py

Builds variants of ``src/repro_torch/csrc/segagg.cu`` into
``build/repro_torch/segagg_phases/``, each with parts of the two scatter
kernels switched off or replaced, and times each (CUDA events, mean of 20
launches after two warm-ups, two rounds; 5 launches under Zipf keys) at the
analytics path's wide-G shapes, CQ3 (N 34,294,000, G 360,000) and CQ4 (N
30,719,000, G 1,500,000), V = 1, under uniform keys and under a finite Zipf
law (``ref.zipf_keys``: rank r has weight 1/r, 7.5% of CQ3's rows in one
group).  Beside them it times ``index_add_``.  A variant that switches a
part off computes wrong values; only its time is read.  The time a part
saves when it is off is what it costs, as long as the parts do not overlap.

Parts of the global-atomic kernel (``segagg_scatter_atomic``, the first
design), ``SKIP`` bits: 1 the global atomic (replaced by a register sum
written once a thread), 2 the value load (replaced by 1.0), 4 the key-range
check.  Parts of the cluster-table kernel (``segagg_scatter``), run with
the plan ``tuning.scatter_plan`` takes (at CQ4, where that is the
global-atomic kernel, forced to two key ranges): 8 the owners' adds of their
mail into their tables, 16 the mail itself (a round's mailed elements are
dropped; the others still go to L2).

Designs of the cluster-table kernel, each right (its counts are checked):
``MAIL`` = 1 or 4 of a thread's four elements a round mailed (the kernel
mails 2); ``DESIGN`` = 1, every element added straight into its owner's
table by a remote shared-memory f32 atomic (the first cluster design, with
no mail); ``COMB`` bits, a warp pre-combine of equal keys (``match.any``)
before 1 the global atomics of the unmailed half, 2 the mail.  And plans:
CQ3 in clusters of 16, CQ4 in 4 key ranges of 8 blocks.

Exits non-zero if there is no card, the kernel's source no longer holds a
text the script replaces, a variant does not build, or a design's counts
differ from the plain version's.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ATOMIC_BODY = """    const int32_t k = __ldg(keys + row);
    if (k >= 0 && (int64_t)k < g) {
      atomicAdd(out + (int64_t)k * v + col, __ldg(values + e));
    }
  }
}
"""
GUARDED_BODY = """    const int32_t k = __ldg(keys + row);
    if ((SKIP & 4) || (k >= 0 && (int64_t)k < g)) {
#if SKIP & 2
      const float x = 1.f;
#else
      const float x = __ldg(values + e);
#endif
#if SKIP & 1
      acc += x + (float)k;
#else
      atomicAdd(out + (int64_t)k * v + col, x);
#endif
    }
  }
  if (SKIP & 1) out[((int64_t)blockIdx.x * blockDim.x + threadIdx.x) % (g * v)] = acc;
}
"""
ATOMIC_HEAD = "segagg_scatter_atomic_kernel("
LOOP = "  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;"
HEADER = """#ifndef SKIP
#define SKIP 0
#endif
#ifndef MAIL
#define MAIL 2
#endif
#ifndef DESIGN
#define DESIGN 0
#endif
#ifndef COMB
#define COMB 0
#endif
"""
COMBINE = """// Sums x over the lanes with the same key (all 32 lanes call it); the lowest
// of them gets the sum and *lead = true.
__device__ __forceinline__ float warp_combine(long long key, float x, bool* lead) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  unsigned above = peers & ~((2u << lane) - 1u);
  float total = x;
  while (__any_sync(0xffffffffu, above)) {
    const float y = __shfl_sync(0xffffffffu, x, above ? __ffs(above) - 1 : lane);
    if (above) {
      total += y;
      above &= above - 1u;
    }
  }
  *lead = lane == __ffs(peers) - 1;
  return total;
}

"""
REMOTE_ADD = """  // The first cluster design: a remote shared-memory f32 atomic.
  __device__ __forceinline__ void remote_add(int64_t i, float v) const {
    if (i < lo || i >= hi) return;
    const uint32_t off = (uint32_t)(i - lo), chunk = off / kChunk;
    atomicAdd(cg::this_cluster().map_shared_rank(table, (int)(chunk & (blocks - 1))) +
                  (((chunk >> log2_blocks) * kChunk) | (off % kChunk)), v);
  }

"""
# (text in segagg.cu, its replacement) for the cluster kernel's variants
CLUSTER_GUARDS = [
    ("    if (r > 0) cb.consume((int)((r - 1) % kBuffers));\n",
     "    if (!(SKIP & 8) && r > 0) cb.consume((int)((r - 1) % kBuffers));\n"),
    ("  if (rounds > 0) cb.consume((int)((rounds - 1) % kBuffers));\n",
     "  if (!(SKIP & 8) && rounds > 0) cb.consume((int)((rounds - 1) % kBuffers));\n"),
    ("constexpr int kMail = 2;", "constexpr int kMail = MAIL;"),
    ("__device__ __forceinline__ void cluster_arrive() {",
     COMBINE + "__device__ __forceinline__ void cluster_arrive() {"),
    ("  // Mails the round's K elements", REMOTE_ADD + "  // Mails the round's K elements"),
    ("    int leader[K];\n    const int lane = threadIdx.x & 31;\n",
     "    int leader[K];\n    float xs[K];\n    const int lane = threadIdx.x & 31;\n"
     "    if (SKIP & 16) return;\n"
     "#if DESIGN == 1\n    for (int k = 0; k < K; ++k) remote_add(idx[k], x[k]);\n"
     "    return;\n#endif\n"),
    ("      ok[k] = idx[k] >= lo && idx[k] < hi;\n",
     "      ok[k] = idx[k] >= lo && idx[k] < hi;\n#if COMB & 2\n      {\n"
     "        bool lead;\n"
     "        xs[k] = warp_combine(ok[k] ? idx[k] : -1 - (long long)lane, x[k], &lead);\n"
     "        ok[k] = ok[k] && lead;\n      }\n#else\n      xs[k] = x[k];\n#endif\n"),
    ("            make_uint2(pos[k], __float_as_uint(x[k]));\n      } else {\n"
     "        atomicAdd(out + idx[k], x[k]);",
     "            make_uint2(pos[k], __float_as_uint(xs[k]));\n      } else {\n"
     "        atomicAdd(out + idx[k], xs[k]);"),
    ("      if (idx[k] >= cb.lo && idx[k] < cb.hi) atomicAdd(out + idx[k], x[k]);\n",
     "#if COMB & 1\n      const bool in = idx[k] >= cb.lo && idx[k] < cb.hi;\n"
     "      bool lead;\n      const float t = warp_combine(\n"
     "          in ? idx[k] : -1 - (long long)(threadIdx.x & 31), x[k], &lead);\n"
     "      if (in && lead) atomicAdd(out + idx[k], t);\n#else\n"
     "      if (idx[k] >= cb.lo && idx[k] < cb.hi) atomicAdd(out + idx[k], x[k]);\n#endif\n"),
]
ATOMIC_PARTS = {1: "global atomic", 2: "value load", 4: "key-range check"}
ATOMIC_VARIANTS = (0, 1, 2, 4, 3)
# name -> -D flags of the cluster kernel's variants
CLUSTER_PARTS = {"cluster, off: none": (), "cluster, off: owners' adds": ("SKIP=8",),
                 "cluster, off: mail": ("SKIP=16",)}
CLUSTER_DESIGNS = {
    "cluster, 1 of 4 mailed": ("MAIL=1",),
    "cluster, 4 of 4 mailed": ("MAIL=4",),
    "cluster, remote f32 atomics, no mail": ("DESIGN=1", "MAIL=4"),
    "cluster, combine unmailed half": ("COMB=1",),
    "cluster, combine mail": ("COMB=2",),
    "cluster, combine both": ("COMB=3",),
}
# (query, rows, groups): the largest main-path batches of the wide-G queries
SHAPES = (("CQ3", 34_294_000, 360_000), ("CQ4", 30_719_000, 1_500_000))
MIXES = ("uniform", "zipf")
REPS = {"uniform": 20, "zipf": 5}
HBM_BYTES_PER_S = 3.35e12


def guarded_source(src: str) -> str:
    if ATOMIC_HEAD not in src:
        raise SystemExit("torch_segagg_phases: segagg.cu has no segagg_scatter_atomic_kernel")
    head = src.index(ATOMIC_HEAD)
    body, loop = src.index(ATOMIC_BODY, head), src.index(LOOP, head)
    if not head < loop < body:
        raise SystemExit("torch_segagg_phases: segagg_scatter_atomic_kernel's body moved")
    src = src[:body] + GUARDED_BODY + src[body + len(ATOMIC_BODY):]
    src = src[:loop] + "  float acc = 0.f;\n" + src[loop:]
    for text, guarded in CLUSTER_GUARDS:
        if src.count(text) != 1:
            raise SystemExit(f"torch_segagg_phases: segagg.cu no longer holds {text!r} once")
        src = src.replace(text, guarded)
    return HEADER + src


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_segagg_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.segagg import tuning
    from repro_torch.kernels.segagg.ref import segagg_ref, zipf_keys
    from repro_torch.kernels.segagg.segagg import (
        active_clusters, scatter_caps, scatter_plan_for)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    out_dir = _build.build_dir() / "segagg_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = out_dir / "segagg_phases.cu"
    source.write_text(guarded_source((_build.CSRC / "segagg.cu").read_text()))

    flag_sets = sorted({(f"SKIP={s}",) if s else () for s in ATOMIC_VARIANTS}
                       | set(CLUSTER_PARTS.values()) | set(CLUSTER_DESIGNS.values()))

    def build(flags):
        lib = out_dir / f"libsegagg_{'_'.join(flags) or 'base'}_{os.getpid()}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{f}" for f in flags), "-o",
               str(lib), str(source)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed for {flags}:\n{done.stdout}{done.stderr}")
        return flags, lib

    with concurrent.futures.ThreadPoolExecutor(len(flag_sets)) as pool:
        built = dict(pool.map(build, flag_sets))
    _build.build_all()
    libs = {}
    for flags, lib_path in built.items():
        lib = ctypes.CDLL(str(lib_path))
        for name in ("segagg_scatter_atomic", "segagg_scatter"):
            f = getattr(lib, name)
            f.argtypes = list(_build.LIBRARIES["segagg"][1][name])
            f.restype = ctypes.c_int
        libs[flags] = lib

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    device = torch.device("cuda")
    smem, _ = scatter_caps(device)

    def timed(fn, reps) -> float:
        fn()
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def check(code: int, what: str) -> None:
        if code:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def atomic(flags, keys, vals, out):
        check(libs[flags].segagg_scatter_atomic(
            keys.data_ptr(), vals.data_ptr(), out.data_ptr(), keys.shape[0], vals.shape[1],
            out.shape[0], torch.cuda.current_stream().cuda_stream), f"atomic {flags}")

    def cluster(flags, plan, keys, vals, out):
        clusters = tuning.scatter_clusters(
            active_clusters(device, plan.cluster, plan.smem_bytes), len(plan.ranges))
        check(libs[flags].segagg_scatter(
            keys.data_ptr(), vals.data_ptr(), out.data_ptr(), keys.shape[0], vals.shape[1],
            out.shape[0], plan.cluster, clusters, plan.range_len, plan.slice_chunks,
            plan.capacity, torch.cuda.current_stream().cuda_stream), f"cluster {flags}")

    def shown(plan) -> str:
        return (f"{len(plan.ranges)} range(s) of {plan.cluster} blocks, "
                f"{active_clusters(device, plan.cluster, plan.smem_bytes)} clusters at "
                f"once, inbox capacity {plan.capacity}")

    try:
        print("kernel, parts off or design: ms in two rounds", flush=True)
        for qid, n, g in SHAPES:
            vals = torch.ones((n, 1), device="cuda")
            out = torch.zeros((g, 1), device="cuda")
            bound = 4.0 * (2 * n + g) / HBM_BYTES_PER_S * 1e3
            plan = scatter_plan_for(g, 1, device, n=n)
            plans = {}
            if plan.route == "atomic":
                plan = scatter_plan_for(g, 1, device, n=n, max_ranges=2)
                print(f"{qid} N={n} G={g} V=1, bound {bound:.4f} ms (bytes at 3.35 TB/s); "
                      f"plan: the global-atomic kernel; cluster kernel forced to "
                      f"{shown(plan)}", flush=True)
                forced = tuning.scatter_plan(g, 1, 8, smem, max_ranges=4, sizes=(8,))
                plans[f"cluster, forced to {shown(forced)}"] = forced
                designs = {}
            else:
                print(f"{qid} N={n} G={g} V=1, bound {bound:.4f} ms (bytes at 3.35 TB/s); "
                      f"plan: {shown(plan)}", flush=True)
                forced = tuning.scatter_plan(g, 1, 16, smem, sizes=(16,))
                plans[f"cluster, forced to {shown(forced)}"] = forced
                designs = CLUSTER_DESIGNS
            for mix in MIXES:
                keys = (torch.randint(0, g, (n,), device="cuda", dtype=torch.int32)
                        if mix == "uniform" else zipf_keys(n, g, seed=1, device="cuda"))
                top = torch.bincount(keys, minlength=g).max().item() / n
                want = segagg_ref(keys, vals, g)
                rows = {}
                for skip in ATOMIC_VARIANTS:
                    off = ", ".join(p for b, p in ATOMIC_PARTS.items() if skip & b) or "none"
                    flags = (f"SKIP={skip}",) if skip else ()
                    rows[f"atomic, off: {off}"] = (
                        lambda flags=flags: atomic(flags, keys, vals, out))
                for name, flags in {**CLUSTER_PARTS, **designs}.items():
                    rows[name] = lambda flags=flags: cluster(flags, plan, keys, vals, out)
                for name, forced in plans.items():
                    rows[name] = lambda forced=forced: cluster((), forced, keys, vals, out)
                rows["index_add_"] = lambda: torch.zeros((g, 1), device="cuda").index_add_(
                    0, keys, vals)
                for name, flags in designs.items():  # each design is right
                    got = torch.zeros((g, 1), device="cuda")
                    cluster(flags, plan, keys, vals, got)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{qid} {mix} {name}: counts differ")
                times = {name: [] for name in rows}
                for _ in range(2):
                    for name, fn in rows.items():
                        times[name].append(timed(fn, REPS[mix]))
                print(f"  {mix} keys (hottest group {top:.2%} of rows), {REPS[mix]} launches",
                      flush=True)
                for name, ts in times.items():
                    print(f"    {name:72s} {ts[0]:.4f} / {ts[1]:.4f}", flush=True)
                del keys, want
            del vals, out
            torch.cuda.empty_cache()
    finally:
        for lib_path in built.values():
            lib_path.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
