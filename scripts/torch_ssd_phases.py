#!/usr/bin/env python3
"""Where the bf16 SSD kernel's time goes, on one CUDA card.

    python3 scripts/torch_ssd_phases.py

Builds variants of ``src/repro_torch/csrc/ssd.cu`` into
``build/repro_torch/phases/``, each with one phase of ``ssd_mma_kernel``
switched off and the P-tile forced (or left to the launcher's rule), and
times each (CUDA events, mean of 3 after a warm-up) at mamba2-370m's prefill
shape (S 32,768, H 32, P 64, N 128, bf16, B and C head-shared) for B = 8 and
B = 1.  A variant computes wrong values; only its time is read.  The time a
phase saves when it is off is what it costs, as long as the phases do not
overlap.  Phases: 1 the loads of C, B and x rows, 2 the state update, 4
exp(cum) (C h), 8 the triangle (S, G and G x), 16 the next chunk's dt and
cumsum.

Exits non-zero if there is no card or a variant does not build.
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

PHASES = {1: "loads", 2: "state update", 4: "C h", 8: "triangle", 16: "dt and cumsum"}
# (source text, the same with phase ``bit`` guarded); the script stops if the
# kernel's source no longer holds a text.
GUARDS = [
    (1, "    if (c + 1 < nchunks) load_chunk(c + 1);",
     "    if (!(SKIP & 1) && c + 1 < nchunks) load_chunk(c + 1);"),
    (2, "    if (owns_state) {\n      const float decay",
     "    if (!(SKIP & 2) && owns_state) {\n      const float decay"),
    (4, "      const bf16* cw = cs + (r0 + ra) * ldn + ca;\n      for (",
     "      const bf16* cw = cs + (r0 + ra) * ldn + ca;\n      if (!(SKIP & 4)) for ("),
    (8, "      for (int j = jlo; j <= jhi; j += 2) {",
     "      if (!(SKIP & 8)) for (int j = jlo; j <= jhi; j += 2) {"),
    (16, "    if (warp == kWarps - 1 && c + 1 < nchunks) scan_chunk(c + 1);",
     "    if (!(SKIP & 16) && warp == kWarps - 1 && c + 1 < nchunks) scan_chunk(c + 1);"),
    (0, "    const int pt = pick_pt(bh, P, sms, [&](int cand) {\n      const int tiles",
     "    const int pt = FORCE_PT ? FORCE_PT : pick_pt(bh, P, sms, [&](int cand) {\n"
     "      const int tiles"),
]
# (forced P-tile or 0 for the rule, phases off)
VARIANTS = ([(0, 0)] + [(pt, 0) for pt in (16, 32, 64)]
            + [(64, bit) for bit in PHASES] + [(64, sum(PHASES))])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ssd_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ssd as ssd_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    src = (_build.CSRC / "ssd.cu").read_text()
    for _, text, guarded in GUARDS:
        if text not in src:
            print(f"torch_ssd_phases: ssd.cu no longer holds {text!r}", file=sys.stderr)
            return 1
        src = src.replace(text, guarded)
    out = _build.build_dir() / "phases"
    out.mkdir(parents=True, exist_ok=True)
    source = out / "ssd_phases.cu"
    source.write_text("#ifndef SKIP\n#define SKIP 0\n#endif\n#ifndef FORCE_PT\n"
                      "#define FORCE_PT 0\n#endif\n" + src)

    def build(variant):
        pt, skip = variant
        lib = out / f"libssd_pt{pt}_skip{skip}_{os.getpid()}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DSKIP={skip}", f"-DFORCE_PT={pt}",
               "-o", str(lib), str(source)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed for {variant}:\n{done.stdout}{done.stderr}")
        return variant, lib

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        built = list(pool.map(build, VARIANTS))

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S=32768, H=32, P=64, N=128):
        r = lambda *s: torch.randn(s, device="cuda", generator=gen)  # noqa: E731
        Bm = (0.3 * r(B, S, N)).bfloat16()[:, :, None].expand(B, S, H, N)
        Cm = (0.3 * r(B, S, N)).bfloat16()[:, :, None].expand(B, S, H, N)
        return ((0.5 * r(B, S, H, P)).bfloat16(),
                torch.nn.functional.softplus(r(B, S, H)).bfloat16(), -r(H).abs() - 0.1,
                Bm, Cm, r(H), torch.zeros(B, H, N, P, device="cuda"))

    args = {B: inputs(B) for B in (8, 1)}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    print("P-tile  phases off            B=8 ms     B=1 ms", flush=True)
    try:
        for (pt, skip), lib_path in built:
            lib = ctypes.CDLL(str(lib_path))
            for fn, argtypes in _build.LIBRARIES["ssd"][1].items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = list(argtypes), ctypes.c_int
            lib.ssd_error_string.argtypes = [ctypes.c_int]
            lib.ssd_error_string.restype = ctypes.c_char_p
            _build._loaded["ssd"] = lib
            times = []
            for B in (8, 1):
                ssd_mod.ssd_cuda(*args[B])
                start.record()
                for _ in range(3):
                    ssd_mod.ssd_cuda(*args[B])
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 3)
            off = ", ".join(n for bit, n in PHASES.items() if skip & bit) or "none"
            print(f"{pt or 'rule':>6}  {off:22s} {times[0]:9.4f}  {times[1]:9.4f}", flush=True)
    finally:
        _build._loaded.pop("ssd", None)
        for _, lib_path in built:
            lib_path.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
