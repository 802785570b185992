#!/usr/bin/env python3
"""Where the flash-attention and RG-LRU kernels' time goes, on one CUDA card.

    python3 scripts/torch_lm_phases.py

Builds variants of ``src/repro_torch/csrc/flash_attention.cu`` and
``rglru.cu`` into ``build/repro_torch/lm_phases/``, each with parts of the
kernel switched off, and times each (CUDA events, mean of 20 after two
warm-ups, two rounds) at recurrentgemma-9b's prefill shapes for B = 1 and
B = 8: flash S 4,096, H 16, Hkv 1, D 256, causal, window 2,048; RG-LRU S
4,096, N 4,096; bf16.  A variant computes wrong values; only its time is
read.  The time a part saves when it is off is what it costs, as long as
the parts do not overlap.

Flash parts: 1 the K/V loads after the first tile, 2 the S = Q K^T product,
4 the P V product, 8 the online softmax (replaced by exp(s - 4), no
mask, maximum or rescale).  RG-LRU parts: 1 the gate math (two expf and a
sqrtf an element, replaced by two multiply-adds), 2 the next chunks' loads.

Exits non-zero if there is no card, a kernel's source no longer holds a text
the script replaces, or a variant does not build.
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

# (bit, source text, the same with the part guarded by SKIP)
FLASH_GUARDS = [
    (1, "    load_kv(it + kStages - 1);\n    mbar_wait(full + 8 * st, (it / kStages) & 1);",
     "    if (!(SKIP & 1)) load_kv(it + kStages - 1);\n"
     "    if (!(SKIP & 1) || it < kStages - 1) mbar_wait(full + 8 * st, (it / kStages) & 1);"),
    (2, "    float s[kNt][4];\n",
     "#if SKIP & 2\n    float s[kNt][4] = {};\n#else\n    float s[kNt][4];\n#endif\n"),
    (2, "      wgmma_ss_n64(&s[0][0],", "      if (!(SKIP & 2)) wgmma_ss_n64(&s[0][0],"),
    (4, "wgmma_rs<kD>(&acc", "if (!(SKIP & 4)) wgmma_rs<kD>(&acc"),
]
FLASH_SOFTMAX = ("    // Soft-cap, mask; online softmax per row (Q came scaled).\n",
                 "#pragma unroll\n    for (int kk = 0; kk < kBlockK / 16; ++kk) {\n"
                 "      p[kk][0] = pack_bf16(")
FLASH_STAND_IN = ("    uint32_t p[kBlockK / 16][4];\n#pragma unroll\n"
                  "    for (int n = 0; n < kNt; ++n)\n#pragma unroll\n"
                  "      for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - 4.f);\n")
RGLRU_GUARDS = [
    (1, "      const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));\n"
        "      ps[j] = expf(log_a);\n",
     "#if SKIP & 1\n      const float beta = 1.f + log_a;\n      ps[j] = 0.5f * log_a + 1.f;\n"
     "#else\n      const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));\n"
     "      ps[j] = expf(log_a);\n#endif\n"),
    (2, "    if (ch + R::kStages - 1 < chunks) issue(ch + R::kStages - 1);",
     "    if (!(SKIP & 2) && ch + R::kStages - 1 < chunks) issue(ch + R::kStages - 1);"),
]
PARTS = {"flash_attention": {1: "K/V loads", 2: "S product", 4: "P V product", 8: "softmax"},
         "rglru": {1: "gate math", 2: "next loads"}}
VARIANTS = {"flash_attention": (0, 1, 2, 4, 6, 8), "rglru": (0, 1, 2, 3)}
BATCHES = (1, 8)
REPS = 20


def guarded_source(name: str, src: str) -> str:
    guards = FLASH_GUARDS if name == "flash_attention" else RGLRU_GUARDS
    for _, text, guarded in guards:
        if text not in src:
            raise SystemExit(f"torch_lm_phases: {name}.cu no longer holds {text!r}")
        src = src.replace(text, guarded)
    if name == "flash_attention":
        start, end = FLASH_SOFTMAX
        if start not in src or end not in src:
            raise SystemExit("torch_lm_phases: flash_attention.cu's softmax moved")
        a, b = src.index(start), src.index(end)
        src = (src[:a] + "#if SKIP & 8\n" + FLASH_STAND_IN + "#else\n" + src[a:b]
               + "#endif\n" + src[b:])
    return "#ifndef SKIP\n#define SKIP 0\n#endif\n" + src


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lm_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru.rglru import rglru_cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    out = _build.build_dir() / "lm_phases"
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name in VARIANTS:
        sources[name] = out / f"{name}_phases.cu"
        sources[name].write_text(guarded_source(name, (_build.CSRC / f"{name}.cu").read_text()))

    def build(job):
        name, skip = job
        lib = out / f"lib{name}_skip{skip}_{os.getpid()}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DSKIP={skip}", "-o", str(lib),
               str(sources[name])]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed for {job}:\n{done.stdout}{done.stderr}")
        regs = [line.split("Used ")[1].split(" registers")[0]
                for line in (done.stdout + done.stderr).splitlines() if "registers" in line]
        return job, lib, regs

    jobs = [(name, skip) for name, skips in VARIANTS.items() for skip in skips]
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        built = list(pool.map(build, jobs))

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, D, W, N = max(BATCHES), 4096, 16, 256, 2048, 4096
    r = lambda *s: torch.randn(s, device="cuda", generator=gen)  # noqa: E731
    q, k, v = r(B, S, H, D).bfloat16(), r(B, S, 1, D).bfloat16(), r(B, S, 1, D).bfloat16()
    x = r(B, S, N).bfloat16()
    rg, ig = torch.sigmoid(r(B, S, N)).bfloat16(), torch.sigmoid(r(B, S, N)).bfloat16()
    a_param, h0 = r(N), torch.zeros(B, N, device="cuda")
    calls = {"flash_attention": lambda b: flash_attention_cuda(q[:b], k[:b], v[:b], True, W),
             "rglru": lambda b: rglru_cuda(x[:b], rg[:b], ig[:b], a_param, h0[:b])}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn) -> float:
        fn()
        fn()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    rows = {job: [] for job, _, _ in built}
    try:
        for _ in range(2):
            for (name, skip), lib_path, _ in built:
                lib = ctypes.CDLL(str(lib_path))
                for fn, argtypes in _build.LIBRARIES[name][1].items():
                    f = getattr(lib, fn)
                    f.argtypes, f.restype = list(argtypes), ctypes.c_int
                err = getattr(lib, f"{name}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                _build._loaded[name] = lib
                rows[(name, skip)].append([timed(lambda: calls[name](b)) for b in BATCHES])
    finally:
        for name in VARIANTS:
            _build._loaded.pop(name, None)
        for _, lib_path, _ in built:
            lib_path.unlink(missing_ok=True)
    print("kernel           parts off                      registers       "
          + "   ".join(f"B={b} ms (two rounds)" for b in BATCHES), flush=True)
    for (name, skip), _, regs in built:
        off = ", ".join(n for bit, n in PARTS[name].items() if skip & bit) or "none"
        times = "   ".join(" / ".join(f"{t[i]:.4f}" for t in rows[(name, skip)])
                           for i in range(len(BATCHES)))
        print(f"{name:16s} {off:30s} {','.join(regs):15s} {times}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
