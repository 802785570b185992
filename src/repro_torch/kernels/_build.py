"""Build and load the port's CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes``.  Builds happen at first use, never at import, into
``build/repro_torch/`` at the root of the checkout, cached under a hash of
the source and the flags.  All
sources are compiled together, one ``nvcc`` each, started at once.  A failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_I32, _I64, _PTR = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
_F32, _I64P = ctypes.c_float, ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)

# Library name -> (source file, {C function: argtypes}).  Every launcher
# returns cudaGetLastError() as an int, and each library exports
# ``<name>_error_string(int)`` to name the error.
LIBRARIES: Dict[str, tuple] = {
    "segagg": ("segagg.cu", {
        # keys, values, out, n, v, g, cluster, clusters, range_len,
        # slice_chunks, capacity, stream
        "segagg_scatter": (_PTR, _PTR, _PTR, _I64, _I32, _I64, _I32, _I32, _I64,
                           _I32, _I32, _PTR),
        "segagg_scatter_atomic": (_PTR, _PTR, _PTR, _I64, _I32, _I64, _PTR),
        # cluster, smem_bytes, &max_clusters
        "segagg_scatter_clusters": (_I32, _I32, _I32P),
        # &smem_bytes
        "segagg_scatter_smem_optin": (_I32P,),
        # keys, values, out, n, v, g, work, stream
        "segagg_narrow": (_PTR, _PTR, _PTR, _I64, _I32, _I32, _PTR, _PTR),
    }),
    "flash_attention": ("flash_attention.cu", {
        # q, k, v, o, strides[12], batch, sq, sk, heads, kv_heads, d, scale,
        # causal, window, cap, q_offset, kv_len (or null), lse (or null), stream
        "flash_attention_fwd": (_PTR, _PTR, _PTR, _PTR, _I64P, _I32, _I32, _I32,
                                _I32, _I32, _I32, _F32, _I32, _I32, _F32, _I32, _PTR,
                                _PTR, _PTR),
    }),
    "rglru": ("rglru.cu", {
        # x, r, i, a_param, h0, y, h_last, carries (or null), batch, seq,
        # width, is_bf16, stream
        "rglru_scan": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
                       _I32, _I32, _PTR),
        # x, r, i, a_param, carries, dy, dh_last (or null), dx, dr, di, dh0,
        # da_part, batch, seq, width, is_bf16, stream
        "rglru_scan_bwd": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                           _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR),
        # is_bf16, &registers, &blocks_per_sm
        "rglru_bwd_resources": (_I32, _I32P, _I32P),
    }),
    # The earlier designs of the two kernels above (the flash one without
    # q_offset and kv_len): the yardsticks that chip_smoke.py times the
    # kernels against.
    "flash_attention_sync": ("flash_attention_sync.cu", {
        "flash_attention_sync_fwd": (_PTR, _PTR, _PTR, _PTR, _I64P, _I32, _I32, _I32,
                                     _I32, _I32, _I32, _F32, _I32, _I32, _F32, _PTR),
    }),
    "rglru_serial": ("rglru_serial.cu", {
        "rglru_serial_scan": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
                              _I32, _I32, _PTR),
    }),
    "ssd": ("ssd.cu", {
        # x, dt, A, Bm, Cm, D, h0, y, h_last, states (or null), strides[6],
        # batch, seq, heads, head_dim, state, is_bf16, stream
        "ssd_fwd": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64P,
                    _I32, _I32, _I32, _I32, _I32, _I32, _PTR),
    }),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: Dict[str, str] = {}  # library -> nvcc's output (-Xptxas -v)


def build_dir() -> pathlib.Path:
    """``build/repro_torch`` at the root of the checkout (beside ``src/``),
    else inside the installed package."""
    src = _PKG.parent
    root = src.parent if src.name == "src" else _PKG
    return root / "build" / "repro_torch"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME)")


def _target(name: str) -> pathlib.Path:
    source = CSRC / LIBRARIES[name][0]
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def _start(name: str) -> Optional[tuple]:
    """Start nvcc for ``name`` unless its library is cached; returns the
    process with its temporary and final paths."""
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started: tuple) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {LIBRARIES[name][0]} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def _open(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every library; returns them by name."""
    with _lock:
        pending = [n for n in LIBRARIES if n not in _loaded]
        started = {n: _start(n) for n in pending}
        try:
            for n, s in started.items():
                if s is not None:
                    _finish(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
        for n in pending:
            _loaded[n] = _open(n)
        return dict(_loaded)


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building every library on first use."""
    lib = _loaded.get(name)
    return lib if lib is not None else build_all()[name]


def check(name: str, code: int, what: str) -> None:
    """Raise if a launcher of library ``name`` returned a CUDA error."""
    if code != 0:
        msg = getattr(_loaded[name], f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
