"""Roofline accounting + HLO collective parsing (repro.launch.dryrun).

``parse_collectives`` scans compiled HLO text for communication ops
(all-reduce / all-gather / reduce-scatter / all-to-all / collective-permute,
including their async ``-start`` forms) and sums their output bytes —
the numerator of the ICI term of the roofline.

``Roofline`` records the three per-step time bounds (compute vs HBM vs
interconnect) under the usual overlap assumption: step time ~= the max of
the three ("whichever roof you hit").

``KernelRooflineManager`` applies the same model to single-kernel
micro-benchmarks (the RooflineManager pattern: a machine spec + per-op
analytic FLOPs/bytes -> the bound and the achieved fraction): used by
``benchmarks.bench_roofline`` to report how close the dispatched segagg
backends run to the measured machine roofs.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1,
    "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# `%name = <shape-or-tuple> <op>(` — shapes look like `bf16[2,16,128]{2,1,0}`.
_ARRAY_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_LINE_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+(" + "|".join(_COLLECTIVE_OPS) + r")(-start|-done)?\("
)


def _shape_bytes(shape_text: str) -> float:
    total = 0.0
    for dtype, dims in _ARRAY_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass(frozen=True)
class CollectiveStats:
    """Per-program communication summary: output bytes + op counts."""

    total_bytes: float
    counts: Dict[str, int]


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum collective output bytes / count collective ops in HLO text.

    Async pairs are counted once (the ``-done`` halves are skipped; their
    bytes are already attributed to the ``-start``)."""
    total = 0.0
    counts: Dict[str, int] = {}
    for m in _LINE_RE.finditer(hlo_text):
        shape_text, op, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":
            continue
        total += _shape_bytes(shape_text)
        counts[op] = counts.get(op, 0) + 1
    return CollectiveStats(total_bytes=total, counts=counts)


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Per-chip roofline for one compiled step program."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def step_seconds(self) -> float:
        """Overlap model: the binding roof decides the step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        bounds = (
            ("compute", self.compute_s),
            ("memory", self.memory_s),
            ("collective", self.collective_s),
        )
        return max(bounds, key=lambda kv: kv[1])[0]

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "step_seconds": self.step_seconds,
            "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_counts": dict(self.collective_counts),
        }


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Peak rates of the machine a kernel micro-bench ran on.  For TPU these
    are datasheet numbers; for the CPU container they are MEASURED
    achievable rates (a copy-bandwidth probe and a big-matmul FLOPs probe),
    so "achieved fraction" compares against what the host demonstrably
    sustains, not a marketing peak.

    ``peak_flops``/``peak_bw`` are PER-DEVICE rates; ``devices`` records how
    many devices the spec aggregates over (1 = a single device, the
    pre-mesh convention).  ``scaled(n)`` builds the MESH roof — aggregate
    FLOPs/bandwidth across ``n`` devices — so ``bench_roofline`` can report
    achieved fraction of the whole mesh instead of one device's roof.  A
    forced-host CPU mesh shares one socket, so its honest mesh roof is the
    single measured host rate — pass ``n=1`` worth of scaling there (the
    bench decides from the platform)."""

    peak_flops: float    # FLOP/s (per device)
    peak_bw: float       # bytes/s (per device)
    source: str = "measured"
    devices: int = 1

    def scaled(self, num_devices: int) -> "MachineSpec":
        """Aggregate roof over ``num_devices`` devices: peaks multiplied,
        provenance recorded in ``source``."""
        if num_devices < 1:
            raise ValueError(f"need at least one device, got {num_devices}")
        if num_devices == 1:
            return self
        return dataclasses.replace(
            self,
            peak_flops=self.peak_flops * num_devices,
            peak_bw=self.peak_bw * num_devices,
            source=f"{self.source} x{num_devices} devices",
            devices=self.devices * num_devices,
        )


class KernelRooflineManager:
    """Achieved-vs-roofline accounting for single-kernel timings.

    ``info`` rows carry analytic ``flops``/``bytes`` for one call (e.g.
    ``repro.kernels.segagg.ops.flops_bytes``) plus the measured seconds;
    ``get_roofline`` returns the two time bounds, the binding roof, and the
    achieved fraction (bound / measured — 1.0 means running AT the roof).
    """

    def __init__(self, spec: MachineSpec):
        self.spec = spec

    def bound_seconds(self, flops: float, bytes_: float) -> float:
        return max(flops / self.spec.peak_flops, bytes_ / self.spec.peak_bw)

    def get_roofline(self, info: Dict) -> Dict:
        flops, bytes_ = float(info["flops"]), float(info["bytes"])
        measured = float(info["seconds"])
        compute_s = flops / self.spec.peak_flops
        memory_s = bytes_ / self.spec.peak_bw
        bound = max(compute_s, memory_s)
        return {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "bound_s": bound,
            "dominant": "compute" if compute_s >= memory_s else "memory",
            "measured_s": measured,
            "achieved_frac": bound / measured if measured > 0 else 0.0,
            "achieved_gbytes_s": bytes_ / measured / 1e9 if measured > 0 else 0.0,
            "achieved_gflops_s": flops / measured / 1e9 if measured > 0 else 0.0,
        }
