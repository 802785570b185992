"""The port's roofline module (``repro_torch.dist.roofline``, a copy of the
JAX package's) and the card's peaks (``repro_torch.dist.machine``), on the
CPU: the copy is byte-identical and gives equal results on equal inputs;
the published peaks are the H100 SXM data sheet's and bound a kernel's work
as the card check counts it; the probe runs at a small size on the host."""
import dataclasses
import math
import pathlib

import pytest
import torch

from repro.dist import roofline as RR
from repro_torch.dist import machine
from repro_torch.dist import roofline as TR

ROOT = pathlib.Path(__file__).resolve().parents[1]

HLO = """
  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %p0), replica_groups={}
  %ag = bf16[2,16,128]{2,1,0} all-gather(bf16[1,16,128]{2,1,0} %x), dimensions={0}
  %rs-start = (f32[64]{0}, f32[8]{0}) reduce-scatter-start(f32[64]{0} %y)
  %rs-done = f32[8]{0} reduce-scatter-done((f32[64]{0}, f32[8]{0}) %rs-start)
  %a2a = s8[4096]{0} all-to-all(s8[4096]{0} %z)
  %cp = pred[3,5]{1,0} collective-permute(pred[3,5]{1,0} %w), source_target_pairs={{0,1}}
  %add = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)
  %odd = u4[7]{0} all-reduce(u4[7]{0} %q)
  %weird = token[] all-gather(token[] %t)
"""


def test_copy_equals_the_reference_source():
    ref = (ROOT / "src" / "repro" / "dist" / "roofline.py").read_bytes()
    port = (ROOT / "src" / "repro_torch" / "dist" / "roofline.py").read_bytes()
    assert port == ref


@pytest.mark.parametrize("text", [HLO, "", "%x = f32[] add(f32[] %a)",
                                  HLO.replace("all-reduce(", "all-reduce-start(")])
def test_parse_collectives_matches_reference(text):
    got, want = TR.parse_collectives(text), RR.parse_collectives(text)
    assert (got.total_bytes, got.counts) == (want.total_bytes, want.counts)


def test_parse_collectives_counts_async_pairs_once():
    stats = TR.parse_collectives(HLO)
    assert stats.counts["reduce-scatter"] == 1
    assert stats.counts["all-reduce"] == 2


@pytest.mark.parametrize("info", [
    {"flops": 1e9, "bytes": 4e9, "seconds": 2e-3},
    {"flops": 8.25e11, "bytes": 1.2e8, "seconds": 2.08e-3},
    {"flops": 0.0, "bytes": 1.0, "seconds": 0.0},
])
@pytest.mark.parametrize("peaks", [(67e12, 3.35e12), (989e12, 3.35e12), (1e9, 1e9)])
def test_get_roofline_matches_reference(info, peaks):
    got = TR.KernelRooflineManager(TR.MachineSpec(*peaks)).get_roofline(info)
    want = RR.KernelRooflineManager(RR.MachineSpec(*peaks)).get_roofline(info)
    assert got == want
    assert TR.KernelRooflineManager(TR.MachineSpec(*peaks)).bound_seconds(
        info["flops"], info["bytes"]) == got["bound_s"]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_scaled_matches_reference(n):
    got = TR.MachineSpec(989e12, 3.35e12, source="x").scaled(n)
    want = RR.MachineSpec(989e12, 3.35e12, source="x").scaled(n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        TR.MachineSpec(1.0, 1.0).scaled(0)


def test_roofline_record_matches_reference():
    kw = dict(compute_s=1.0, memory_s=2.0, collective_s=0.5, flops_per_chip=3.0,
              bytes_per_chip=4.0, collective_bytes_per_chip=5.0,
              collective_counts={"all-reduce": 2})
    got, want = TR.Roofline(**kw), RR.Roofline(**kw)
    assert got.as_dict() == want.as_dict()
    assert (got.step_seconds, got.dominant) == (2.0, "memory")


def test_published_peaks():
    f32, bf16 = machine.PUBLISHED_H100_SXM["float32"], machine.PUBLISHED_H100_SXM["bfloat16"]
    assert (f32.peak_flops, f32.peak_bw) == (67e12, 3.35e12)
    assert (bf16.peak_flops, bf16.peak_bw) == (989e12, 3.35e12)
    assert f32.source.startswith("published") and bf16.source.startswith("published")


def test_probe_on_the_host_at_a_small_size():
    specs = machine.measure_machine_spec("cpu", copy_bytes=2**20, matmul_n=64, reps=2)
    assert sorted(specs) == ["bfloat16", "float32"]
    for name, spec in specs.items():
        assert math.isfinite(spec.peak_flops) and spec.peak_flops > 0
        assert spec.peak_bw == specs["float32"].peak_bw > 0
        assert spec.source.startswith("measured on cpu") and name in spec.source


def test_probe_restores_the_tf32_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        machine.measure_machine_spec("cpu", copy_bytes=2**16, matmul_n=16, reps=1)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_probe_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.measure_machine_spec()


@pytest.mark.parametrize("dtype, flops, nbytes, bound_s", [
    ("float32", 0.0, 3.35e9, 1e-3),           # bytes only
    ("float32", 67e9, 0.0, 1e-3),             # operations only
    ("float32", 67e9, 6.7e9, 2e-3),           # bytes bound
    ("bfloat16", 989e9, 3.35e9, 1e-3),        # a tie
    ("bfloat16", 9.89e12, 3.35e9, 1e-2),      # operations bound
])
def test_published_peaks_bound_the_work(dtype, flops, nbytes, bound_s):
    """The least time of a kernel's work at the data-sheet peaks, as the
    card check computes its ``bound_ms``: the larger of bytes over 3.35 TB/s
    and operations over the dtype's peak."""
    roof = TR.KernelRooflineManager(machine.PUBLISHED_H100_SXM[dtype]).get_roofline({"flops": flops, "bytes": nbytes, "seconds": 0.0})
    assert roof["bound_s"] == pytest.approx(bound_s, rel=1e-12)
