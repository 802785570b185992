"""Dry run of every (architecture x input-shape) cell on the production
meshes of H100s, and its roofline (the JAX package's ``launch/dryrun.py``).

For each cell, on the single (data=32, model=8) and multi (pod=2, data=32,
model=8) meshes of ``launch/mesh.py``, the cell's production program
(``launch/steps.py``'s ``build_cell_program``) runs once under a fake
process group of 256 (512) ranks (``torch.testing._internal.distributed
.fake_pg``: every collective returns at once) and ``FakeTensorMode``: each
tensor has a shape, a dtype and a device but no memory.  The run is rank
0's, at the busiest place on the mesh (``busiest_model_rank``): the first
where every rank does the same work, the last on "model" in a training
cell whose attention core splits its query rows on "model" (its causal
rows see the most keys; the record's ``model_rank`` says so).  A serving
cell whose rows divide "data" but not "pod" x "data" runs on the multi
mesh's pod-local submesh (``steps.serving_mesh``), and its record's
``program_mesh`` says so; ``fallback_events`` counts the
``sharding_fallback`` events sent while the cell is built and run.  A
dispatch mode below DTensor sees every op on the local shards (DTensor
returns to it as local ops and functional collectives) and records, per
card:

* flops: ``FlopCounterMode``'s formulas (its registry), and for a kernel's
  custom op the kernel's own ``flops_bytes`` (``kernels.register_cost``);
* bytes: the sum of each op's operand and result bytes, a kernel op's from
  its formula.  Ops are counted one by one, before any fusion, so this is
  a ceiling on the traffic an eager run moves;
* collectives: count and output bytes of each, by mesh axis;
* peak bytes: the most bytes of local storage alive at once, the
  arguments (parameters, optimizer state, batch, cache) included.

DTensor's sharding propagation and redistribution planning run outside
the fake mode and are not counted (the propagator's shape inference runs
the op on global-shape tensors).  ``FlopCounterMode`` alone would see DTensor ops at their
global shapes, hence the mode below DTensor.

The reference costs its cells compositionally (a zero-layer and a
one-unit program per segment) because XLA's ``cost_analysis`` counts a
``while`` body once; here Python loops run every layer and every
microbatch, so the one traced program counts everything.

The roofline divides by the published figures of one H100 SXM at 700 W
(``launch/mesh.py``): bf16 peak, HBM bandwidth, NVLink for "model" and
InfiniBand for "data" and "pod"; ``fits_hbm`` is judged against its 80 GB.
These are derived numbers, not measurements.  Records are JSON under
``torch_dryrun/`` at the root of the checkout.  On a host without CUDA the
fake tensors are CPU tensors (the kernels' ops are taken for fake tensors
on any device); on the card they are CUDA tensors.

Usage:
    python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..dist.context import mesh_axes
from ..dist.roofline import Roofline
from ..dist.sharding import on_fallback
from ..kernels import COSTS
from ..layers.attention import row_split_applies
from ..models.base import ARCH_IDS, SHAPES, ShapeCell, cell_supported, get_config
from ..models.config import ModelConfig
from ..models.params import num_params
from .mesh import HBM_BW, HBM_BYTES, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16, production_shape
from .steps import build_cell_program, map_placed, model_specs

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "torch_dryrun"
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}


def active_params(cfg) -> int:
    """Parameters touched per token (MoE experts scaled by top_k/E)."""
    total = 0
    for s in model_specs(cfg).values():
        n = int(np.prod(s.shape))
        if "experts" in s.axes and cfg.num_experts:
            n = int(n * cfg.top_k / cfg.num_experts)
        total += n
    return total


def model_flops(cfg, cell) -> float:
    """Analytic MODEL_FLOPS (param-matmul only: 6*N*D train, 2*N*D fwd)."""
    n_act = active_params(cfg)
    if cell.kind == "train":
        return 6.0 * n_act * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_act * cell.global_batch * cell.seq_len
    return 2.0 * n_act * cell.global_batch


# ---------------------------------------------------------------------------
# The counting mode
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _CellCounter(TorchDispatchMode):
    """Flops, bytes, collectives and live storage of the ops a card runs."""

    def __init__(self, mesh):
        super().__init__()
        self.groups = {mesh.get_group(i).group_name: name
                       for i, name in enumerate(mesh_axes(mesh))}
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_counts: Dict[str, int] = {}
        self.coll_bytes: Dict[str, float] = {}
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.in_propagation = False

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` (local shards) as live; returns
        their bytes."""
        from torch.distributed.tensor import DTensor

        before = self.current
        for t in tensors:
            self._hold(t.to_local() if isinstance(t, DTensor) else t)
        return self.current - before

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.current += st.nbytes()
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars it into local ops
        out = func(*args, **kwargs)
        if self.in_propagation:
            return out
        packet = func._overloadpacket
        outs = _tensors(out)
        name = packet.__name__
        if packet in COSTS:
            from torch.utils.flop_counter import get_shape

            shapes = [get_shape(a) if isinstance(a, torch.Tensor) else a for a in args]
            flops, nbytes = COSTS[packet](*shapes)
            self.flops += flops
            self.bytes += nbytes
        else:
            from torch.utils.flop_counter import flop_registry

            if packet in flop_registry:
                # mm/bmm's ``out_dtype`` overloads take a third argument
                # that the formulas do not
                fargs = args[:2] if packet in (torch.ops.aten.mm, torch.ops.aten.bmm) else args
                self.flops += flop_registry[packet](*fargs, out_val=out)
            if not (func.is_view or name in ("detach", "wait_tensor")):
                self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + \
                    sum(map(_nbytes, outs))
        group = next((a for a in reversed(args) if isinstance(a, str)), None)
        if group in self.groups and name not in ("wait_tensor",):
            axis = self.groups[group]
            key = f"{name}@{axis}"
            self.coll_counts[key] = self.coll_counts.get(key, 0) + 1
            self.coll_bytes[axis] = self.coll_bytes.get(axis, 0.0) + \
                sum(map(_nbytes, outs))
        for t in outs:
            self._hold(t)
        return out


@contextlib.contextmanager
def _planning_outside_fake(counter: _CellCounter):
    """DTensor's sharding propagation and redistribution planning, run
    outside the fake mode and not counted.  The propagator infers shapes on
    global-shape fake tensors of its own; the planners and a strided shard's
    own sizing use small real tensors, which a fake mode would make
    data-dependent."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    targets = [(obj, name) for obj, name in (
        (ShardingPropagator, "propagate"),
        (ShardingPropagator, "_propagate_tensor_meta_non_cached"),
        (_redistribute, "_gen_transform_infos_non_cached"),
        (getattr(placement_types, "_StridedShard", None), "local_shard_size_and_offset"))
        if hasattr(obj, name)]
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]

    def outside(orig):
        def run(*a, **k):
            prev, counter.in_propagation = counter.in_propagation, True
            try:
                with unset_fake_temporarily():
                    return orig(*a, **k)
            finally:
                counter.in_propagation = prev
        return run

    for obj, name, orig in saved:
        setattr(obj, name, outside(orig))
    try:
        yield
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process is rank 0),
    destroyed on exit.  Refuses to start beside an existing group."""
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; a default "
                           "process group already exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _fallbacks():
    """The ``sharding_fallback`` events sent inside the block, in a list."""
    got = []
    unsubscribe = on_fallback(got.append)
    try:
        yield got
    finally:
        unsubscribe()


def _fake_args(prog, device: str):
    """The program's arguments as DTensors with fake local shards of their
    placements (a leaf without placements: a fake plain tensor, or the
    value as it is)."""
    from torch.distributed.tensor import DTensor

    def make(t, p):
        if not isinstance(t, torch.Tensor):
            return t
        if p is None:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        local = list(t.shape)
        for size, pl in zip(prog.mesh.shape, p):
            if pl.is_shard():
                local[pl.dim] //= size
        stride = tuple(int(np.prod(t.shape[i + 1:])) for i in range(t.dim()))
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device=device),
                                  prog.mesh, p, run_check=False, shape=t.shape,
                                  stride=stride)

    return tuple(map_placed(make, a, p) for a, p in zip(prog.args, prog.in_placements))


def busiest_model_rank(cfg: ModelConfig, cell: ShapeCell, shape: Dict[str, int]) -> int:
    """The "model" coordinate with the most work in ``cell`` on a mesh of
    ``shape`` (axis name -> size): the last in a training cell whose
    attention core splits its rows on "model" (``row_split_applies``), its
    contiguous causal rows seeing the most keys; else 0 (the shares are the
    same)."""
    model = shape.get("model", 1)
    if cell.kind == "train" and row_split_applies(model, cfg.num_kv_heads, cell.seq_len):
        return model - 1
    return 0


def _mesh(shape: Dict[str, int], device: str, model_rank: int):
    """The mesh of ``shape`` (``init_device_mesh``'s layout) with this
    process, rank 0, at ``model_rank`` on "model": the ranks rolled along
    "model" where that is not 0.  A rolled mesh does not compare equal to
    the plain one, so nothing DTensor keeps by mesh passes from one layout's
    fake world to the other's, whose groups are named otherwise."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    names = tuple(shape)
    if not model_rank:
        return init_device_mesh(device, tuple(shape.values()), mesh_dim_names=names)
    ranks = torch.arange(math.prod(shape.values())).reshape(tuple(shape.values()))
    return DeviceMesh(device, ranks.roll(model_rank, dims=names.index("model")),
                      mesh_dim_names=names)


def run_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeCell],
             multi_pod: bool = False, mesh_shape: Optional[Dict[str, int]] = None) -> dict:
    """The record of one cell: ``arch`` an id or a config, ``shape`` a name
    of ``SHAPES`` or a cell, on the production mesh (``mesh_shape``: axis
    name -> size, another mesh), as its busiest rank runs it
    (``busiest_model_rank``; the record says which where it is not the
    first)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch) if isinstance(arch, str) else arch
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    arch_name = arch if isinstance(arch, str) else cfg.name
    mesh_name = "multi" if multi_pod else "single"
    if mesh_shape is not None:
        mesh_name = "x".join(f"{k}{v}" for k, v in mesh_shape.items())
    shape_ = mesh_shape or production_shape(multi_pod)
    model_rank = busiest_model_rank(cfg, cell, shape_)
    head = {"arch": arch_name, "shape": cell.name, "mesh": mesh_name,
            **({"model_rank": model_rank} if model_rank else {})}
    skip = cell_supported(cfg, cell)
    if skip:
        return {**head, "status": "skipped", "reason": skip}
    nchips = math.prod(shape_.values())
    device = "cuda" if torch.cuda.is_available() else "cpu"

    from ..layers.moe import moe_ffn

    dropped, moe_ffn.dropped = moe_ffn.dropped, 0  # no fake tensor outlives the run
    t0 = time.time()
    with fake_world(nchips), _fallbacks() as fallbacks:
        mesh = _mesh(shape_, device, model_rank)
        prog = build_cell_program(cfg, cell, mesh)
        counter = _CellCounter(prog.mesh)  # a serving program's pod-local submesh
        with FakeTensorMode():
            args = _fake_args(prog, device)
            arg_bytes = counter.track(_tensors(args))
            with _planning_outside_fake(counter), counter:
                out = prog.run(*args)
            outs = _tensors(out)
            ins = {id(t.to_local().untyped_storage()) if hasattr(t, "to_local")
                   else id(t.untyped_storage()) for t in _tensors(args)}
            out_bytes = alias = 0
            for t in outs:
                local = t.to_local() if hasattr(t, "to_local") else t
                out_bytes += _nbytes(local)
                alias += _nbytes(local) if id(local.untyped_storage()) in ins else 0
    moe_ffn.dropped = dropped
    t_trace = time.time() - t0

    coll_s = sum(b / AXIS_BW[ax] for ax, b in counter.coll_bytes.items())
    roof = Roofline(
        compute_s=counter.flops / PEAK_FLOPS_BF16,
        memory_s=counter.bytes / HBM_BW,
        collective_s=coll_s,
        flops_per_chip=counter.flops,
        bytes_per_chip=counter.bytes,
        collective_bytes_per_chip=sum(counter.coll_bytes.values()),
        collective_counts=dict(counter.coll_counts),
    )
    mf = model_flops(cfg, cell)
    traced_total = roof.flops_per_chip * nchips
    peak = counter.peak
    return {
        **head,
        "status": "ok",
        "chips": nchips,
        "program_mesh": mesh_axes(prog.mesh),
        "fallback_events": len(fallbacks),
        "kind": cell.kind,
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "params": num_params(model_specs(cfg)),
        "active_params": active_params(cfg),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes,
            "alias_bytes": alias,
            "peak_bytes_per_chip": peak,
            "fits_hbm": bool(peak < HBM_BYTES),
        },
        "roofline": roof.as_dict(),
        "collective_bytes_by_axis": dict(counter.coll_bytes),
        "model_flops_total": mf,
        "hlo_flops_total": traced_total,
        "useful_flops_ratio": mf / traced_total if traced_total else None,
        "mfu_bound": mf / (nchips * PEAK_FLOPS_BF16 * roof.step_seconds)
        if roof.step_seconds else None,
        "device": device,
    }


def cell_path(arch: str, shape: str, mesh: str) -> pathlib.Path:
    return RESULTS_DIR / f"{arch}__{shape}__{mesh}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape) cell")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                out = cell_path(arch, shape, mesh_name)
                if out.exists() and not args.force:
                    prev = json.loads(out.read_text())
                    if prev.get("status") != "error":
                        print(f"[cached] {arch} x {shape} x {mesh_name}")
                        continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi)
                except Exception as e:  # record failures — they are bugs
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                out.write_text(json.dumps(rec, indent=2))
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" step={r['step_seconds']:.4f}s"
                             f" mem={rec['memory']['peak_bytes_per_chip']/2**30:.2f}GiB"
                             f" fits={rec['memory']['fits_hbm']}"
                             f" mfu_bound={rec['mfu_bound']:.3f}"
                             f" ({rec['lower_s']}s)")
                print(f"[{rec['status']}] {arch} x {shape} x {mesh_name}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
