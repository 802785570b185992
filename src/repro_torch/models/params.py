"""Parameter specification tables and their initialisation.

Each model family builds a flat ``{path: ParamSpec}`` table once (the JAX
package's keys, ``seg{i}/l{j}/<block>/<leaf>``); ``init_params`` draws real
tensors from it on the target device (``init_params_sharded``: the same
values as DTensors, each rank drawing leaf by leaf and keeping its shard),
and ``params_from_numpy`` carries the JAX package's parameters across one
key to one key.  ``axes`` are the logical axis names of the reference
(``dist/sharding.py`` turns them into placements).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # "normal" | "zeros" | "ones" | "rglru_a" | "ssm_dt"
    fan_in_axis: Optional[int] = None  # for scaled normal init

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self.shape} vs {self.axes}")


Specs = Dict[str, ParamSpec]
Params = Dict[str, torch.Tensor]


def num_params(specs: Specs) -> int:
    return sum(int(np.prod(s.shape)) for s in specs.values())


def shape_structs(specs: Specs) -> Params:
    """Meta tensors (``device="meta"``) of every spec's shape and dtype."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s in specs.items()}


def _init_leaf(gen: torch.Generator, spec: ParamSpec,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "rglru_a":
        # Griffin's a-parameter: softplus-inverse spread so that the gate
        # a = sigmoid(param)^(c*r) starts near 0.9..0.999 per channel.
        u = torch.rand(spec.shape, generator=gen, device=device) * 0.099 + 0.9
        return torch.log(u / (1 - u)).to(spec.dtype)
    if spec.init == "ssm_dt":
        # Mamba dt bias: log-uniform in [1e-3, 1e-1] through softplus-inverse.
        u = torch.rand(spec.shape, generator=gen, device=device)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return torch.log(torch.expm1(dt)).to(spec.dtype)
    fan_in = (
        spec.shape[spec.fan_in_axis]
        if spec.fan_in_axis is not None
        else (spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
    )
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, device=device)
    return x.mul_(scale).to(spec.dtype)


# A leaf with a "layers" axis whose f32 draw exceeds this is drawn one unit
# at a time: internvl2-76b's (80, 8192, 28672) MLP weights take 70 GiB in
# f32, which no card holds.  Every leaf of the other configs is smaller
# (olmoe-1b-7b's experts, 8 GiB, the largest drawn on one card), so their
# draws are as they were.
SLICED_DRAW_BYTES = 16 * 2 ** 30


def _unit_slices(spec: ParamSpec) -> Optional[ParamSpec]:
    """The spec of one unit of ``spec`` when it is drawn unit by unit, else
    None."""
    if not spec.axes or spec.axes[0] != "layers" or \
            4 * int(np.prod(spec.shape)) <= SLICED_DRAW_BYTES:
        return None
    fan = None if spec.fan_in_axis is None else spec.fan_in_axis - 1
    return dataclasses.replace(spec, shape=spec.shape[1:], axes=spec.axes[1:],
                               fan_in_axis=fan)


def _draw(gen: torch.Generator, spec: ParamSpec, device: torch.device,
          keep=None) -> torch.Tensor:
    """``spec``'s leaf drawn from ``gen``: whole, or past
    ``SLICED_DRAW_BYTES`` one unit at a time into one tensor allocated at
    the first unit and written in place.  ``keep(draw, unit)`` maps each
    draw (one unit of the leaf when ``unit``) to what is kept of it: this
    rank's shard on a mesh, the draw itself off one."""
    keep = keep or (lambda t, unit: t)
    unit = _unit_slices(spec)
    if unit is None:
        return keep(_init_leaf(gen, spec, device), False)
    out = None
    for i in range(spec.shape[0]):
        part = keep(_init_leaf(gen, unit, device), True)
        if out is None:
            out = part.new_empty((spec.shape[0], *part.shape))
        out[i] = part
        del part  # freed before the next unit is drawn
    return out


def init_params(specs: Specs, seed: int = 0, device: DeviceLike = None) -> Params:
    """Real tensors for every spec, drawn in sorted key order from one
    ``torch.Generator`` seeded with ``seed`` on the target device (the
    numbers differ from ``jax.random``'s; the rules are the same), a leaf
    past ``SLICED_DRAW_BYTES`` unit by unit."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: _draw(gen, s, dev) for k, s in sorted(specs.items())}


def init_params_sharded(specs: Specs, seed: int, mesh,
                        placements: Mapping[str, tuple]) -> Params:
    """``init_params`` laid out on ``mesh``: a DTensor a spec with
    ``placements[key]``, each rank holding only its own shard.  Every rank
    draws every leaf (or unit of a leaf, as ``init_params`` does) whole, in
    ``init_params``'s order from one generator seeded with ``seed`` on its
    own card (the CPU on a gloo mesh), keeps its shard and frees the draw
    before the next, so the values are ``init_params``'s bit for bit and no
    card holds more than the shards and one draw (``_draw``).  No collective
    runs."""
    from torch.distributed.tensor import DTensor, Shard

    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: Params = {}
    for k, s in sorted(specs.items()):
        pl, upl = tuple(placements[k]), None
        if _unit_slices(s) is not None:  # the layers axis is never split: a unit's
            if any(p.is_shard(0) for p in pl):  # placements are dims - 1
                raise ValueError(f"{k}: a leaf drawn unit by unit is split on its layers axis")
            upl = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in pl)
        local = _draw(gen, s, dev, lambda t, unit: _shard(t, mesh, upl if unit else pl))
        out[k] = DTensor.from_local(local, mesh, pl, run_check=False, shape=s.shape,
                                    stride=torch.empty(s.shape, device="meta").stride())
    return out


def _shard(full: torch.Tensor, mesh, placements: tuple) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements``, in memory of its
    own (a view would keep the whole draw alive)."""
    from torch.distributed.tensor import distribute_tensor

    local = distribute_tensor(full, mesh, placements, src_data_rank=None).to_local()
    if local.untyped_storage().data_ptr() == full.untyped_storage().data_ptr() \
            and local.numel() < full.numel():
        local = local.clone()
    return local


def _to_numpy(value) -> np.ndarray:
    """A numpy array of ``value``; a bfloat16 (``ml_dtypes``) array goes
    through float32, which holds every bf16 value exactly."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32)
    return arr


def params_from_numpy(np_params: Mapping[str, object], device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Tensors on ``device`` from arrays keyed as the JAX package keys them
    (one key to one key).  Each keeps its own dtype (bf16 stays bf16) unless
    ``dtype`` is given."""
    dev = resolve_device(device)
    out: Params = {}
    for k, v in np_params.items():
        src = np.asarray(v)
        want = dtype if dtype is not None else (
            torch.bfloat16 if src.dtype.name == "bfloat16"
            else torch.from_numpy(np.zeros(0, src.dtype)).dtype)
        t = torch.from_numpy(np.array(_to_numpy(src)))  # a writable copy
        out[k] = t.to(device=dev, dtype=want)
    return out


def count_table(specs: Specs) -> str:
    rows = [f"{k:60s} {str(s.shape):28s} {int(np.prod(s.shape)):>14,d}"
            for k, s in sorted(specs.items())]
    rows.append(f"{'TOTAL':60s} {'':28s} {num_params(specs):>14,d}")
    return "\n".join(rows)
