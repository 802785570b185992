"""Parameter specification tables and their initialisation.

Each model family builds a flat ``{path: ParamSpec}`` table once (the JAX
package's keys, ``seg{i}/l{j}/<block>/<leaf>``); ``init_params`` draws real
tensors from it on the target device, and ``params_from_numpy`` carries the
JAX package's parameters across one key to one key.  ``axes`` are the
logical axis names of the reference (kept as data for a later sharding
slice).
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


def init_params(specs: Specs, seed: int = 0, device: DeviceLike = None) -> Params:
    """Real tensors for every spec, drawn in sorted key order from one
    ``torch.Generator`` seeded with ``seed`` on the target device (the
    numbers differ from ``jax.random``'s; the rules are the same)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: _init_leaf(gen, s, dev) for k, s in sorted(specs.items())}


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
