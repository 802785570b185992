"""Logical-axis sharding constraints (model-code side of repro_torch.dist),
the JAX package's ``dist/context.py`` on DTensor placements.

Model code never names mesh axes directly; it names LOGICAL axes —
``constrain(h, "batch", "seq_model", None)`` — and this module resolves them
against the active mesh:

* activations (``constrain``):
    "batch"     -> the data-parallel axes ("pod", "data")
    "seq_model" -> sequence dim stored sharded on "model" (sequence-parallel
                   layer boundaries)
    "model"     -> tensor-parallel dim ("model")
    None        -> replicated

* parameters (``constrain_param``): the ParamSpec logical names of
  ``repro_torch.models.params`` ("embed" -> FSDP on "data",
  "heads"/"ffn"/"vocab" -> TP on "model", ...), used to pin per-unit slices
  (and therefore their gradients) to the parameter sharding.

A resolved spec is a tuple with one entry a tensor dim: ``None``, a mesh
axis name, or a tuple of axis names (the entries of a JAX
``PartitionSpec``).  ``to_placements`` turns it into DTensor placements, one
a mesh dim: ``Shard(d)`` on every mesh dim that dim ``d`` names (a dim on
("pod", "data") is ``Shard(d)`` on both, "pod" the major one, as in JAX),
``Replicate()`` elsewhere.  ``constrain``/``constrain_param`` redistribute a
DTensor to its spec's placements; on a plain tensor, or outside a mesh, they
are the identity, so model code is mesh-agnostic.  A mesh is active inside
``with mesh_context(mesh):`` (``launch/steps.py``'s programs enter it).  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims, or,
for the spec functions alone, a mapping of axis name to size.

A mesh axis is only applied when the corresponding dim is divisible by the
axis size and when the axis has not already been consumed by an earlier dim
of the same tensor.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# Logical activation axis -> mesh axes (tried in order, kept if present).
ACT_AXIS_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq_model": ("model",),
    "model": ("model",),
}

# Logical parameter axis -> mesh axes (see repro_torch.models.params).
PARAM_AXIS_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
    "state": (),
    "conv": (),
    "frames": (),
}

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

_local = threading.local()


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of ``mesh``, in mesh order: a ``DeviceMesh`` with
    named dims, or a mapping of name to size."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims must be named")
    return dict(zip(names, mesh.shape))


@contextlib.contextmanager
def mesh_context(mesh):
    """Activate ``mesh`` for ``constrain``/``constrain_param``."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def active_mesh():
    """The mesh constraints resolve against, or None (constraints no-op)."""
    return getattr(_local, "mesh", None)


def _resolve(
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    rules: Dict[str, Tuple[str, ...]],
    mesh,
) -> Optional[Spec]:
    """The spec of ``shape`` under ``rules``; None if fully replicated."""
    sizes = mesh_axes(mesh)
    used: set = set()
    entries: list = []
    any_sharded = False
    for dim, name in zip(shape, logical_axes):
        axes: Tuple[str, ...] = ()
        if name is not None:
            want = rules.get(name, ())
            picked = []
            size = 1
            for ax in want:
                if ax in sizes and ax not in used:
                    picked.append(ax)
                    size *= sizes[ax]
            if picked and size > 0 and dim % size == 0:
                axes = tuple(picked)
        if axes:
            used.update(axes)
            entries.append(axes if len(axes) > 1 else axes[0])
            any_sharded = True
        else:
            entries.append(None)
    if not any_sharded:
        return None
    return tuple(entries)


def to_placements(spec: Optional[Spec], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that entry ``d`` names, ``Replicate()`` on the others and on a mesh
    dim of size 1 (which splits nothing; DTensor's view rules refuse some
    size-1 dims sharded on one)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    out = [Replicate()] * len(sizes)
    names = list(sizes)
    for dim, entry in enumerate(spec or ()):
        for ax in (entry,) if isinstance(entry, str) else (entry or ()):
            if sizes[ax] > 1:
                out[names.index(ax)] = Shard(dim)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _constrain_with(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
                    rules: Dict[str, Tuple[str, ...]]) -> torch.Tensor:
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"rank mismatch: {len(logical_axes)} logical axes for shape {tuple(x.shape)}")
    spec = _resolve(x.shape, logical_axes, rules, mesh)
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Pin an ACTIVATION to the placements implied by its logical axes.

    Identity on a plain tensor or when no mesh is active."""
    return _constrain_with(x, logical_axes, ACT_AXIS_RULES)


def constrain_param(x: torch.Tensor,
                    axes: Union[Sequence[Optional[str]], Tuple[Optional[str], ...]]
                    ) -> torch.Tensor:
    """Pin a PARAMETER (or its per-unit slice) to its spec's placements."""
    return _constrain_with(x, tuple(axes), PARAM_AXIS_RULES)


def gathered(p: torch.Tensor) -> torch.Tensor:
    """A parameter as its products use it: whole over the data-parallel
    axes (the FSDP gather; its gradient is reduce-scattered back), its
    "model" split kept.  Left to itself DTensor may instead gather the
    batch and keep the weight split.  Identity on a plain tensor."""
    if not is_dtensor(p):
        return p
    from torch.distributed.tensor import Replicate

    names = list(mesh_axes(p.device_mesh))
    want = tuple(Replicate() if n in ("pod", "data") else pl
                 for n, pl in zip(names, p.placements))
    return p if want == tuple(p.placements) else p.redistribute(p.device_mesh, want)


# --- local regions --------------------------------------------------------
# Where DTensor has no sharding rule (a custom kernel, sort/top-k/cumsum
# routing, an index gather), the layer runs the part on the local shards
# under ``local_map``, with the placements its logical axes name.

def dtensor_mesh(*tensors):
    """The mesh of the first DTensor among ``tensors``, or None."""
    return next((t.device_mesh for t in tensors if is_dtensor(t)), None)


def act_placements(mesh, shape: Sequence[int], *logical_axes: Optional[str]) -> tuple:
    """Placements on ``mesh`` of a tensor of ``shape`` under ``constrain``'s
    rules."""
    return to_placements(_resolve(shape, logical_axes, ACT_AXIS_RULES, mesh), mesh)


def local_region(fn, args: Sequence, in_placements: Sequence, out_placements):
    """``fn(*args)`` on local shards: each DTensor argument is redistributed
    to its entry of ``in_placements`` (None for a non-tensor) and handed to
    ``fn`` as its local tensor; ``fn``'s tensors come back as DTensors with
    ``out_placements``.  An input replicated on a mesh dim that another
    input is sharded on gets a ``Partial`` gradient there (each shard adds
    its part).  With no DTensor among ``args`` it is ``fn(*args)``."""
    mesh = dtensor_mesh(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    # Only the tensors go through local_map; the rest (None, flags) are
    # put back in place around them.
    idx = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    ins = [None if in_placements[i] is None else tuple(in_placements[i]) for i in idx]
    split = {m for p in ins if p for m, pl in enumerate(p) if pl.is_shard()}
    grads = [p and tuple(Partial() if m in split and pl.is_replicate() else pl
                         for m, pl in enumerate(p)) for p in ins]

    def inner(*tensors):
        full = list(args)
        for i, t in zip(idx, tensors):
            full[i] = t
        return fn(*full)

    from torch.distributed.tensor.placement_types import Placement

    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = (out_placements,)  # one output
    return local_map(inner, out_placements=out_placements, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*(args[i] for i in idx))


def shard_start(mesh, placements, dim: int, size: int) -> Tuple[int, list]:
    """(this rank's first index along ``dim``, the mesh dims splitting it)
    of a tensor with ``size`` entries there laid out by ``placements``
    (split on one mesh dim at most)."""
    split = [i for i, p in enumerate(placements) if p.is_shard(dim)]
    if len(split) > 1:
        raise ValueError(f"dim {dim} split on {len(split)} mesh dims")
    if not split:
        return 0, split
    return mesh.get_coordinate()[split[0]] * (size // mesh.shape[split[0]]), split
