"""repro_torch.dist — logical-axis sharding, the scheduler's batch splits on
real devices, and roofline utilities.

* ``context``  — ``constrain``/``constrain_param``: logical-axis sharding
                 constraints (DTensor redistributions) that are no-ops on
                 plain tensors and outside a mesh context, ``to_placements``
                 and ``local_region`` (a layer part on local shards).
* ``sharding`` — partition specs from the logical axis names of
                 ``repro_torch.models.params.ParamSpec`` (FSDP on "data", TP
                 on "model", DP for inputs/caches), the scheduler's 1-D batch
                 splits (``batch_shard_extents`` / ``weighted_shard_extents``)
                 and divisibility-fallback reporting (``on_fallback``).
* ``mesh``     — ``DeviceMesh``/``MeshBackend``: real multi-device
                 execution of the scheduler's shard dispatch (segagg shards
                 on per-slot CUDA streams, merged on the first device;
                 worker clocks from measured wall seconds).
* ``roofline`` — compute/memory/collective roofline record, HLO collective
                 parser and ``KernelRooflineManager`` (a byte-identical copy
                 of the JAX package's module).
* ``machine``  — the H100's published peaks and a measured copy and
                 matmul probe.
"""
from .context import (
    ACT_AXIS_RULES,
    PARAM_AXIS_RULES,
    active_mesh,
    constrain,
    constrain_param,
    mesh_context,
    to_placements,
)
from .machine import PUBLISHED_H100_SXM, measure_machine_spec
from .mesh import DeviceMesh, MeshBackend
from .roofline import (
    CollectiveStats,
    KernelRooflineManager,
    MachineSpec,
    Roofline,
    parse_collectives,
)
from .sharding import (
    batch_shard_extents,
    batch_spec,
    cache_pspecs,
    input_pspecs,
    on_fallback,
    param_pspecs,
    param_shardings,
    weighted_shard_extents,
)

__all__ = [
    "ACT_AXIS_RULES",
    "CollectiveStats",
    "DeviceMesh",
    "KernelRooflineManager",
    "MachineSpec",
    "MeshBackend",
    "PARAM_AXIS_RULES",
    "PUBLISHED_H100_SXM",
    "Roofline",
    "active_mesh",
    "batch_shard_extents",
    "batch_spec",
    "cache_pspecs",
    "constrain",
    "constrain_param",
    "input_pspecs",
    "measure_machine_spec",
    "mesh_context",
    "on_fallback",
    "param_pspecs",
    "param_shardings",
    "parse_collectives",
    "to_placements",
    "weighted_shard_extents",
]
