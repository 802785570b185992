"""repro_torch.dist — the scheduler's batch splits on real devices, and
roofline utilities.

* ``sharding`` — the scheduler's 1-D batch splits (``batch_shard_extents``
                 / ``weighted_shard_extents``) and the divisibility-fallback
                 event (``fallback_event``), copied from the JAX package.
* ``mesh``     — ``DeviceMesh``/``MeshBackend``: real multi-device
                 execution of the scheduler's shard dispatch (segagg shards
                 on per-slot CUDA streams, merged on the first device;
                 worker clocks from measured wall seconds).
* ``roofline`` — compute/memory/collective roofline record, HLO collective
                 parser and ``KernelRooflineManager`` (a byte-identical copy
                 of the JAX package's module).
* ``machine``  — the H100's published peaks and a measured copy and
                 matmul probe.

The JAX package's ``context`` module and its partition-spec functions are
bound to XLA and are not ported.
"""
from .machine import PUBLISHED_H100_SXM, measure_machine_spec
from .mesh import DeviceMesh, MeshBackend
from .roofline import (
    CollectiveStats,
    KernelRooflineManager,
    MachineSpec,
    Roofline,
    parse_collectives,
)
from .sharding import batch_shard_extents, weighted_shard_extents

__all__ = [
    "CollectiveStats",
    "DeviceMesh",
    "KernelRooflineManager",
    "MachineSpec",
    "MeshBackend",
    "PUBLISHED_H100_SXM",
    "Roofline",
    "batch_shard_extents",
    "measure_machine_spec",
    "parse_collectives",
    "weighted_shard_extents",
]
