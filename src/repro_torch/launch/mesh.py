"""Production and host meshes of H100s, and the card's published figures
(the JAX package's ``launch/mesh.py``).

Functions, never module-level meshes, so importing this module creates no
process group.  Shapes: single = (data=32, model=8), 256 cards; multi =
(pod=2, data=32, model=8), 512 cards, the "pod" axis carrying data
parallelism only (gradient all-reduce).  These are the JAX package's chip
counts; "model" is one HGX node's 8 NVLink-connected cards, "data" and
"pod" cross nodes over InfiniBand.  ``make_production_mesh`` needs a
process group of that size (the dry run's fake one); ``make_host_mesh``
covers the ranks that exist.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device
from ..dist.machine import PUBLISHED_H100_SXM

# One NVIDIA H100 SXM5 80GB ("NVIDIA H100 80GB HBM3" to nvidia-smi) at its
# full 700 W power limit, from NVIDIA's published figures; dense rates.
PEAK_FLOPS_BF16 = PUBLISHED_H100_SXM["bfloat16"].peak_flops  # 989e12 FLOP/s, data sheet
HBM_BW = PUBLISHED_H100_SXM["bfloat16"].peak_bw              # 3.35e12 bytes/s, data sheet
NVLINK_BW = 450e9         # bytes/s each direction: NVLink 4, 900 GB/s a card in all
IB_BW = 50e9              # bytes/s a card: one NDR InfiniBand port, 400 Gb/s
HBM_BYTES = 80e9          # 80 GB of HBM3, data sheet
SINGLE_SHAPE = {"data": 32, "model": 8}
MULTI_SHAPE = {"pod": 2, "data": 32, "model": 8}


def production_shape(multi_pod: bool = False) -> dict:
    """Axis name -> size of the production mesh."""
    return dict(MULTI_SHAPE if multi_pod else SINGLE_SHAPE)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over a process group of 256 (512) ranks."""
    shape = production_shape(multi_pod)
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_host_mesh(model_parallel: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the default process group, on
    the card unless ``device`` names the CPU.  With no process group:

    * under a launcher (``RANK`` and ``WORLD_SIZE`` in the environment, as
      ``torch.distributed.run`` sets them), this process joins the
      launcher's group (``init_method="env://"``) on the card ``LOCAL_RANK``
      names; a failed rendezvous raises;
    * otherwise a one-rank group is made in this process, so a
      single-process run needs no launcher.

    NCCL on the card, gloo on the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            kw = {}
            if dev.type == "cuda":
                card = dev if dev.index is not None else torch.device(
                    "cuda", int(os.environ.get("LOCAL_RANK", "0")))
                torch.cuda.set_device(card)
                kw["device_id"] = card
            dist.init_process_group(backend, init_method="env://", **kw)
        else:
            if dev.type == "cuda":
                torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev)
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    return init_device_mesh(dev.type, (n // mp, mp), mesh_dim_names=("data", "model"))
