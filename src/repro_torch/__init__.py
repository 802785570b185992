"""repro_torch — the PyTorch/CUDA port of the intermittent-query scheduler.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` or ``repro``.  Module names follow the reference
so that each counterpart is easy to find:

* ``core``                 the deadline scheduler (a copy of ``repro.core``:
                           planner, policies, runtime loop, ``Session``,
                           pane sharing, overload, forecast, tenancy);
* ``data.tpch``            the seeded TPC-H-shaped record streams;
* ``kernels.segagg``       GROUP-BY partial aggregation: two hand-written
                           CUDA kernels for Hopper (``csrc/segagg.cu``) and
                           their plain PyTorch version;
* ``serve.analytics``      the executors that run scheduled batches on the
                           card and spill partials to the host (one query,
                           pane-shared windows, recurring sessions);
* ``serve.engine``         deadline-scheduled LM prefill serving, with
                           online admission (``serve_session``);
* ``train``, ``launch``    mixed-precision AdamW, checkpoints, the train
                           step and the trainer
                           (``python -m repro_torch.launch.train``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; see ``repro_torch.device.resolve_device``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
