"""Hand-written Hopper kernels, their plain PyTorch versions and public ops.

Each CUDA launch of the LM kernels is a ``torch.library.custom_op``
registered for CUDA only, with a fake (shape) function, so that DTensor
programs and fake tensors go through it.  ``register_cost`` gives an op its
(operations, bytes) formula, the kernel's own ``flops_bytes``: it is the
op's ``FlopCounterMode`` formula, and ``COSTS`` keeps both numbers for the
dry run (``launch/dryrun.py``).  A fake tensor (``is_fake``) takes the
kernel's route whatever its device: the dry run traces what the card runs.
"""
from typing import Callable, Dict

COSTS: Dict[object, Callable] = {}


def register_cost(op, cost: Callable) -> None:
    """``cost(*args)``, called with the op's arguments with every tensor
    replaced by its shape, returns (operations, bytes) of one call."""
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula(op)(lambda *args, out_shape=None, **kw: int(cost(*args)[0]))
    COSTS[op] = cost


def is_fake(t) -> bool:
    """True for a fake tensor (shape and dtype only, no data)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)
