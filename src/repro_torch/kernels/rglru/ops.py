"""Public RG-LRU op: gates and recurrence in one pass, and its gradient.

Dispatch follows the tensors: a CUDA tensor launches the Hopper kernels
(``rglru_cuda``, ``rglru_bwd_cuda``) or raises; a CPU tensor takes the
plain PyTorch versions (``ref.rglru_ref``, ``ref.rglru_bwd_ref``).  No path
runs a plain version on a CUDA tensor.  A fake tensor (the dry run) takes
the kernels' ops.  Unlike the JAX package's Pallas op,
nothing is rounded to bf16 between the gates and the scan (the model's
layer keeps log_a and u in f32).  Neither function records autograd
history: ``layers/rglru.py`` ``_RGLRU`` joins them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import is_fake
from .ref import rglru_bwd_ref, rglru_ref
from .rglru import rglru_bwd_cuda, rglru_cuda


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rglru runs on CUDA or CPU tensors, not {x.device}")
    return "cuda" if is_fake(x) else x.device.type


def rglru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, a_param: torch.Tensor,
          h0: Optional[torch.Tensor] = None, return_carries: bool = False):
    """x, r, i: (B, S, N); a_param: (N,); h0: (B, N) or None.
    Returns (y (B, S, N) in x's dtype, h_last (B, N) f32), and with
    ``return_carries`` the f32 state entering each 128-step chunk
    (B, chunks, N), which ``rglru_bwd`` starts from."""
    # serving calls each version as it did before the carries existed
    carries = {"return_carries": True} if return_carries else {}
    if _device(x) == "cuda":
        # a_param and h0 widen to f32 exactly; x, r and i go as they are.
        return rglru_cuda(x.contiguous(), r.contiguous(), i.contiguous(),
                          a_param.float().contiguous(),
                          None if h0 is None else h0.float().contiguous(), **carries)
    return rglru_ref(x, r, i, a_param, h0, **carries)


def rglru_bwd(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, a_param: torch.Tensor,
              carries: torch.Tensor, dy: torch.Tensor,
              dh_last: Optional[torch.Tensor] = None):
    """The gradient of ``rglru`` from its inputs, the ``carries`` it
    returned (the first is h0), dy and dh_last (or None): (dx, dr, di in x's
    dtype, d a_param (N,) f32, dh0 (B, N) f32)."""
    if _device(x) == "cuda":
        return rglru_bwd_cuda(x.contiguous(), r.contiguous(), i.contiguous(),
                              a_param.float().contiguous(), carries,
                              dy.to(x.dtype).contiguous(),
                              None if dh_last is None else dh_last.float().contiguous())
    return rglru_bwd_ref(x, r, i, a_param, carries[:, 0], dy, dh_last)
