"""Public RG-LRU op: gates and recurrence in one pass.

Dispatch follows the tensors: a CUDA tensor launches the Hopper kernel
(``rglru_cuda``) or raises; a CPU tensor takes the plain PyTorch version
(``ref.rglru_ref``).  No path runs the plain version on a CUDA tensor.
Unlike the JAX package's Pallas op, nothing is rounded to bf16 between the
gates and the scan (the model's layer keeps log_a and u in f32).  The
kernel has no backward yet: on the card a call that autograd would have to
differentiate raises ``NotImplementedError`` rather than return an output
with no history (on the CPU autograd runs through the plain version).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ref import rglru_ref
from .rglru import rglru_cuda


def rglru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, a_param: torch.Tensor,
          h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i: (B, S, N); a_param: (N,); h0: (B, N) or None.
    Returns (y (B, S, N) in x's dtype, h_last (B, N) f32)."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, r, i, a_param, h0)):
            raise NotImplementedError(
                "rglru on the card has no backward yet (ROADMAP queue 1, item 5: the "
                "backward of rglru and ssm); call it under torch.no_grad()")
        # a_param and h0 widen to f32 exactly; x, r and i go as they are.
        return rglru_cuda(x.contiguous(), r.contiguous(), i.contiguous(),
                          a_param.float().contiguous(),
                          None if h0 is None else h0.float().contiguous())
    if x.device.type != "cpu":
        raise ValueError(f"rglru runs on CUDA or CPU tensors, not {x.device}")
    return rglru_ref(x, r, i, a_param, h0)
