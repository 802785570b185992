"""Public SSD op: the Mamba-2 chunked forward with the dt weighting and the
D skip, as the model's layer (``layers/ssd.py`` ``ssd_chunked``) computes it.

Dispatch follows the tensors: a CUDA tensor launches the Hopper kernel
(``ssd_cuda``) or raises; a CPU tensor takes the plain PyTorch version
(``ref.ssd_chunked_ref``).  No path runs the plain version on a CUDA tensor.
Unlike the JAX package's Pallas op, nothing is rounded to x's dtype before
the chunk math or before the D skip (the model's layer keeps xw, la, B, C
and h in f32 and rounds only y).  The kernel has no backward yet: on the
card a call that autograd would have to differentiate raises
``NotImplementedError`` rather than return an output with no history (on
the CPU autograd runs through the plain version).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ref import ssd_chunked_ref
from .ssd import ssd_cuda


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None,
        chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) positive, A (H,) negative, Bm/Cm
    (B, S, H, N), D (H,), h0 (B, H, N, P) or None.  Returns (y (B, S, H, P)
    in x's dtype, h_last (B, H, N, P) f32).  ``chunk`` is the plain
    version's chunk; the kernel's is 128 (the result does not depend on it
    beyond rounding)."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, D, h0)):
            raise NotImplementedError(
                "ssd on the card has no backward yet (ROADMAP queue 1, item 5: the "
                "backward of rglru and ssm); call it under torch.no_grad()")
        # A, D and h0 widen to f32 (bf16 to f32 is exact); x, dt, B and C go
        # as they are, B and C through their strides.
        return ssd_cuda(x.contiguous(), dt.contiguous(), A.float().contiguous(), Bm, Cm,
                        D.float().contiguous(),
                        None if h0 is None else h0.float().contiguous())
    if x.device.type != "cpu":
        raise ValueError(f"ssd runs on CUDA or CPU tensors, not {x.device}")
    return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk, h0)
