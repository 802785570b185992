"""Public SSD op: the Mamba-2 chunked forward with the dt weighting and the
D skip, as the model's layer (``layers/ssd.py`` ``ssd_chunked``) computes it.

Dispatch follows the tensors: a CUDA tensor launches the Hopper kernel
(``ssd_cuda``) or raises; a CPU tensor takes the plain PyTorch version
(``ref.ssd_chunked_ref``).  No path runs the plain version on a CUDA tensor.
A fake tensor (the dry run) takes the kernel's op.
Unlike the JAX package's Pallas op, nothing is rounded to x's dtype before
the chunk math or before the D skip (the model's layer keeps xw, la, B, C
and h in f32 and rounds only y).  The op records no autograd history:
``layers/ssd.py`` ``_SSD`` pairs it with its backward, ``ssd_bwd``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import is_fake
from .ref import ssd_chunked_ref
from .ssd import CHUNK, ssd_cuda


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor] = None,
        chunk: int = 128, return_states: bool = False):
    """x (B, S, H, P), dt (B, S, H) positive, A (H,) negative, Bm/Cm
    (B, S, H, N), D (H,), h0 (B, H, N, P) or None.  Returns (y (B, S, H, P)
    in x's dtype, h_last (B, H, N, P) f32), and with ``return_states`` the
    f32 state entering each chunk (B, H, chunks, N, P).  ``chunk`` is the
    plain version's chunk; the kernel's is ``CHUNK`` = 128 (the result does
    not depend on it beyond rounding; the states do: ``state_chunk`` gives
    the one they were taken at)."""
    # serving calls each version as it did before the states existed
    states = {"return_states": True} if return_states else {}
    if x.device.type == "cuda" or is_fake(x):
        # A, D and h0 widen to f32 (bf16 to f32 is exact); x, dt, B and C go
        # as they are, B and C through their strides.
        return ssd_cuda(x.contiguous(), dt.contiguous(), A.float().contiguous(), Bm, Cm,
                        D.float().contiguous(),
                        None if h0 is None else h0.float().contiguous(), **states)
    if x.device.type != "cpu":
        raise ValueError(f"ssd runs on CUDA or CPU tensors, not {x.device}")
    return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk, h0, **states)


def state_chunk(x: torch.Tensor, chunk: int) -> int:
    """The chunk length of the states ``ssd`` returns for x: the kernel's on
    the card, the plain version's min(chunk, S) on the CPU."""
    return CHUNK if x.device.type == "cuda" or is_fake(x) else max(min(chunk, x.shape[1]), 1)
