"""Public flash-attention op in the model's (B, S, H, D) layout.

Dispatch follows the tensors: a CUDA tensor launches the Hopper kernel
(``flash_attention_cuda``) or raises; a CPU tensor takes the plain PyTorch
version (``ref.chunked_attention_ref``).  No path runs the plain version on
a CUDA tensor.  A fake tensor (the dry run) takes the kernel's op.  What
the kernel does not take (a dtype other than bf16, a negative
``q_offset``) raises on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import is_fake
from .flash_attention import flash_attention_cuda
from .ref import chunked_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, logit_cap: float = 0.0,
                    *, chunk: int = 256, q_offset: int = 0,
                    kv_valid_len: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D) in q's dtype.
    ``chunk`` is the KV chunk of the plain version; ``q_offset`` is the
    absolute position of q[0] and ``kv_valid_len`` (B,) masks keys at or
    past each row's valid length.  ``return_lse``: returns (out, lse), lse
    (B, H, Sq) f32 each row's log-sum-exp."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} are not a multiple of KV "
                         f"heads {k.shape[2]}")
    if q.device.type == "cuda" or is_fake(q):
        return flash_attention_cuda(q, k, v, causal, window, logit_cap,
                                    q_offset=q_offset, kv_valid_len=kv_valid_len,
                                    return_lse=return_lse)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    return chunked_attention_ref(q, k, v, causal, window, logit_cap, chunk,
                                 q_offset, kv_valid_len, return_lse=return_lse)
