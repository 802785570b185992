"""Attention for prefill: the chunked online softmax of the JAX package's
``layers/attention.py``, forward only.

``chunked_attention`` goes through ``kernels.flash_attention.ops``: on a
CUDA tensor it launches the Hopper flash kernel (and raises for what the
kernel does not take: ``q_offset != 0`` or ``kv_valid_len``); on a CPU
tensor it runs the plain chunked scan with ``chunk = spec.chunk``, q scaled
in f32 and cast back to q's dtype first.  GQA reads KV head
``h // (H / Hkv)``; KV heads are never repeated in memory.  The backward
(training) and ``decode_attention`` come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.flash_attention import ops as flash_ops


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: int = 0          # >0: sliding window (only last `window` keys)
    logit_cap: float = 0.0   # >0: tanh soft-cap
    chunk: int = 512         # KV chunk length of the plain online-softmax scan


def chunked_attention(
    q: torch.Tensor,                 # (B, Sq, H, D)
    k: torch.Tensor,                 # (B, Sk, Hkv, D)
    v: torch.Tensor,                 # (B, Sk, Hkv, D)
    spec: AttnSpec,
    q_offset: int = 0,               # absolute position of q[0]
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,) valid prefix of k/v
) -> torch.Tensor:
    """Flash attention forward.  Returns (B, Sq, H, D) in q's dtype."""
    return flash_ops.flash_attention(
        q, k, v, spec.causal, spec.window, spec.logit_cap, chunk=spec.chunk,
        q_offset=q_offset, kv_valid_len=kv_valid_len)
