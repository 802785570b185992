"""Attention for prefill and decode: the chunked online softmax and the
single-step decode attention of the JAX package's ``layers/attention.py``,
forward only.

``chunked_attention`` goes through ``kernels.flash_attention.ops``: on a
CUDA tensor it launches the Hopper flash kernel (``q_offset`` and
``kv_valid_len`` included); on a CPU tensor it runs the plain chunked scan
with ``chunk = spec.chunk``, q scaled in f32 and cast back to q's dtype
first.  ``decode_attention`` is one query token over a KV cache, in plain
PyTorch on both devices, as the reference computes it outside any Pallas
kernel.  GQA reads KV head ``h // (H / Hkv)``; KV heads are never repeated
in memory.  The backward (training) comes with a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import NEG_INF


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


def decode_attention(
    q: torch.Tensor,                 # (B, 1, H, D): one new token
    k_cache: torch.Tensor,           # (B, S, Hkv, D)
    v_cache: torch.Tensor,           # (B, S, Hkv, D)
    cache_len: Union[int, torch.Tensor],  # (B,) or scalar: valid cache slots
    spec: AttnSpec,
) -> torch.Tensor:
    """Single-step attention over a KV cache: slot ``s`` is live when
    ``s < cache_len`` (and ``s >= cache_len - window`` with a window).
    Logits in f32; q scaled in f32 and cast back, p cast to v's dtype
    before P·V, as the reference does.  Returns (B, 1, H, D) in q's dtype."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = (q.float() * scale).to(q.dtype).reshape(B, Hkv, g, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())  # (B,Hkv,g,S)
    if spec.logit_cap > 0:
        s = spec.logit_cap * torch.tanh(s / spec.logit_cap)
    pos = torch.arange(S, device=q.device)[None, :]                    # (1,S)
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)  # (B,1)|(1,1)
    ok = pos < clen
    if spec.window > 0:
        ok = ok & (pos >= clen - spec.window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
