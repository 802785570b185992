"""Plain PyTorch versions of the flash-attention forward.

* ``attention_ref``: the materialised masked softmax (S x S; fine at test
  sizes), a copy of the JAX package's oracle, in its (B, H, S, D) layout.
* ``chunked_attention_ref``: the kernel's plain version, in the model's
  (B, S, H, D) layout: the online softmax over KV chunks of the JAX layer
  (``repro/layers/attention.py`` ``_fwd_scan``), with q scaled in f32 and
  cast back to q's dtype first and p cast to v's dtype before ``p @ v``.
  It never materialises Sq x Sk, only (Sq x chunk) per step.  With
  ``return_lse`` it also returns each row's log-sum-exp, the residual of
  the JAX layer's ``_flash_fwd``.
* ``chunked_attention_f32_ref``: the standard the kernel is held to: the
  plain version in f32 but for the one rounding that the kernel shares
  with the JAX layer, q/sqrt(D) rounded to q's dtype; k, v and p stay f32,
  so the kernel's own bf16 roundings count against the tolerance.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30  # finite, bf16-safe sentinel (avoids NaN from inf-inf)


def attention_ref(q, k, v, causal=True, window=0, logit_cap=0.0, seq_k=-1):
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    seq_k = Sk if seq_k < 0 else seq_k
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = k_pos < seq_k
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window > 0:
        ok = ok & (k_pos > q_pos - window)
    s = s.masked_fill(~ok[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          logit_cap: float = 0.0, chunk: int = 256,
                          q_offset: int = 0,
                          kv_valid_len: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None, return_lse: bool = False):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (B,Sq,H,D) in q's dtype.
    ``q_offset`` is the absolute position of q[0]; ``kv_valid_len`` (B,)
    masks keys at or past each row's valid length; ``scale`` multiplies q
    (1/sqrt(D) when None).  With ``return_lse`` returns (out, lse): lse
    (B, H, Sq) f32, ``m + log(max(l, 1e-20))`` as ``_flash_fwd`` keeps it,
    H in the order (Hkv, g)."""
    B, Sq, H, D = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qg = (q.float() * scale).to(q.dtype).reshape(B, Sq, Hkv, g, D)
    C = min(chunk, Sk)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, g, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=torch.float32, device=q.device)
    qf = qg.float()
    for c0 in range(0, Sk, C):
        # The last chunk is not padded: its columns are the keys that exist.
        kch, vch = k[:, c0:c0 + C], v[:, c0:c0 + C]
        k_pos = c0 + torch.arange(kch.shape[1], device=q.device)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kch.float())
        if logit_cap > 0:
            s = logit_cap * torch.tanh(s / logit_cap)
        ok = torch.ones((Sq, k_pos.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            ok &= k_pos[None, :] > q_pos[:, None] - window
        s = s + torch.where(ok, 0.0, NEG_INF)[None, None, None]
        if kv_valid_len is not None:
            bad = k_pos[None, :] >= kv_valid_len.to(q.device)[:, None]
            s = s + torch.where(bad, NEG_INF, 0.0)[:, None, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vch.dtype).float(), vch.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(torch.clamp(l, min=1e-20))).reshape(B, H, Sq)
    return out


def chunked_attention_f32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              *args, **kwargs) -> torch.Tensor:
    """``chunked_attention_ref`` in f32 on q scaled by 1/sqrt(D) in f32 and
    rounded to q's dtype (as the JAX layer and the kernel round it), with k
    and v widened to f32 and p kept in f32.  Returns f32 (and the lse with
    ``return_lse``)."""
    qs = (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype).float()
    return chunked_attention_ref(qs, k.float(), v.float(), *args, scale=1.0, **kwargs)


def rows_with_keys(B: int, Sq: int, Sk: int, causal: bool = True, window: int = 0,
                   q_offset: int = 0, kv_valid_len: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """(B, Sq) bool: the query rows that see at least one key under the
    masks.  The kernel gives the other rows zeros and the plain version a
    softmax over masked keys, so comparisons leave them out."""
    if device is None and kv_valid_len is not None:
        device = kv_valid_len.device
    pos = q_offset + torch.arange(Sq, device=device)[None, :]
    n = (torch.full((B, 1), Sk, device=device) if kv_valid_len is None
         else kv_valid_len.to(device).long().clamp(0, Sk)[:, None])
    hi = torch.minimum(n, pos + 1) if causal else n.expand(B, Sq)
    lo = (pos - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(pos)
    return hi > lo
