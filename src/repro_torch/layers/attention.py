"""Attention for training, prefill and decode: the chunked online softmax
with its custom backward, and the single-step decode attention of the JAX
package's ``layers/attention.py``.

``chunked_attention`` goes through ``kernels.flash_attention.ops``: on a
CUDA tensor it launches the Hopper flash kernel (``q_offset`` and
``kv_valid_len`` included); on a CPU tensor it runs the plain chunked scan
with ``chunk = spec.chunk``, q scaled in f32 and cast back to q's dtype
first.  When a gradient is wanted (grad mode on, q, k or v requiring it,
no ``kv_valid_len``, as the reference differentiates only that call) it
runs as ``_Flash``, the counterpart of the reference's ``_flash`` custom
VJP: the forward is the same op asked for each row's log-sum-exp as well,
and the backward is ``flash_bwd``, the reference's ``_flash_bwd`` in
PyTorch ops on both devices (the JAX package has no Pallas backward
kernel).  Under ``torch.inference_mode()`` or ``torch.no_grad()`` (prefill,
decode) nothing of that runs: the forward-only call, no lse.
``decode_attention`` is one query token over a KV cache, in plain PyTorch
on both devices, as the reference computes it outside any Pallas kernel.
GQA reads KV head ``h // (H / Hkv)``; KV heads are never repeated in
memory.  On DTensors both run on the local shards (``local_region``): batch
on the data-parallel axes, heads on "model" only where the KV heads divide
it (sharding q's heads alone would break the local head-to-KV map).  Where
they do not, a differentiated ``chunked_attention`` splits the query rows
on "model" instead, as the reference stores ``_flash_fwd``'s residuals on
"seq_model": each rank runs ``_Flash`` on its contiguous block of rows at
its own ``q_offset`` over the whole k and v (``_row_split``), so q, the
output and the lse are kept split and dk, dv come back as each rank's
partial sums.  Serving (no grad, or a ``kv_valid_len``) keeps the whole
core on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from ..dist.context import (act_placements, dtensor_mesh, local_region, mesh_axes,
                            shard_start)
from ..kernels import is_fake
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import NEG_INF


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: int = 0          # >0: sliding window (only last `window` keys)
    logit_cap: float = 0.0   # >0: tanh soft-cap
    chunk: int = 512         # KV chunk length of the plain online-softmax scan


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """(Sq, C) additive f32 bias: 0 where the causal and window masks let a
    key through, ``NEG_INF`` elsewhere (the reference's ``_mask_bias``; a
    chunk here holds only keys that exist, so there is no padding term)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if spec.causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if spec.window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - spec.window
    return torch.where(ok, 0.0, NEG_INF)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a leading batch dim with an f32 result, the products
    and their sums taken in f32, as the reference's einsums with
    ``preferred_element_type=float32`` form them: bf16 operands on the card
    (and fake ones, which stand for the card's in the dry run) go to the
    tensor cores with f32 accumulation (``out_dtype``); elsewhere the
    operands are widened to f32 first (exact for bf16)."""
    if (a.is_cuda or is_fake(a)) and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, do: torch.Tensor, spec: AttnSpec, q_offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``chunked_attention`` from its inputs,
    its output ``o``, each row's log-sum-exp ``lse`` (B, H, Sq) and the
    output's gradient ``do``: the reference's ``_flash_bwd``
    (``src/repro/layers/attention.py:137``) with its roundings, over key
    chunks of ``spec.chunk``.  Every product has an f32 result
    (``_bmm_f32``): s from the unscaled q times 1/sqrt(D), p cast to do's
    dtype before dV, ds to k's and q's dtypes before dQ and dK,
    ``delta = rowsum(dO O)`` in f32, dQ summed in f32 over the chunks; dK
    and dV are summed over a KV head's g query heads by the contraction.
    A chunk takes only the query rows that the causal and window masks let
    see one of its keys: the others have p = 0 exactly.  Each gradient is
    returned in its input's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    C = min(spec.chunk, Sk)

    # (B, S, Hkv, ...) -> (B * Hkv, S * ..., ...): one batch entry a KV head,
    # its g query heads beside each query row.
    def rows(t):
        return t.reshape(B, Sq, Hkv, g, D).transpose(1, 2).reshape(B * Hkv, Sq * g, D)

    def keys(t):
        return t.transpose(1, 2).reshape(B * Hkv, Sk, D)

    qr, dor, kr, vr = rows(q), rows(do), keys(k), keys(v)
    delta = (dor.float() * rows(o).float()).sum(-1)                      # (BK, Sq*g)
    lse = lse.reshape(B, Hkv, g, Sq).transpose(2, 3).reshape(B * Hkv, Sq * g)
    pos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros((B * Hkv, Sq * g, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B * Hkv, Sk, D), dtype=k.dtype, device=q.device)
    dv = torch.zeros((B * Hkv, Sk, D), dtype=v.dtype, device=q.device)
    for c0 in range(0, Sk, C):
        c1 = min(c0 + C, Sk)
        r0 = max(0, c0 - q_offset) if spec.causal else 0
        r1 = min(Sq, c1 - 1 + spec.window - q_offset) if spec.window > 0 else Sq
        if r1 <= r0:
            continue
        a, b = r0 * g, r1 * g
        kch, vch = kr[:, c0:c1], vr[:, c0:c1]
        s = _bmm_f32(qr[:, a:b], kch.transpose(1, 2)) * scale           # (BK, n*g, c)
        dcap = None
        if spec.logit_cap > 0:
            t = torch.tanh(s / spec.logit_cap)
            s = spec.logit_cap * t
            dcap = 1.0 - t.square()         # d(cap)/d(s)
        bias = _mask_bias(pos[r0:r1].repeat_interleave(g),
                          torch.arange(c0, c1, device=q.device), spec)
        p = torch.exp(s + bias - lse[:, a:b, None])
        del s
        dp = _bmm_f32(dor[:, a:b], vch.transpose(1, 2))
        dv[:, c0:c1] = _bmm_f32(p.to(do.dtype).transpose(1, 2), dor[:, a:b]).to(v.dtype)
        ds = p * (dp - delta[:, a:b, None])
        del p, dp
        if dcap is not None:
            ds = ds * dcap
        ds = ds * scale
        dq[:, a:b] += _bmm_f32(ds.to(k.dtype), kch)
        dk[:, c0:c1] = _bmm_f32(ds.to(q.dtype).transpose(1, 2), qr[:, a:b]).to(k.dtype)
    dq = dq.reshape(B, Hkv, Sq, g, D).transpose(1, 2).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.reshape(B, Hkv, Sk, D).transpose(1, 2),
            dv.reshape(B, Hkv, Sk, D).transpose(1, 2))


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's recompute-in-backward VJP
    (``_flash``/``_flash_fwd``/``_flash_bwd``): the forward (the kernel on
    the card, the plain scan on the CPU) also returns each row's
    log-sum-exp; q, k, v, the output and the lse are saved, never a
    (Sq, Sk) tensor, and ``flash_bwd`` recomputes p chunk by chunk."""

    @staticmethod
    def forward(ctx, q, k, v, spec: AttnSpec, q_offset: int):
        out, lse = flash_ops.flash_attention(
            q, k, v, spec.causal, spec.window, spec.logit_cap, chunk=spec.chunk,
            q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec, ctx.q_offset = spec, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, ctx.spec, ctx.q_offset)
        return dq, dk, dv, None, None


def _core_placements(mesh, q: torch.Tensor, k: torch.Tensor) -> tuple:
    """(q's, k's and v's) placements for the attention core."""
    heads = "model" if k.shape[2] % mesh_axes(mesh).get("model", 1) == 0 else None
    return (act_placements(mesh, q.shape, "batch", None, heads, None),
            act_placements(mesh, k.shape, "batch", None, heads, None))


def row_split_applies(model: int, kv_heads: int, sq: int) -> bool:
    """Whether a differentiated core on a mesh whose "model" axis has
    ``model`` ranks splits its ``sq`` query rows on "model" (``_row_split``):
    the KV heads do not divide "model" and the rows do."""
    return model > 1 and kv_heads % model != 0 and sq % model == 0


def _wants_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def _row_split(mesh, q, k, v, spec: AttnSpec, q_offset: int):
    """``_Flash`` with q's rows split on "model" (the output laid out the
    same way), k and v whole on every "model" rank: each rank's rows
    ``[r0, r0 + Sq / M)`` see their keys at ``q_offset + r0``."""
    pq = act_placements(mesh, q.shape, "batch", "seq_model", None, None)
    pk = act_placements(mesh, k.shape, "batch", None, None, None)
    r0, _ = shard_start(mesh, pq, 1, q.shape[1])
    return local_region(lambda ql, kl, vl: _Flash.apply(ql, kl, vl, spec, q_offset + r0),
                        (q, k, v), (pq, pk, pk), pq)


def chunked_attention(
    q: torch.Tensor,                 # (B, Sq, H, D)
    k: torch.Tensor,                 # (B, Sk, Hkv, D)
    v: torch.Tensor,                 # (B, Sk, Hkv, D)
    spec: AttnSpec,
    q_offset: int = 0,               # absolute position of q[0]
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,) valid prefix of k/v
) -> torch.Tensor:
    """Flash attention.  Returns (B, Sq, H, D) in q's dtype.  Differentiable
    (through ``_Flash``) when ``kv_valid_len`` is None, as in the reference,
    which masks valid lengths only on paths it does not differentiate
    (on the CPU autograd runs through the plain scan; on the card that
    raises, since the kernel's output would carry no history)."""
    mesh = dtensor_mesh(q, k, v)
    if mesh is not None:
        if (row_split_applies(mesh_axes(mesh).get("model", 1), k.shape[2], q.shape[1])
                and kv_valid_len is None and _wants_grad(q, k, v)):
            return _row_split(mesh, q, k, v, spec, q_offset)
        pq, pk = _core_placements(mesh, q, k)
        pb = act_placements(mesh, q.shape[:1], "batch")
        return local_region(chunked_attention, (q, k, v, spec, q_offset, kv_valid_len),
                            (pq, pk, pk, None, None, pb), pq)
    if _wants_grad(q, k, v):
        if kv_valid_len is None:
            return _Flash.apply(q, k, v, spec, q_offset)
        if q.device.type == "cuda":
            raise NotImplementedError("chunked_attention: kv_valid_len has no backward "
                                      "on the card")
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
    mesh = dtensor_mesh(q, k_cache, v_cache)
    if mesh is not None:
        pq, pk = _core_placements(mesh, q, k_cache)
        pc = (act_placements(mesh, cache_len.shape, "batch")
              if torch.is_tensor(cache_len) else None)
        return local_region(decode_attention, (q, k_cache, v_cache, cache_len, spec),
                            (pq, pk, pk, pc, None), pq)
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
