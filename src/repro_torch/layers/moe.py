"""Mixture-of-Experts with token-choice top-k routing (the JAX package's
``layers/moe.py``), in index form.

Tokens are routed in GROUPS of ``Tg = min(group_size, S)`` (a batch row is
split into sequence chunks), with ``cap = max(k Tg capacity_factor / E, 4)``
slots an expert and group, rounded up to 8.  Within a group the
token-choices take slots in (token, choice) order; a choice at or past
``cap`` is dropped.  The reference builds one-hot dispatch and combine
tensors (G, Tg, E, cap) and contracts them on the MXU; here the same
routing is kept as indices: the kept tokens are gathered into (E, G, cap,
D) expert buffers (empty slots zero), the expert FFN runs as one batched
product an expert, and each token sums its k weighted rows back.  The
routing is identical and exact, ties included (``route_group``).

Used by olmoe-1b-7b (64 experts, top-8) and mixtral-8x22b (8 experts, top-2).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .common import _activate


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"
    renormalize: bool = True   # mixtral/olmoe renormalize top-k gates
    group_size: int = 2048     # tokens per dispatch group


class Routing(NamedTuple):
    """Each token-choice of a (G, Tg) token grid, (G, Tg, k) each."""
    expert: torch.Tensor   # int64 expert index, choice 0 the most probable
    slot: torch.Tensor     # int64 slot in the expert's buffer of the group
    keep: torch.Tensor     # bool: slot < cap (False: dropped by capacity)
    gate: torch.Tensor     # f32 gate value (renormalised over the k)
    aux: torch.Tensor      # f32 scalar: the Switch load-balance loss


def capacity(spec: MoESpec, tokens_per_group: int) -> int:
    """Slots an expert and group: ``max(k Tg cf / E, 4)`` rounded up to 8."""
    cap = int(max(spec.top_k * tokens_per_group * spec.capacity_factor
                  / spec.num_experts, 4))
    return -(-cap // 8) * 8


def route_group(gate_logits: torch.Tensor, spec: MoESpec, cap: int) -> Routing:
    """Top-k routing within token groups.  gate_logits: (G, Tg, E).

    Softmax in f32; the top k by a stable descending sort, so that among
    equal probabilities the lower expert index comes first (as
    ``jax.lax.top_k``); a choice's slot is the number of earlier
    choices of the group, in (token, choice) order, for the same expert."""
    G, Tg, E = gate_logits.shape
    k = spec.top_k
    probs = torch.softmax(gate_logits.float(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    gate = torch.gather(probs, -1, order)                          # (G,Tg,k)
    if spec.renormalize:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(order, E).to(torch.int32)                   # (G,Tg,k,E)
    flat = onehot.reshape(G, Tg * k, E)
    prior = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat    # earlier choices
    slot = torch.gather(prior, -1, order.reshape(G, Tg * k, 1)).reshape(G, Tg, k)
    # Switch-style load-balance aux loss, over all tokens.
    frac_tokens = onehot.sum(2).reshape(-1, E).float().mean(0)
    frac_probs = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs) / k
    return Routing(order, slot.long(), slot < cap, gate, aux)


def moe_ffn(
    x: torch.Tensor,          # (B, S, D)
    gate_w: torch.Tensor,     # (D, E) router
    w_gate: torch.Tensor,     # (E, D, F) expert gate proj
    w_up: torch.Tensor,       # (E, D, F)
    w_down: torch.Tensor,     # (E, F, D)
    spec: MoESpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, D) in x's dtype, aux_loss).  ``moe_ffn.dropped``
    adds up the token-choices dropped by capacity over calls (a tensor on
    x's device, read without a sync until the caller reads it; the caller
    resets it to 0)."""
    B, S, D = x.shape
    Tg = min(spec.group_size, S)
    if S % Tg:
        raise ValueError(f"moe_ffn: sequence length {S} is not a multiple of the "
                         f"routing group {Tg}")
    G = B * (S // Tg)
    E, k = spec.num_experts, spec.top_k
    cap = capacity(spec, Tg)
    xt = x.reshape(G * Tg, D)
    r = route_group((xt @ gate_w).reshape(G, Tg, E), spec, cap)
    moe_ffn.dropped = moe_ffn.dropped + (~r.keep).sum()
    # Row of each kept choice in the flat (E, G, cap) buffer; dropped
    # choices go to one spare row past the end, which is never read.
    group = torch.arange(G, device=x.device)[:, None, None]
    dest = (r.expert * G + group) * cap + r.slot
    dest = torch.where(r.keep, dest, E * G * cap).reshape(G * Tg, k)
    buf = x.new_zeros((E * G * cap + 1, D))
    buf[dest] = xt[:, None].expand(G * Tg, k, D)
    xe = buf[:-1].view(E, G * cap, D)
    h = _activate(torch.bmm(xe, w_gate), spec.act) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down).view(E * G * cap, D)
    # The combine weights rounded to x's dtype, as the reference's einsum
    # takes them; a dropped choice weighs 0 (its row index is any valid one).
    w = torch.where(r.keep, r.gate, 0.0).to(x.dtype).reshape(G * Tg, 1, k)
    rows = ye[torch.where(r.keep.reshape(G * Tg, k), dest, 0)]        # (G*Tg,k,D)
    y = torch.bmm(w, rows)                                         # (G*Tg,1,D)
    return y.reshape(B, S, D), r.aux


moe_ffn.dropped = 0
