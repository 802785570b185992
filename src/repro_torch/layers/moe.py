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
from torch.distributed.tensor import Partial

from ..dist.context import act_placements, constrain, dtensor_mesh, local_region, shard_start
from .common import _activate, _mm_f32


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
    counts: torch.Tensor   # f32 (E,): token-choices of each expert
    psum: torch.Tensor     # f32 (E,): router probabilities summed over tokens


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
    counts = onehot.sum(2).reshape(-1, E).float().sum(0)
    psum = probs.reshape(-1, E).sum(0)
    return Routing(order, slot.long(), slot < cap, gate,
                   load_balance(counts, psum, G * Tg, spec), counts, psum)


def load_balance(counts: torch.Tensor, psum: torch.Tensor, tokens: int,
                 spec: MoESpec) -> torch.Tensor:
    """The Switch-style load-balance loss over ``tokens`` tokens:
    E * sum(fraction of choices x mean probability) / k."""
    return spec.num_experts * torch.sum((counts / tokens) * (psum / tokens)) / spec.top_k


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
    resets it to 0).

    On DTensors the two parts run on the local shards (``local_region``),
    the token groups on the data-parallel axes ("batch", as the reference
    pins them): the routing with every expert, replicated on "model"; the
    experts split on "model" where the expert count divides it, each shard
    running its own experts on every token and the partial sums formed and
    added in f32, rounded once to x's dtype (``_experts``).
    The load-balance loss takes its counts over the whole batch."""
    B, S, D = x.shape
    Tg = min(spec.group_size, S)
    if S % Tg:
        raise ValueError(f"moe_ffn: sequence length {S} is not a multiple of the "
                         f"routing group {Tg}")
    G = B * (S // Tg)
    cap = capacity(spec, Tg)
    grid = constrain(x, "batch", None, None).reshape(G, Tg, D)
    xt = constrain(grid, "batch", None, None)
    mesh = dtensor_mesh(xt, gate_w, w_gate)
    place = (lambda shape, *axes: None) if mesh is None else (
        lambda shape, *axes: act_placements(mesh, shape, *axes))
    pg = place(xt.shape, "batch", None, None)
    pr = place((G, Tg, spec.top_k), "batch", None, None)
    # the experts' counts are sums over the local groups: added over the
    # data-parallel axes where the groups are split there
    pc = None if mesh is None else tuple(Partial() if p.is_shard() else p for p in pg)
    expert, slot, keep, gate, counts, psum = local_region(
        lambda xt, gw: _route(xt, gw, spec, cap), (xt, gate_w),
        (pg, place(gate_w.shape, None, None)), (pr, pr, pr, pr, pc, pc))
    pe = place(w_gate.shape, "model", None, None)
    e0 = 0 if mesh is None else shard_start(mesh, pe, 0, spec.num_experts)[0]
    py = None if mesh is None else tuple(Partial() if pl.is_shard() else q
                                         for pl, q in zip(pe, pg))
    split = py is not None and any(p.is_partial() for p in py)
    y = local_region(lambda *a: _experts(*a, spec, cap, e0, split),
                     (xt, expert, slot, keep, gate, w_gate, w_up, w_down),
                     (pg, pr, pr, pr, pr, pe, pe, pe), py)
    if mesh is not None:  # back to x's layout: groups split where rows are not
        y = y.redistribute(mesh, grid.placements).to(x.dtype)
    return y.reshape(B, S, D), load_balance(counts, psum, G * Tg, spec)


def _route(xt: torch.Tensor, gate_w: torch.Tensor, spec: MoESpec, cap: int):
    """Routing of a (G, Tg, D) token grid over every expert: (expert, slot,
    keep, gate) (G, Tg, k) each, and the experts' choice counts and summed
    probabilities (E,)."""
    G, Tg, D = xt.shape
    r = route_group((xt.reshape(G * Tg, D) @ gate_w).reshape(G, Tg, -1), spec, cap)
    moe_ffn.dropped = moe_ffn.dropped + (~r.keep).sum()
    return r.expert, r.slot, r.keep, r.gate, r.counts, r.psum


def _experts(xt, expert, slot, keep, gate, w_gate, w_up, w_down, spec: MoESpec,
             cap: int, e0: int, partial: bool = False) -> torch.Tensor:
    """The FFN of experts ``e0 .. e0 + w_gate.shape[0]`` on a (G, Tg, D)
    token grid routed by ``_route``: each token's weighted sum of the rows
    those experts give it, (G, Tg, D) in xt's dtype, or in f32 where it is
    one shard's ``partial`` sum: the k weighted rows are then added in f32,
    so that the shards' partials, added in f32 and rounded once, give what
    one card's single product over the k rows gives (DTensor would round
    each partial to x's dtype and add them in it)."""
    G, Tg, D = xt.shape
    k = spec.top_k
    El = w_gate.shape[0]
    mine = keep & (expert >= e0) & (expert < e0 + El)
    # Row of each kept choice in the flat (El, G, cap) buffer; dropped
    # choices go to one spare row past the end, which is never read.
    group = torch.arange(G, device=xt.device)[:, None, None]
    dest = ((expert - e0) * G + group) * cap + slot
    dest = torch.where(mine, dest, El * G * cap).reshape(G * Tg, k)
    flat = xt.reshape(G * Tg, D)
    buf = flat.new_zeros((El * G * cap + 1, D))
    buf[dest] = flat[:, None].expand(G * Tg, k, D)
    xe = buf[:-1].view(El, G * cap, D)
    h = _activate(torch.bmm(xe, w_gate), spec.act) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down).view(El * G * cap, D)
    # The combine weights rounded to x's dtype, as the reference's einsum
    # takes them; a dropped choice weighs 0 (its row index is any valid one).
    w = torch.where(mine, gate, 0.0).to(xt.dtype).reshape(G * Tg, 1, k)
    rows = ye[torch.where(mine.reshape(G * Tg, k), dest, 0)]     # (G*Tg,k,D)
    if partial:  # the k products summed in f32, no (G*Tg, k, D) f32 copy on the card
        return _mm_f32(w, rows).reshape(G, Tg, D)
    return torch.bmm(w, rows).reshape(G, Tg, D)


moe_ffn.dropped = 0
