"""AdamW with mixed precision and global-norm clipping (the JAX package's
``train/optimizer.py`` in PyTorch).

TrainState layout (flat dicts keyed as the parameter specs):
  params : f32 master weights
  m, v   : f32 Adam moments
  step   : int, the number of updates applied

The loss casts the masters to bf16 inside the autograd graph
(``cast_params``), so compute runs in bf16 and the gradients land in f32 on
the masters.  Every tensor stays on the state's device.
``state_shape_structs`` gives the state's meta tensors for the dry run.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


class TrainState(NamedTuple):
    params: Params   # f32 masters
    m: Params
    v: Params
    step: int


def init_state(params: Params) -> TrainState:
    """f32 masters (copies of ``params``) and zero moments, at step 0."""
    f32 = {k: v.detach().float().clone() for k, v in params.items()}
    return TrainState(params=f32, m={k: torch.zeros_like(v) for k, v in f32.items()},
                      v={k: torch.zeros_like(v) for k, v in f32.items()}, step=0)


def state_shape_structs(param_structs: Params) -> TrainState:
    """The state of ``param_structs`` as meta tensors: f32 masters and
    moments of the same shapes (step 0)."""
    f32 = {k: torch.empty(s.shape, dtype=torch.float32, device="meta")
           for k, s in param_structs.items()}
    return TrainState(params=f32, m={k: torch.empty_like(v) for k, v in f32.items()},
                      v={k: torch.empty_like(v) for k, v in f32.items()}, step=0)


def cast_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    return {k: v.to(dtype) for k, v in params.items()}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps`` updates, in f32 as
    the reference rounds it; ``step`` a 0-d tensor."""
    return cfg.lr * torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)


@torch.no_grad()
def apply_updates(state: TrainState, grads: Params,
                  cfg: AdamWConfig) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW update, as the reference computes it: the global gradient
    norm is the square root of the sum of per-leaf sums of squares, the
    gradients are scaled by ``min(1, clip_norm / max(gnorm, 1e-12))``, the
    schedule and the bias corrections (in f32) use ``step + 1``, and weight
    decay applies to every leaf with ``ndim >= 2`` (matrices, and the
    reference's stacked per-layer norm gains of shape (units, D) too).

    The masters and moments are updated IN PLACE (each value formed as the
    reference forms it, then copied in): the reference's train step donates
    its state (``donate_argnums=(0,)``), and a second copy of a model's f32
    state would not fit beside the first on one card.  Returns the state at
    ``step + 1`` (a new tuple around the same tensors) and
    {"grad_norm", "lr"}."""
    gnorm = torch.sqrt(sum(_on_shards(_sum_sq, g, out=_summed(g)) for g in grads.values()))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    t = torch.tensor(step, dtype=torch.float32, device=gnorm.device)
    lr = _schedule(cfg, t)
    b1c = 1.0 - cfg.b1 ** t
    b2c = 1.0 - cfg.b2 ** t
    for k, p in state.params.items():
        _on_shards(lambda *a: _update(cfg, *a), p, state.m[k], state.v[k], grads[k],
                   scale, lr, b1c, b2c)
    return state._replace(step=step), {"grad_norm": gnorm, "lr": lr}


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    return g.float().square().sum()


def _update(cfg: AdamWConfig, p, m, v, g, scale, lr, b1c, b2c) -> torch.Tensor:
    """One leaf's AdamW update in place; returns p."""
    g = g.float() * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
    upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if p.ndim >= 2:  # decay matrices only (not norms/biases/gains)
        upd = upd + cfg.weight_decay * p
    return p.copy_(p - lr * upd)


def _summed(g: torch.Tensor):
    """The placements of a per-shard sum of DTensor ``g``: added over the
    mesh dims it is split on (None for a plain tensor)."""
    from torch.distributed.tensor import Partial, Replicate

    if not hasattr(g, "placements"):
        return None
    return tuple(Partial() if p.is_shard() else Replicate() for p in g.placements)


def _on_shards(fn, first: torch.Tensor, *rest, out=None):
    """``fn(first, *rest)``; on DTensors on each rank's local shards (every
    tensor argument laid out as ``first``, 0-d ones replicated), the result
    laid out as ``first`` or as ``out``.  Elementwise work on the local
    shards gives the same values with one DTensor rule less a leaf shape."""
    from ..dist.context import local_region

    pl = getattr(first, "placements", None)
    if pl is None:
        return fn(first, *rest)
    from torch.distributed.tensor import Replicate

    rep = (Replicate(),) * len(pl)
    args = (first, *rest)
    return local_region(fn, args, [None if not torch.is_tensor(a) else rep if a.dim() == 0
                                   else pl for a in args], out or pl)
