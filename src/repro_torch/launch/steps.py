"""The train step: the body of the JAX package's ``build_train_program``
(``src/repro/launch/steps.py:88-151``) for one device, in PyTorch.

f32 masters are cast to bf16 inside the autograd graph, so the bf16
compute's gradients land in f32 on the masters; the batch is split into
``cfg.train_microbatches`` microbatches (one when the batch rows do not
divide) whose gradients are summed in f32 and averaged; then
``apply_updates``.  The reference's ``CellProgram``, shardings and
prefill/decode programs are bound to XLA and have no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..models.encdec import build_encdec_specs, encdec_loss
from ..models.params import Specs
from ..train.optimizer import AdamWConfig, TrainState, apply_updates, cast_params


def model_specs(cfg: ModelConfig) -> Specs:
    return build_encdec_specs(cfg) if cfg.family == "audio" else lm.build_specs(cfg)


def loss_fn_for(cfg: ModelConfig) -> Callable:
    return encdec_loss if cfg.family == "audio" else lm.lm_loss


def train_step(cfg: ModelConfig, state: TrainState, batch: Dict[str, torch.Tensor],
               adamw: AdamWConfig = AdamWConfig(), remat: bool = True
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``batch`` (tensors on the state's device).
    Returns (the new state, {"loss", the loss function's metrics of the last
    microbatch, "grad_norm", "lr"}), every metric a 0-d tensor."""
    loss_fn = loss_fn_for(cfg)
    rows = next(iter(batch.values())).shape[0]
    nmicro = max(cfg.train_microbatches, 1)
    if rows % nmicro:
        nmicro = 1
    masters = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    grads = None
    loss_sum = 0.0
    size = rows // nmicro
    for i in range(nmicro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, metrics = loss_fn(cfg, cast_params(masters),
                                mb, remat=remat)
        loss.backward()
        g = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in masters.items()}
        for v in masters.values():
            v.grad = None
        grads = g if grads is None else {k: grads[k] + g[k] for k in grads}
        loss_sum = loss_sum + loss.detach()
    if nmicro > 1:
        grads = {k: g / nmicro for k, g in grads.items()}
    new_state, opt_metrics = apply_updates(state, grads, adamw)
    out = {"loss": loss_sum / nmicro,
           **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
    return new_state, out
