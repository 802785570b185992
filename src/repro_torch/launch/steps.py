"""Step programs: one (arch x shape x mesh) cell -> a step function, its
arguments as meta tensors and their DTensor placements (the JAX package's
``launch/steps.py``).

``train_step`` is the body of the reference's train program: f32 masters
are cast to bf16 inside the autograd graph, so the bf16 compute's gradients
land in f32 on the masters; the batch is split into
``cfg.train_microbatches`` microbatches (one when the batch rows do not
divide) whose gradients are summed in f32 and averaged, pinned to the
parameters' placements, then ``apply_updates``.  On plain tensors it is
the one-device step.

``CellProgram`` is the reference's jitted program with its shardings:
``run`` lays each input out on the mesh (``distribute_tensor``, or a
redistribution of a DTensor) and calls the step inside the mesh's context
(``constrain`` active; a plain tensor meeting a DTensor is taken as
replicated), so the model runs on DTensors: parameters FSDP on "data" and
tensor-parallel on "model", batches on the data-parallel axes, the parts
without a sharding rule on local shards (``dist.context.local_region``).
The dry run (``launch/dryrun.py``) runs the same step on fake tensors.

A serving program whose rows divide "data" but not "pod" x "data" runs on
the pod-local submesh (``serving_mesh``): each pod runs the single-pod
program on its own copy of the rows, "pod" only replicates, and the rows
split over "data" where the whole mesh would replicate them.  The plan
itself (``dist/sharding.py``) is not changed: the choice is the program's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..dist.context import is_dtensor, mesh_axes, mesh_context, to_placements
from ..dist.sharding import (batch_spec, cache_pspecs, input_pspecs,
                             param_shardings)
from ..models import lm
from ..models.base import ShapeCell, input_specs
from ..models.config import ModelConfig
from ..models.encdec import build_encdec_specs, encdec_loss, encdec_prefill
from ..models.params import Specs, shape_structs
from ..train.optimizer import (AdamWConfig, TrainState, apply_updates, cast_params,
                               state_shape_structs)


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
        mb = batch if nmicro == 1 else {k: _microbatch(v, i, size) for k, v in batch.items()}
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
    grads = {k: _placed_like(g, state.params[k]) for k, g in grads.items()}
    new_state, opt_metrics = apply_updates(state, grads, adamw)
    out = {"loss": loss_sum / nmicro,
           **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
    return new_state, out


def _microbatch(v: torch.Tensor, i: int, size: int) -> torch.Tensor:
    """Rows ``i*size .. (i+1)*size`` of a batch leaf; a DTensor's are put
    back on the data-parallel axes (the reference's constraint on its
    microbatch reshape)."""
    x = v[i * size:(i + 1) * size]
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          to_placements(batch_spec(x.device_mesh, size, x.ndim), x.device_mesh))


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient laid out as its parameter (a no-op off a mesh)."""
    if is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ---------------------------------------------------------------------------
# Cell programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellProgram:
    """A step ``fn`` with its arguments as meta tensors (``args``), their
    placements on ``mesh`` (``in_placements``, pytrees matching ``args``;
    None for a leaf that stays as it is) and the placements its outputs
    are laid out with (``out_placements``; None where the step decides)."""
    fn: Callable
    args: Tuple[Any, ...]
    in_placements: Tuple[Any, ...]
    out_placements: Any
    mesh: Any

    def _place(self, t, placements):
        """A full tensor (the same on every rank) scattered, a DTensor
        redistributed, to ``placements``; anything else as it is."""
        from torch.distributed.tensor import distribute_tensor

        if placements is None or not isinstance(t, torch.Tensor):
            return t
        if is_dtensor(t):
            return t if t.placements == placements else t.redistribute(self.mesh, placements)
        return distribute_tensor(t, self.mesh, placements)

    def distribute(self, *tensors) -> Tuple[Any, ...]:
        """Each tensor leaf as a DTensor with its placements."""
        return tuple(map_placed(self._place, t, p)
                     for t, p in zip(tensors, self.in_placements))

    def run(self, *tensors):
        """``fn`` on the distributed inputs inside the mesh's context, its
        outputs laid out as ``out_placements`` say."""
        from torch.distributed.tensor.experimental import implicit_replication

        args = self.distribute(*tensors)
        with mesh_context(self.mesh), implicit_replication():
            return map_placed(self._place, self.fn(*args), self.out_placements)


def map_placed(fn, tree, placements):
    """``fn(leaf, its placements)`` over a tree of dicts and tuples (a
    ``TrainState`` too) matched with a tree of placements (None: a leaf
    without any, or a subtree left as it is); dicts keep ``tree``'s order."""
    if placements is None and isinstance(tree, (dict, tuple)):
        return tree
    if isinstance(tree, dict):
        return {k: map_placed(fn, v, placements[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and not _is_placements(placements):
        items = [map_placed(fn, a, b) for a, b in zip(tree, placements)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, placements)


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and all(hasattr(p, "is_shard") for p in x)


def _placements(specs: Dict[str, tuple], mesh) -> Dict[str, tuple]:
    return {k: to_placements(s, mesh) for k, s in specs.items()}


def _meta(structs: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Meta tensors of {name: (shape, dtype)}."""
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in structs.items()}


def build_train_program(cfg: ModelConfig, cell: ShapeCell, mesh,
                        adamw: AdamWConfig = AdamWConfig(),
                        remat: bool = True) -> CellProgram:
    """``train_step`` on DTensor state: masters and AdamW moments laid out
    as the parameters, the batch on the data-parallel axes; returns (the new
    state, metrics)."""
    specs = model_specs(cfg)
    in_structs = input_specs(cfg, cell)
    pshard = param_shardings(specs, mesh)

    def step(state: TrainState, batch):
        return train_step(cfg, state, batch, adamw, remat)

    state_shard = TrainState(params=pshard, m=dict(pshard), v=dict(pshard), step=None)
    return CellProgram(
        fn=step,
        args=(state_shape_structs(shape_structs(specs)), in_structs),
        in_placements=(state_shard, _placements(input_pspecs(in_structs, mesh), mesh)),
        out_placements=(state_shard, None),
        mesh=mesh,
    )


def serving_mesh(mesh, rows: int):
    """The mesh a serving program of ``rows`` rows runs on: ``mesh``, or,
    where the rows divide "data" but not "pod" x "data", the pod-local
    submesh of its other dims (``mesh["data", "model"]``, this rank's pod).
    There each pod runs the single-pod program on its own copy of the rows,
    which split over "data" (no ``sharding_fallback``) where the whole mesh
    would replicate them on every card."""
    axes = mesh_axes(mesh)
    if "pod" not in axes or "data" not in axes:
        return mesh
    if rows % (axes["pod"] * axes["data"]) == 0 or rows % axes["data"]:
        return mesh
    return mesh[tuple(n for n in axes if n != "pod")]


def build_prefill_program(cfg: ModelConfig, cell: ShapeCell, mesh) -> CellProgram:
    """The prompt of ``cell`` into a ``cell.seq_len`` cache: (logits, cache,
    cache_len), the cache laid out by ``cache_pspecs``; whisper through
    ``encdec_prefill``.  Runs on ``serving_mesh(mesh, cell.global_batch)``."""
    mesh = serving_mesh(mesh, cell.global_batch)
    specs = model_specs(cfg)
    in_structs = input_specs(cfg, cell)
    cache_structs = lm.cache_shape_specs(cfg, cell.global_batch, cell.seq_len)
    cache_shard = _placements(cache_pspecs(cfg, cache_structs, mesh), mesh)

    if cfg.family == "audio":
        def prefill_step(params, batch):
            logits, cache, clen, _ = encdec_prefill(
                cfg, params, batch["frames"], batch["tokens"], cell.seq_len)
            return logits, cache, clen
    else:
        def prefill_step(params, batch):
            return lm.prefill(cfg, params, batch["tokens"], cell.seq_len,
                              patches=batch.get("patches"))

    return CellProgram(
        fn=prefill_step,
        args=(shape_structs(specs), in_structs),
        in_placements=(param_shardings(specs, mesh),
                       _placements(input_pspecs(in_structs, mesh), mesh)),
        out_placements=(None, cache_shard, None),
        mesh=mesh,
    )


def build_decode_program(cfg: ModelConfig, cell: ShapeCell, mesh) -> CellProgram:
    """serve_step: one new token against a ``cell.seq_len``-deep cache,
    updated in place; returns (logits, cache).  Runs on
    ``serving_mesh(mesh, cell.global_batch)``, as the prefill that made the
    cache."""
    mesh = serving_mesh(mesh, cell.global_batch)
    specs = model_specs(cfg)
    B = cell.global_batch
    cache_structs = lm.cache_shape_specs(cfg, B, cell.seq_len)
    cache_shard = _placements(cache_pspecs(cfg, cache_structs, mesh), mesh)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    tok_shard = _placements(input_pspecs({"tokens": tokens}, mesh), mesh)["tokens"]

    def serve_step(params, cache, cache_len, tokens):
        return lm.decode_step(cfg, params, cache, cache_len, tokens)

    return CellProgram(
        fn=serve_step,
        args=(shape_structs(specs), _meta(cache_structs),
              torch.empty((), dtype=torch.int32, device="meta"), tokens),
        in_placements=(param_shardings(specs, mesh), cache_shard, None, tok_shard),
        out_placements=(None, cache_shard),
        mesh=mesh,
    )


def build_cell_program(cfg: ModelConfig, cell: ShapeCell, mesh, **kw) -> CellProgram:
    if cell.kind == "train":
        return build_train_program(cfg, cell, mesh, **kw)
    if cell.kind == "prefill":
        return build_prefill_program(cfg, cell, mesh)
    if cell.kind == "decode":
        return build_decode_program(cfg, cell, mesh)
    raise ValueError(cell.kind)
