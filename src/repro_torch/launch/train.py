"""End-to-end trainer (the JAX package's ``launch/train.py`` in
PyTorch), on the card unless ``--device cpu``:

    python -m repro_torch.launch.train --arch yi_6b --steps 50

Steps run through ``build_train_program`` on ``make_host_mesh``'s (data,
model = 1) mesh, as the reference's trainer runs its jitted program on its
host mesh: a one-rank group in this process when no launcher started it,
else the launcher's ranks, one card each:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --full --arch yi_6b

The state is a set of DTensors, drawn leaf by leaf into its shards
(``init_params_sharded``); every rank feeds the same seeded batch; only
rank 0 prints and writes checkpoints, from full tensors that every rank
gathers leaf by leaf; ``--resume`` reads the newest one on every rank.

Synthetic LM data (the reference's stream, the same arrays for the same
seed), mixed-precision AdamW, remat, checkpoints and restart (crash-safe;
``--resume`` takes the newest valid checkpoint), and the straggler bound
``--c-max`` (a step that exceeds it is logged).  ``--reduced`` (the
default) trains the config's reduced form widened as the reference widens
it (d_model 512, four units a segment, a 32,768 vocabulary: 45.6M
parameters for yi-6b); ``--full`` the published widths.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.base import ShapeCell, get_config
from ..models.params import init_params_sharded, num_params
from ..train.checkpoint import latest_valid, restore_checkpoint, save_checkpoint
from ..train.optimizer import AdamWConfig, TrainState, init_state
from .mesh import make_host_mesh
from .steps import build_train_program, model_specs


def synthetic_batches(cfg, batch: int, seq: int, seed: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM stream (zipf-ish unigram with order): the
    reference's draws, in its order, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(cfg.vocab_size, size=(batch, seq + 1), p=probs)
        b = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend == "vision":
            b["patches"] = rng.normal(
                0, 0.02, (batch, cfg.num_patches, cfg.d_model)
            ).astype(np.float32)
        if cfg.frontend == "audio":
            b["frames"] = rng.normal(
                0, 0.02, (batch, cfg.encoder_seq, cfg.d_model)
            ).astype(np.float32)
        yield b


def widened(cfg):
    """The reduced config widened as the reference's ``--reduced`` widens
    it (the reference calls it ~100M parameters)."""
    cfg = cfg.reduced()
    return dataclasses.replace(
        cfg, d_model=512,
        num_heads=8, num_kv_heads=min(8, max(cfg.num_kv_heads, 2)),
        head_dim=64, d_ff=1536 if cfg.d_ff else 0,
        lru_width=512 if cfg.lru_width else 0,
        vocab_size=32_768,
        segments=tuple(dataclasses.replace(s, num_units=4) for s in cfg.segments),
        encoder_segments=tuple(dataclasses.replace(s, num_units=4)
                               for s in cfg.encoder_segments),
    )


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (the same on every rank); a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _flat(state: TrainState, keep: bool = True) -> Dict[str, torch.Tensor]:
    """The state's leaves as full tensors on the host, gathered one at a
    time (every rank takes part in each gather; ``keep=False``: none is
    kept, for the ranks that write nothing)."""
    out = {}
    for p in ("params", "m", "v"):
        for k, v in getattr(state, p).items():
            full = _full(v)
            if keep:
                out[f"{p}/{k}"] = full.cpu()
            del full
    return out


def _unflat(flat: Dict[str, torch.Tensor], step: int) -> TrainState:
    part = {p: {k[len(p) + 1:]: v for k, v in flat.items() if k.startswith(p + "/")}
            for p in ("params", "m", "v")}
    return TrainState(part["params"], part["m"], part["v"], step)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the trainer; returns {"start_step", "losses", "checkpoints"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--c-max", type=float, default=60.0,
                    help="straggler bound: step wall-time budget (s)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = make_host_mesh(model_parallel=1, device=dev)
    if dev.type == "cuda":  # the card make_host_mesh chose for this rank
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = widened(cfg)
    specs = model_specs(cfg)
    say(f"arch={cfg.name} params={num_params(specs)/1e6:.1f}M device={dev} "
        f"ranks={dist.get_world_size()}")
    adamw = AdamWConfig(lr=args.lr, warmup_steps=20)
    prog = build_train_program(cfg, ShapeCell("example", "train", args.seq, args.batch),
                               mesh, adamw=adamw)

    start_step, state = 0, None
    if args.resume:
        ckpt = latest_valid(args.ckpt_dir)
        if ckpt is not None:
            start_step, flat, _ = restore_checkpoint(ckpt, device="cpu")
            state = _unflat(flat, start_step)
            say(f"resumed from {ckpt} at step {start_step}")
        else:
            say("no valid checkpoint found; cold start")
    if state is None:
        state = init_state(init_params_sharded(specs, 0, mesh, prog.in_placements[0].params))
    state, = prog.distribute(state)  # a host leaf to the card, one at a time

    data = synthetic_batches(cfg, args.batch, args.seq)
    losses, checkpoints = [], []
    for i in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        t0 = time.perf_counter()
        state, metrics = prog.run(state, batch)
        loss = float(_full(metrics["loss"]))  # waits for the step
        dt = time.perf_counter() - t0
        if dt > args.c_max:
            say(f"[straggler] step {i} took {dt:.1f}s > C_max "
                f"{args.c_max}s — would re-dispatch on a pod")
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i:4d} loss {loss:.4f} "
                f"gnorm {float(_full(metrics['grad_norm'])):.3f} ({dt*1e3:.0f} ms)")
        if (i + 1) % args.ckpt_every == 0 or i == args.steps - 1:
            flat = _flat(state, keep=lead)
            if lead:
                path = save_checkpoint(args.ckpt_dir, i + 1, flat, extra={"loss": loss})
                checkpoints.append(path)
                say(f"checkpoint -> {path}")
            del flat
    if losses:
        first, last = losses[0], losses[-1]
        say(f"loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})")
    return {"start_step": start_step, "losses": losses, "checkpoints": checkpoints}


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
