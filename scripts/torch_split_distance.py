#!/usr/bin/env python3
"""Where reduced recurrentgemma-9b's (1, 2) train program parts from one
rank's ``train_step``: the program on two gloo ranks on the CPU and
``train_step`` in this process, one step of B 4 x S 32 from ``init_params``
at seed 0 (``tests/test_torch_attn_split.py``'s case), each computed in
f32 and in bf16, compared tensor by tensor.

    PYTHONPATH=src python scripts/torch_split_distance.py      # ~40 s on the CPU

Every block's intermediate tensors are tapped (the RG-LRU block's norm,
products, convolution and scan, through its callees while the model's own
block runs; the attention and MLP blocks' outputs; the final hidden state), with remat off so that each
gradient hook sits on the graph that is differentiated, and so are the
gradient leaves handed to AdamW and the state after the step.  For each
tensor the script prints the relative L2 distance of the program's value
and gradient from ``train_step``'s, in backward order for the gradients,
and the first gradient that parts by more than ``PART`` times the
distance of the one before it.  The state's distances are printed with
remat on and off (remat changes no value).  Last, the rounding floor: one
rank, no mesh, every bf16 product's input gradient formed as two products
over the halves of its weight's columns, each rounded to bf16 and added
in bf16, as two "model" ranks that split those columns hand it back.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, MP, B, S, SEED = "recurrentgemma_9b", 2, 4, 32, 0
PART = 3.0  # a gradient parts when its distance exceeds PART times the last one's
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


def _full(t: torch.Tensor) -> torch.Tensor:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float().clone()


class Taps:
    """Values tapped in the forward and their gradients, in hook order."""

    def __init__(self):
        self.values, self.grads, self.leaf_grads = {}, [], {}

    def __call__(self, name: str, t: torch.Tensor) -> torch.Tensor:
        self.values[name] = _full(t)
        if t.requires_grad:
            t.register_hook(lambda g, name=name: self.grads.append((name, g)))
        return t

    def settle(self) -> None:
        """Gradients gathered after the backward (a collective on every rank,
        in the same order)."""
        self.grads = [(n, _full(g)) for n, g in self.grads]


def install(taps: Taps) -> None:
    """Tap the reduced model's blocks and the gradients ``train_step`` hands
    to AdamW."""
    from repro_torch.launch import steps
    from repro_torch.models import lm

    products = {"w_x": "x_proj", "w_gate": "gate_pre", "w_r": "r_pre", "w_i": "i_pre",
                "w_out": "out"}

    want = {"norm_out", "conv_out", "scan_y", *products.values()}

    def rglru_block(block):
        """The model's own block, its callees tapped while it runs: the
        norm, each product (named by its weight), the convolution and the
        scan."""
        def call(cfg, p, prefix, *a, **kw):
            names = {id(p[f"{prefix}/{w}"]): n for w, n in products.items()}
            callees = {k: getattr(lm, k) for k in ("_norm", "matmul", "short_conv1d",
                                                  "rglru_scan")}
            norm, matmul, conv, scan = callees.values()
            lm._norm = lambda *b: taps(f"{prefix}/norm_out", norm(*b))
            lm.matmul = lambda x, w: (taps(f"{prefix}/{names[id(w)]}", matmul(x, w))
                                      if id(w) in names else matmul(x, w))

            def short_conv1d(*b):
                y, state = conv(*b)
                return taps(f"{prefix}/conv_out", y), state

            def rglru_scan(*b):
                y, h_last = scan(*b)
                return taps(f"{prefix}/scan_y", y), h_last

            lm.short_conv1d, lm.rglru_scan = short_conv1d, rglru_scan
            before = set(taps.values)
            try:
                out = block(cfg, p, prefix, *a, **kw)
            finally:
                for k, fn in callees.items():
                    setattr(lm, k, fn)
            missed = want - {n[len(prefix) + 1:] for n in set(taps.values) - before}
            if missed:
                raise RuntimeError(f"{prefix}: the block no longer calls what taps {missed}")
            return out
        return call

    def tapped(fn, what):
        def call(cfg, p, prefix, *a, **kw):
            out = fn(cfg, p, prefix, *a, **kw)
            x = out[0] if isinstance(out, tuple) else out
            taps(f"{prefix}/{what}", x)
            return out
        return call

    lm._rglru_block = rglru_block(lm._rglru_block)
    lm._mlp_block = tapped(lm._mlp_block, "residual_out")
    lm._self_attn_block = tapped(lm._self_attn_block, "residual_out")
    xent = lm.xent_loss
    lm.xent_loss = lambda cfg, params, hidden, *a, **kw: xent(
        cfg, params, taps("backbone_out", hidden), *a, **kw)
    apply = steps.apply_updates

    def apply_updates(state, grads, adamw):
        taps.leaf_grads = {k: _full(g) for k, g in grads.items()}
        return apply(state, grads, adamw)

    steps.apply_updates = apply_updates


class _HalvedInputGrad(torch.autograd.Function):
    """``x @ w`` whose input gradient is formed as two products over the
    halves of w's columns, each rounded to x's dtype, and their sum rounded
    again: what two "model" ranks that split the columns hand back."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        h = w.shape[1] // 2
        dx = g[..., :h] @ w[:, :h].T + g[..., h:] @ w[:, h:].T
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx, dw


def halve_input_grads() -> None:
    """One rank's every bf16 product with ``_HalvedInputGrad``: the rounding
    floor of the program's partial input gradients."""
    from repro_torch.layers import common
    from repro_torch.models import lm

    plain = common.matmul

    def matmul(x, w):
        if x.dtype == torch.bfloat16 and w.ndim == 2 and w.shape[1] % 2 == 0:
            return _HalvedInputGrad.apply(x, w)
        return plain(x, w)

    common.matmul = lm.matmul = matmul


def _setup(dtype: str):
    from repro_torch.launch import steps
    from repro_torch.train import optimizer

    if dtype == "f32":  # the masters uncast: the step computed in f32
        steps.cast_params = lambda params: optimizer.cast_params(params, torch.float32)


def _state_dict(state, metrics) -> dict:
    out = {f"{p}/{k}": _full(v) for p in ("params", "m", "v")
           for k, v in getattr(state, p).items()}
    out["loss"] = _full(metrics["loss"])
    return out


def worker(dtype: str, remat: bool, out: str) -> None:
    """One rank of the (1, MP) program (started by ``launch``)."""
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    _setup(dtype)
    taps = Taps()
    if not remat:
        install(taps)
    mesh = make_host_mesh(model_parallel=MP, device="cpu")
    cfg = get_config(ARCH).reduced()
    prog = steps.build_train_program(cfg, ShapeCell("t", "train", S, B), mesh,
                                     adamw=AdamWConfig(lr=1e-3, warmup_steps=2), remat=remat)
    state = init_state(init_params(steps.model_specs(cfg), seed=SEED, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in next(synthetic_batches(cfg, B, S)).items()}
    state, metrics = prog.run(state, batch)
    taps.settle()
    got = _state_dict(state, metrics)
    if dist.get_rank() == 0:
        torch.save({"state": got, "values": taps.values, "grads": taps.grads,
                    "leaf_grads": taps.leaf_grads}, out)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(dtype: str, remat: bool, out: str) -> dict:
    """The program on MP ranks started as a launcher starts them."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", dtype, str(int(remat)), out],
        env={**env, "RANK": str(r), "WORLD_SIZE": str(MP), "LOCAL_RANK": str(r),
             "LOCAL_WORLD_SIZE": str(MP), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(MP)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(logs)[-4000:])
    return torch.load(out)


def reference(dtype: str, remat: bool) -> dict:
    """One rank's ``train_step`` on the same seed and batch."""
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.base import get_config
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    cfg = get_config(ARCH).reduced()
    state = init_state(init_params(steps.model_specs(cfg), seed=SEED, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in next(synthetic_batches(cfg, B, S)).items()}
    state, metrics = steps.train_step(cfg, state, batch,
                                      AdamWConfig(lr=1e-3, warmup_steps=2), remat=remat)
    return {"state": _state_dict(state, metrics)}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def furthest(got: dict, want: dict, n: int = 4) -> str:
    """The ``n`` state leaves of ``got`` furthest from ``want``'s."""
    worst = sorted(((rel_l2(got[k], v), k) for k, v in want.items()), reverse=True)[:n]
    return ", ".join(f"{k} {d:.3e}" for d, k in worst)


def compare(dtype: str, tmp: str, refs: dict) -> None:
    for remat in (True, False):
        got = launch(dtype, remat, os.path.join(tmp, f"{dtype}.{int(remat)}.pt"))
        want = refs[dtype, remat]
        print(f"{dtype} remat={remat}: state leaves furthest from train_step: "
              + furthest(got["state"], want["state"]))
        if remat:
            continue
        print(f"{dtype}: forward values (relative L2 from train_step)")
        for name, v in want["values"].items():
            print(f"    {name:<32} {rel_l2(got['values'][name], v):.3e}")
        print(f"{dtype}: gradients in backward order (relative L2, ratio to the one before)")
        prev, first = None, None
        got_grads = dict(got["grads"])
        for name, w in want["grads"]:
            d = rel_l2(got_grads[name], w)
            ratio = d / prev if prev else float("nan")
            mark = ""
            if first is None and prev is not None and d > PART * prev:
                first, mark = name, "  <- parts"
            print(f"    {name:<32} {d:.3e}  x{ratio:.2f}{mark}")
            prev = max(d, 1e-30)
        print(f"{dtype}: first gradient that parts by more than x{PART}: {first}")
        print(f"{dtype}: gradient leaves handed to AdamW (relative L2, |g| rms)")
        for k, w in sorted(want["leaf_grads"].items(),
                           key=lambda kv: -rel_l2(got["leaf_grads"][kv[0]], kv[1]))[:8]:
            print(f"    {k:<32} {rel_l2(got['leaf_grads'][k], w):.3e}  "
                  f"rms {float(w.pow(2).mean().sqrt()):.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", nargs=3, metavar=("DTYPE", "REMAT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        dtype, remat, out = args.worker
        worker(dtype, bool(int(remat)), out)
        return 0
    from repro_torch.launch import steps

    cast, refs, taps = steps.cast_params, {}, Taps()
    for remat in (True, False):
        if not remat:  # taps on the graph that is differentiated
            install(taps)
        for dtype in ("f32", "bf16"):
            steps.cast_params = cast
            _setup(dtype)
            taps.__init__()
            refs[dtype, remat] = {**reference(dtype, remat), "values": dict(taps.values),
                                  "grads": list(taps.grads),
                                  "leaf_grads": dict(taps.leaf_grads)}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("f32", "bf16"):
            compare(dtype, tmp, refs)
    # the floor: one rank whose products hand back bf16 halves
    steps.cast_params = cast
    taps.__init__()
    halve_input_grads()
    floor = reference("bf16", False)
    want = refs["bf16", False]
    print("bf16, one rank with every product's input gradient in two bf16 halves, from "
          "train_step:")
    d = rel_l2(dict(taps.grads)["backbone_out"], dict(want["grads"])["backbone_out"])
    print(f"    backbone_out gradient {d:.3e}")
    print("    state leaves furthest: " + furthest(floor["state"], want["state"]))
    for k in ("v/seg0/l0/rglru/w_r", "v/seg1/l0/rglru/w_r"):
        print(f"    {k} {rel_l2(floor['state'][k], want['state'][k]):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
