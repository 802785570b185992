#!/usr/bin/env python3
"""How far one card's own training steps part when only the gradient's
summation grouping changes: ``train_step`` against ``train_step`` with the
batch in ``--micro`` microbatches (a (4, 1) mesh's grouping), step by step,
on yi-6b at full width and 8 of 32 layers, B 4 x S 2,048 (phase 21a's
cell), from the seeded init and from a copy with wq and wk divided by 16
(``chip_smoke.py`` phase 19b's tempering).

    python3 scripts/torch_train_floor.py            # ~75 s on one H100

Each step prints both losses, how many of the 36 state leaves (masters,
AdamW moments) part by more than 2e-2 relative L2, the worst leaves, and
the sign flips of the zero-initialised norm gains.  Both states stay on
the card (2 x 23 GB).
"""
import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_floor: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.base import get_config
    from repro_torch.models.config import Segment
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("yi_6b")
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, 8),))
    grouped = dataclasses.replace(cfg, train_microbatches=args.micro)
    specs = steps.model_specs(cfg)
    data = synthetic_batches(cfg, 4, 2048, seed=22)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
               for _ in range(args.steps)]

    def fresh(temper: float):
        p = init_params(specs, 22, device="cuda")
        return init_state({k: (v.float() / temper).to(v.dtype)
                           if k.endswith(("/wq", "/wk")) else v for k, v in p.items()})

    def leaves(state):
        return {f"{q}/{k}": v for q in ("params", "m", "v")
                for k, v in getattr(state, q).items()}

    print(torch.cuda.get_device_name(0), flush=True)
    for temper in (1.0, 16.0):
        one, many = fresh(temper), fresh(temper)
        for t, batch in enumerate(batches):
            one, m1 = steps.train_step(cfg, one, batch, AdamWConfig())
            many, m2 = steps.train_step(grouped, many, batch, AdamWConfig())
            a, b = leaves(one), leaves(many)
            errs = sorted((float((b[k] - a[k]).norm() / a[k].norm().clamp(min=1e-30)), k)
                          for k in a)[::-1]
            flips = sum(int(((a[k] > 0) != (b[k] > 0)).sum()) for k in a
                        if k.startswith("params/") and k.endswith("norm"))
            print(f"wq, wk / {temper:g}, step {t + 1}: loss {m1['loss'].item():.6f} / "
                  f"{m2['loss'].item():.6f}; {sum(e > 2e-2 for e, _ in errs)} of {len(a)} "
                  f"leaves above 2e-2; worst {[(k, round(e, 4)) for e, k in errs[:4]]}; "
                  f"norm sign flips {flips}", flush=True)
        del one, many, a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
