#!/usr/bin/env python3
"""The JAX package's own decode held against its own prefill, on the CPU,
at the teacher-forced check of ``chip_smoke.py`` phases 17 and 18: a model
at full width cut to the first ``--units`` units of segment 0 (and of
encoder segment 0), 2 rows, a prompt of P tokens drawn as the smoke draws
it (``np.random.default_rng(seed + 17)``), then 8 steps; for each step the
relative L2 distance of ``decode_step``'s logits to the last logits of a
prefill of the same P + t + 1 tokens.  It tells whether a distance the
card shows is the seeded model's (the reference shows it too) or the
port's.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/reference_decode_check.py [--port]
        # recurrentgemma-9b, 3 layers, P = 4,096, bf16
    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/reference_decode_check.py \
        --arch whisper_medium --units 2 --seq 224 --f32 --port
        # whisper-medium, 2 encoder and 2 decoder layers, 1,500 seeded frames

Weights: the JAX package's seeded init (``jax.random``; the card's seeded
init draws other numbers by the same rules), in bf16 or, with ``--f32``,
widened to f32.  ``--port`` also runs the port's plain PyTorch path on the
same weights and inputs.  Prints one line a step and a JSON line at the
end.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import encdec as JE
from repro.models import lm as JL
from repro.models.base import get_config
from repro.models.config import Segment
from repro.models.params import init_params

TF_BATCH, TF_STEPS = 2, 8


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def cut(cfg, units, Segment):
    """The first ``units`` units of segment 0 and of encoder segment 0."""
    def first(segs):
        return (Segment(segs[0].pattern, units),) if segs else ()
    return dataclasses.replace(cfg, segments=first(cfg.segments),
                               encoder_segments=first(cfg.encoder_segments))


def steps(prefill, decode_step, toks, P, label) -> list:
    """``prefill(tokens, cache_size) -> (logits, cache, cache_len)``."""
    _, cache, clen = prefill(toks[:, :P], P + TF_STEPS)
    rels = []
    for t in range(TF_STEPS):
        t0 = time.perf_counter()
        logits, cache = decode_step(cache, clen + t, toks[:, P + t:P + t + 1])
        want, _, _ = prefill(toks[:, :P + t + 1], P + t + 1)
        rels.append(rel_l2(np.asarray(logits[:, 0], np.float32), np.asarray(want, np.float32)))
        print(f"  {label} step {t}: rel L2 {rels[-1]:.4e} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return rels


def jax_steps(cfg, params, toks, P, frames) -> list:
    if frames is None:
        fn = jax.jit(JL.prefill, static_argnums=(0, 3))

        def prefill(t, n):
            return fn(cfg, params, jnp.asarray(t), n)
    else:
        fn = jax.jit(JE.encdec_prefill, static_argnums=(0, 4))
        fr = jnp.asarray(frames).astype(params["embed/tokens"].dtype)

        def prefill(t, n):
            return fn(cfg, params, fr, jnp.asarray(t), n)[:3]
    step = jax.jit(JL.decode_step, static_argnums=(0,))
    return steps(prefill, lambda c, n, t: step(cfg, params, c, n, jnp.asarray(t)), toks, P,
                 "jax ")


def port_steps(arch, units, params, toks, P, frames) -> list:
    import torch

    from repro_torch.models import encdec as TE
    from repro_torch.models import lm as TL
    from repro_torch.models.base import get_config as tget
    from repro_torch.models.config import Segment as TSegment
    from repro_torch.models.params import params_from_numpy

    cfg = cut(tget(arch), units, TSegment)
    tp = params_from_numpy({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    if frames is None:
        def prefill(t, n):
            return TL.prefill(cfg, tp, torch.from_numpy(t), n)
    else:
        fr = torch.from_numpy(frames).to(tp["embed/tokens"].dtype)
        def prefill(t, n):
            return TE.encdec_prefill(cfg, tp, fr, torch.from_numpy(t), n)[:3]
    return steps(prefill, lambda c, n, t: TL.decode_step(cfg, tp, c, n, torch.from_numpy(t)),
                 toks, P, "port")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma_9b")
    ap.add_argument("--units", type=int, default=1, help="units of segment 0 kept")
    ap.add_argument("--seq", type=int, default=4096, help="prompt length P")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32", action="store_true", help="weights widened to f32")
    ap.add_argument("--port", action="store_true", help="also the port's plain path")
    args = ap.parse_args(argv)

    cfg = cut(get_config(args.arch), args.units, Segment)
    specs = (JE.build_encdec_specs if cfg.encoder_segments else JL.build_specs)(cfg)
    t0 = time.perf_counter()
    params = init_params(specs, jax.random.PRNGKey(args.seed))
    if args.f32:
        params = {k: v.astype(jnp.float32) for k, v in params.items()}
    dtype = "f32" if args.f32 else "bf16"
    print(f"{cfg.name} cut to {args.units} unit(s) of each segment 0, {dtype} seeded init "
          f"({time.perf_counter() - t0:.1f} s); B={TF_BATCH}, P={args.seq}, {TF_STEPS} steps",
          flush=True)
    rng = np.random.default_rng(args.seed + 17)
    toks = rng.integers(0, cfg.vocab_size, (TF_BATCH, args.seq + TF_STEPS)).astype(np.int32)
    frames = None
    if cfg.encoder_segments:
        frames = np.random.default_rng(args.seed + 18).standard_normal(
            (TF_BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    out = {"arch": cfg.name, "units": args.units, "P": args.seq, "dtype": dtype,
           "jax": jax_steps(cfg, params, toks, args.seq, frames)}
    if args.port:
        out["port"] = port_steps(args.arch, args.units, params, toks, args.seq, frames)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
