"""Dynamic multi-job deadline serving with real model execution on the
PyTorch port (``repro_torch``), the twin of
``examples/multi_query_serving.py``:

three concurrent batch-inference jobs (prompt windows with deadlines) are
time-shared by the paper's Algorithm 2 (the registered ``llf-dynamic``
policy) on one model; every scheduled MinBatch runs a real prefill through
the shared runtime loop.  On the card each attention layer of the prefill
launches the hand-written flash-attention kernel; with ``--device cpu`` its
plain PyTorch version runs.  ``--full`` serves yi-6b at its published width
(32 layers, d_model 4,096, 32 heads, 4 KV heads, d_ff 11,008, vocab
64,000: about 12 GB of bf16 weights); the default is the reduced config of
the reference example.  Weights are drawn from seed 0.

    PYTHONPATH=src python examples/torch_multi_query_serving.py --device cpu
    PYTHONPATH=src python examples/torch_multi_query_serving.py --full
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.core import Strategy, UniformWindowArrival
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.models.base import get_config
from repro_torch.models.lm import build_specs
from repro_torch.models.params import init_params, num_params
from repro_torch.serve.engine import PrefillExecutor, WindowJob, serve_multi_jobs

SEQ = 64
BUCKETS = (1, 2, 4, 8, 16)
JOBS = ((24, 30.0, 3.0), (16, 20.0, 2.0), (32, 40.0, 2.5))  # (prompts, window s, slack)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', 'cuda' or 'cuda:N' (default: the CUDA card)")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the reference example's reduced yi-6b, vocab 1,024 (default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="yi-6b at its published width and depth")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    flash_attention_cuda.launches = 0

    cfg = get_config("yi_6b")
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=1024)
    specs = build_specs(cfg)
    params = init_params(specs, seed=0, device=device)
    size = num_params(specs)
    print(f"model: {'reduced ' if args.reduced else ''}{cfg.name} "
          f"({size/1e6:.2f}M params) on {device}")

    executor = PrefillExecutor(cfg, params, buckets=BUCKETS, device=device)
    cost_model = executor.calibrate(SEQ, cfg.vocab_size)
    print(f"calibrated: prefill(1)={cost_model.cost(1)*1e3:.1f} ms, "
          f"prefill(16)={cost_model.cost(16)*1e3:.1f} ms")

    rng = np.random.default_rng(0)
    jobs = []
    for i, (n, window, slack) in enumerate(JOBS):
        arr = UniformWindowArrival(wind_start=0.0, wind_end=window,
                                   num_tuples_total=n)
        jobs.append(WindowJob(
            job_id=f"job{i}",
            prompts=rng.integers(0, cfg.vocab_size, (n, SEQ)).astype(np.int32),
            arrival=arr,
            deadline=window + slack * cost_model.cost(n),
        ))

    report = serve_multi_jobs(jobs, executor, cost_model, Strategy.LLF,
                              delta_rsf=0.5, c_max=5.0)
    for jid, r in report.items():
        print(f"{jid}: processed {r['processed']} prompts in {r['num_batches']} "
              f"batches; modelled finish {r['completion']:.3f}s vs deadline "
              f"{r['deadline']:.3f}s -> met={r['met_modelled']}; real exec "
              f"{r['wall_exec_seconds']*1e3:.0f} ms")
    assert all(r["met_modelled"] for r in report.values())
    assert all(report[j.job_id]["processed"] == j.num_requests for j in jobs)
    print("all jobs met their deadlines with batched execution.")
    launches = {"flash_attention": flash_attention_cuda.launches}
    seconds = time.perf_counter() - t_start
    print(f"kernel launches: {json.dumps(launches)} in {seconds:.1f} s")
    return {"report": report, "cost_model": cost_model, "jobs": jobs, "cfg": cfg,
            "launches": launches}


if __name__ == "__main__":
    main()
