"""Single-query intermittent analytics, end to end on the PyTorch port
(``repro_torch``), the twin of ``examples/deadline_analytics.py``:

  1. generate a TPC-H-like record stream,
  2. calibrate the cost model from measured batch runs (paper Section 6.2),
  3. plan batches with the "single" policy (Algorithm 1) against a deadline,
  4. execute the plan on the device (segagg partial aggregation, host spill),
  5. final aggregation; verify the result equals a one-shot run.

On the card each batch launches a hand-written segagg kernel (the route
``resolve_backend`` prints as ``cuda``; the kernel ``ops.segagg`` picks for
the query's group count); with ``--device cpu`` the plain PyTorch version
runs.  The one-shot check is the plain version on the host, independent of
the kernel; CQ3 is a count, so the two must be equal.

    PYTHONPATH=src python examples/torch_deadline_analytics.py --device cpu
    PYTHONPATH=src python examples/torch_deadline_analytics.py --scale 1.0 --files 4500
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import Planner, Query, TraceArrival, plan_cost
from repro_torch.data.tpch import PAPER_QUERIES, StreamScale, stream_files
from repro_torch.device import resolve_device
from repro_torch.kernels.segagg.ops import resolve_backend
from repro_torch.kernels.segagg.segagg import (
    segagg_narrow_cuda, segagg_scatter_atomic_cuda, segagg_scatter_cuda)
from repro_torch.serve.analytics import measure_cost_model, run_batched, run_plan

KERNELS = {"segagg_scatter": segagg_scatter_cuda,
           "segagg_scatter_atomic": segagg_scatter_atomic_cuda,
           "segagg_narrow": segagg_narrow_cuda}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', 'cuda' or 'cuda:N' (default: the CUDA card)")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="StreamScale of the stream (the paper's Section 7.1: 1.0)")
    ap.add_argument("--files", type=int, default=96,
                    help="files in the stream (the paper's window: 4500)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    for k in KERNELS.values():
        k.launches = 0

    scale = StreamScale(scale=args.scale)
    num_files = args.files
    query = PAPER_QUERIES[2]  # CQ3: count(*) GROUP BY suppKey
    files, times = [], []
    for t, orders, lineitem in stream_files(seed=11, num_files=num_files, sc=scale):
        files.append(lineitem if query.stream == "lineitem" else orders)
        times.append(t)

    print(f"query {query.query_id}: {query.description} "
          f"(segagg route: {resolve_backend(None, device)} on {device})")
    cost_model = measure_cost_model(query, files, scale, device=device)
    print(f"calibrated cost model: cost(1 file)={cost_model.cost(1)*1e3:.2f} ms, "
          f"cost({num_files})={cost_model.cost(num_files)*1e3:.1f} ms")

    arrival = TraceArrival(timestamps=tuple(times))
    deadline = arrival.wind_end + 0.6 * cost_model.cost(num_files)
    q = Query("CQ3-deadline", arrival.wind_start, arrival.wind_end, deadline,
              num_files, cost_model, arrival)
    plan = Planner(policy="single").schedule(q)
    print(f"deadline {deadline:.2f}s -> plan: {plan.sch_tuples} files per batch "
          f"at t={[round(p, 2) for p in plan.sch_points]} "
          f"(modelled cost {plan_cost(q, plan)*1e3:.1f} ms)")

    result, log, agg_s = run_plan(query, files, plan, scale, device=device)
    oneshot, _, _ = run_batched(query, files, num_files, scale, device="cpu")
    np.testing.assert_array_equal(result, oneshot)
    print(f"executed {len(log)} real batches "
          f"({[b.num_records for b in log]} records), final agg {agg_s*1e3:.1f} ms")
    print("result identical to one-shot run — partial aggregation exact.")
    print(f"total rows: {int(result.sum())}, groups touched: "
          f"{int((result > 0).sum())}")
    # the plan's measured finish: each batch starts at its planned point or
    # when the one before it ends, whichever is later
    finish = 0.0
    for point, batch in zip(plan.sch_points, log):
        finish = max(finish, point) + batch.seconds
    finish += agg_s
    launches = {name: k.launches for name, k in KERNELS.items()}
    seconds = time.perf_counter() - t_start
    print(f"measured finish {finish:.3f}s vs deadline {deadline:.3f}s "
          f"(batches' measured seconds in place of their modelled cost)")
    print(f"kernel launches: {json.dumps(launches)} in {seconds:.1f} s")
    return {"result": result, "oneshot": oneshot, "cost_model": cost_model, "plan": plan,
            "batches": log, "route": resolve_backend(None, device), "launches": launches}


if __name__ == "__main__":
    main()
