"""Legacy dynamic multi-query entry point (paper §4, Algorithm 2).

Algorithm 2's event loop moved to ``repro.core.runtime`` (the single runtime
loop shared by every executor) and the per-strategy decision logic to
``repro.core.policies.dynamic`` (registered as ``llf-dynamic`` /
``edf-dynamic`` / ``sjf-dynamic`` / ``rr-dynamic``); ``schedule_dynamic``
below is a thin deprecation shim kept for the pre-Planner API.
``DynamicQuerySpec`` (the workload spec) now lives in
``repro.core.runtime`` and is re-exported here unchanged.

Migration:

    schedule_dynamic(specs, Strategy.LLF, delta_rsf=d, c_max=c)
        -> Planner(policy="llf-dynamic", delta_rsf=d, c_max=c).run(specs)
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from ._deprecation import warn_deprecated
from .runtime import DynamicQuerySpec, LARGE_NUMBER  # noqa: F401  (re-export)
from .types import BatchExecution, ExecutionTrace, Strategy

__all__ = ["DynamicQuerySpec", "LARGE_NUMBER", "schedule_dynamic"]


def schedule_dynamic(
    specs: Sequence[DynamicQuerySpec],
    strategy: Strategy = Strategy.LLF,
    delta_rsf: float = 0.5,
    c_max: float = 30.0,
    start_time: Optional[float] = None,
    max_steps: int = 1_000_000,
    on_batch: Optional[Callable[[BatchExecution], None]] = None,
) -> ExecutionTrace:
    """Deprecated shim for the ``<strategy>-dynamic`` policies."""
    warn_deprecated(
        "schedule_dynamic()",
        f'Planner(policy="{strategy.value}-dynamic").run(specs)',
    )
    from .policies.dynamic import policy_for_strategy
    from .runtime import SimulatedExecutor, run

    policy = policy_for_strategy(strategy, delta_rsf=delta_rsf, c_max=c_max)
    return run(
        policy,
        specs,
        SimulatedExecutor(),
        start_time=start_time,
        max_steps=max_steps,
        on_batch=on_batch,
    )
