"""Built-in scheduling policies.

Importing this package registers every built-in policy with the registry in
``repro.core.api`` (string keys; ``get_policy(name)`` instantiates):

    single          Algorithm 1 (ScheduleSingleMain): slack test, then
                    backward construction with the Eq. (4) agg-cost fixpoint
    single-no-agg   backward construction ignoring final-aggregation cost
                    (paper function ScheduleWithoutAggCost)
    single-agg      the Eq. (4) agg-cost fixpoint (ScheduleWithAggCost)
    constraints     smallest-n feasibility of the §3.2 Eq. (5)-(8) system
                    (linear cost models)
    brute-force     exhaustive composition search (tests/ground truth)
    llf-dynamic     Algorithm 2, least-laxity-first (§4.2, Eq. (10))
    edf-dynamic     Algorithm 2, earliest-deadline-first
    sjf-dynamic     Algorithm 2, shortest-job-first
    rr-dynamic      Algorithm 2, round-robin
"""
from .single import (
    AggCostPolicy,
    NoAggCostPolicy,
    SingleQueryPolicy,
    StaticPolicy,
)
from .constraint import BruteForcePolicy, ConstraintPolicy
from .dynamic import (
    DynamicPolicy,
    EDFPolicy,
    LLFPolicy,
    RRPolicy,
    SJFPolicy,
)

__all__ = [
    "AggCostPolicy",
    "BruteForcePolicy",
    "ConstraintPolicy",
    "DynamicPolicy",
    "EDFPolicy",
    "LLFPolicy",
    "NoAggCostPolicy",
    "RRPolicy",
    "SJFPolicy",
    "SingleQueryPolicy",
    "StaticPolicy",
]
