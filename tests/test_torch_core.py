"""The port's copy of the scheduler (``repro_torch.core``) schedules exactly
like the JAX package's ``repro.core``: every copied module equals its
reference file (read with ``repro_torch`` as ``repro``), the package exports
the same names, and it gives equal plans (or the same ``InfeasibleDeadline``
message) for the paper's 13 queries under both cost regimes and equal
simulated traces for the dynamic policies, pooled too."""
import dataclasses
import pathlib
import sys

import pytest

import repro.core as R
import repro_torch.core as T
from repro.data import tpch as RT
from repro_torch.data import tpch as TT

PACKAGES = {"ref": (R, RT), "port": (T, TT)}
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
COPIED = sorted(p.relative_to(SRC / "repro_torch" / "core").as_posix()
                for p in (SRC / "repro_torch" / "core").rglob("*.py")
                if p.name != "__init__.py" or p.parent.name == "policies")
DEADLINE_FRACS = (0.02, 0.1, 0.3, 1.0, 2.0)


def paper_query(pkg, qid, frac, regime="fig4", n=TT.NUM_FILES, start=0.0, rate=1.0):
    core, tpch = PACKAGES[pkg]
    cm = tpch.paper_cost_model(qid, regime)
    arr = core.ConstantRateArrival(wind_start=start, rate=rate, num_tuples_total=n)
    return core.Query(qid, start, arr.wind_end, arr.wind_end + frac * cm.cost(n),
                      n, cm, arr)


def plan_or_error(pkg, policy, query):
    core, _ = PACKAGES[pkg]
    try:
        s = core.Planner(policy=policy).schedule(query)
    except core.InfeasibleDeadline as e:
        return ("infeasible", str(e))
    return (s.sch_tuples, s.sch_points)


def test_list_policies_match():
    assert T.list_policies() == R.list_policies()


def test_paper_query_ids_and_cost_models_match():
    assert TT.PAPER_QUERY_IDS == RT.PAPER_QUERY_IDS
    assert TT.NUM_FILES == RT.NUM_FILES
    for qid in TT.PAPER_QUERY_IDS + ["TPC-Q6-like", "TPC-Q4-like", "other"]:
        for regime in ("fig4", "spark"):
            t, r = TT.paper_cost_model(qid, regime), RT.paper_cost_model(qid, regime)
            assert dataclasses.asdict(t) == dataclasses.asdict(r)


@pytest.mark.parametrize("policy", ["single", "single-agg", "single-no-agg"])
@pytest.mark.parametrize("regime", ["fig4", "spark"])
@pytest.mark.parametrize("qid", TT.PAPER_QUERY_IDS)
def test_single_query_plans_identical(qid, regime, policy):
    outcomes = set()
    for frac in DEADLINE_FRACS:
        want = plan_or_error("ref", policy, paper_query("ref", qid, frac, regime))
        got = plan_or_error("port", policy, paper_query("port", qid, frac, regime))
        assert got == want, (qid, regime, policy, frac)
        outcomes.add(want[0] == "infeasible")
    assert False in outcomes  # at least one deadline is feasible


@pytest.mark.parametrize("n, tuple_cost, overhead, agg, frac", [
    (10, 1.0, 0.0, 0.0, 0.6), (12, 0.4, 0.3, 0.2, 0.5), (20, 0.2, 1.0, 0.3, 0.4),
    (16, 0.5, 0.1, 0.0, 0.05),
])
@pytest.mark.parametrize("policy", ["constraints", "brute-force", "single"])
def test_linear_cost_plans_identical(policy, n, tuple_cost, overhead, agg, frac):
    results = []
    for pkg in ("ref", "port"):
        core, _ = PACKAGES[pkg]
        cm = core.LinearCostModel(tuple_cost=tuple_cost, overhead=overhead,
                                  agg_per_batch=agg)
        arr = core.ConstantRateArrival(wind_start=1.0, rate=1.0, num_tuples_total=n)
        q = core.Query("lin", 1.0, arr.wind_end,
                       arr.wind_end + frac * cm.cost(n) + overhead, n, cm, arr)
        results.append(plan_or_error(pkg, policy, q))
    assert results[0] == results[1]


def _workload(pkg):
    qs = []
    for i, qid in enumerate(["CQ1", "CQ3", "TPC-Q3", "CQ4", "TPC-Q10", "TPC-Q6"]):
        qs.append(paper_query(pkg, qid, 0.5 + 0.25 * i, n=400 + 50 * i,
                              start=30.0 * i, rate=1.0 + 0.5 * (i % 2)))
    return qs


def _trace_rows(trace):
    return ([dataclasses.asdict(e) for e in trace.executions],
            [dataclasses.asdict(o) for o in trace.outcomes],
            list(trace.stragglers))


@pytest.mark.parametrize("runtime", [None, "heap"])
@pytest.mark.parametrize("workers", [None, 2])
@pytest.mark.parametrize("policy", ["llf-dynamic", "edf-dynamic", "sjf-dynamic",
                                    "rr-dynamic"])
def test_simulated_traces_identical(policy, workers, runtime):
    kw = {} if runtime is None else {"runtime": runtime}
    traces = [PACKAGES[pkg][0].Planner(policy=policy).run(
        _workload(pkg), workers=workers, **kw) for pkg in ("ref", "port")]
    want, got = _trace_rows(traces[0]), _trace_rows(traces[1])
    assert got == want
    assert len(got[0]) > len(_workload("port"))  # more than one batch per query


def test_sharded_decisions_reach_the_ports_shard_extents():
    # shard_across > 1 makes dynamic.py import dist.sharding lazily.
    traces = [PACKAGES[pkg][0].Planner(policy="llf-dynamic", shard_across=2).run(
        _workload(pkg), workers=2) for pkg in ("ref", "port")]
    assert _trace_rows(traces[1]) == _trace_rows(traces[0])
    assert "repro_torch.dist.sharding" in sys.modules


def test_static_run_identical():
    traces = [PACKAGES[pkg][0].Planner(policy="single").run(_workload(pkg))
              for pkg in ("ref", "port")]
    assert _trace_rows(traces[1]) == _trace_rows(traces[0])


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_equals_reference(module):
    port = (SRC / "repro_torch" / "core" / module).read_text()
    assert port.replace("repro_torch", "repro") == (SRC / "repro" / "core" / module).read_text()


def test_every_reference_module_is_copied():
    ref = sorted(p.relative_to(SRC / "repro" / "core").as_posix()
                 for p in (SRC / "repro" / "core").rglob("*.py")
                 if p.name != "__init__.py" or p.parent.name == "policies")
    assert COPIED == ref
    assert "session.py" in COPIED and "api.py" in COPIED


def test_exports_equal_reference():
    assert T.__all__ == R.__all__
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.Session.__module__ == "repro_torch.core.api"
    assert T.SessionRuntime.__module__ == "repro_torch.core.session"


def test_planner_share_attaches_the_pane_book():
    trace = T.Planner(policy="llf-dynamic").run(_workload("port"), share=True)
    want = R.Planner(policy="llf-dynamic").run(_workload("ref"), share=True)
    assert _trace_rows(trace) == _trace_rows(want)
    assert isinstance(trace.pane_book, T.SharedBook)
