"""Pane sharing in the port (``repro_torch.core.panes`` and
``repro_torch.serve.analytics.SharedAnalyticsExecutor``) against the JAX
package's: ``Planner.run(share=True)`` gives equal trace rows and pane
statistics in the aligned and sliding regimes of
``benchmarks/bench_shared_panes.py``, and ``run_shared_jobs`` over the same
seeded record stream gives equal aggregates (counts exact, the float sum of
TPC-Q6-like within 1e-5), equal pane statistics and equal traces, shared and
unshared, on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import panes as RP
from repro.data import tpch as RT
from repro.serve import analytics as RA
from repro_torch.core import panes as TP
from repro_torch.data import tpch as TT
from repro_torch.serve import analytics as TA

N_TUPLES, SLIDE = 64, 8   # bench_shared_panes.py's window range and slide


def rows(trace):
    return ([dataclasses.asdict(e) for e in trace.executions],
            [dataclasses.asdict(o) for o in trace.outcomes],
            list(trace.stragglers))


def overlapping(core, k, regime):
    """bench_shared_panes.py's workload: k identical (``aligned``) or
    slide-staggered (``sliding``) windows over one stream."""
    cm = core.LinearCostModel(tuple_cost=0.05, overhead=0.5, agg_per_batch=0.02)
    qs = []
    for i in range(k):
        off = 0 if regime == "aligned" else i * SLIDE
        arr = core.UniformWindowArrival(wind_start=float(off),
                                        wind_end=float(off + N_TUPLES),
                                        num_tuples_total=N_TUPLES)
        qs.append(core.Query(f"q{i}", arr.wind_start, arr.wind_end,
                             arr.wind_end + 3.0 * cm.cost(N_TUPLES), N_TUPLES, cm, arr,
                             stream="shared-stream", stream_offset=off))
    return qs


def shared_run(core, k, regime, policy, runtime):
    kw = {} if runtime is None else {"runtime": runtime}
    knobs = {"c_max": 10.0} if policy.endswith("-dynamic") else {}
    trace = core.Planner(policy=policy, **knobs).run(
        overlapping(core, k, regime), share=True,
        pane_tuples=16 if regime == "aligned" else None, **kw)
    return rows(trace), dataclasses.asdict(trace.pane_book.store.stats), \
        trace.total_cost


@pytest.mark.parametrize("runtime", [None, "heap"])
@pytest.mark.parametrize("policy", ["llf-dynamic", "edf-dynamic", "sjf-dynamic",
                                    "rr-dynamic", "single"])
@pytest.mark.parametrize("regime", ["aligned", "sliding"])
@pytest.mark.parametrize("k", [1, 8])
def test_planner_share_trace_identical(k, regime, policy, runtime):
    want = shared_run(R, k, regime, policy, runtime)
    got = shared_run(T, k, regime, policy, runtime)
    assert got == want
    if k > 1 and policy != "single":
        assert got[1]["hits"] > 0


@pytest.mark.parametrize("regime", ["aligned", "sliding"])
def test_sharing_saves_what_the_reference_saves(regime):
    """The benchmark's gate, on the port: at 8 queries the shared run costs
    at least 3x less than the unshared one, the same ratio as the
    reference's."""
    ratios = []
    for core in (R, T):
        unshared = core.Planner(policy="llf-dynamic", c_max=10.0).run(
            overlapping(core, 8, regime))
        _, _, shared = shared_run(core, 8, regime, "llf-dynamic", None)
        ratios.append(unshared.total_cost / shared)
    assert ratios[1] == ratios[0] >= 3.0


def test_share_false_is_the_unshared_runtime():
    qs = overlapping(T, 4, "sliding")
    plain = T.Planner(policy="llf-dynamic").run(qs)
    off = T.Planner(policy="llf-dynamic").run(overlapping(T, 4, "sliding"), share=False)
    assert rows(off) == rows(plain)
    with pytest.raises(ValueError, match="pane_tuples"):
        T.Planner(policy="llf-dynamic").run(qs, pane_tuples=8)


@pytest.mark.parametrize("ranges, slides", [((64,), (8,)), ((60, 90), (15, 0)),
                                            ((), ()), ((7,), ()), ((48, 64), (16,))])
def test_pane_width_identical(ranges, slides):
    assert TP.pane_width(ranges, slides) == RP.pane_width(ranges, slides)


@pytest.mark.parametrize("lo, hi, width", [(0, 64, 16), (3, 61, 8), (10, 10, 4), (5, 9, 8)])
def test_panes_in_identical(lo, hi, width):
    want = [dataclasses.asdict(p) for p in RP.panes_in("s", width, lo, hi)]
    assert [dataclasses.asdict(p) for p in TP.panes_in("s", width, lo, hi)] == want


def test_share_workload_identical():
    def go(core, panes):
        specs, book = panes.share_workload(overlapping(core, 4, "sliding"))
        return ([(s.query.query_id, s.query.cost_model.cost(8),
                  s.query.cost_model.agg_cost(3)) for s in specs], dict(book.widths))

    assert go(T, TP) == go(R, RP)


def test_pane_store_identical():
    def go(panes):
        store = panes.PaneStore()
        for q in ("a", "b"):
            for pane in panes.panes_in("s", 4, 0, 12):
                store.subscribe(pane, q)
        store.deposit("s", 0, by="a", data=np.ones(2))
        store.deposit("s", 1, by="a", data=np.ones(2))
        events = [store.entry("s", 0).computed, store.entry("s", 2)]
        for q in ("a", "b"):
            for i in range(3):
                store.release("s", i, q)
        return events, dataclasses.asdict(store.stats), store.resident

    want, got = go(RP), go(TP)
    assert repr(got) == repr(want)


# -- the real backend: run_shared_jobs ----------------------------------------

RSCALE, TSCALE = RT.StreamScale(0.005), TT.StreamScale(0.005)
RQ = {q.query_id: q for q in RT.PAPER_QUERIES}
TQ = {q.query_id: q for q in TT.PAPER_QUERIES}


def stream(tpch, sc, name, n, seed=3):
    return [l if name == "lineitem" else o
            for _, o, l in tpch.stream_files(seed=seed, num_files=n, sc=sc)]


def direct_groupby(aq, files, sc, lo, hi):
    """The window aggregated at once on the host in float64."""
    recs = TA.concat_files(files[lo:hi])
    keys = np.asarray(aq.key_fn(recs))
    vals = np.asarray(aq.value_fn(recs), np.float64).reshape(len(keys), -1)
    out = np.zeros((aq.num_groups(TSCALE), vals.shape[1]))
    np.add.at(out, keys, vals)
    return out


def shared_jobs(qid, windows, share, pane_tuples=None, **kw):
    n = max(lo + m for lo, m in windows)
    out = []
    for core, tpch, analytics, sc, queries, dev in (
            (R, RT, RA, RSCALE, RQ, {}), (T, TT, TA, TSCALE, TQ, {"device": "cpu"})):
        files = stream(tpch, sc, queries[qid].stream, n)
        cm = core.LinearCostModel(tuple_cost=0.02, overhead=0.1, agg_per_batch=0.01)
        out.append(analytics.run_shared_jobs(
            queries[qid], files, windows, sc, cm, share=share,
            pane_tuples=pane_tuples, c_max=5.0, **dev, **kw) + (files,))
    return out


# bench_shared_panes.py's sliding regime cut to the test's stream: four
# windows of 30 files sliding by 5 (6x overlap, GCD pane 5 files)
SLIDING = [(0, 30), (5, 30), (10, 30), (15, 30)]


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("qid", ["CQ3", "TPC-Q6-like", "CQ2"])
def test_run_shared_jobs_matches_reference(qid, share):
    (want, wtrace, wbook, _), (got, gtrace, gbook, files) = shared_jobs(qid, SLIDING, share)
    assert sorted(got) == sorted(want) == [f"{qid}-w{i}" for i in range(4)]
    for i, (lo, n) in enumerate(SLIDING):
        key = f"{qid}-w{i}"
        assert got[key].shape == want[key].shape
        oneshot = direct_groupby(TQ[qid], files, TSCALE, lo, lo + n)
        if qid == "TPC-Q6-like":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
            np.testing.assert_allclose(got[key], oneshot, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(got[key], oneshot)
    assert rows(gtrace) == rows(wtrace)
    assert dataclasses.asdict(gbook.store.stats) == dataclasses.asdict(wbook.store.stats)
    if share:
        assert gbook.store.stats.hits > 0


@pytest.mark.parametrize("windows, pane_tuples", [
    ([(0, 16), (4, 16), (8, 16)], None),      # test_panes.py's overlapping windows
    ([(0, 12), (0, 12)], 4),                  # aligned, explicit pane width
    ([(2, 9), (7, 11), (0, 5)], None),        # ragged: edge fragments
    ([(0, 10), (3, 10)], 4),                  # a width that does not divide the slide
])
def test_run_shared_jobs_window_sets_match_reference(windows, pane_tuples):
    (want, wtrace, wbook, _), (got, gtrace, gbook, files) = shared_jobs(
        "CQ3", windows, True, pane_tuples)
    for i, (lo, n) in enumerate(windows):
        np.testing.assert_array_equal(got[f"CQ3-w{i}"], want[f"CQ3-w{i}"])
        np.testing.assert_array_equal(got[f"CQ3-w{i}"],
                                      direct_groupby(TQ["CQ3"], files, TSCALE, lo, lo + n))
    assert rows(gtrace) == rows(wtrace)
    assert dataclasses.asdict(gbook.store.stats) == dataclasses.asdict(wbook.store.stats)


def test_run_shared_jobs_refuses_a_window_outside_the_stream():
    files = stream(TT, TSCALE, "lineitem", 10)
    cm = T.LinearCostModel(tuple_cost=0.02)
    with pytest.raises(ValueError, match="outside the stream"):
        TA.run_shared_jobs(TQ["CQ3"], files, [(5, 6)], TSCALE, cm, device="cpu")


def test_shared_executor_needs_stream_placed_queries():
    files = stream(TT, TSCALE, "lineitem", 4)
    ex = TA.SharedAnalyticsExecutor(TQ["CQ3"], files, TSCALE, TP.SharedBook(),
                                    device="cpu")
    arr = T.TraceArrival(timestamps=(1.0, 2.0))
    q = T.Query("loose", 1.0, 2.0, 10.0, 2, T.LinearCostModel(tuple_cost=0.1), arr)
    with pytest.raises(ValueError, match="stream-placed"):
        ex.submit_batch(q, 2, 0)


def test_shared_executor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    files = stream(TT, TSCALE, "lineitem", 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.SharedAnalyticsExecutor(TQ["CQ3"], files, TSCALE, TP.SharedBook())
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.run_shared_jobs(TQ["CQ3"], files, [(0, 4)], TSCALE,
                           T.LinearCostModel(tuple_cost=0.1))


def test_pane_scans_go_through_pane_segagg(monkeypatch):
    """Uncached pane runs are one ``pane_segagg`` call each, on the
    executor's device; the composite key space is panes x groups."""
    calls = []
    real = TA.pane_segagg

    def spy(keys, values, pane_ids, num_panes, num_groups, **kw):
        calls.append((keys.device.type, num_panes, num_groups, int(pane_ids.max())))
        return real(keys, values, pane_ids, num_panes, num_groups, **kw)

    monkeypatch.setattr(TA, "pane_segagg", spy)
    (_, _, _, _), (_, _, book, _) = shared_jobs("CQ3", SLIDING, True)
    assert calls and book.store.stats.scans == sum(c[1] for c in calls)
    assert all(dev == "cpu" and g == TQ["CQ3"].num_groups(TSCALE) and top == p - 1
               for dev, p, g, top in calls)
