"""The port's analytics path (``repro_torch.serve.analytics``) on the CPU
against the JAX package's, on the same seeded record streams: equal files,
equal plans, equal final aggregates (counts exact, the float sum of
TPC-Q6-like within 1e-5) and equal modelled executions."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.data import tpch as RT
from repro.serve import analytics as RA
from repro_torch import device as tdevice
from repro_torch.data import tpch as TT
from repro_torch.serve import analytics as TA

RSCALE, TSCALE = RT.StreamScale(0.005), TT.StreamScale(0.005)
CPU = "cpu"


def _files(tpch, sc, stream, n=24, seed=3):
    files, times = [], []
    for t, o, l in tpch.stream_files(seed=seed, num_files=n, sc=sc):
        files.append(l if stream == "lineitem" else o)
        times.append(t)
    return files, times


def _both(stream, n=24, seed=3):
    return (_files(RT, RSCALE, stream, n, seed)[0],
            _files(TT, TSCALE, stream, n, seed)[0])


def _same(qid, got, want):
    assert got.shape == want.shape
    if qid == "TPC-Q6-like":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


QIDS = [q.query_id for q in TT.PAPER_QUERIES]
RQ = {q.query_id: q for q in RT.PAPER_QUERIES}
TQ = {q.query_id: q for q in TT.PAPER_QUERIES}


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_stream_files_byte_identical(seed):
    ref = list(RT.stream_files(seed, 6, RSCALE))
    port = list(TT.stream_files(seed, 6, TSCALE))
    assert len(ref) == len(port)
    for (rt, *rfiles), (tt, *tfiles) in zip(ref, port):
        assert rt == tt
        for rf, tf in zip(rfiles, tfiles):
            assert list(rf) == list(tf)
            for col in rf:
                assert rf[col].dtype == tf[col].dtype
                assert rf[col].tobytes() == tf[col].tobytes()


@pytest.mark.parametrize("qid", QIDS)
def test_run_batched_matches_reference(qid):
    rfiles, tfiles = _both(TQ[qid].stream)
    want, _, nb_want = RA.run_batched(RQ[qid], rfiles, 5, RSCALE)
    got, secs, nb = TA.run_batched(TQ[qid], tfiles, 5, TSCALE, device=CPU)
    assert nb == nb_want == 5 and secs >= 0.0
    _same(qid, got, want)
    one, _, _ = TA.run_batched(TQ[qid], tfiles, 24, TSCALE, device=CPU)
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)


def _plan(core, times, n):
    cm = core.LinearCostModel(tuple_cost=0.4, overhead=0.3, agg_per_batch=0.2)
    arr = core.TraceArrival(timestamps=tuple(times))
    q = core.Query("it", arr.wind_start, arr.wind_end,
                   arr.wind_end + 0.5 * cm.cost(n), n, cm, arr)
    return core.Planner(policy="single").schedule(q)


@pytest.mark.parametrize("qid", QIDS)
def test_run_plan_matches_reference(qid):
    rfiles, times = _files(RT, RSCALE, TQ[qid].stream, 48)
    tfiles, _ = _files(TT, TSCALE, TQ[qid].stream, 48)
    rplan, tplan = _plan(R, times, 48), _plan(T, times, 48)
    assert (tplan.sch_tuples, tplan.sch_points) == (rplan.sch_tuples, rplan.sch_points)
    assert tplan.num_batches > 1
    want, rlog, _ = RA.run_plan(RQ[qid], rfiles, rplan, RSCALE)
    got, tlog, agg_s = TA.run_plan(TQ[qid], tfiles, tplan, TSCALE, device=CPU)
    _same(qid, got, want)
    assert [b.num_records for b in tlog] == [b.num_records for b in rlog]
    assert sum(b.num_records for b in tlog) == sum(len(f["ts"]) for f in tfiles)
    assert agg_s >= 0.0


def _thinned_run(core, analytics, tpch, sc, files, times, device_kw):
    cm = core.LinearCostModel(tuple_cost=0.4, overhead=0.3, agg_per_batch=0.2)
    base = core.TraceArrival(timestamps=tuple(times))
    arr = core.ThinnedArrival(base=base, keep=9, prefix=4, seed=2)
    q = core.Query("thin", arr.wind_start, arr.wind_end,
                   arr.wind_end + 5.0 * cm.cost(len(times)),
                   arr.num_tuples_total, cm, arr)
    aq = next(a for a in tpch.PAPER_QUERIES if a.query_id == "CQ3")
    ex = analytics.AnalyticsRuntimeExecutor({"thin": (aq, files)}, sc, **device_kw)
    trace = core.run(core.get_policy("llf-dynamic", delta_rsf=0.5, c_max=30.0), [q], ex)
    return ex, trace


def test_thinned_arrival_weighted_results_match():
    rfiles, times = _files(RT, RSCALE, "lineitem", 24)
    tfiles, _ = _files(TT, TSCALE, "lineitem", 24)
    rex, rtrace = _thinned_run(R, RA, RT, RSCALE, rfiles, times, {})
    tex, ttrace = _thinned_run(T, TA, TT, TSCALE, tfiles, times, {"device": CPU})
    got, want = tex.results["thin"], rex.results["thin"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # sampled scan: fewer records than the stream, weighted back up
    scanned = sum(b.num_records for b in tex.physical("thin").batch_log)
    assert scanned < sum(len(f["ts"]) for f in tfiles)
    assert got.sum() > scanned
    assert [dataclasses.asdict(e) for e in ttrace.executions] == \
        [dataclasses.asdict(e) for e in rtrace.executions]


def _multi(core, analytics, tpch, sc, device_kw):
    streams = {s: _files(tpch, sc, s, 30, seed=5)[0] for s in ("orders", "lineitem")}
    _, times = _files(tpch, sc, "orders", 30, seed=5)
    arr = core.TraceArrival(timestamps=tuple(times))
    queries, jobs = [], {}
    for i, aq in enumerate(tpch.PAPER_QUERIES):
        cm = core.LinearCostModel(tuple_cost=0.05 + 0.01 * i, overhead=0.3,
                                  agg_per_batch=0.1)
        queries.append(core.Query(aq.query_id, arr.wind_start, arr.wind_end,
                                  arr.wind_end + 3.0 + 2.0 * i, 30, cm, arr))
        jobs[aq.query_id] = (aq, streams[aq.stream])
    ex = analytics.AnalyticsRuntimeExecutor(jobs, sc, **device_kw)
    trace = core.Planner(policy="llf-dynamic").run(queries, executor=ex)
    return ex, trace


def test_multi_query_llf_dynamic_matches_reference():
    rex, rtrace = _multi(R, RA, RT, RSCALE, {})
    tex, ttrace = _multi(T, TA, TT, TSCALE, {"device": CPU})
    assert [dataclasses.asdict(e) for e in ttrace.executions] == \
        [dataclasses.asdict(e) for e in rtrace.executions]
    assert [dataclasses.asdict(o) for o in ttrace.outcomes] == \
        [dataclasses.asdict(o) for o in rtrace.outcomes]
    assert sorted(tex.results) == sorted(QIDS)
    for qid in QIDS:
        _same(qid, tex.results[qid], rex.results[qid])
        assert tex.physical(qid).num_batches == rex.physical(qid).num_batches


def test_measure_cost_model_on_cpu_fits_a_model():
    files, _ = _files(TT, TSCALE, "orders", 16)
    cm = TA.measure_cost_model(TQ["CQ2"], files, TSCALE, batch_sizes=(1, 4),
                               device=CPU)
    assert cm.cost(16) > 0.0
    assert cm.agg_cost(8) >= 0.0


def test_entry_points_without_a_device_raise_on_a_cpu_only_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    files, _ = _files(TT, TSCALE, "orders", 4)
    aq = TQ["CQ2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.AnalyticsExecutor(aq, TSCALE)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.run_batched(aq, files, 2, TSCALE)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.measure_cost_model(aq, files, TSCALE)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.AnalyticsRuntimeExecutor({"q": (aq, files)}, TSCALE, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.resolve_device("meta")


def test_sequential_slots_never_clobber():
    files, _ = _files(TT, TSCALE, "orders", 6)
    ex = TA.AnalyticsExecutor(TQ["CQ2"], TSCALE, device=CPU)
    ex.process_batch(TA.concat_files(files[:3]), slot=1)
    ex.process_batch(TA.concat_files(files[3:]))
    ex.process_batch(TA.concat_files(files[3:]))
    assert sorted(ex.partials) == [1, 2, 3]
    total, _ = ex.finalize()
    assert total.sum() == sum(len(f["ts"]) for f in files) + \
        sum(len(f["ts"]) for f in files[3:])
