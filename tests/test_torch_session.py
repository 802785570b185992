"""The port's ``Session`` (``repro_torch.core.session``), its overload,
forecast, tenancy and schedulability layers and the simulator's baselines
against the JAX package's: each scenario runs once through ``repro.core``
and once through ``repro_torch.core``, and the two give equal trace rows
(``dataclasses.asdict`` of executions, outcomes, stragglers and session
events) and equal admission results.  The real backends follow:
``run_session`` over the segagg analytics executor and ``serve_session``
over the prefill engine, both on the CPU."""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import tenancy as RTEN
from repro_torch.core import tenancy as TTEN

DYNAMIC = ["llf-dynamic", "edf-dynamic", "sjf-dynamic", "rr-dynamic"]


def rows(trace):
    out = {"executions": [dataclasses.asdict(e) for e in trace.executions],
           "outcomes": [dataclasses.asdict(o) for o in trace.outcomes],
           "stragglers": list(trace.stragglers)}
    if hasattr(trace, "events"):
        out["events"] = [dataclasses.asdict(e) for e in trace.events]
    return out


def admission(res):
    return None if res is None else dataclasses.asdict(res)


def both(scenario, *args, **kw):
    """``scenario(core, ...)`` through the reference and the port."""
    return scenario(R, *args, **kw), scenario(T, *args, **kw)


def linear(core, tuple_cost=0.4, overhead=0.3, agg=0.2):
    return core.LinearCostModel(tuple_cost=tuple_cost, overhead=overhead,
                                agg_per_batch=agg)


def fixed_query(core, qid, start=0.0, slack=3.0, rate=1.0, n=8, **kw):
    arr = core.ConstantRateArrival(wind_start=start, rate=rate, num_tuples_total=n)
    cm = linear(core)
    return core.Query(qid, start, arr.wind_end, arr.wind_end + slack * cm.cost(n),
                      n, cm, arr, **kw)


def uniform_query(core, qid, start, span, n, deadline, cm=None, **kw):
    arr = core.UniformWindowArrival(wind_start=start, wind_end=start + span,
                                    num_tuples_total=n)
    return core.Query(qid, start, start + span, deadline, n,
                      cm if cm is not None else linear(core), arr, **kw)


# -- recurring windows, admission, withdrawal ---------------------------------

def lifecycle(core, policy, runtime):
    """Recurring specs roll over; one query is admitted mid-run, one is
    rejected, one is forced in; a recurring spec is withdrawn."""
    s = core.Session(policy=policy, runtime=runtime)
    results = [s.submit(core.RecurringQuerySpec(
        base=fixed_query(core, "a"), period=30.0, num_windows=3))]
    results.append(s.submit(core.RecurringQuerySpec(
        base=fixed_query(core, "r", start=2.0, slack=5.0), period=30.0,
        num_windows=6)))
    s.run_until(40.0)
    results.append(s.submit(fixed_query(core, "b", start=45.0, slack=5.0)))
    arr = core.ConstantRateArrival(wind_start=50.0, rate=1.0, num_tuples_total=20)
    hopeless = core.Query("bad", 50.0, arr.wind_end, arr.wind_end + 0.1, 20,
                          core.LinearCostModel(tuple_cost=2.0, overhead=5.0), arr)
    results.append(s.submit(hopeless))
    s.run_until(70.0)
    s.withdraw("r")
    results.append(s.submit(dataclasses.replace(hopeless, query_id="forced"),
                            force=True))
    trace = s.run_until(400.0)
    return rows(trace), [admission(r) for r in results], s.live_ids, s.now


@pytest.mark.parametrize("runtime", [None, "heap"])
@pytest.mark.parametrize("policy", DYNAMIC + ["single"])
def test_session_lifecycle_trace_identical(policy, runtime):
    want, got = both(lifecycle, policy, runtime)
    assert got == want
    trace = got[0]
    assert [r["admitted"] for r in got[1]] == [True, True, True, False, True]
    kinds = [e["kind"] for e in trace["events"]]
    assert {"submit", "reject", "withdraw", "window_open", "window_close"} <= set(kinds)


def pooled(core, admission_mode):
    """Two workers, overload control, tiers and a mid-run withdrawal, with
    the snapshot or the incremental (``DemandLedger``) admission path."""
    s = core.Session(policy="llf-dynamic", workers=2, overload=True,
                     runtime="heap", admission=admission_mode)
    res = []
    for i in range(4):
        base = fixed_query(core, f"r{i}", start=2.0 * i, n=6, slack=6.0, tier=i % 2)
        res.append(s.submit(core.RecurringQuerySpec(base=base, period=30.0,
                                                    num_windows=2)))
    s.run_until(20.0)
    s.withdraw("r2")
    return rows(s.run_until(100.0)), [admission(r) for r in res]


@pytest.mark.parametrize("admission_mode", ["snapshot", "incremental"])
def test_pooled_overload_withdraw_trace_identical(admission_mode):
    want, got = both(pooled, admission_mode)
    assert got == want
    assert got[0]["executions"]


def calibrating(core, policy):
    """True costs 1.5x the fitted model: the calibrating session refits and
    replans (``recalibrate`` events)."""
    fit = linear(core, 0.1, 0.2, 0.1)
    true = linear(core, 0.15, 0.3, 0.15)
    arr = core.ConstantRateArrival(wind_start=0.0, rate=2.0, num_tuples_total=40)
    base = core.Query("d", 0.0, arr.wind_end, arr.wind_end + 0.5 * fit.cost(40),
                      40, fit, arr)
    s = core.Session(policy=policy, calibrate=True, drift_threshold=0.2,
                     min_samples=2, refit_every=1_000_000)
    s.submit(core.RecurringQuerySpec(base=base, period=60.0, num_windows=4,
                                     true_cost_model=true))
    trace = s.run()
    cal = s.calibrator("d")
    return (rows(trace), cal.refits, cal.samples,
            [cal.cost(n) for n in (1, 10, 40)], cal.agg_cost(4))


@pytest.mark.parametrize("policy", ["single", "llf-dynamic"])
def test_calibrating_session_trace_identical(policy):
    want, got = both(calibrating, policy)
    assert got == want
    assert any(e["kind"] == "recalibrate" for e in got[0]["events"])


# -- pane sharing --------------------------------------------------------------

def sharing(core, withdraw):
    s = core.Session(policy="llf-dynamic", sharing=True, c_max=25.0,
                     admission_control=False)
    for i, qid in enumerate(("a", "b", "c")):
        q = uniform_query(core, qid, 0.0, 40.0, 40, 90.0,
                          linear(core, 1.0, 0.5, 0.0), stream="s",
                          stream_offset=0)
        s.submit(core.RecurringQuerySpec(base=q, period=40.0, num_windows=2))
    s.run_until(10.0)
    if withdraw:
        s.withdraw("c")
    trace = s.run_until(300.0)
    return rows(trace), dataclasses.asdict(s.pane_stats)


@pytest.mark.parametrize("withdraw", [False, True])
def test_sharing_session_trace_identical(withdraw):
    want, got = both(sharing, withdraw)
    assert got == want
    assert got[1]["hits"] > 0


# -- overload control ------------------------------------------------------------

def overload_query(core, qid, tier=0, shed=True, slack=30.0):
    """100 tuples over [0, 100] at one unit a tuple: one such query
    saturates the executor."""
    arr = core.UniformWindowArrival(wind_start=0.0, wind_end=100.0,
                                    num_tuples_total=100)
    return core.Query(qid, 0.0, 100.0, 100.0 + slack, 100,
                      core.LinearCostModel(tuple_cost=1.0), arr, tier=tier, shed=shed)


def overloaded(core, renegotiate):
    """Two saturating queries: the second is shed (tier 1) or, marked
    ``shed=False``, offered a deadline extension that the hook takes."""
    s = core.Session(policy="llf-dynamic", overload=True, c_max=50.0,
                     on_renegotiate=(lambda p: True) if renegotiate else None)
    res = [s.submit(overload_query(core, "gold", shed=False)),
           s.submit(overload_query(core, "bronze", tier=1, shed=not renegotiate))]
    return rows(s.run_until(500.0)), [admission(r) for r in res]


@pytest.mark.parametrize("renegotiate", [False, True])
def test_overload_session_trace_identical(renegotiate):
    want, got = both(overloaded, renegotiate)
    assert got == want
    decision = got[1][1]["decision"]
    assert decision == ("renegotiate" if renegotiate else "shed")


def test_overload_planning_functions_identical():
    def go(core):
        qs = [overload_query(core, f"q{i}", tier=i % 2, shed=i != 0) for i in range(3)]
        plan = core.plan_shedding(qs, now=0.0, config=core.OverloadConfig())
        thin, cum, bound = core.apply_shed(qs[1], 0.25)
        prop = core.min_deadline_extension(overload_query(core, "b", shed=False),
                                           [overload_query(core, "a", shed=False)])
        return (dataclasses.asdict(plan), dataclasses.asdict(core.overload_check(qs)),
                dataclasses.asdict(core.tiered_work_demand_condition(qs)),
                thin.num_tuples_total, cum, bound, core.shed_error_bound(0.3, 70),
                dataclasses.asdict(prop))

    want, got = both(go)
    assert got == want


# -- forecasting -----------------------------------------------------------------

SPAN = 100.0


def burst_arr(core, start, n=100, burst=20.0):
    """All n tuples in the last ``burst`` time units of the window."""
    return core.UniformWindowArrival(wind_start=start + SPAN - burst,
                                     wind_end=start + SPAN, num_tuples_total=n)


def forecasting(core, case, runtime):
    """``proactive``: windows predicted uniform arrive in a tail burst, and
    the forecast sheds later windows before their burst lands; ``refund``:
    window 4 arrives later still and its shed is refunded; ``prewarm``:
    a sliding window over a shared stream pre-warms panes."""
    if case == "prewarm":
        base = uniform_query(core, "r", 0.0, SPAN, 100, SPAN + 400.0,
                             core.LinearCostModel(tuple_cost=0.05), stream="clicks")
        spec = core.RecurringQuerySpec(base=base, period=SPAN / 2, num_windows=8,
                                       slide_tuples=50)
        s = core.Session(policy="llf-dynamic", runtime=runtime, sharing=True,
                         forecast=True)
    else:
        late = {4: burst_arr(core, 4 * SPAN, burst=4.0)} if case == "refund" else {}
        base = uniform_query(core, "r", 0.0, SPAN, 100, SPAN + 30.0,
                             core.LinearCostModel(tuple_cost=1.0))
        spec = core.RecurringQuerySpec(
            base=base, period=SPAN, num_windows=8,
            truth_factory=lambda w: late.get(w) or burst_arr(core, w * SPAN))
        s = core.Session(policy="llf-dynamic", runtime=runtime, overload=True,
                         forecast=core.ForecastConfig())
    s.submit(spec)
    trace = s.run()
    h = s.history("r")
    fc = s.forecaster("r")
    return (rows(trace), [dataclasses.asdict(o) for o in h.arrivals],
            h.cost_samples, (fc.num_observations, fc.hits, fc.misses),
            None if s.pane_stats is None else dataclasses.asdict(s.pane_stats))


@pytest.mark.parametrize("runtime", [None, "heap"])
@pytest.mark.parametrize("case, event", [("proactive", "forecast_shed"),
                                         ("refund", "forecast_refund"),
                                         ("prewarm", "pane_prewarm")])
def test_forecast_session_trace_identical(case, event, runtime):
    want, got = both(forecasting, case, runtime)
    assert got == want
    assert any(e["kind"] == event for e in got[0]["events"])


def test_forecaster_and_observations_identical():
    def go(core):
        fc = core.ArrivalForecaster(core.ForecastConfig())
        for w in range(5):
            arr = core.UniformWindowArrival(wind_start=w * 10.0 + 3.0 * (w % 2),
                                            wind_end=w * 10.0 + 10.0,
                                            num_tuples_total=20 + 3 * w)
            fc.observe(core.observe_arrival(arr, window=w))
        f = fc.forecast(5)
        q = uniform_query(core, "q", 50.0, 10.0, 20, 80.0)
        fq = core.forecast_query(q, f)
        return (dataclasses.asdict(f), fq.num_tuples_total, fq.wind_start,
                fq.arrival.tuples_available(55.0),
                core.offered_arrival(q.arrival).tuples_available(55.0))

    want, got = both(go)
    assert got == want


# -- tenancy -------------------------------------------------------------------

def tenant_session(core, runtime):
    quotas = {"a": core.TenantQuota(weight=2.0, capacity=0.5),
              "b": core.TenantQuota(weight=1.0, capacity=0.3)}
    s = core.Session(policy="llf-dynamic", runtime=runtime, overload=True,
                     tenancy=core.TenancyConfig(quotas=quotas))
    res = []
    for i in range(4):
        tenant = "ab"[i % 2]
        base = uniform_query(core, f"{tenant}{i}", 2.0 * i, 10.0, 6, 2.0 * i + 22.0,
                             tier=i % 2, tenant=tenant)
        res.append(s.submit(core.RecurringQuerySpec(base=base, period=30.0,
                                                    num_windows=2)))
    res.append(s.submit(uniform_query(core, "a-big", 10.0, 10.0, 200, 70.0,
                                      core.LinearCostModel(tuple_cost=0.2),
                                      tenant="a")))
    s.run_until(15.0)
    applied = s.set_quota("b", core.TenantQuota(weight=1.0, capacity=0.05))
    trace = s.run_until(120.0)
    return (rows(trace), [admission(r) for r in res],
            None if applied is None else dataclasses.asdict(applied),
            core.tenant_summary(trace.outcomes))


@pytest.mark.parametrize("runtime", [None, "heap"])
def test_tenancy_session_trace_identical(runtime):
    want, got = both(tenant_session, runtime)
    assert got == want
    assert any(e["kind"] == "quota" for e in got[0]["events"])
    assert [r["decision"] for r in got[1]] == ["admit"] * 4 + ["shed"]
    assert got[2] is not None  # the tightened quota shed live windows


def test_zipf_traffic_identical():
    def go(core):
        def factory(tenant, k, g):
            return uniform_query(core, f"{tenant}-{k}", 3.0 * g, 10.0, 5, 3.0 * g + 30.0)

        qs = core.zipf_traffic(17, ["t0", "t1", "t2", "t3"], factory, skew=1.2)
        return ([(q.query_id, q.tenant) for q in qs], core.zipf_counts(100, 5, 0.8, 2),
                core.zipf_shares(6, 1.5), core.demand_by_tenant(qs))

    want, got = both(go)
    assert got == want


FAIR_CASES = [
    ({"a": 10.0, "b": 90.0}, {"a": 1.0, "b": 1.0}, 60.0),
    ({"a": 10.0, "b": 90.0, "c": 40.0}, {"a": 2.0, "b": 1.0, "c": 1.0}, 100.0),
    ({"a": 50.0, "b": 50.0, "c": 0.0}, {"a": 1.0, "b": 0.0, "c": 1.0}, 30.0),
    ({"a": 90.0, "b": 90.0}, None, 60.0),
    ({"a": 7.0}, {"a": 4.0}, 0.0),
]


@pytest.mark.parametrize("demand, weights, capacity", FAIR_CASES)
def test_fair_shares_identical(demand, weights, capacity):
    assert TTEN.fair_shares(demand, weights, capacity) == \
        RTEN.fair_shares(demand, weights, capacity)


def test_fair_shares_identical_property():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    rows_ = st.lists(st.tuples(st.floats(0.0, 100.0), st.floats(0.0, 8.0)),
                     min_size=1, max_size=6)

    @hypothesis.settings(max_examples=80, deadline=None, database=None,
                         derandomize=True)
    @hypothesis.given(rows=rows_, capacity=st.floats(0.0, 250.0))
    def check(rows, capacity):
        demand = {f"t{i}": d for i, (d, _) in enumerate(rows)}
        weights = {f"t{i}": w for i, (_, w) in enumerate(rows)}
        assert TTEN.fair_shares(demand, weights, capacity) == \
            RTEN.fair_shares(demand, weights, capacity)

    check()


# A subnormal weight: cap * w / wsum rounds cap * w up to w, so the one
# tenant is allotted its whole demand, above capacity (ROADMAP.md section 3).
# The port keeps the reference's arithmetic.
SUBNORMAL = ({"t0": 1.0}, {"t0": 5e-324}, 0.75)


def test_fair_shares_subnormal_weight_equals_reference():
    assert TTEN.fair_shares(*SUBNORMAL) == RTEN.fair_shares(*SUBNORMAL)


@pytest.mark.xfail(strict=True, reason="the reference's fair_shares allots above "
                   "capacity for a subnormal weight (ROADMAP.md section 3); the "
                   "port's copy is faithful")
def test_fair_shares_subnormal_weight_within_capacity():
    demand, weights, capacity = SUBNORMAL
    assert sum(TTEN.fair_shares(demand, weights, capacity).values()) <= capacity + 1e-6


# -- schedulability ----------------------------------------------------------------

def test_schedulability_reports_identical():
    def go(core):
        qs = [uniform_query(core, f"q{i}", 2.0 * i, 10.0, 8 + i, 2.0 * i + 13.0 + i)
              for i in range(4)]
        ledger = core.DemandLedger(qs[:2])
        ledger.add(qs[2])
        return ([dataclasses.asdict(core.check_schedulability(qs, c_max=c)) for c in
                 (float("inf"), 2.0)],
                dataclasses.asdict(core.admission_check([qs[3]], qs[:3])),
                dataclasses.asdict(core.work_demand_condition(qs)),
                dataclasses.asdict(core.post_window_condition(qs)),
                [core.min_post_window_work(q) for q in qs],
                [q.query_id for q in core.edf_order(qs)])

    want, got = both(go)
    assert got == want


# -- the simulator's baselines (paper section 7) -------------------------------------

@pytest.mark.parametrize("interval", [1.0, 7.5, 40.0])
def test_simulator_baselines_identical(interval):
    def go(core):
        q = fixed_query(core, "q", n=60, rate=2.0, slack=2.0)
        qs = [fixed_query(core, f"s{i}", start=10.0 * i, n=20) for i in range(5)]
        mem = core.MemoryModel(bytes_per_tuple=1e6, capacity_bytes=4e7,
                               partial_bytes_per_batch=1e5)
        return (rows(core.micro_batch_trace(q, interval)), rows(core.one_shot_trace(q)),
                core.batched_cost_curve(q, [1, 2, 5, 60, 100]),
                [(x.query_id, x.deadline) for x in
                 core.staggered_deadlines(qs, delta=0.5, c_max=3.0, seed=4)],
                (mem.streaming_oom(60), mem.batch_oom(20, 3), mem.batch_peak(20, 3)))

    want, got = both(go)
    assert got == want


# -- the legacy shims --------------------------------------------------------------

def test_deprecated_shims_identical():
    def go(core):
        q = fixed_query(core, "q", n=10, slack=0.6)
        with pytest.warns(DeprecationWarning):
            single = core.schedule_single(q)
        with pytest.warns(DeprecationWarning):
            agg = core.schedule_with_agg_cost(q)
        with pytest.warns(DeprecationWarning):
            noagg = core.schedule_without_agg_cost(q, q.deadline)
        with pytest.warns(DeprecationWarning):
            cons = core.schedule_via_constraints(q)
        with pytest.warns(DeprecationWarning):
            brute = core.brute_force_optimal(q)
        with pytest.warns(DeprecationWarning):
            trace = core.execute_single(q, single)
        with pytest.warns(DeprecationWarning):
            dyn = core.schedule_dynamic([fixed_query(core, f"d{i}", start=float(i),
                                                     slack=5.0) for i in range(3)],
                                        core.Strategy.LLF)
        return ([(s.sch_tuples, s.sch_points) for s in (single, agg, noagg)],
                cons, brute, rows(trace), rows(dyn))

    want, got = both(go)
    assert repr(got) == repr(want)


# -- the real backends ----------------------------------------------------------------

from repro.data import tpch as RT  # noqa: E402
from repro.serve import analytics as RA  # noqa: E402
from repro_torch.data import tpch as TT  # noqa: E402
from repro_torch.serve import analytics as TA  # noqa: E402

RSCALE, TSCALE = RT.StreamScale(0.005), TT.StreamScale(0.005)


def _windows(tpch, sc, stream, num_windows, per_window, seed=5):
    files, times = [], []
    for t, o, l in tpch.stream_files(seed=seed, num_files=num_windows * per_window, sc=sc):
        files.append(l if stream == "lineitem" else o)
        times.append(t)
    return ([files[w * per_window:(w + 1) * per_window] for w in range(num_windows)],
            [times[w * per_window:(w + 1) * per_window] for w in range(num_windows)])


def session_run(core, tpch, analytics, sc, qid, calibrate, **kw):
    aq = next(a for a in tpch.PAPER_QUERIES if a.query_id == qid)
    windows, wts = _windows(tpch, sc, aq.stream, 3, 12)
    cm = linear(core, 0.05, 0.3, 0.1)
    return analytics.run_session(aq, windows, wts, sc, cm, period=12.0,
                                 calibrate=calibrate, **kw)


@pytest.mark.parametrize("qid", ["CQ3", "CQ4", "TPC-Q6-like"])
@pytest.mark.parametrize("calibrate", [False, True])
def test_run_session_matches_reference(qid, calibrate):
    want, wtrace = session_run(R, RT, RA, RSCALE, qid, calibrate)
    got, gtrace = session_run(T, TT, TA, TSCALE, qid, calibrate, device="cpu")
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for w in want:
        assert got[w].shape == want[w].shape
        if qid == "TPC-Q6-like":
            np.testing.assert_allclose(got[w], want[w], rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[w], want[w])
    series = gtrace.outcome_series(qid)
    assert [o.complete for o in series] == [True] * 3
    assert [e.kind for e in gtrace.events].count("window_open") == 3
    if not calibrate:  # measured seconds feed the model only when calibrating
        assert rows(gtrace) == rows(wtrace)


# -- serve_session: online admission on the prefill engine --------------------

SEQ = 16
VOCAB = 128


def prefill_executors(arch="recurrentgemma_9b"):
    """The reference's and the port's prefill executors over one reduced
    config, with the same f32 weights carried across."""
    import jax
    import jax.numpy as jnp
    from repro.models import base as JB, lm as JL, params as JP
    from repro.serve import engine as RE
    from repro_torch.models import base as TB
    from repro_torch.models.params import params_from_numpy
    from repro_torch.serve import engine as TE

    jcfg = dataclasses.replace(JB.get_config(arch).reduced(), vocab_size=VOCAB)
    tcfg = dataclasses.replace(TB.get_config(arch).reduced(), vocab_size=VOCAB)
    jp = JP.init_params(JL.build_specs(jcfg), jax.random.PRNGKey(0))
    jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    buckets = (1, 2, 4, 8)
    return ((RE, RE.PrefillExecutor(jcfg, jp, buckets=buckets)),
            (TE, TE.PrefillExecutor(tcfg, tp, buckets=buckets, device="cpu")))


def admission_jobs(engine, core):
    """Two feasible jobs at staggered submit instants and one whose
    deadline lies below its least cost: its last prompt arrives at the
    window's end and needs cost(1) after it."""
    rng = np.random.default_rng(0)
    cm = core.LinearCostModel(tuple_cost=0.02, overhead=0.05)

    def job(jid, n, start, deadline):
        return engine.WindowJob(
            job_id=jid, prompts=rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32),
            arrival=core.UniformWindowArrival(start, start + 10.0, n), deadline=deadline)

    jobs = [job("j0", 4, 0.0, 10.0 + 3.0 * cm.cost(4)),
            job("j1", 6, 2.0, 12.0 + 3.0 * cm.cost(6)),
            job("hopeless", 5, 1.0, 11.0 + 0.5 * cm.cost(1))]
    return jobs, cm


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's prefill while the test runs: with
    one per core in each of several test processes, a batch that takes
    10 ms alone took up to 2.2 s, past the test's ``c_max``."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("calibrate", [False, True])
def test_serve_session_matches_reference(calibrate, one_torch_thread):
    out = []
    for (engine, ex), core in zip(prefill_executors(), (R, T)):
        # Every bucket at SEQ once before the session, as the engine's
        # ``calibrate`` does: the reference's first call of a bucket times
        # its jit compile, which can pass c_max and re-queue the batch.
        for b in ex.buckets:
            ex.run_batch(np.zeros((b, SEQ), np.int32))
        jobs, cm = admission_jobs(engine, core)
        report, session = engine.serve_session(
            jobs, ex, cm, policy="llf-dynamic", submit_times=[0.0, 3.0, 1.0],
            calibrate=calibrate, c_max=2.0)
        assert session.trace.stragglers == [], (
            f"{engine.__name__}: a prefill batch took longer than c_max=2.0 s "
            f"of wall time: {session.trace.stragglers}")
        out.append((jobs, report, session))
    (jjobs, want, wsession), (tjobs, got, tsession) = out
    assert set(got) == set(want) == {"j0", "j1", "hopeless"}
    assert got["hopeless"] == want["hopeless"] == {"admitted": False}
    assert tjobs[2].processed == 0 and not tjobs[2].results
    for jid in ("j0", "j1"):
        assert set(got[jid]) == set(want[jid])
        assert got[jid]["admitted"] and got[jid]["completed"]
        assert got[jid]["processed"] == want[jid]["processed"]
        assert got[jid]["wall_exec_seconds"] > 0.0
        if not calibrate:  # measured seconds feed the model only when calibrating
            for key, val in want[jid].items():
                if key != "wall_exec_seconds":
                    assert got[jid][key] == val, key
    for jj, tj in zip(jjobs[:2], tjobs[:2]):
        assert tj.processed == tj.num_requests
        logits = np.concatenate(tj.results)
        assert logits.shape == (tj.num_requests, VOCAB) and np.isfinite(logits).all()
        np.testing.assert_allclose(logits, np.concatenate(jj.results), rtol=2e-4, atol=2e-4)
    assert any(e.kind == "reject" and e.query_id == "hopeless"
               for e in tsession.trace.events)
    if not calibrate:
        assert rows(tsession.trace) == rows(wsession.trace)
    assert tsession.now >= max(got[j]["completion"] for j in ("j0", "j1"))
