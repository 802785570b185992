"""The port's device mesh (``repro_torch.dist.mesh``) and the ``mesh=`` knob
of its analytics entry points, on the CPU, against the JAX package's
``repro.dist`` on its one jax device.

The port's CPU meshes repeat one device (``["cpu"] * D``): each slot runs
its own shard and the partials are merged on the first, so D > 1 needs no
``XLA_FLAGS``.  Integer-valued f32 sums are exact under any association, so
the mesh against the single-device op is EXACT equality; TPC-Q6-like's float
sum is held within 1e-5 (f32 addition order changes with D)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.data import tpch as RT
from repro.dist import DeviceMesh as RMesh
from repro.dist import on_fallback as r_on_fallback
from repro.dist.sharding import _emit_fallback as r_emit_fallback
from repro.dist.sharding import batch_shard_extents as r_extents
from repro.kernels.segagg import ops as rops
from repro.serve import analytics as RA
from repro_torch.data import tpch as TT
from repro_torch.dist import DeviceMesh, MeshBackend
from repro_torch.dist import mesh as tmesh
from repro_torch.kernels.segagg.ref import pane_segagg_ref, segagg_ref
from repro_torch.serve import analytics as TA

RSCALE, TSCALE = RT.StreamScale(0.005), TT.StreamScale(0.005)
DEVICES = [1, 2, 3, 8]
ROWS = ["zero", "one", "d_minus_1", "ragged", "divisible"]


def n_rows(kind, d):
    return {"zero": 0, "one": 1, "d_minus_1": d - 1, "ragged": 5 * d + 1,
            "divisible": 6 * d}[kind]


def int_valued(rng, n, v=3):
    """Integer-valued f32 rows: sums are exact regardless of association."""
    return rng.integers(0, 8, size=(n, v)).astype(np.float32)


def cpu_mesh(d, **kw):
    return DeviceMesh(["cpu"] * d, **kw)


# -- extents and shardings ----------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 8, 64, 100])
@pytest.mark.parametrize("d", DEVICES)
def test_shard_extents_match_reference(n, d):
    assert cpu_mesh(d).shard_extents(n) == r_extents(n, d)


@pytest.mark.parametrize("d", DEVICES)
def test_divisible_rows_match_the_extents(d):
    mesh = cpu_mesh(d)
    n = 6 * d
    assert mesh.batch_sharding(n, 2) == mesh.shard_extents(n)
    assert mesh.events == []


@pytest.mark.parametrize("d", [2, 3, 8])
def test_non_divisible_rows_fall_back_with_the_reference_event(d):
    want = []
    unsub = r_on_fallback(want.append)
    try:
        r_emit_fallback(6 * d + 1, ("data",), d)
    finally:
        unsub()
    seen = []
    mesh = cpu_mesh(d, on_event=seen.append)
    assert mesh.batch_sharding(6 * d + 1, 2) is None
    assert mesh.events == seen == want
    assert len(want) == 1 and want[0]["kind"] == "sharding_fallback"


def test_fallback_events_stay_with_their_mesh():
    seen = []
    two, three = cpu_mesh(2, on_event=seen.append), cpu_mesh(3)
    assert two.batch_sharding(7, 1) is None
    assert three.batch_sharding(7, 1) is None
    assert two.batch_sharding(8, 1) == ((0, 4), (4, 4))
    assert [e["axis_size"] for e in seen] == [e["axis_size"] for e in two.events] == [2]
    assert [e["axis_size"] for e in three.events] == [3]


# -- segagg and pane_segagg ---------------------------------------------------


@pytest.mark.parametrize("kind", ROWS)
@pytest.mark.parametrize("d", DEVICES)
def test_segagg_matches_reference(d, kind):
    n, g = n_rows(kind, d), 16
    rng = np.random.default_rng(d * 1000 + n)
    keys = rng.integers(0, g, size=n).astype(np.int32)
    vals = int_valued(rng, n)
    want = np.asarray(rops.segagg(keys, vals, g))
    assert np.array_equal(np.asarray(RMesh(1).segagg(keys, vals.copy(), g)), want)
    got = cpu_mesh(d).segagg(keys, vals, g)
    assert got.shape == (g, 3) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # values is not consumed: a second call on the same arrays agrees
    assert torch.equal(cpu_mesh(d).segagg(torch.from_numpy(keys),
                                          torch.from_numpy(vals), g), got)


@pytest.mark.parametrize("kind", ROWS)
@pytest.mark.parametrize("d", DEVICES)
def test_pane_segagg_matches_reference(d, kind):
    n, p, g = n_rows(kind, d), 5, 8
    rng = np.random.default_rng(7 + d + n)
    keys = rng.integers(0, g, size=n).astype(np.int32)
    panes = rng.integers(0, p, size=n).astype(np.int32)
    vals = int_valued(rng, n, v=2)
    want = np.asarray(rops.pane_segagg(keys, vals, panes, p, g))
    got = cpu_mesh(d).pane_segagg(keys, vals, panes, p, g)
    assert got.shape == (p, g, 2)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, pane_segagg_ref(torch.from_numpy(keys), torch.from_numpy(vals),
                                            torch.from_numpy(panes), p, g))


@pytest.mark.parametrize("d", DEVICES)
def test_1d_values(d):
    keys, vals = np.array([0, 1, 1], np.int32), np.array([1.0, 2.0, 3.0])
    want = np.asarray(RMesh(1).segagg(keys, vals.copy(), 4))
    out = cpu_mesh(d).segagg(keys, vals, 4)
    assert out.shape == (4, 1) == want.shape
    assert np.array_equal(out[:, 0].numpy(), [1.0, 5.0, 0.0, 0.0])
    assert np.array_equal(out.numpy(), want)


def test_padding_rows_are_dropped():
    # 7 rows over 4 slots: one padding row per short slot, keyed num_groups
    keys = torch.tensor([0, 1, 2, 3, 0, 1, 2], dtype=torch.int32)
    vals = torch.ones((7, 1))
    assert torch.equal(cpu_mesh(4).segagg(keys, vals, 4), segagg_ref(keys, vals, 4))


def test_device_count_validation():
    with pytest.raises(ValueError, match="at least one"):
        DeviceMesh(0)
    with pytest.raises(ValueError, match="at least one"):
        DeviceMesh([])
    k = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(ValueError, match="explicit device list"):
        DeviceMesh(k)
    assert cpu_mesh(3).num_devices == 3
    assert cpu_mesh(3).devices == (torch.device("cpu"),) * 3


def test_no_cpu_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMesh(None)
    with pytest.raises(ValueError, match="explicit device list"):
        DeviceMesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMesh(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="unsupported device"):
        DeviceMesh(["meta"])


def test_a_mesh_is_all_cpu_or_all_cuda(monkeypatch):
    monkeypatch.setattr(tmesh, "_device", torch.device)
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        DeviceMesh(["cpu", "cuda:0"])


# -- MeshBackend: measured per-worker weights ---------------------------------


class _FakeMesh:
    """num_devices is all MeshBackend.__init__ reads off the mesh."""

    def __init__(self, n):
        self.num_devices = n


def _weights_backend(backend_cls, solo):
    wb = backend_cls(_FakeMesh(len(solo)), names=tuple(solo))
    for name, (tuples, secs) in solo.items():
        wb._solo_tuples[name] = tuples
        wb._solo_secs[name] = secs
    return wb


@pytest.mark.parametrize("solo", [
    {"a": (0.0, 0.0), "b": (0.0, 0.0)},          # no solo data: neutral
    {"a": (100.0, 1.0), "b": (100.0, 1.1)},      # below the threshold: neutral
    {"a": (100.0, 1.0), "b": (100.0, 2.0)},      # heterogeneous
    {"a": (100.0, 1.0), "b": (0.0, 0.0), "c": (50.0, 1.0)},
    {"a": (10.0, 1.0), "b": (40.0, 1.0), "c": (20.0, 1.0)},
], ids=["empty", "noise", "two_x", "one_unmeasured", "three_way"])
def test_worker_weights_match_reference(solo):
    from repro.dist import MeshBackend as RMeshBackend

    got = _weights_backend(MeshBackend, solo).worker_weights
    assert got == _weights_backend(RMeshBackend, solo).worker_weights
    assert sum(got) == pytest.approx(len(got))


def test_heterogeneous_weights_normalize_to_mean_one():
    w = _weights_backend(MeshBackend, {"a": (100.0, 1.0), "b": (100.0, 2.0)}).worker_weights
    assert w[0] == pytest.approx(2 * w[1], rel=1e-6)


def test_name_count_must_match_devices():
    with pytest.raises(ValueError, match="names"):
        MeshBackend(cpu_mesh(1), names=("a", "b"))
    assert MeshBackend(cpu_mesh(3)).worker_names == ("d0", "d1", "d2")


# -- MeshAnalyticsBackend end to end ------------------------------------------


def _stream(tpch, sc, aq, n=16, seed=5):
    return [(line if aq.stream == "lineitem" else o)
            for _, o, line in tpch.stream_files(seed=seed, num_files=n, sc=sc)]


def _fixed_query(core, cm, qid="q0", n=16, slack=50.0):
    arr = core.TraceArrival(timestamps=tuple(float(i) for i in range(n)))
    base = core.LinearCostModel(tuple_cost=0.4, overhead=0.3, agg_per_batch=0.2)
    return core.Query(qid, arr.wind_start, arr.wind_end,
                      arr.wind_end + slack * base.cost(n), n, cm, arr)


def mesh_backend_run(core, tpch, analytics, sc, mesh, ways, qid="CQ2"):
    aq = next(a for a in tpch.PAPER_QUERIES if a.query_id == qid)
    wb = analytics.MeshAnalyticsBackend({"q0": (aq, _stream(tpch, sc, aq))}, sc, mesh)
    pool = core.ExecutorPool(worker_backend=wb)
    base = core.LinearCostModel(tuple_cost=1.0, overhead=1.0)
    cm = core.ShardedCostModel(base, ways) if ways > 1 else base
    trace = core.run(core.get_policy("llf-dynamic", shard_across=ways),
                     [_fixed_query(core, cm)], pool)
    assert trace.outcome("q0").complete
    return wb, trace


@pytest.mark.parametrize("qid", ["CQ2", "CQ3", "TPC-Q6-like"])
def test_single_device_backend_matches_reference(qid):
    want, _ = mesh_backend_run(R, RT, RA, RSCALE, RMesh(1), 1, qid)
    got, _ = mesh_backend_run(T, TT, TA, TSCALE, cpu_mesh(1), 1, qid)
    aq = next(a for a in RT.PAPER_QUERIES if a.query_id == qid)
    oneshot, _, _ = RA.run_batched(aq, _stream(RT, RSCALE, aq), 16, RSCALE)
    assert got.results["q0"].shape == want.results["q0"].shape
    if qid == "TPC-Q6-like":
        np.testing.assert_allclose(got.results["q0"], want.results["q0"], rtol=1e-5)
        np.testing.assert_allclose(got.results["q0"], oneshot, rtol=1e-5)
    else:
        assert np.array_equal(got.results["q0"], want.results["q0"])
        assert np.array_equal(got.results["q0"].ravel(), np.asarray(oneshot).ravel())


@pytest.mark.parametrize("ways", [2, 4])
def test_sharded_backend_is_exact_and_fused(ways):
    one, _ = mesh_backend_run(T, TT, TA, TSCALE, cpu_mesh(1), 1)
    wb, trace = mesh_backend_run(T, TT, TA, TSCALE, cpu_mesh(ways), ways)
    assert np.array_equal(wb.results["q0"], one.results["q0"])
    # Group dispatch: sharded batches share one start/end per group, and
    # every mesh worker participates.
    batches = [e for e in trace.executions if e.kind == "batch"]
    assert len({(e.start, e.end) for e in batches}) < len(batches)
    assert {e.worker for e in batches} == set(wb.worker_names)


def test_wall_clock_bookkeeping_and_reset():
    wb, _ = mesh_backend_run(T, TT, TA, TSCALE, cpu_mesh(2), 2)
    assert wb.wall_seconds["q0"] > 0.0
    assert all(p.device.type == "cpu" for p in wb._partials["q0"].values())
    wb.reset(0.0)
    assert wb.results == {} and wb._partials == {}


def test_requeue_overwrites_its_slot():
    aq = TT.PAPER_QUERIES[1]
    wb = TA.MeshAnalyticsBackend({"q0": (aq, _stream(TT, TSCALE, aq))}, TSCALE, cpu_mesh(2))
    q = _fixed_query(T, T.LinearCostModel(tuple_cost=1.0))
    wb._batch_execute(q, 8, 0)
    wb.requeue_batch(q, 8, 0)
    wb._group_execute(q, (4, 4), 8, ("d0", "d1"))
    wb._agg_execute(q, 2)
    oneshot, _, _ = TA.run_batched(aq, _stream(TT, TSCALE, aq), 16, TSCALE, device="cpu")
    assert np.array_equal(wb.results["q0"], oneshot)


# -- mesh= against mesh=None at each entry point -------------------------------


class CountingMesh(DeviceMesh):
    """A CPU mesh that counts its segagg and pane_segagg calls."""

    def __init__(self, d):
        super().__init__(["cpu"] * d)
        self.calls = {"segagg": 0, "pane_segagg": 0}

    def segagg(self, *a, **kw):
        self.calls["segagg"] += 1
        return super().segagg(*a, **kw)

    def pane_segagg(self, *a, **kw):
        self.calls["pane_segagg"] += 1
        return super().pane_segagg(*a, **kw)


def _same(qid, got, want, d):
    assert got.shape == want.shape
    if qid == "TPC-Q6-like" and d > 1:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def rows(trace):
    out = {"executions": [dataclasses.asdict(e) for e in trace.executions],
           "outcomes": [dataclasses.asdict(o) for o in trace.outcomes]}
    if hasattr(trace, "events"):
        out["events"] = [dataclasses.asdict(e) for e in trace.events]
    return out


TQ = {q.query_id: q for q in TT.PAPER_QUERIES}
MESH_QIDS = ["CQ3", "TPC-Q6-like"]


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("qid", MESH_QIDS)
def test_process_batch_with_a_mesh(qid, d):
    files = _stream(TT, TSCALE, TQ[qid], 6)
    mesh = CountingMesh(d)
    plain = TA.AnalyticsExecutor(TQ[qid], TSCALE, device="cpu")
    meshed = TA.AnalyticsExecutor(TQ[qid], TSCALE, device="cpu", mesh=mesh)
    assert meshed.device == torch.device("cpu")
    for ex in (plain, meshed):
        ex.process_batch(TA.concat_files(files[:4]))
        ex.process_batch(TA.concat_files(files[4:]))
    assert mesh.calls["segagg"] == 2
    _same(qid, meshed.finalize()[0], plain.finalize()[0], d)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("qid", MESH_QIDS)
def test_run_batched_and_run_plan_with_a_mesh(qid, d):
    files = _stream(TT, TSCALE, TQ[qid], 24)
    mesh = CountingMesh(d)
    want, _, nb = TA.run_batched(TQ[qid], files, 5, TSCALE, device="cpu")
    got, _, nb_mesh = TA.run_batched(TQ[qid], files, 5, TSCALE, mesh=mesh)
    assert nb == nb_mesh == mesh.calls["segagg"] == 5
    _same(qid, got, want, d)
    cm = T.LinearCostModel(tuple_cost=0.4, overhead=0.3, agg_per_batch=0.2)
    arr = T.TraceArrival(timestamps=tuple(float(i) for i in range(24)))
    plan = T.Planner(policy="single").schedule(
        T.Query("it", arr.wind_start, arr.wind_end, arr.wind_end + 0.5 * cm.cost(24),
                24, cm, arr))
    want, wlog, _ = TA.run_plan(TQ[qid], files, plan, TSCALE, device="cpu")
    got, glog, _ = TA.run_plan(TQ[qid], files, plan, TSCALE, mesh=mesh)
    assert [b.num_records for b in glog] == [b.num_records for b in wlog]
    assert mesh.calls["segagg"] == 5 + plan.num_batches
    _same(qid, got, want, d)


@pytest.mark.parametrize("qid", MESH_QIDS)
def test_multi_query_runtime_executor_with_a_mesh(qid):
    files = _stream(TT, TSCALE, TQ[qid], 20)
    arr = T.TraceArrival(timestamps=tuple(float(i) for i in range(20)))
    out = []
    for kw in ({"device": "cpu"}, {"mesh": CountingMesh(2)}):
        ex = TA.AnalyticsRuntimeExecutor({"a": (TQ[qid], files), "b": (TQ[qid], files[:10])},
                                         TSCALE, **kw)
        cm = T.LinearCostModel(tuple_cost=0.1, overhead=0.3, agg_per_batch=0.1)
        qs = [T.Query("a", arr.wind_start, arr.wind_end, arr.wind_end + 4.0, 20, cm, arr),
              T.Query("b", arr.wind_start, arr.wind_end, arr.wind_end + 6.0, 10, cm, arr)]
        out.append((ex, T.Planner(policy="llf-dynamic").run(qs, executor=ex)))
    (ex, trace), (mex, mtrace) = out
    assert rows(mtrace) == rows(trace)
    for key in ("a", "b"):
        _same(qid, mex.results[key], ex.results[key], 2)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("qid", ["CQ4", "TPC-Q6-like"])
def test_run_session_with_a_mesh(qid, d):
    aq = TQ[qid]
    files, times = [], []
    for t, o, line in TT.stream_files(seed=5, num_files=36, sc=TSCALE):
        files.append(line if aq.stream == "lineitem" else o)
        times.append(t)
    windows = [files[w * 12:(w + 1) * 12] for w in range(3)]
    wts = [times[w * 12:(w + 1) * 12] for w in range(3)]
    cm = T.LinearCostModel(tuple_cost=0.05, overhead=0.3, agg_per_batch=0.1)
    mesh = CountingMesh(d)
    want, wtrace = TA.run_session(aq, windows, wts, TSCALE, cm, period=12.0,
                                  calibrate=False, device="cpu")
    got, gtrace = TA.run_session(aq, windows, wts, TSCALE, cm, period=12.0,
                                 calibrate=False, mesh=mesh)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert mesh.calls["segagg"] > 0
    for w in want:
        _same(qid, got[w], want[w], d)
    assert rows(gtrace) == rows(wtrace)


SLIDING = [(0, 30), (5, 30), (10, 30), (15, 30)]


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("qid", MESH_QIDS)
def test_run_shared_jobs_with_a_mesh(qid, d, share):
    files = _stream(TT, TSCALE, TQ[qid], 45)
    cm = T.LinearCostModel(tuple_cost=0.02, overhead=0.1, agg_per_batch=0.01)
    mesh = CountingMesh(d)
    want, wtrace, wbook = TA.run_shared_jobs(TQ[qid], files, SLIDING, TSCALE, cm,
                                             share=share, c_max=5.0, device="cpu")
    got, gtrace, gbook = TA.run_shared_jobs(TQ[qid], files, SLIDING, TSCALE, cm,
                                            share=share, c_max=5.0, mesh=mesh)
    assert sorted(got) == sorted(want)
    for key in want:
        _same(qid, got[key], want[key], d)
    assert rows(gtrace) == rows(wtrace)
    assert dataclasses.asdict(gbook.store.stats) == dataclasses.asdict(wbook.store.stats)
    assert (mesh.calls["pane_segagg"] > 0) == share


def test_measure_cost_model_with_a_mesh():
    files = _stream(TT, TSCALE, TQ["CQ2"], 16)
    mesh = CountingMesh(2)
    cm = TA.measure_cost_model(TQ["CQ2"], files, TSCALE, batch_sizes=(1, 4), mesh=mesh)
    want = TA.measure_cost_model(TQ["CQ2"], files, TSCALE, batch_sizes=(1, 4), device="cpu")
    assert type(cm) is type(want)
    assert cm.cost(16) > 0.0 and cm.agg_cost(8) >= 0.0
    # each batch size: a warm-up run_batched and its timed reps; then the
    # final-aggregation executors of 2, 8 and 32 batches
    reps = [max(3, min(8, 16 // bs)) for bs in (1, 4)]
    assert mesh.calls["segagg"] == 1 + 1 + sum(reps) + 2 + 8 + 32


def test_device_and_mesh_must_agree():
    mesh = cpu_mesh(2)
    assert TA.AnalyticsExecutor(TQ["CQ2"], TSCALE, device="cpu", mesh=mesh).device == \
        torch.device("cpu")

    class CardMesh:
        devices = (torch.device("cuda", 1),)

    with pytest.raises(ValueError, match="first device"):
        TA._executor_device("cpu", CardMesh())
