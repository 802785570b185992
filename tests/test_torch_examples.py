"""The port's example twins (``examples/torch_deadline_analytics.py``,
``examples/torch_multi_query_serving.py``) on the CPU:

* each runs as a user runs it, with ``--device cpu`` at the reference
  examples' sizes, exits 0 and prints its closing line (its own asserts:
  the aggregate equal to the one-shot; every job met, every prompt
  processed);
* the analytics twin's aggregate equals, exactly, the JAX package's
  one-shot ``run_batched(PAPER_QUERIES[2], files, 96, StreamScale(0.01))``
  on the JAX package's own ``stream_files(seed=11)`` (CQ3 is a count);
* the serving twin's report equals the JAX package's ``serve_multi_jobs``
  on the same jobs under the twin's calibrated cost model, per job:
  ``processed``, ``num_batches``, ``completion``, ``met_modelled`` and
  ``deadline``; with the JAX parameters carried across (f32), every job's
  logits within 2e-4 of the JAX package's (summation order only);
* without ``--device``, on a host with no card, each exits non-zero with
  ``resolve_device``'s message before it computes anything.
"""
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as R
from repro.data import tpch as JT
from repro.models import base as JB
from repro.models import lm as JL
from repro.models import params as JP
from repro.serve import analytics as JA
from repro.serve import engine as RE
from repro_torch.models.params import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = {"analytics": ROOT / "examples" / "torch_deadline_analytics.py",
         "serving": ROOT / "examples" / "torch_multi_query_serving.py"}
CLOSING = {"analytics": "result identical to one-shot run",
           "serving": "all jobs met their deadlines with batched execution."}
NO_CARD = "repro_torch runs on a CUDA device and none is available"
TIMEOUT = 300
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)


def _run(name: str, *args: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, str(TWINS[name]), *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_twin_{name}", TWINS[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_runs_on_the_cpu(name):
    proc = _run(name, "--device", "cpu")
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert CLOSING[name] in proc.stdout, proc.stdout
    assert "kernel launches:" in proc.stdout


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_without_device_refuses_a_host_with_no_card(name):
    proc = _run(name)
    assert proc.returncode != 0
    assert NO_CARD in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout == "", proc.stdout  # nothing ran on the CPU


def test_analytics_twin_equals_the_jax_oneshot():
    got = _load("analytics").main(["--device", "cpu"])
    scale = JT.StreamScale(scale=0.01)
    query = JT.PAPER_QUERIES[2]
    files = [lineitem if query.stream == "lineitem" else orders
             for _, orders, lineitem in JT.stream_files(seed=11, num_files=96, sc=scale)]
    want, _, _ = JA.run_batched(query, files, 96, scale)
    np.testing.assert_array_equal(got["result"], np.asarray(want))
    np.testing.assert_array_equal(got["oneshot"], np.asarray(want))
    assert got["route"] == "plain"
    assert sum(got["plan"].sch_tuples) == 96
    assert sum(b.num_records for b in got["batches"]) == int(np.asarray(want).sum())
    assert not any(got["launches"].values())


def test_serving_twin_schedule_equals_the_jax_package(monkeypatch):
    mod = _load("serving")
    jcfg = dataclasses.replace(JB.get_config("yi_6b").reduced(), vocab_size=1024)
    jp = JP.init_params(JL.build_specs(jcfg), jax.random.PRNGKey(0))
    jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    # the twin on the JAX parameters, carried across in f32
    monkeypatch.setattr(mod, "init_params", lambda specs, seed, device: params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device=device))
    got = mod.main(["--device", "cpu"])
    assert got["cfg"].d_model == jcfg.d_model and got["cfg"].vocab_size == 1024

    cm = got["cost_model"]
    jcm = R.PiecewiseLinearCostModel(points=cm.points, agg_points=cm.agg_points)
    jobs = [RE.WindowJob(job_id=j.job_id, prompts=j.prompts,
                         arrival=R.UniformWindowArrival(j.arrival.wind_start,
                                                        j.arrival.wind_end,
                                                        j.arrival.num_tuples_total),
                         deadline=j.deadline) for j in got["jobs"]]
    want = RE.serve_multi_jobs(jobs, RE.PrefillExecutor(jcfg, jp, buckets=mod.BUCKETS), jcm,
                               R.Strategy.LLF, delta_rsf=0.5, c_max=5.0)
    assert set(got["report"]) == set(want) == {"job0", "job1", "job2"}
    for jid, w in want.items():
        g = got["report"][jid]
        for key in ("processed", "num_batches", "completion", "met_modelled", "deadline"):
            assert g[key] == w[key], (jid, key, g[key], w[key])
        assert g["met_modelled"] and g["processed"] == w["processed"] > 0
    for tj, jj in zip(got["jobs"], jobs):
        assert len(tj.results) == len(jj.results)
        np.testing.assert_allclose(np.concatenate(tj.results), np.concatenate(jj.results),
                                   **LOGITS_TOL, err_msg=tj.job_id)
