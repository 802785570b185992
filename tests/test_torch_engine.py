"""The port's serving engine (``repro_torch.serve.engine``) on the CPU
against the JAX package's, with the same parameters (f32), prompts and
``LinearCostModel``: equal plans, batch counts, modelled finishes, deadline
outcomes and processed counts, and logits within 2e-4 (f32, summation
order only)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.models import base as JB
from repro.models import lm as JL
from repro.models import params as JP
from repro.serve import engine as RE
from repro_torch.models import base as TB
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import engine as TE

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-4)
SEQ = 16


def _executors(arch, vocab=128, buckets=(1, 2, 4, 8)):
    jcfg = dataclasses.replace(JB.get_config(arch).reduced(), vocab_size=vocab)
    tcfg = dataclasses.replace(TB.get_config(arch).reduced(), vocab_size=vocab)
    jp = JP.init_params(JL.build_specs(jcfg), jax.random.PRNGKey(0))
    jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    return (RE.PrefillExecutor(jcfg, jp, buckets=buckets),
            TE.PrefillExecutor(tcfg, tp, buckets=buckets, device=CPU))


def _jobs(mod, core, sizes, vocab=128, seed=0, slack=3.0):
    rng = np.random.default_rng(seed)
    cm = core.LinearCostModel(tuple_cost=0.02, overhead=0.05)
    jobs = [mod.WindowJob(job_id=f"j{i}",
                          prompts=rng.integers(0, vocab, (n, SEQ)).astype(np.int32),
                          arrival=core.UniformWindowArrival(0.0, 10.0, n),
                          deadline=10.0 + slack * cm.cost(n))
            for i, n in enumerate(sizes)]
    return jobs, cm


def _same_report(got, want):
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "wall_exec_seconds":
            assert got[key] > 0.0
        elif isinstance(val, float):
            assert got[key] == pytest.approx(val, rel=1e-12, abs=1e-12), key
        else:
            assert got[key] == val, key


@pytest.mark.parametrize("arch", ["yi_6b", "recurrentgemma_9b", "mamba2_370m", "olmoe_1b_7b",
                                  "mixtral_8x22b"])
def test_single_job_matches_reference(arch):
    jex, tex = _executors(arch)
    # a tight deadline: the plan must start batches inside the window
    (jjob,), jcm = _jobs(RE, R, (11,), slack=0.6)
    (tjob,), tcm = _jobs(TE, T, (11,), slack=0.6)
    want = RE.serve_single_job(jjob, jex, jcm)
    got = TE.serve_single_job(tjob, tex, tcm)
    _same_report(got, want)
    assert got["processed"] == 11 and got["num_batches"] >= 2
    np.testing.assert_allclose(np.concatenate(tjob.results),
                               np.concatenate(jjob.results), **TOL)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's prefill while the test runs: with
    one per core in each of several test processes, a batch can pass the
    test's wall-clock ``c_max``."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_multi_jobs_llf_matches_reference(one_torch_thread):
    jex, tex = _executors("recurrentgemma_9b")
    # Every bucket at SEQ once first: the reference's first call of a bucket
    # times its jit compile, which can pass c_max and re-queue the batch.
    for ex in (jex, tex):
        for b in ex.buckets:
            ex.run_batch(np.zeros((b, SEQ), np.int32))
    jjobs, jcm = _jobs(RE, R, (6, 10), seed=1)
    tjobs, tcm = _jobs(TE, T, (6, 10), seed=1)
    want = RE.serve_multi_jobs(jjobs, jex, jcm, R.Strategy.LLF, delta_rsf=0.5, c_max=2.0)
    got = TE.serve_multi_jobs(tjobs, tex, tcm, T.Strategy.LLF, delta_rsf=0.5, c_max=2.0)
    for name, report in (("reference", want), ("port", got)):
        assert all(r["straggler_events"] == 0 for r in report.values()), (
            f"{name}: a prefill batch took longer than c_max=2.0 s of wall "
            f"time: {report}")
    assert set(got) == set(want)
    for jid in want:
        _same_report(got[jid], want[jid])
    for jj, tj in zip(jjobs, tjobs):
        assert tj.processed == tj.num_requests
        out = np.concatenate(tj.results)
        assert out.shape == (tj.num_requests, 128) and np.isfinite(out).all()
        np.testing.assert_allclose(out, np.concatenate(jj.results), **TOL)


def test_multi_jobs_on_a_worker_pool():
    _, tex = _executors("yi_6b")
    tjobs, tcm = _jobs(TE, T, (5, 7), seed=2)
    report = TE.serve_multi_jobs(tjobs, tex, tcm, T.Strategy.LLF, c_max=2.0, workers=2)
    assert all(report[j.job_id]["processed"] == j.num_requests for j in tjobs)


def test_oversized_batch_split_into_bucket_sized_subbatches():
    """n above the largest bucket splits into bucket-sized sub-batches, wall
    times summed; rows are independent, so padding must not leak."""
    _, tex = _executors("yi_6b", buckets=(1, 2, 4, 8, 16, 32))
    prompts = np.random.default_rng(1).integers(0, 128, (40, 8)).astype(np.int32)
    out, dt = tex.run_batch(prompts)
    assert out.shape == (40, 128) and dt > 0.0
    ref, _ = tex.run_batch(prompts[32:])
    np.testing.assert_allclose(out[32:], ref, rtol=1e-5, atol=1e-5)


def test_calibrate_fits_one_sample_per_bucket():
    jex, tex = _executors("yi_6b", buckets=(1, 2, 4))
    calls = []
    run = tex.run_batch
    tex.run_batch = lambda p: calls.append(p.shape[0]) or run(p)
    cm = tex.calibrate(SEQ, 128)
    assert calls == [1, 1, 2, 2, 4, 4]   # a warm-up and a timed call per bucket
    assert isinstance(cm, T.CostModelBase) and cm.cost(4) > 0.0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    cfg = dataclasses.replace(TB.get_config("yi_6b").reduced(), vocab_size=128)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.PrefillExecutor(cfg, {})
