"""The port's MoE layer on the CPU against the JAX package's
(``repro/layers/moe.py``), on the same seeded numpy inputs.

``route_group`` keeps the routing as indices; the test builds the
reference's one-hot dispatch from them and holds it, the slots and the
drops exactly equal to the JAX package's, with logits forced to tie and
with groups over capacity.  The combine weights and the aux loss agree
within 1e-6 (f32 summation order).  ``moe_ffn``: f32 within 2e-5
(summation order of the expert products), bf16 within 2e-2 (bf16 rounds
the expert activations at other places in the two frameworks).  Reduced
olmoe-1b-7b and mixtral-8x22b prefill at ``tests/test_torch_lm.py``'s
2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import moe as JM
from repro.models import base as JB
from repro.models import lm as JL
from repro.models import params as JP
from repro_torch.layers import moe as TM
from repro_torch.models import base as TB
from repro_torch.models import lm as TL
from repro_torch.models import params as TP

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-4)


def _specs(E, k, cf, group=2048):
    return (JM.MoESpec(num_experts=E, top_k=k, capacity_factor=cf, group_size=group),
            TM.MoESpec(num_experts=E, top_k=k, capacity_factor=cf, group_size=group))


def _dense_dispatch(r: TM.Routing, E: int, cap: int):
    """The reference's (G, Tg, E, cap) dispatch and combine from the index
    form."""
    G, Tg, k = r.expert.shape
    dispatch = np.zeros((G, Tg, E, cap), np.float32)
    combine = np.zeros((G, Tg, E, cap), np.float32)
    for g, t, j in zip(*np.nonzero(r.keep.numpy())):
        e, c = int(r.expert[g, t, j]), int(r.slot[g, t, j])
        dispatch[g, t, e, c] = 1.0
        combine[g, t, e, c] = float(r.gate[g, t, j])
    return dispatch, combine


def _jax_slots(logits, jspec):
    """The reference's slots and keep flags, as its route_group computes
    them (the function returns only the dense tensors)."""
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, jspec.top_k)
    G, Tg, E = logits.shape
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    flat = onehot.reshape(G, Tg * jspec.top_k, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    slot = (pos.reshape(G, Tg, jspec.top_k, E) * onehot).sum(-1).astype(jnp.int32)
    return np.asarray(idx), np.asarray(slot)


def _check_routing(logits, E, k, cf):
    G, Tg, _ = logits.shape
    jspec, tspec = _specs(E, k, cf)
    cap = TM.capacity(tspec, Tg)
    want_d, want_c, want_aux = JM.route_group(jnp.asarray(logits), jspec, cap)
    r = TM.route_group(torch.from_numpy(logits), tspec, cap)
    idx, slot = _jax_slots(logits, jspec)
    np.testing.assert_array_equal(r.expert.numpy(), idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), slot < cap)
    got_d, got_c = _dense_dispatch(r, E, cap)
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    np.testing.assert_allclose(got_c, np.asarray(want_c), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(r.aux), float(want_aux), rtol=1e-6, atol=1e-6)
    return r, cap


@pytest.mark.parametrize("G, Tg, E, k, cf", [
    (2, 16, 8, 2, 1.25),      # mixtral's routing, reduced
    (1, 64, 64, 8, 1.25),     # olmoe's E and k
    (3, 40, 8, 2, 0.5),       # groups over capacity: cap 8 < 10 choices an expert
    (2, 24, 4, 1, 1.0),       # top-1
    (1, 128, 16, 4, 16.0),    # capacity_factor = num_experts: nothing dropped
])
def test_route_group_matches_jax(G, Tg, E, k, cf):
    logits = np.random.default_rng(G * Tg + E).standard_normal((G, Tg, E)).astype(np.float32)
    r, cap = _check_routing(logits, E, k, cf)
    if cf == 0.5:
        assert not r.keep.all()
    if cf == E:
        assert r.keep.all()


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_route_group_breaks_ties_by_the_lower_expert(levels):
    """Logits from a few values, so that many experts tie (all of them with
    one level); the top k among equals are the lowest indices, as
    ``jax.lax.top_k`` takes them.  Tg = 64 over 8 experts at cf 1.0 also
    sends the ties over capacity."""
    rng = np.random.default_rng(levels)
    logits = rng.integers(0, levels, (2, 64, 8)).astype(np.float32)
    r, _ = _check_routing(logits, 8, 2, 1.0)
    if levels == 1:
        assert (r.expert[..., 0] == 0).all() and (r.expert[..., 1] == 1).all()
        assert not r.keep.all()


def test_route_group_ties_in_bf16_logits():
    """Router logits rounded to bf16 (as the model computes them) tie
    among 64 experts; the routing still equals the reference's."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((2, 256, 64)) * 0.05).astype(np.float32)
    rounded = torch.from_numpy(logits).bfloat16().float().numpy()
    assert any(len(np.unique(row)) < 64 for row in rounded.reshape(-1, 64))
    _check_routing(rounded, 64, 8, 1.25)


def _ffn_inputs(B, S, D, E, F, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B, S, D, E, F, k, cf, group", [
    (2, 32, 16, 8, 24, 2, 1.25, 16),    # two groups a row
    (1, 64, 32, 16, 8, 4, 0.5, 64),     # over capacity: drops
    (3, 1, 16, 8, 16, 2, 1.25, 2048),   # decode: one token a group
    (2, 48, 16, 4, 16, 1, 4.0, 2048),   # top-1, nothing dropped
])
def test_moe_ffn_matches_jax(dtype, B, S, D, E, F, k, cf, group):
    args = _ffn_inputs(B, S, D, E, F, seed=S + E)
    jspec, tspec = _specs(E, k, cf, group)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_aux = JM.moe_ffn(*[jnp.asarray(a).astype(jd) for a in args], jspec)
    got, aux = TM.moe_ffn(*[torch.from_numpy(a).to(td) for a in args], tspec)
    assert got.dtype == td and got.shape == (B, S, D)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B, S, D, E, F, k, cf, group", [
    (1, 64, 32, 16, 8, 4, 0.5, 64),     # over capacity: drops
    (2, 32, 16, 8, 24, 2, 1.25, 16),
    (2, 48, 16, 4, 16, 1, 4.0, 2048),   # nothing dropped
])
def test_moe_ffn_counts_dropped_choices(B, S, D, E, F, k, cf, group):
    """``moe_ffn.dropped`` adds up, over calls, the token-choices whose
    reference slot is at or past ``cap``."""
    args = [torch.from_numpy(a) for a in _ffn_inputs(B, S, D, E, F, seed=S + E)]
    jspec, tspec = _specs(E, k, cf, group)
    Tg = min(group, S)
    logits = (args[0].reshape(-1, D) @ args[1]).reshape(-1, Tg, E).numpy()
    _, slot = _jax_slots(logits, jspec)
    want = int((slot >= TM.capacity(tspec, Tg)).sum())
    if cf < 1.0:
        assert want > 0
    if cf == E:
        assert want == 0
    TM.moe_ffn.dropped = 0
    try:
        TM.moe_ffn(*args, tspec)
        assert int(TM.moe_ffn.dropped) == want
        TM.moe_ffn(*args, tspec)
        assert int(TM.moe_ffn.dropped) == 2 * want
    finally:
        TM.moe_ffn.dropped = 0


@pytest.mark.parametrize("S, group", [(30, 16), (100, 64)])
def test_moe_ffn_rejects_a_ragged_group(S, group):
    args = _ffn_inputs(1, S, 16, 4, 8, seed=0)
    _, tspec = _specs(4, 2, 1.25, group)
    with pytest.raises(ValueError, match="multiple"):
        TM.moe_ffn(*[torch.from_numpy(a) for a in args], tspec)


@pytest.mark.parametrize("Tg, E, k, cf, want", [
    (2048, 64, 8, 1.25, 320), (1, 64, 8, 1.25, 8), (64, 8, 2, 1.25, 24),
    (512, 64, 8, 64.0, 4096), (24, 8, 2, 1.25, 8)])
def test_capacity_is_the_reference_rule(Tg, E, k, cf, want):
    assert TM.capacity(TM.MoESpec(num_experts=E, top_k=k, capacity_factor=cf), Tg) == want


# -- the moe block in the model -------------------------------------------------

def _both(arch, seed, **overrides):
    jcfg = dataclasses.replace(JB.get_config(arch).reduced(), **overrides)
    tcfg = dataclasses.replace(TB.get_config(arch).reduced(), **overrides)
    jp = JP.init_params(JL.build_specs(jcfg), jax.random.PRNGKey(seed))
    jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x22b"])
@pytest.mark.parametrize("S, cf", [(24, None), (128, None), (64, 0.5)])
def test_moe_prefill_matches_jax(arch, S, cf):
    """Reduced olmoe (64-token groups: S = 128 is two a row) and mixtral
    (window 16 < S); cf 0.5 drops token-choices in both frameworks."""
    over = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg, jp, tp = _both(arch, seed=S, **over)
    toks = np.random.default_rng(S).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    j_logits, j_cache, _ = JL.prefill(jcfg, jp, jnp.asarray(toks), S)
    t_logits, t_cache, _ = TL.prefill(tcfg, tp, torch.from_numpy(toks), S)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    assert sorted(t_cache) == sorted(j_cache)
    for k, v in j_cache.items():
        np.testing.assert_allclose(t_cache[k].float().numpy(), np.asarray(v, np.float32),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x22b"])
def test_params_from_numpy_carries_the_moe_leaves(arch, dtype):
    cfg = JB.get_config(arch).reduced()
    jp = JP.init_params(JL.build_specs(cfg), jax.random.PRNGKey(5))
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    assert sorted(tp) == sorted(jp) == sorted(TL.build_specs(TB.get_config(arch).reduced()))
    U, D, E, F = 1, cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    for leaf, shape in (("router", (U, D, E)), ("w_gate", (U, E, D, F)),
                        ("w_up", (U, E, D, F)), ("w_down", (U, E, F, D)), ("norm", (U, D))):
        assert tuple(tp[f"seg0/l0/moe/{leaf}"].shape) == shape, leaf
    for k, v in jp.items():
        assert tp[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(v, np.float32))


def test_moe_prefill_rejects_a_ragged_group():
    _, tcfg, _, tp = _both("olmoe_1b_7b", seed=0)
    toks = torch.zeros((1, 100), dtype=torch.int32)   # groups of 64
    with pytest.raises(ValueError, match="multiple"):
        TL.prefill(tcfg, tp, toks, 100)


def test_engine_serves_olmoe_like_the_reference():
    """``serve_multi_jobs`` (LLF) and ``serve_session`` over reduced olmoe
    on the port's engine and the JAX package's, with the same f32 weights
    and prompts: equal reports (wall seconds aside) and logits within
    2e-4."""
    import repro.core as R
    import repro_torch.core as T
    from repro.serve import engine as RE
    from repro_torch.serve import engine as TE

    jcfg, tcfg, jp, tp = _both("olmoe_1b_7b", seed=1, vocab_size=128)
    runs = []
    for engine, core, ex in ((RE, R, RE.PrefillExecutor(jcfg, jp, buckets=(1, 2, 4))),
                             (TE, T, TE.PrefillExecutor(tcfg, tp, buckets=(1, 2, 4),
                                                        device=CPU))):
        rng = np.random.default_rng(0)
        cm = core.LinearCostModel(tuple_cost=0.02, overhead=0.05)

        def jobs():
            return [engine.WindowJob(f"j{i}", rng.integers(0, 128, (n, 16)).astype(np.int32),
                                     core.UniformWindowArrival(0.0, 10.0, n),
                                     deadline=10.0 + 2.0 * cm.cost(n))
                    for i, n in enumerate((3, 5))]

        multi = jobs()
        report = engine.serve_multi_jobs(multi, ex, cm, core.Strategy.LLF)
        session_jobs = jobs()
        session_report, _ = engine.serve_session(session_jobs, ex, cm,
                                                  submit_times=[0.0, 2.0])
        runs.append((report, session_report, multi + session_jobs))
    (want, want_s, jjobs), (got, got_s, tjobs) = runs
    for g, w in ((got, want), (got_s, want_s)):
        assert set(g) == set(w) == {"j0", "j1"}
        for jid in w:
            assert {k: v for k, v in g[jid].items() if k != "wall_exec_seconds"} \
                == {k: v for k, v in w[jid].items() if k != "wall_exec_seconds"}
    for tj, jj in zip(tjobs, jjobs):
        assert tj.processed == tj.num_requests
        np.testing.assert_allclose(np.concatenate(tj.results), np.concatenate(jj.results),
                                   **TOL)
