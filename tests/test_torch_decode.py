"""The port's decode on the CPU against the JAX package's: ``decode_attention``
(scalar and per-row cache lengths, window, soft-cap, GQA and MQA) and
``prefill`` + ``decode_step`` for every reduced config (whisper through
``encdec_prefill`` on seeded frames), on the same seeded numpy inputs and
parameters carried across with ``params_from_numpy``.

Tolerances: ``decode_attention`` f32 1e-5 (summation order only), bf16 2e-2
(bf16 rounds q, p and the output at other places in the two frameworks).
``decode_step`` in f32: logits within 5e-4, the JAX package's own
prefill/decode tolerance (``tests/test_arch_smoke.py``), every cache leaf
within 1e-4.  The port-only check holds prefill + decode against the port's
teacher-forced prefill of the same tokens at the same 5e-4; MoE configs take
``capacity_factor = num_experts`` there, since capacity drops depend on the
group's shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.attention import AttnSpec as JSpec
from repro.layers.attention import decode_attention as jax_decode_attention
from repro.models import base as JB
from repro.models import encdec as JE
from repro.models import lm as JL
from repro.models import params as JP
from repro_torch.layers.attention import AttnSpec, decode_attention
from repro_torch.models import base as TB
from repro_torch.models import encdec as TE
from repro_torch.models import lm as TL
from repro_torch.models import params as TP

CPU = "cpu"
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_ARCHS = list(JB.ARCH_IDS)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


# -- decode_attention -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H, Hkv", [(8, 2), (4, 1)])          # GQA, MQA
@pytest.mark.parametrize("window, cap", [(0, 0.0), (5, 0.0), (0, 30.0), (7, 30.0)])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_jax(dtype, H, Hkv, window, cap, per_row):
    B, S, D = 3, 20, 16
    rng = np.random.default_rng(H + Hkv + window)
    q = (3.0 * rng.standard_normal((B, 1, H, D))).astype(np.float32)
    k = (3.0 * rng.standard_normal((B, S, Hkv, D))).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    clen = np.array([20, 9, 1], np.int32) if per_row else np.int32(13)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_decode_attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                                jnp.asarray(clen), JSpec(window=window, logit_cap=cap))
    got = decode_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                           torch.from_numpy(np.asarray(clen)),
                           AttnSpec(window=window, logit_cap=cap))
    assert got.dtype == td and got.shape == (B, 1, H, D)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_decode_attention_takes_a_python_int():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 1, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
    torch.testing.assert_close(decode_attention(q, k, v, 4, AttnSpec()),
                               decode_attention(q, k, v, torch.tensor([4, 4]), AttnSpec()))


# -- decode_step against the JAX package -------------------------------------------

def _both_params(arch, seed, **overrides):
    jcfg = dataclasses.replace(JB.get_config(arch).reduced(), **overrides)
    tcfg = dataclasses.replace(TB.get_config(arch).reduced(), **overrides)
    specs = (JE.build_encdec_specs if jcfg.encoder_segments else JL.build_specs)(jcfg)
    jp = JP.init_params(specs, jax.random.PRNGKey(seed))
    jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    return jcfg, tcfg, jp, tp


def _frames(cfg, B, seed):
    """Seeded frame embeddings for an encoder-decoder, else None."""
    if not cfg.encoder_segments:
        return None
    return (np.random.default_rng(seed + 100)
            .standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))


def _jax_prefill(cfg, params, toks, cache_size, frames):
    if frames is None:
        return JL.prefill(cfg, params, jnp.asarray(toks), cache_size)
    return JE.encdec_prefill(cfg, params, jnp.asarray(frames), jnp.asarray(toks),
                             cache_size)[:3]


def _torch_prefill(cfg, params, toks, cache_size, frames):
    toks = torch.as_tensor(toks)
    if frames is None:
        return TL.prefill(cfg, params, toks, cache_size)
    return TE.encdec_prefill(cfg, params, torch.as_tensor(frames), toks, cache_size)[:3]


def _run_both(arch, B, S, n_dec, seed, **overrides):
    jcfg, tcfg, jp, tp = _both_params(arch, seed, **overrides)
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S + n_dec)).astype(np.int32)
    frames = _frames(jcfg, B, seed)
    j_logits, j_cache, j_len = _jax_prefill(jcfg, jp, toks[:, :S], S + n_dec, frames)
    t_logits, t_cache, t_len = _torch_prefill(tcfg, tp, toks[:, :S], S + n_dec, frames)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **DECODE_TOL)
    assert t_len == int(j_len) == S
    for t in range(n_dec):
        step = toks[:, S + t:S + t + 1]
        j_logits, j_cache = JL.decode_step(jcfg, jp, j_cache, j_len + t, jnp.asarray(step))
        t_logits, t_cache = TL.decode_step(tcfg, tp, t_cache, t_len + t,
                                           torch.from_numpy(step))
        assert t_logits.dtype == torch.float32 and t_logits.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"{arch} step {t}", **DECODE_TOL)
        assert sorted(t_cache) == sorted(j_cache)
        for k, v in j_cache.items():
            assert tuple(t_cache[k].shape) == v.shape, k
            np.testing.assert_allclose(_np(t_cache[k]), np.asarray(v, np.float32),
                                       err_msg=f"{arch} step {t} {k}", **CACHE_TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_jax(arch):
    """Prefill 24 tokens into a cache of 30, then 6 steps: reduced
    recurrentgemma and mixtral have window 16, so their rings wrap; whisper's
    steps read the cached cross-attention K/V of 24 frames."""
    _run_both(arch, B=2, S=24, n_dec=6, seed=DECODE_ARCHS.index(arch))


def test_ring_buffer_beyond_window_matches_jax():
    """recurrentgemma reduced, S = 14 and 10 steps: the decode crosses the
    window of 16 (``tests/test_arch_smoke.py``'s case)."""
    assert TB.get_config("recurrentgemma_9b").reduced().window == 16
    _run_both("recurrentgemma_9b", B=1, S=14, n_dec=10, seed=4)


def test_moe_decode_with_drops_in_prefill_matches_jax():
    """olmoe reduced at capacity_factor 0.5: the prefill drops token-choices
    (in both frameworks alike); a decode group is one token and drops
    nothing."""
    _run_both("olmoe_1b_7b", B=2, S=64, n_dec=4, seed=9, capacity_factor=0.5)


# -- port-only: prefill + decode equals the teacher-forced prefill ----------------

@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_equals_teacher_forced_prefill(arch):
    cfg = TB.get_config(arch).reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    specs = (TE.build_encdec_specs if cfg.encoder_segments else TL.build_specs)(cfg)
    params = {k: v.float() for k, v in TP.init_params(specs, seed=3, device=CPU).items()}
    B, S, n = 2, 20, 5
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + n)).astype(np.int32))
    frames = _frames(cfg, B, 3)
    _, cache, clen = _torch_prefill(cfg, params, toks[:, :S], S + n, frames)
    for t in range(n):
        logits, cache = TL.decode_step(cfg, params, cache, clen + t, toks[:, S + t:S + t + 1])
        want, _, _ = _torch_prefill(cfg, params, toks[:, :S + t + 1], S + t + 1, frames)
        torch.testing.assert_close(logits[:, 0], want, **DECODE_TOL)


def test_decode_step_updates_the_cache_in_place():
    _, tcfg, _, tp = _both_params("recurrentgemma_9b", seed=1)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    _, cache, clen = TL.prefill(tcfg, tp, toks, 12)
    before = {k: v.clone() for k, v in cache.items()}
    ids = {k: v.data_ptr() for k, v in cache.items()}
    _, out = TL.decode_step(tcfg, tp, cache, clen, toks[:, :1])
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ids
    assert all(not torch.equal(before[k], cache[k]) for k in cache)
    # the new token's K went to slot 8 of the attention ring
    assert cache["seg0/l2/k"][:, :, 8].any() and not before["seg0/l2/k"][:, :, 8].any()


def test_causal_lm_decode_step_and_tensor_cache_len():
    jcfg, tcfg, jp, tp = _both_params("olmoe_1b_7b", seed=2)
    model = TL.CausalLM.from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()},
                                   device=CPU)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    _, cache_m, clen = model.prefill(toks[:, :8], cache_size=9)
    got, _ = model.decode_step(toks[:, 8:], cache_m, clen)
    _, cache_f, _ = TL.prefill(tcfg, tp, torch.from_numpy(toks[:, :8]), 9)
    want, _ = TL.decode_step(tcfg, tp, cache_f, torch.tensor(clen),
                             torch.from_numpy(toks[:, 8:]))
    torch.testing.assert_close(got, want)
    for k in cache_f:
        torch.testing.assert_close(cache_m[k], cache_f[k])
