"""The port's encoder-decoder (whisper-medium) on the CPU against the JAX
package's: ``sinusoidal_positions``, ``build_encdec_specs``, ``encode``,
``lm.backbone`` (the ``xattn`` branch of ``_unit_forward`` with ``enc_out``,
and the other kinds), ``encdec_prefill`` (logits, every cache leaf with the
cross-attention's ``xk``/``xv``, ``cache_len``, ``enc_out``; also in two row
chunks), four ``encdec_decode_step``s and ``EncDecLM``'s key map, on the
reduced config (``encoder_seq`` 24) with seeded numpy inputs and the JAX
package's parameters carried across with ``params_from_numpy``.  The JAX
functions run as ``tests/test_arch_smoke.py::test_whisper_encdec_smoke``
drives them (``encode`` with ``remat=False``).

Tolerances: f32 throughout, ``TOL`` 2e-4 (summation order only; the JAX
package's own f32 bar, ``tests/test_torch_lm.py``), decode ``DECODE_TOL``
5e-4 (the JAX package's prefill/decode tolerance, ``tests/test_arch_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import base as JB
from repro.models import encdec as JE
from repro.models import lm as JL
from repro.models import params as JP
from repro_torch import models as TM
from repro_torch.models import base as TB
from repro_torch.models import encdec as TE
from repro_torch.models import lm as TL
from repro_torch.models import params as TP

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)
ARCH = "whisper_medium"


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _both(seed=6, **overrides):
    """The reduced whisper config in both packages and its f32 parameters:
    the JAX package's seeded init, carried across one key to one key."""
    jcfg = dataclasses.replace(JB.get_config(ARCH).reduced(), **overrides)
    tcfg = dataclasses.replace(TB.get_config(ARCH).reduced(), **overrides)
    jp = JP.init_params(JE.build_encdec_specs(jcfg), jax.random.PRNGKey(seed))
    jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    return jcfg, tcfg, jp, tp


def _inputs(cfg, B, S, seed=7):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, toks


def _close_caches(got, want, tol, what=""):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(_np(got[k]), np.asarray(v, np.float32),
                                   err_msg=f"{what} {k}", **tol)


# -- tables ------------------------------------------------------------------

@pytest.mark.parametrize("S, D", [(24, 64), (1500, 1024), (7, 10), (1, 2)])
def test_sinusoidal_positions_match_jax(S, D):
    got = TE.sinusoidal_positions(S, D)
    want = JE.sinusoidal_positions(S, D)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bf = TE.sinusoidal_positions(S, D, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, got.to(torch.bfloat16))


@pytest.mark.parametrize("reduced", [False, True])
def test_build_encdec_specs_equal(reduced):
    jcfg, tcfg = JB.get_config(ARCH), TB.get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    js, ts = JE.build_encdec_specs(jcfg), TE.build_encdec_specs(tcfg)
    assert sorted(js) == sorted(ts)
    assert any(k.startswith("enc0/") for k in ts) and "enc_final_norm_bias" in ts
    for k in js:
        a, b = js[k], ts[k]
        assert (a.shape, a.axes, a.init, a.fan_in_axis) == (b.shape, b.axes, b.init,
                                                            b.fan_in_axis), k
    assert JP.num_params(js) == TP.num_params(ts)
    assert JP.count_table(js) == TP.count_table(ts)


# -- encoder and backbone ----------------------------------------------------------

def test_encode_matches_jax():
    jcfg, tcfg, jp, tp = _both()
    frames, _ = _inputs(jcfg, B=2, S=1)
    want = JE.encode(jcfg, jp, jnp.asarray(frames), remat=False)
    got = TE.encode(tcfg, tp, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch, key_prefix, causal", [
    ("whisper_medium", "seg", True),      # the decoder's xattn layers, with enc_out
    ("whisper_medium", "enc", False),     # the encoder's attn layers, not causal
    ("recurrentgemma_9b", "seg", True),
    ("mamba2_370m", "seg", True),
    ("olmoe_1b_7b", "seg", True),         # with its aux loss
])
def test_backbone_matches_jax(arch, key_prefix, causal):
    jcfg, tcfg = JB.get_config(arch).reduced(), TB.get_config(arch).reduced()
    specs = (JE.build_encdec_specs if jcfg.encoder_segments else JL.build_specs)(jcfg)
    jp = {k: v.astype(jnp.float32)
          for k, v in JP.init_params(specs, jax.random.PRNGKey(3)).items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    B, S = 2, 20
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    enc = (rng.standard_normal((B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
           if arch == ARCH else None)
    segs = dict(segments=jcfg.encoder_segments) if key_prefix == "enc" else {}
    jh, jaux = JL.backbone(jcfg, jp, jnp.asarray(x), jnp.arange(S),
                           enc_out=None if enc is None else jnp.asarray(enc), remat=False,
                           key_prefix=key_prefix, causal=causal, **segs)
    th, taux = TL.backbone(tcfg, tp, torch.from_numpy(x), torch.arange(S),
                           enc_out=None if enc is None else torch.from_numpy(enc),
                           key_prefix=key_prefix, causal=causal,
                           **({"segments": tcfg.encoder_segments} if segs else {}))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **TOL)
    if jcfg.num_experts:
        assert float(taux) > 0


# -- prefill and decode --------------------------------------------------------------

def test_encdec_prefill_matches_jax():
    jcfg, tcfg, jp, tp = _both()
    frames, toks = _inputs(jcfg, B=2, S=8)
    j_logits, j_cache, j_len, j_enc = JE.encdec_prefill(
        jcfg, jp, jnp.asarray(frames), jnp.asarray(toks), cache_size=12)
    t_logits, t_cache, t_len, t_enc = TE.encdec_prefill(
        tcfg, tp, torch.from_numpy(frames), torch.from_numpy(toks), 12)
    assert t_logits.dtype == torch.float32 and t_logits.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), **TOL)
    assert t_len == int(j_len) == 8
    assert {"seg0/l0/xk", "seg0/l0/xv"} <= set(t_cache)
    assert tuple(t_cache["seg0/l0/xk"].shape) == (1, 2, jcfg.encoder_seq,
                                                   jcfg.num_kv_heads, jcfg.head_dim)
    _close_caches(t_cache, j_cache, TOL)


def test_encdec_prefill_in_row_chunks_matches_jax():
    jcfg, tcfg, jp, tp = _both(prefill_row_chunks=2)
    frames, toks = _inputs(jcfg, B=4, S=6, seed=8)
    j_logits, j_cache, j_len, _ = JE.encdec_prefill(
        jcfg, jp, jnp.asarray(frames), jnp.asarray(toks), cache_size=10)
    t_logits, t_cache, t_len, _ = TE.encdec_prefill(
        tcfg, tp, torch.from_numpy(frames), torch.from_numpy(toks), 10)
    assert t_len == int(j_len) == 6
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    _close_caches(t_cache, j_cache, TOL)
    # each chunk's rows of the cross K/V come from its own rows of enc_out
    whole, _, _, _ = TE.encdec_prefill(dataclasses.replace(tcfg, prefill_row_chunks=1),
                                       tp, torch.from_numpy(frames),
                                       torch.from_numpy(toks), 10)
    torch.testing.assert_close(t_logits, whole, **TOL)


def test_encdec_decode_steps_match_jax():
    jcfg, tcfg, jp, tp = _both()
    B, S, n = 2, 8, 4
    frames, toks = _inputs(jcfg, B=B, S=S + n)
    _, j_cache, j_len, _ = JE.encdec_prefill(
        jcfg, jp, jnp.asarray(frames), jnp.asarray(toks[:, :S]), cache_size=S + n)
    _, t_cache, t_len, _ = TE.encdec_prefill(
        tcfg, tp, torch.from_numpy(frames), torch.from_numpy(toks[:, :S]), S + n)
    xk = t_cache["seg0/l0/xk"].clone()
    for t in range(n):
        step = toks[:, S + t:S + t + 1]
        j_logits, j_cache = JE.encdec_decode_step(jcfg, jp, j_cache, j_len + t,
                                                  jnp.asarray(step))
        t_logits, t_cache = TE.encdec_decode_step(tcfg, tp, t_cache, t_len + t,
                                                  torch.from_numpy(step))
        assert t_logits.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   err_msg=f"step {t}", **DECODE_TOL)
        _close_caches(t_cache, j_cache, DECODE_TOL, f"step {t}")
    assert torch.equal(t_cache["seg0/l0/xk"], xk)   # a step leaves the cross K/V alone


def test_prefill_of_xattn_needs_enc_out():
    _, tcfg, _, tp = _both()
    with pytest.raises(ValueError, match="enc_out"):
        TL.prefill(tcfg, tp, torch.zeros((1, 4), dtype=torch.int32), 4)


# -- the module --------------------------------------------------------------------

def test_params_from_numpy_carries_encoder_keys_one_to_one():
    jcfg, tcfg, jp, tp = _both()
    assert sorted(tp) == sorted(jp) == sorted(TE.build_encdec_specs(tcfg))
    assert any(k.startswith("enc0/") for k in tp)
    for k, v in jp.items():
        assert tp[k].dtype == torch.float32 and tuple(tp[k].shape) == v.shape, k
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)


def test_encdec_module_maps_keys_one_to_one():
    jcfg, tcfg, jp, tp = _both()
    model = TM.EncDecLM.from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()},
                                   device=CPU)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jp)
    assert sorted(model.params()) == sorted(jp)
    assert "enc0__l0__attn__wq" in names and "seg0__l0__xattn__wq" in names
    frames, toks = _inputs(jcfg, B=2, S=9)
    logits, cache, clen, enc = model.prefill(frames, toks[:, :8], cache_size=9)
    want, cache_f, _, enc_f = TE.encdec_prefill(tcfg, tp, torch.from_numpy(frames),
                                                torch.from_numpy(toks[:, :8]), 9)
    torch.testing.assert_close(logits, want)
    torch.testing.assert_close(enc, enc_f)
    torch.testing.assert_close(model.encode(frames), enc_f)
    got, _ = model.decode_step(toks[:, 8:], cache, clen)
    want, _ = TE.encdec_decode_step(tcfg, tp, cache_f, clen, torch.from_numpy(toks[:, 8:]))
    torch.testing.assert_close(got, want)
    seeded = TM.EncDecLM(tcfg, seed=7, device=CPU)
    assert sorted(seeded.params()) == sorted(TE.build_encdec_specs(tcfg))
    with pytest.raises(ValueError, match="no encoder"):
        TM.EncDecLM(TB.get_config("yi_6b").reduced(), device=CPU)
