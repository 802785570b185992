"""The port's model stack on the CPU against the JAX package's: configs and
parameter tables for all ten archs, parameter carry-over (bf16 included),
the layer primitives, and ``prefill`` (last-position logits and every
cache leaf) for reduced recurrentgemma-9b (S = 24 > window 16, so the ring
buffer and the window mask run), reduced yi-6b and reduced mamba2-370m
(chunk 16 < S = 24, so the last SSD chunk is ragged).

Tolerances: parameters in f32 give 2e-4 (summation order only).  With bf16
parameters the two frameworks round at other places (XLA keeps fused
elementwise chains in f32, PyTorch rounds after each op) and random-weight
layers amplify the difference from layer to layer: the bf16 case holds the
relative L2 error of the logits under 5e-2 (the bar the card's smoke run
uses) with equal argmax, the first segment's cache leaves under 5e-2 and
every later one under 2.5e-1 (measured on this case: 0-1% in the first
segment, up to 15% in the last RG-LRU state).  Mamba-2 in bf16, three
units: logits under 5e-2 with equal argmax and every cache leaf under 5e-2
(measured: logits 7.6e-3, leaves up to 1.8e-2 in the third unit's state).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import common as JC
from repro.models import base as JB
from repro.models import lm as JL
from repro.models import params as JP
from repro.models.config import Segment as JSegment
from repro_torch.layers import common as TC
from repro_torch.models import base as TB
from repro_torch.models import lm as TL
from repro_torch.models import params as TP
from repro_torch.models.config import Segment as TSegment

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-4)


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want)
                 / max(np.linalg.norm(want), 1e-12))


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


# -- configs and parameter tables --------------------------------------------

@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_configs_and_specs_equal(arch):
    jcfg, tcfg = JB.get_config(arch), TB.get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jcfg.reduced()) == dataclasses.asdict(tcfg.reduced())
    js, ts = JL.build_specs(jcfg), TL.build_specs(tcfg)
    assert sorted(js) == sorted(ts)
    for k in js:
        a, b = js[k], ts[k]
        assert (a.shape, a.axes, a.init, a.fan_in_axis) == (b.shape, b.axes, b.init,
                                                            b.fan_in_axis), k
        assert b.dtype == torch.bfloat16
    assert JP.num_params(js) == TP.num_params(ts)
    assert JP.count_table(js) == TP.count_table(ts)
    for cell in TB.SHAPES.values():
        assert JB.cell_supported(jcfg, JB.SHAPES[cell.name]) == TB.cell_supported(tcfg, cell)


def test_recurrentgemma_full_width_param_count():
    assert TP.num_params(TL.build_specs(TB.get_config("recurrentgemma_9b"))) \
        == 10_444_664_832


def test_mamba2_full_width_param_count():
    assert TP.num_params(TL.build_specs(TB.get_config("mamba2_370m"))) == 368_178_688


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        TB.get_config("gpt5")
    assert TB.get_config("recurrentgemma-9b").name == "recurrentgemma-9b"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_numpy_carries_every_leaf(dtype):
    cfg = JB.get_config("recurrentgemma_9b").reduced()
    jp = JP.init_params(JL.build_specs(cfg), jax.random.PRNGKey(3))
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tp[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(v, np.float32))
    as32 = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU,
                                dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in as32.values())


def test_init_params_rules_and_seed():
    specs = {
        "w": TP.ParamSpec((64, 512), (None, None)),
        "z": TP.ParamSpec((8,), (None,), init="zeros"),
        "o": TP.ParamSpec((8,), (None,), init="ones"),
        "a": TP.ParamSpec((4096,), (None,), init="rglru_a", dtype=torch.float32),
        "dt": TP.ParamSpec((4096,), (None,), init="ssm_dt", dtype=torch.float32),
        "f": TP.ParamSpec((16, 4, 1000), (None, None, None), fan_in_axis=0,
                          dtype=torch.float32),
    }
    p = TP.init_params(specs, seed=5, device=CPU)
    assert p["w"].dtype == torch.bfloat16 and p["w"].shape == (64, 512)
    assert abs(p["w"].float().std().item() - 1 / 8) < 0.01   # 1/sqrt(fan_in=64)
    assert abs(p["f"].std().item() - 1 / 4) < 0.01            # fan_in_axis=0: 16
    assert torch.equal(p["z"], torch.zeros(8, dtype=torch.bfloat16))
    assert torch.equal(p["o"], torch.ones(8, dtype=torch.bfloat16))
    gate = torch.sigmoid(p["a"])                               # in [0.9, 0.999)
    assert gate.min() >= 0.9 - 1e-6 and gate.max() < 0.999 + 1e-6
    dt = torch.nn.functional.softplus(p["dt"])                 # in [1e-3, 1e-1]
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4)
    again = TP.init_params(specs, seed=5, device=CPU)
    other = TP.init_params(specs, seed=6, device=CPU)
    assert [k for k in specs if not torch.equal(p[k], again[k])] == []
    assert not torch.equal(p["w"], other["w"])


# -- layer primitives ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    s, b = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    np.testing.assert_allclose(_np(TC.rms_norm(tx, torch.from_numpy(s))),
                               _np(JC.rms_norm(jx, jnp.asarray(s))), **tol)
    np.testing.assert_allclose(
        _np(TC.layer_norm(tx, torch.from_numpy(s), torch.from_numpy(b))),
        _np(JC.layer_norm(jx, jnp.asarray(s), jnp.asarray(b))), **tol)


@pytest.mark.parametrize("rotary_frac", [1.0, 0.5, 0.0])
def test_rope_interleaved_pairs(rotary_frac):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7) + 3
    got = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0, rotary_frac)
    want = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0, rotary_frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
def test_mlps_and_activations(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    bu, bd = rng.standard_normal(24).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    t, j = (lambda *a: [torch.from_numpy(v) for v in a]), (lambda *a: [jnp.asarray(v) for v in a])
    np.testing.assert_allclose(TC.gated_mlp(*t(x, wg, wu, wd), act).numpy(),
                               np.asarray(JC.gated_mlp(*j(x, wg, wu, wd), act)), **TOL)
    np.testing.assert_allclose(TC.mlp(*t(x, wu, wd, bu, bd), act=act).numpy(),
                               np.asarray(JC.mlp(*j(x, wu, wd, bu, bd), act=act)), **TOL)
    with pytest.raises(ValueError, match="unknown activation"):
        TC._activate(torch.zeros(1), "swish2")


def test_sinusoidal_positions():
    pos = np.array([0, 1, 5, 90])
    np.testing.assert_allclose(TC.sinusoidal_at(torch.from_numpy(pos), 24).numpy(),
                               np.asarray(JC.sinusoidal_at(jnp.asarray(pos), 24)), **TOL)


# -- prefill -------------------------------------------------------------------

def _both_params(arch, seed=0, f32=True, **overrides):
    jcfg = dataclasses.replace(JB.get_config(arch).reduced(), **overrides)
    tcfg = dataclasses.replace(TB.get_config(arch).reduced(), **overrides)
    jp = JP.init_params(JL.build_specs(jcfg), jax.random.PRNGKey(seed))
    if f32:
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    return jcfg, tcfg, jp, tp


def _tokens(vocab, B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "yi_6b", "mamba2_370m"])
def test_prefill_matches_jax_f32(arch):
    jcfg, tcfg, jp, tp = _both_params(arch)
    toks = _tokens(jcfg.vocab_size)
    j_logits, j_cache, j_len = JL.prefill(jcfg, jp, jnp.asarray(toks), 24)
    t_logits, t_cache, t_len = TL.prefill(tcfg, tp, torch.from_numpy(toks), 24)
    assert t_len == int(j_len) == 24
    assert t_logits.dtype == torch.float32 and t_logits.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    assert sorted(t_cache) == sorted(j_cache)
    for k, v in j_cache.items():
        assert tuple(t_cache[k].shape) == v.shape, k
        assert str(t_cache[k].dtype).split(".")[1] == str(v.dtype), k
        np.testing.assert_allclose(_np(t_cache[k]), np.asarray(v, np.float32),
                                   err_msg=k, **TOL)
    if arch == "recurrentgemma_9b":
        # window 16 < S = 24: the attention cache is a ring of 16 slots
        assert t_cache["seg0/l2/k"].shape[2] == jcfg.window == 16


def test_prefill_matches_jax_bf16():
    jcfg, tcfg, jp, tp = _both_params("recurrentgemma_9b", seed=1, f32=False)
    toks = _tokens(jcfg.vocab_size, seed=1)
    j_logits, j_cache, _ = JL.prefill(jcfg, jp, jnp.asarray(toks), 24)
    t_logits, t_cache, _ = TL.prefill(tcfg, tp, torch.from_numpy(toks), 24)
    assert _rel_l2(t_logits.numpy(), j_logits) < 5e-2
    assert np.array_equal(t_logits.numpy().argmax(-1), np.asarray(j_logits).argmax(-1))
    for k, v in j_cache.items():
        assert t_cache[k].dtype == (torch.float32 if k.endswith("/h") else torch.bfloat16)
        assert _rel_l2(_np(t_cache[k]), v) < (5e-2 if k.startswith("seg0/") else 2.5e-1), k


def test_mamba2_prefill_matches_jax_bf16():
    """Three Mamba-2 units in bf16: the block's own dtypes (bf16 projections,
    dt and gate; f32 A, SSD state and norm) against the JAX block's."""
    jcfg = dataclasses.replace(JB.get_config("mamba2_370m").reduced(),
                               segments=(JSegment(("ssm",), 3),))
    tcfg = dataclasses.replace(TB.get_config("mamba2_370m").reduced(),
                               segments=(TSegment(("ssm",), 3),))
    jp = JP.init_params(JL.build_specs(jcfg), jax.random.PRNGKey(1))
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    toks = _tokens(jcfg.vocab_size, seed=1)
    j_logits, j_cache, _ = JL.prefill(jcfg, jp, jnp.asarray(toks), 24)
    t_logits, t_cache, _ = TL.prefill(tcfg, tp, torch.from_numpy(toks), 24)
    assert _rel_l2(t_logits.numpy(), j_logits) < 5e-2
    assert np.array_equal(t_logits.numpy().argmax(-1), np.asarray(j_logits).argmax(-1))
    assert sorted(t_cache) == ["seg0/l0/conv", "seg0/l0/h"]
    for k, v in j_cache.items():
        assert tuple(t_cache[k].shape) == v.shape, k
        assert t_cache[k].dtype == (torch.float32 if k.endswith("/h") else torch.bfloat16)
        assert _rel_l2(_np(t_cache[k]), v) < 5e-2, k


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_numpy_carries_the_ssm_leaves(dtype):
    """Every leaf of the Mamba-2 block crosses one to one: dt_bias, a_log and
    d_skip (U, H), conv_w (U, T, Din) among them."""
    cfg = JB.get_config("mamba2_370m").reduced()
    jp = JP.init_params(JL.build_specs(cfg), jax.random.PRNGKey(5))
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    assert sorted(tp) == sorted(jp)
    U, H, T, Din = 1, cfg.ssm_num_heads, cfg.conv_width, cfg.ssm_d_inner
    for leaf, shape in (("dt_bias", (U, H)), ("a_log", (U, H)), ("d_skip", (U, H)),
                        ("conv_w", (U, T, Din))):
        assert tuple(tp[f"seg0/l0/ssm/{leaf}"].shape) == shape, leaf
    for k, v in jp.items():
        assert tp[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(v, np.float32))


def test_prefill_cache_longer_than_prompt_and_logit_cap():
    """cache_size > S writes slots [0, S) and leaves the rest zero; a
    soft-capped config runs the cap through the layer."""
    jcfg, tcfg, jp, tp = _both_params("yi_6b", logit_cap=5.0)
    toks = _tokens(jcfg.vocab_size, S=12)
    j_logits, j_cache, _ = JL.prefill(jcfg, jp, jnp.asarray(toks), 20)
    t_logits, t_cache, _ = TL.prefill(tcfg, tp, torch.from_numpy(toks), 20)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for k, v in j_cache.items():
        np.testing.assert_allclose(_np(t_cache[k]), np.asarray(v), err_msg=k, **TOL)
    assert not t_cache["seg0/l0/k"][:, :, 12:].any()


def test_prefill_row_chunks_and_vision_prefix():
    """internvl2 (reduced): a vision prefix of patch embeddings and two
    sequential row chunks, against the JAX package's same path."""
    jcfg, tcfg, jp, tp = _both_params("internvl2_76b", prefill_row_chunks=2)
    toks = _tokens(jcfg.vocab_size, B=4, S=10)
    patches = np.random.default_rng(4).standard_normal(
        (4, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
    j_logits, j_cache, j_len = JL.prefill(jcfg, jp, jnp.asarray(toks), 14,
                                          jnp.asarray(patches))
    t_logits, t_cache, t_len = TL.prefill(tcfg, tp, torch.from_numpy(toks), 14,
                                          torch.from_numpy(patches))
    assert t_len == int(j_len) == 14
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for k, v in j_cache.items():
        np.testing.assert_allclose(_np(t_cache[k]), np.asarray(v), err_msg=k, **TOL)


@pytest.mark.parametrize("entry", ["prefill", "decode_step", "CausalLM"])
def test_unported_kinds_raise(entry):
    """Every kind of the ten configs runs (``check_ported`` passes them all);
    a kind the reference does not know raises in each entry point."""
    for arch in TB.ARCH_IDS:
        TL.check_ported(TB.get_config(arch))
    cfg = TB.get_config("yi_6b").reduced()
    cfg = dataclasses.replace(cfg, segments=(TSegment(("attn", "conv"), 1),))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    call = {"prefill": lambda: TL.prefill(cfg, {}, toks, 4),
            "decode_step": lambda: TL.decode_step(cfg, {}, {}, 0, toks[:, :1]),
            "CausalLM": lambda: TL.CausalLM(cfg, device=CPU)}[entry]
    with pytest.raises(NotImplementedError, match="'conv'"):
        call()


def test_causal_lm_module_maps_keys_one_to_one():
    jcfg, tcfg, jp, tp = _both_params("recurrentgemma_9b")
    model = TL.CausalLM.from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()},
                                   device=CPU)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jp)
    assert sorted(model.params()) == sorted(jp)
    assert "seg0__l2__attn__wq" in names
    toks = _tokens(jcfg.vocab_size, seed=2)
    logits, cache, _ = model.prefill(toks)
    want, _, _ = TL.prefill(tcfg, tp, torch.from_numpy(toks), 24)
    torch.testing.assert_close(logits, want)
    seeded = TL.CausalLM(tcfg, seed=7, device=CPU)
    assert sorted(seeded.params()) == sorted(TL.build_specs(tcfg))
