"""The port's flash-attention op on the CPU (its plain version) against the
JAX package's Pallas kernel in interpret mode and its materialised oracle,
on the same seeded numpy inputs, at ``tests/test_kernels.py``'s shapes,
window and soft-cap.  Tolerances: f32 2e-5 (summation order only), bf16
2e-2 (bf16 rounds q, k, v, p and the output at other places in the two
frameworks)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.layers.attention import AttnSpec as JSpec
from repro.layers.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.flash_attention import flops_bytes
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    chunked_attention_f32_ref,
    chunked_attention_ref,
    rows_with_keys,
)
from repro_torch.layers.attention import AttnSpec, chunked_attention

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(B, Sq, Sk, H, Hkv, D, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            scale * rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


@pytest.mark.parametrize("shape", [
    # (B, Sq, Sk, H, Hkv, D)
    (1, 128, 128, 4, 4, 32),
    (2, 64, 64, 4, 2, 16),
    (1, 256, 256, 8, 1, 64),   # MQA
    (2, 100, 100, 4, 4, 32),   # ragged: no block multiple
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_interpret(shape, dtype, causal):
    B, Sq, Sk, H, Hkv, D = shape
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, D, seed=Sq + H + D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(_jax(q, jd), _jax(k, jd), _jax(v, jd), causal=causal)
    got = ops.flash_attention(_torch(q, td), _torch(k, td), _torch(v, td), causal)
    assert got.dtype == td and got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("window", [16, 64])
def test_sliding_window(window):
    q, k, v = _inputs(1, 128, 128, 2, 2, 32, seed=7)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), True, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_logit_cap():
    q, k, v = _inputs(1, 64, 64, 2, 2, 16, seed=9, scale=5.0)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     logit_cap=50.0)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), True, 0, 50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("causal, window, cap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 16, 0.0), (True, 24, 30.0),
    (False, 20, 0.0)])
def test_materialised_oracle_matches_jax(causal, window, cap):
    q, k, v = _inputs(2, 48, 48, 4, 2, 16, seed=3, scale=3.0)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)  # noqa: E731
    j = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    got = attention_ref(t(q), t(k), t(v), causal, window, cap)
    want = jax_ref(j(q), j(k), j(v), causal, window, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # and the plain chunked version against the materialised one
    chunked = chunked_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal, window, cap, chunk=16)
    np.testing.assert_allclose(chunked.numpy(), got.transpose(1, 2).numpy(), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk, window, cap", [(32, 0, 0.0), (40, 24, 0.0),
                                                (16, 0, 50.0)])
def test_model_layer_matches_jax_layer(dtype, chunk, window, cap):
    """The port's ``chunked_attention`` (CPU) against the JAX layer, which
    the JAX model runs: same chunking, same q pre-scaling."""
    q, k, v = _inputs(2, 96, 96, 4, 2, 32, seed=chunk, scale=2.0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_chunked(_jax(q, jd), _jax(k, jd), _jax(v, jd),
                       JSpec(causal=True, window=window, logit_cap=cap, chunk=chunk))
    got = chunked_attention(_torch(q, td), _torch(k, td), _torch(v, td),
                            AttnSpec(causal=True, window=window, logit_cap=cap,
                                     chunk=chunk))
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_layer_offset_and_valid_length_on_cpu():
    """q_offset and kv_valid_len run on the CPU, as in the JAX layer."""
    q, k, v = _inputs(2, 8, 40, 4, 4, 16, seed=5)
    valid = np.array([40, 23], np.int32)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       JSpec(causal=True, chunk=16), q_offset=32,
                       kv_valid_len=jnp.asarray(valid))
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), AttnSpec(causal=True, chunk=16),
                            q_offset=32, kv_valid_len=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_head_mismatch_raises():
    q, k, v = (torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("causal, window, want_pairs", [
    (True, 0, 10 * 11 // 2), (False, 0, 100), (True, 3, 3 * 10 - 3),
    (False, 4, 4 * 10 + 10 * 9 // 2 - 6)])
def test_flops_bytes_count_live_pairs(causal, window, want_pairs):
    # S = 10: causal keeps k <= q; window keeps k > q - window.
    ops_, nbytes = flops_bytes(1, 10, 10, 2, 1, 8, causal, window)
    brute = sum(1 for qp in range(10) for kp in range(10)
                if (not causal or kp <= qp) and (window <= 0 or kp > qp - window))
    assert brute == want_pairs
    assert ops_ == 4.0 * 2 * 8 * brute
    assert nbytes == 2 * (2 * 10 * 2 * 8 + 2 * 10 * 1 * 8)


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 5), (False, 0), (False, 4)])
def test_flops_bytes_with_offset_and_valid_length(causal, window):
    """Query row i at position q_offset + i, keys of row b live below
    kv_valid_len[b]: operations count each row's live pairs, bytes each
    row's live keys and values."""
    valid = [12, 3]
    ops_, nbytes = flops_bytes(2, 4, 12, 2, 1, 8, causal, window, q_offset=8,
                               kv_valid_len=valid)
    brute = sum(1 for n in valid for qp in range(8, 12) for kp in range(n)
                if (not causal or kp <= qp) and (window <= 0 or kp > qp - window))
    assert ops_ == 4.0 * 2 * 8 * brute
    assert nbytes == 2 * (2 * 2 * 4 * 2 * 8 + 2 * sum(valid) * 1 * 8)


@pytest.mark.parametrize("causal, window, q_offset, valid", [
    (True, 0, 0, None), (True, 4, 6, [10, 2]), (False, 0, 3, [0, 7]),
    (True, 3, 20, [5, 10]), (False, 6, 2, None)])
def test_rows_with_keys_matches_the_masks(causal, window, q_offset, valid):
    """The rows the plain version's masks leave a key for; a row with none
    gets a softmax over masked keys (finite NEG_INF), which the kernel
    replaces by zeros."""
    B, Sq, Sk = 2, 5, 10
    kv = None if valid is None else torch.tensor(valid)
    got = rows_with_keys(B, Sq, Sk, causal, window, q_offset, kv)
    for b in range(B):
        n = Sk if valid is None else valid[b]
        for i in range(Sq):
            qp = q_offset + i
            want = any((not causal or kp <= qp) and (window <= 0 or kp > qp - window)
                       for kp in range(n))
            assert bool(got[b, i]) == want, (b, i)


@pytest.mark.parametrize("causal, window, cap, q_offset, valid", [
    (True, 0, 0.0, 0, None), (True, 5, 0.0, 7, [9, 16]), (False, 0, 20.0, 0, [3, 16]),
    (True, 0, 20.0, 12, None)])
def test_f32_reference_rounds_only_q(causal, window, cap, q_offset, valid):
    """``chunked_attention_f32_ref`` on bf16 inputs: q/sqrt(D) rounded to
    bf16, the rest a float64 materialised softmax would give (the standard
    the card tests hold the kernel to)."""
    B, Sq, Sk, H, Hkv, D = 2, 4, 16, 4, 2, 48
    q, k, v = (_torch(a, torch.bfloat16) for a in _inputs(B, Sq, Sk, H, Hkv, D, seed=5,
                                                            scale=3.0))
    kv = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    got = chunked_attention_f32_ref(q, k, v, causal, window, cap, 8, q_offset, kv)
    assert got.dtype == torch.float32
    qs = (q.float() * (1.0 / np.sqrt(D))).bfloat16().double()
    kd = k.double().repeat_interleave(H // Hkv, dim=2)
    vd = v.double().repeat_interleave(H // Hkv, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", qs, kd)
    if cap:
        sc = cap * torch.tanh(sc / cap)
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    ok = ok[None].expand(B, Sq, Sk).clone()
    if kv is not None:
        ok &= kp[None] < kv[:, None, None]
    p = torch.softmax(sc.masked_fill(~ok[:, None], float("-inf")), dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, vd)
    torch.testing.assert_close(got, want.float(), **F32_TOL)
