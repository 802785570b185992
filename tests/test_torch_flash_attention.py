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
from repro_torch.kernels.flash_attention.ref import attention_ref, chunked_attention_ref
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
