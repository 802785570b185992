"""The port's RG-LRU op and layer on the CPU (the plain version) against the
JAX package's layer (``rglru_scan``, an associative scan) and its Pallas op
in interpret mode, on the same seeded numpy inputs; the plain version of
the kernel's order of arithmetic (``rglru_chunked_ref``) against both; and
``short_conv1d`` with a carried state.  Tolerance 2e-4: f32 throughout, the
associative scan sums in another order than the sequential one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru as jax_rglru_op
from repro.kernels.rglru.ref import rglru_rec_ref as jax_rec_ref
from repro.layers import rglru as jax_layer
from repro_torch.kernels.rglru import ops
from repro_torch.kernels.rglru.ref import rglru_chunked_ref, rglru_rec_ref, rglru_ref
from repro_torch.kernels.rglru.rglru import flops_bytes
from repro_torch.layers.rglru import rglru_scan, rglru_step, short_conv1d

TOL = dict(rtol=2e-4, atol=2e-4)

# jit: one compile per shape instead of one per eager op of the scan
jax_scan = jax.jit(jax_layer.rglru_scan)
jax_step = jax.jit(jax_layer.rglru_step)
jax_conv = jax.jit(jax_layer.short_conv1d)


def _inputs(B, S, N, seed):
    rng = np.random.default_rng(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    x = rng.standard_normal((B, S, N)).astype(np.float32)
    r = sig(rng.standard_normal((B, S, N))).astype(np.float32)
    i = sig(rng.standard_normal((B, S, N))).astype(np.float32)
    a_param = rng.standard_normal(N).astype(np.float32)
    h0 = rng.standard_normal((B, N)).astype(np.float32)
    return x, r, i, a_param, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 160, 96), (1, 256, 128), (3, 37, 20)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_layer_matches_jax_layer(shape, with_h0):
    x, r, i, a, h0 = _inputs(*shape, seed=sum(shape))
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    y_want, h_want = jax_scan(*_j(x, r, i, a), jh0)
    y_got, h_got = rglru_scan(*_t(x, r, i, a), th0)
    assert y_got.dtype == torch.float32 and h_got.dtype == torch.float32
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **TOL)


@pytest.mark.parametrize("shape", [(2, 160, 96), (1, 300, 200)])
def test_op_matches_pallas_op_interpret(shape):
    x, r, i, a, _ = _inputs(*shape, seed=11)
    y_want, h_want = jax_rglru_op(*_j(x, r, i, a))
    y_got, h_got = ops.rglru(*_t(x, r, i, a))
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **TOL)


def test_bf16_layer_keeps_y_dtype_and_f32_state():
    """bf16 x, r, i: y comes back in bf16 (one rounding of an f32 value, so
    within 2^-8 relative of the JAX layer's), h_last in f32."""
    x, r, i, a, h0 = _inputs(2, 64, 32, seed=4)
    jb = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, r, i)]
    tb = [torch.from_numpy(v).bfloat16() for v in (x, r, i)]
    y_want, h_want = jax_scan(*jb, jnp.asarray(a), jnp.asarray(h0))
    y_got, h_got = rglru_scan(*tb, torch.from_numpy(a), torch.from_numpy(h0))
    assert y_got.dtype == torch.bfloat16 and h_got.dtype == torch.float32
    np.testing.assert_allclose(y_got.float().numpy(), np.asarray(y_want, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **TOL)


# (steps, sub-segments) of a chunk: the kernel's (8, 16), and sizes that
# neither shape's S is a multiple of.
@pytest.mark.parametrize("steps, segments", [(8, 16), (3, 5), (4, 1), (1, 7)])
@pytest.mark.parametrize("shape", [(2, 160, 96), (1, 37, 20)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_order_matches_jax_layer_and_plain_version(steps, segments, shape,
                                                           with_h0, dtype):
    """``rglru_chunked_ref`` (sub-segments scanned from h = 0, then combined
    with the carry) against the JAX layer's associative scan and against
    ``rglru_ref``'s sequential one.  bf16: y is one rounding of an f32 value
    (1e-2, as above), h_last stays f32 (2e-4)."""
    x, r, i, a, h0 = _inputs(*shape, seed=steps * 10 + segments)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    tx, tr, ti = (torch.from_numpy(v).to(td) for v in (x, r, i))
    y_got, h_got = rglru_chunked_ref(tx, tr, ti, torch.from_numpy(a), th0, steps, segments)
    assert y_got.dtype == td and h_got.dtype == torch.float32
    y_tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    y_want, h_want = jax_scan(*(jnp.asarray(v).astype(jd) for v in (x, r, i)),
                              jnp.asarray(a), jh0)
    np.testing.assert_allclose(y_got.float().numpy(), np.asarray(y_want, np.float32), **y_tol)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **TOL)
    y_plain, h_plain = rglru_ref(tx, tr, ti, torch.from_numpy(a), th0)
    np.testing.assert_allclose(y_got.float().numpy(), y_plain.float().numpy(), **y_tol)
    np.testing.assert_allclose(h_got.numpy(), h_plain.numpy(), **TOL)


def test_recurrence_oracle_matches_jax():
    rng = np.random.default_rng(5)
    log_a = (-np.abs(rng.standard_normal((2, 50, 24))) * 0.1).astype(np.float32)
    u = (rng.standard_normal((2, 50, 24)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    y_want, h_want = jax_rec_ref(*_j(log_a, u, h0))
    y_got, h_got = rglru_rec_ref(*_t(log_a, u, h0))
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **TOL)


def test_step_matches_jax_step():
    x, r, i, a, h0 = _inputs(3, 1, 16, seed=8)
    y_want, h_want = jax_step(*_j(x[:, 0], r[:, 0], i[:, 0], a, h0))
    y_got, h_got = rglru_step(*_t(x[:, 0], r[:, 0], i[:, 0], a, h0))
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_short_conv1d_matches_jax(dtype, with_state):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    js = jnp.asarray(state).astype(jd) if with_state else None
    ts = torch.from_numpy(state).to(td) if with_state else None
    y_want, s_want = jax_conv(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd), js)
    y_got, s_got = short_conv1d(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), ts)
    assert y_got.dtype == td and s_got.shape == (2, 3, 12)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(y_got.float().numpy(), np.asarray(y_want, np.float32), **tol)
    np.testing.assert_array_equal(s_got.float().numpy(), np.asarray(s_want, np.float32))


def test_conv_state_carries_across_calls():
    """Two calls with the carried state equal one call over the whole run."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 10, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    y_all, s_all = short_conv1d(x, w)
    y1, s1 = short_conv1d(x[:, :7], w)
    y2, s2 = short_conv1d(x[:, 7:], w, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all)
    torch.testing.assert_close(s2, s_all)


def test_flops_bytes():
    ops_, nbytes = flops_bytes(8, 4096, 4096)
    assert nbytes == 8.0 * 8 * 4096 * 4096 + 4.0 * 4096 + 8.0 * 8 * 4096
    assert ops_ == 10.0 * 8 * 4096 * 4096
