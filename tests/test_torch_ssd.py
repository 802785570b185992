"""The port's Mamba-2 SSD op and layer on the CPU (the plain version) against
the JAX package's layer (``ssd_chunked``, a ``lax.scan`` over chunks), its
Pallas op in interpret mode and its sequential oracle, on the same seeded
numpy inputs.  Tolerances are the JAX package's own for the SSD
(``tests/test_kernels.py`` ``TestSSD``): y 2e-4 and h_last 2e-3 in f32.
The comparisons stay in f32: the Pallas op rounds xw to x's dtype and y
again before the D skip, which the model's layer (and the port) does not.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd_op
from repro.kernels.ssd.ref import ssd_rec_ref as jax_rec_ref
from repro.layers import ssd as jax_layer
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked_bf16ops_ref, ssd_chunked_ref, ssd_rec_ref
from repro_torch.kernels.ssd.ssd import flops_bytes
from repro_torch.layers.ssd import ssd_chunked, ssd_step

Y_TOL = dict(rtol=2e-4, atol=2e-4)
H_TOL = dict(rtol=2e-3, atol=2e-3)
# bf16 (tests/test_kernels.py TestSSD): y 3e-2, h_last rtol 2e-3 and atol 5e-3.
Y_TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
H_TOL_BF16 = dict(rtol=2e-3, atol=5e-3)
BF16_SHAPES = [(1, 256, 2, 16, 8), (2, 200, 4, 32, 16), (1, 77, 3, 8, 5), (1, 512, 1, 64, 32)]

jax_step = jax.jit(jax_layer.ssd_step)


@functools.lru_cache(maxsize=None)
def _jax_layer(chunk):
    return jax.jit(functools.partial(jax_layer.ssd_chunked, chunk=chunk))


def _inputs(B, S, H, P, N, seed, h0=False):
    """As the JAX package's SSD test draws them: x 0.5 sigma, dt a softplus,
    A negative, B and C 0.3 sigma, D ones; h0 optional."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(B, S, H, P) * 0.5
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    A = (-np.abs(f(H)) - 0.1).astype(np.float32)
    Bm, Cm = f(B, S, H, N) * 0.3, f(B, S, H, N) * 0.3
    D = np.ones(H, np.float32)
    return x, dt, A, Bm, Cm, D, (f(B, H, N, P) if h0 else None)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", [(1, 256, 2, 16, 8), (2, 200, 4, 32, 16),
                                   (1, 512, 1, 64, 32)])
def test_op_matches_pallas_op_interpret(shape):
    x, dt, A, Bm, Cm, D, _ = _inputs(*shape, seed=13)
    y_want, h_want = jax_ssd_op(*_j(x, dt, A, Bm, Cm, D))
    y_got, h_got = ops.ssd(*_t(x, dt, A, Bm, Cm, D))
    assert y_got.dtype == torch.float32 and h_got.dtype == torch.float32
    assert h_got.shape == (shape[0], shape[2], shape[4], shape[3])
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **Y_TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **H_TOL)


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("shape", [(2, 200, 4, 32, 16), (1, 77, 3, 8, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_layer_matches_jax_layer(chunk, shape, with_h0):
    """Ragged S (200 and 77 are no multiple of any chunk) with and without an
    initial state."""
    x, dt, A, Bm, Cm, D, h0 = _inputs(*shape, seed=sum(shape) + chunk, h0=with_h0)
    y_want, h_want = _jax_layer(chunk)(*_j(x, dt, A, Bm, Cm, D), h0=_j(h0)[0])
    y_got, h_got = ssd_chunked(*_t(x, dt, A, Bm, Cm, D), chunk=chunk, h0=_t(h0)[0])
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **Y_TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **H_TOL)


def test_bf16_layer_keeps_y_dtype_and_f32_state():
    """bf16 x, dt, B and C: y comes back in bf16 (one rounding of an f32
    value), h_last in f32 (the same f32 arithmetic on the same values)."""
    x, dt, A, Bm, Cm, D, h0 = _inputs(2, 150, 4, 16, 8, seed=4, h0=True)
    jb = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, dt, Bm, Cm)]
    tb = [torch.from_numpy(v).bfloat16() for v in (x, dt, Bm, Cm)]
    y_want, h_want = _jax_layer(64)(jb[0], jb[1], jnp.asarray(A), jb[2], jb[3],
                                    jnp.asarray(D), h0=jnp.asarray(h0))
    y_got, h_got = ssd_chunked(tb[0], tb[1], torch.from_numpy(A), tb[2], tb[3],
                               torch.from_numpy(D), chunk=64, h0=torch.from_numpy(h0))
    assert y_got.dtype == torch.bfloat16 and h_got.dtype == torch.float32
    np.testing.assert_allclose(y_got.float().numpy(), np.asarray(y_want, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **H_TOL)


def test_step_matches_jax_step():
    x, dt, A, Bm, Cm, D, h0 = _inputs(3, 1, 4, 8, 6, seed=8, h0=True)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, h0)
    y_want, h_want = jax_step(*_j(*args))
    y_got, h_got = ssd_step(*_t(*args))
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **Y_TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **Y_TOL)


def test_steps_continue_the_chunked_scan():
    """Decode continues prefill: ssd_step from the chunked scan's h_last
    equals the chunked scan over one step more."""
    x, dt, A, Bm, Cm, D, _ = _inputs(2, 41, 3, 8, 4, seed=9)
    t = _t(x, dt, A, Bm, Cm, D)
    y_all, h_all = ssd_chunked(*t, chunk=16)
    _, h_prev = ssd_chunked(*[v[:, :40] for v in t[:2]], t[2], *[v[:, :40] for v in t[3:5]],
                            t[5], chunk=16)
    y_last, h_last = ssd_step(t[0][:, 40], t[1][:, 40], t[2], t[3][:, 40], t[4][:, 40],
                              t[5], h_prev)
    torch.testing.assert_close(y_last, y_all[:, 40], **Y_TOL)
    torch.testing.assert_close(h_last, h_all, **Y_TOL)


def test_recurrence_oracle_matches_jax():
    x, dt, A, Bm, Cm, _, _ = _inputs(2, 60, 3, 8, 5, seed=5)
    la = dt * A[None, None, :]
    xw = x * dt[..., None]
    y_want, h_want = jax_rec_ref(*_j(xw, la, Bm, Cm))
    y_got, h_got = ssd_rec_ref(*_t(xw, la, Bm, Cm))
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), **Y_TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **Y_TOL)


@pytest.mark.parametrize("chunk", [16, 128])
def test_chunked_matches_recurrence_from_a_state(chunk):
    """The plain chunked version with h0 against the sequential oracle with
    the same h0 (the JAX oracle starts at zero)."""
    x, dt, A, Bm, Cm, D, h0 = _inputs(2, 100, 3, 8, 5, seed=6, h0=True)
    xt, dtt, At, Bt, Ct, Dt, h0t = _t(x, dt, A, Bm, Cm, D, h0)
    y_got, h_got = ssd_chunked_ref(xt, dtt, At, Bt, Ct, Dt, chunk, h0t)
    y_rec, h_rec = ssd_rec_ref(xt * dtt[..., None], dtt * At, Bt, Ct, h0t)
    torch.testing.assert_close(y_got, y_rec + xt * Dt[None, None, :, None], **Y_TOL)
    torch.testing.assert_close(h_got, h_rec, **H_TOL)


def test_head_shared_b_and_c_as_stride0_views():
    """B and C given as (B, S, N) expanded over the heads (stride 0, as the
    model passes them) equal the same values materialised."""
    x, dt, A, _, _, D, h0 = _inputs(2, 70, 4, 8, 6, seed=7, h0=True)
    rng = np.random.default_rng(70)
    b_sh = torch.from_numpy(rng.standard_normal((2, 70, 6)).astype(np.float32))
    c_sh = torch.from_numpy(rng.standard_normal((2, 70, 6)).astype(np.float32))
    Bv, Cv = (t[:, :, None].expand(2, 70, 4, 6) for t in (b_sh, c_sh))
    assert Bv.stride(2) == 0 and Cv.stride(2) == 0
    xt, dtt, At, Dt, h0t = _t(x, dt, A, D, h0)
    y_v, h_v = ops.ssd(xt, dtt, At, Bv, Cv, Dt, h0t, chunk=32)
    y_m, h_m = ops.ssd(xt, dtt, At, Bv.contiguous(), Cv.contiguous(), Dt, h0t, chunk=32)
    torch.testing.assert_close(y_v, y_m, rtol=0, atol=0)
    torch.testing.assert_close(h_v, h_m, rtol=0, atol=0)


def test_other_devices_raise():
    x = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.ssd(x, torch.zeros((1, 4, 2), device="meta"), torch.zeros(2, device="meta"),
                torch.zeros((1, 4, 2, 3), device="meta"),
                torch.zeros((1, 4, 2, 3), device="meta"), torch.zeros(2, device="meta"))


def test_flops_bytes_at_the_path_shape():
    """mamba2-370m's prefill: B 8, S 32,768, H 32, P 64, N 128, 256 chunks of
    128: 2.3 GB of bytes and 4.8e11 operations (the causal half of the chunk
    products)."""
    ops_, nbytes = flops_bytes(8, 32768, 32, 64, 128)
    mac_per_chunk = 128 * 129 / 2 * (128 + 64) + 2 * 128 * 128 * 64
    assert ops_ == 2.0 * 8 * 32 * 256 * mac_per_chunk
    assert nbytes == (2.0 * (2 * 8 * 32768 * 32 * 64 + 8 * 32768 * 32 + 2 * 8 * 32768 * 128)
                      + 4.0 * 2 * 32 + 4.0 * 2 * 8 * 32 * 128 * 64)
    assert 2.29e9 < nbytes < 2.32e9 and 4.8e11 < ops_ < 4.9e11
    ragged, _ = flops_bytes(1, 200, 1, 4, 2)  # chunks of 128 and 72
    assert ragged == 2.0 * sum(q * (q + 1) / 2 * 6 + 2.0 * q * 8 for q in (128, 72))


def _bf16_inputs(shape, seed, with_h0):
    """The inputs above with x, dt, B and C rounded to bf16, for both sides."""
    x, dt, A, Bm, Cm, D, h0 = _inputs(*shape, seed=seed, h0=with_h0)
    jb = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, dt, Bm, Cm)]
    tb = [torch.from_numpy(v).bfloat16() for v in (x, dt, Bm, Cm)]
    return jb, tb, A, D, h0


@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_bf16ops_version_matches_jax_layer(shape, with_h0):
    """The bf16 kernel's arithmetic (G, the state's copy for C h and Bw
    rounded to bf16) against the JAX layer on the same bf16 inputs, at the
    JAX package's bf16 tolerances; ragged S (200, 77) and an initial state."""
    jb, tb, A, D, h0 = _bf16_inputs(shape, sum(shape) + 1, with_h0)
    y_want, h_want = _jax_layer(128)(jb[0], jb[1], jnp.asarray(A), jb[2], jb[3],
                                     jnp.asarray(D), h0=_j(h0)[0])
    y_got, h_got = ssd_chunked_bf16ops_ref(tb[0], tb[1], torch.from_numpy(A), tb[2], tb[3],
                                           torch.from_numpy(D), 128, _t(h0)[0])
    assert y_got.dtype == torch.bfloat16 and h_got.dtype == torch.float32
    np.testing.assert_allclose(y_got.float().numpy(), np.asarray(y_want, np.float32),
                               **Y_TOL_BF16)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **H_TOL_BF16)


@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_bf16ops_version_matches_f32_chunked(shape, with_h0):
    """The bf16 kernel's arithmetic against the port's f32 chunked version
    on the same bf16 inputs, at the same tolerances, with B and C as
    stride-0 head views (as the model passes them)."""
    _, tb, A, D, h0 = _bf16_inputs(shape, sum(shape) + 2, with_h0)
    B, S, H, _, N = shape
    Bv, Cv = (t[:, :, :1].expand(B, S, H, N) for t in (tb[2], tb[3]))
    args = (tb[0], tb[1], torch.from_numpy(A), Bv, Cv, torch.from_numpy(D), 128, _t(h0)[0])
    y_got, h_got = ssd_chunked_bf16ops_ref(*args)
    y_want, h_want = ssd_chunked_ref(*args)
    torch.testing.assert_close(y_got.float(), y_want.float(), **Y_TOL_BF16)
    torch.testing.assert_close(h_got, h_want, **H_TOL_BF16)


def test_bf16ops_version_splits_its_operands():
    """It is not the f32 version: y differs by bf16 roundings, within 2^-8.
    Its split operands keep h_last within 2^-16 of the f32 version, where
    rounding them once (``split=()``) does not."""
    _, tb, A, D, h0 = _bf16_inputs((2, 200, 4, 32, 16), 3, True)
    args = (tb[0], tb[1], torch.from_numpy(A), tb[2], tb[3], torch.from_numpy(D), 128,
            _t(h0)[0])
    y_want, h_want = ssd_chunked_ref(*args)

    def rel(got, want):
        return ((got.float() - want.float()).norm() / want.float().norm()).item()

    y_got, h_got = ssd_chunked_bf16ops_ref(*args)
    _, h_once = ssd_chunked_bf16ops_ref(*args, split=())
    assert 0 < rel(y_got, y_want) < 2.0 ** -8
    assert rel(h_got, h_want) < 2.0 ** -16 < rel(h_once, h_want)
