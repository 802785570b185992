"""The port's backwards of the two recurrent ops on the CPU against the JAX
package's autodiff, on the same seeded numpy inputs in f32:

* RG-LRU: ``rglru_bwd_ref`` (the reverse recurrence, sequential) and
  ``rglru_bwd_chunked_ref`` (the backward kernel's order of arithmetic, from
  the forward's chunk carries) against ``jax.vjp`` of
  ``repro.layers.rglru.rglru_scan`` (an associative scan); ``rglru_scan``
  under grad (``_RGLRU``) too.  Relative L2 error 1e-4 for each gradient.
* SSD: ``ssd_bwd`` (explicit gradients from the forward's chunk states)
  against ``jax.vjp`` of ``repro.layers.ssd.ssd_chunked``, with B and C per
  head and shared by the heads (a (B, S, N) tensor, the gradient summed over
  the heads; the JAX side broadcasts it); ``ssd_chunked`` under grad
  (``_SSD``) too.  Relative L2 error 2e-4, the JAX package's own SSD
  tolerance.

Each with and without h0 and dh_last, at S that is not a multiple of the
chunk.  The carries and states that the plain forwards return are held to
the reference's own scan states (its y in f32 for the RG-LRU, its h_last on
each prefix for the SSD).  The SSD inputs keep each chunk's summed decay
|sum dt A| well below 88: the reference's autodiff takes exp(cum_t - cum_s)
above the diagonal too, where it overflows past that and 0 * inf makes its
gradients NaN (``test_ssd_bwd_stays_finite_where_the_reference_overflows``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import rglru as jax_rglru
from repro.layers import ssd as jax_ssd
from repro_torch.kernels.rglru.ref import (CHUNK, rglru_bwd_chunked_ref, rglru_bwd_ref,
                                           rglru_chunked_ref, rglru_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.layers.rglru import rglru_scan
from repro_torch.layers.ssd import ssd_bwd, ssd_chunked

RGLRU_TOL = 1e-4
SSD_TOL = 2e-4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a):
    return None if a is None else torch.from_numpy(a)


# -- RG-LRU ------------------------------------------------------------------

def _rglru_inputs(B, S, N, seed, with_h0, with_dh):
    rng = np.random.default_rng(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, r, i = f(B, S, N), sig(f(B, S, N)), sig(f(B, S, N))
    a_param = f(N)
    h0 = f(B, N) if with_h0 else None
    dy, dh = f(B, S, N), (f(B, N) if with_dh else None)
    return x, r.astype(np.float32), i.astype(np.float32), a_param, h0, dy, dh


def _rglru_reference(x, r, i, a_param, h0, dy, dh):
    """jax.vjp of the JAX layer: (dx, dr, di, d a_param, dh0 or None)."""
    B, _, N = x.shape
    args = [jnp.asarray(t) for t in (x, r, i, a_param)]
    if h0 is None:
        (y, h_last), vjp = jax.vjp(lambda *a: jax_rglru.rglru_scan(*a), *args)
    else:
        (y, h_last), vjp = jax.vjp(lambda *a: jax_rglru.rglru_scan(*a[:4], a[4]), *args,
                                   jnp.asarray(h0))
    cot = (jnp.asarray(dy), jnp.zeros((B, N), jnp.float32) if dh is None else jnp.asarray(dh))
    grads = vjp(cot)
    return [np.asarray(g) for g in grads] + ([None] if h0 is None else [])


RGLRU_SHAPES = [(2, 300, 24), (1, 128, 8), (3, 37, 5)]


@pytest.mark.parametrize("shape", RGLRU_SHAPES)
@pytest.mark.parametrize("with_h0, with_dh", [(False, False), (True, True), (True, False)])
def test_rglru_bwd_matches_jax_vjp(shape, with_h0, with_dh):
    x, r, i, a, h0, dy, dh = _rglru_inputs(*shape, seed=sum(shape) + 2 * with_h0 + with_dh,
                                           with_h0=with_h0, with_dh=with_dh)
    want = _rglru_reference(x, r, i, a, h0, dy, dh)
    got = rglru_bwd_ref(*map(_t, (x, r, i, a, h0, dy, dh)))
    _, _, carries = rglru_chunked_ref(*map(_t, (x, r, i, a, h0)), return_carries=True)
    chunked = rglru_bwd_chunked_ref(*map(_t, (x, r, i, a)), carries, _t(dy), _t(dh))
    for name, g, gc, w in zip(("dx", "dr", "di", "da_param", "dh0"), got, chunked, want):
        if w is None:
            continue
        assert g.dtype == gc.dtype == torch.float32, name
        assert _rel(g, w) < RGLRU_TOL, (name, _rel(g, w))
        assert _rel(gc, w) < RGLRU_TOL, (name, _rel(gc, w))


@pytest.mark.parametrize("shape", RGLRU_SHAPES)
def test_rglru_carries_equal_reference_states(shape):
    """The state entering each chunk from both plain forwards: h0 first,
    then the JAX layer's h (its f32 y) at the step before the chunk."""
    x, r, i, a, h0, _, _ = _rglru_inputs(*shape, seed=7, with_h0=True, with_dh=False)
    y, _ = jax_rglru.rglru_scan(*map(jnp.asarray, (x, r, i, a)), jnp.asarray(h0))
    y = np.asarray(y)
    B, S, N = x.shape
    want = np.stack([h0] + [y[:, t - 1] for t in range(CHUNK, S, CHUNK)], 1)
    for fn in (rglru_ref, rglru_chunked_ref):
        _, _, carries = fn(*map(_t, (x, r, i, a, h0)), return_carries=True)
        assert carries.shape == (B, -(-S // CHUNK), N) and carries.dtype == torch.float32
        np.testing.assert_allclose(carries.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_under_grad_matches_jax_vjp(with_h0):
    """``rglru_scan`` with inputs that need gradients runs ``_RGLRU``: y and
    h_last as without, and every input's gradient as the JAX layer's."""
    x, r, i, a, h0, dy, dh = _rglru_inputs(2, 200, 16, seed=11, with_h0=with_h0, with_dh=True)
    want = _rglru_reference(x, r, i, a, h0, dy, dh)
    leaves = [None if v is None else _t(v).clone().requires_grad_(True)
              for v in (x, r, i, a, h0)]
    y, h_last = rglru_scan(*leaves)
    y0, h0_ = rglru_scan(*map(_t, (x, r, i, a, h0)))
    assert torch.equal(y.detach(), y0) and torch.equal(h_last.detach(), h0_)
    ((y * _t(dy)).sum() + (h_last * _t(dh)).sum()).backward()
    for leaf, w in zip(leaves, want):
        if leaf is not None:
            assert _rel(leaf.grad, w) < RGLRU_TOL


# -- SSD ---------------------------------------------------------------------

def _ssd_inputs(B, S, H, P, N, seed, shared, with_h0, with_dh):
    """x 0.5 sigma, dt a softplus of N(-2, 1) (mean ~0.15), A in [-1.1,
    -0.1], B and C 0.3 sigma (one (B, S, N) for all heads when ``shared``),
    D normal; dy, dh_last normal."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(B, S, H, P) * 0.5
    dt = np.log1p(np.exp(f(B, S, H) - 2.0)).astype(np.float32)
    A = (-rng.uniform(0.1, 1.1, H)).astype(np.float32)
    bc = (B, S, N) if shared else (B, S, H, N)
    Bm, Cm = f(*bc) * 0.3, f(*bc) * 0.3
    D = f(H)
    h0 = f(B, H, N, P) if with_h0 else None
    dy, dh = f(B, S, H, P), (f(B, H, N, P) if with_dh else None)
    return x, dt, A, Bm, Cm, D, h0, dy, dh


def _ssd_reference(x, dt, A, Bm, Cm, D, h0, dy, dh, chunk):
    """jax.vjp of the JAX layer (B and C broadcast over the heads when 3-D):
    (dx, ddt, dA, dBm, dCm, dD, dh0 or None)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]

    def heads(t):
        return jnp.broadcast_to(t[:, :, None, :], (B, S, H, N)) if t.ndim == 3 else t

    def fn(x, dt, A, Bm, Cm, D, *h0):
        return jax_ssd.ssd_chunked(x, dt, A, heads(Bm), heads(Cm), D, chunk=chunk,
                                   h0=h0[0] if h0 else None)

    args = [jnp.asarray(t) for t in (x, dt, A, Bm, Cm, D)] + (
        [] if h0 is None else [jnp.asarray(h0)])
    (y, h_last), vjp = jax.vjp(fn, *args)
    cot = (jnp.asarray(dy), jnp.zeros((B, H, N, P), jnp.float32) if dh is None
           else jnp.asarray(dh))
    return [np.asarray(g) for g in vjp(cot)] + ([None] if h0 is None else [])


SSD_CASES = [  # (B, S, H, P, N, chunk)
    (2, 50, 3, 4, 5, 16), (1, 200, 2, 8, 16, 64), (2, 300, 4, 16, 8, 128)]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("with_h0, with_dh", [(False, False), (True, True)])
def test_ssd_bwd_matches_jax_vjp(case, shared, with_h0, with_dh):
    *shape, chunk = case
    x, dt, A, Bm, Cm, D, h0, dy, dh = _ssd_inputs(*shape, seed=sum(shape) + shared,
                                                  shared=shared, with_h0=with_h0,
                                                  with_dh=with_dh)
    want = _ssd_reference(x, dt, A, Bm, Cm, D, h0, dy, dh, chunk)
    H = x.shape[2]
    heads = (lambda t: t[:, :, None].expand(*t.shape[:2], H, t.shape[2])) if shared else (
        lambda t: t)
    _, _, states = ssd_chunked_ref(*map(_t, (x, dt, A)), heads(_t(Bm)), heads(_t(Cm)), _t(D),
                                   chunk, _t(h0), return_states=True)
    got = ssd_bwd(*map(_t, (x, dt, A, Bm, Cm, D)), states, _t(dy), _t(dh), chunk)
    names = ("dx", "ddt", "dA", "dBm", "dCm", "dD", "dh0")
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) < SSD_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_states_equal_reference_states(case):
    """The state entering each chunk from the plain forward (and the op on
    the CPU): h0 first, then the JAX layer's h_last on each prefix."""
    *shape, chunk = case
    x, dt, A, Bm, Cm, D, h0, _, _ = _ssd_inputs(*shape, seed=5, shared=False, with_h0=True,
                                                with_dh=False)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    want = [h0]
    for lo in range(chunk, S, chunk):
        _, h = jax_ssd.ssd_chunked(*map(jnp.asarray, (x[:, :lo], dt[:, :lo], A, Bm[:, :lo],
                                                       Cm[:, :lo], D)), chunk=chunk,
                                   h0=jnp.asarray(h0))
        want.append(np.asarray(h))
    want = np.stack(want, 2)
    _, _, states = ssd_ops.ssd(*map(_t, (x, dt, A, Bm, Cm, D, h0)), chunk=chunk,
                               return_states=True)
    assert states.shape == (B, H, -(-S // chunk), N, P) and states.dtype == torch.float32
    assert ssd_ops.state_chunk(_t(x), chunk) == chunk
    np.testing.assert_allclose(states.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("shared", [False, True])
def test_ssd_chunked_under_grad_matches_jax_vjp(shared):
    """``ssd_chunked`` with inputs that need gradients runs ``_SSD``: y and
    h_last as without, and every input's gradient as the JAX layer's (a 3-D
    B and C is the model's head-shared form)."""
    x, dt, A, Bm, Cm, D, h0, dy, dh = _ssd_inputs(2, 90, 3, 8, 6, seed=13, shared=shared,
                                                  with_h0=True, with_dh=True)
    want = _ssd_reference(x, dt, A, Bm, Cm, D, h0, dy, dh, 32)
    leaves = [_t(v).clone().requires_grad_(True) for v in (x, dt, A, Bm, Cm, D, h0)]
    y, h_last = ssd_chunked(*leaves[:6], chunk=32, h0=leaves[6])
    y0, hl0 = ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), chunk=32, h0=_t(h0))
    assert torch.equal(y.detach(), y0) and torch.equal(h_last.detach(), hl0)
    ((y * _t(dy)).sum() + (h_last * _t(dh)).sum()).backward()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        assert _rel(leaf.grad, w) < SSD_TOL


def test_ssd_bwd_stays_finite_where_the_reference_overflows():
    """Large steps (dt ~ 2.5, A = -1: a chunk of 64 decays by e^-160): the
    JAX layer's exp(cum_t - cum_s) above the diagonal overflows and its
    autodiff returns NaN (0 * inf); ``ssd_bwd`` takes the exponential only
    on and below the diagonal, and its gradients are finite and agree with
    the chunk-of-16 reference's, which does not overflow."""
    x, dt, A, Bm, Cm, D, h0, dy, dh = _ssd_inputs(1, 128, 2, 4, 4, seed=3, shared=False,
                                                  with_h0=False, with_dh=False)
    dt = dt * 0 + 2.5
    A = np.full_like(A, -1.0)
    at64 = _ssd_reference(x, dt, A, Bm, Cm, D, None, dy, None, 64)
    assert not all(np.isfinite(g).all() for g in at64[:6])
    want = _ssd_reference(x, dt, A, Bm, Cm, D, None, dy, None, 16)
    _, _, states = ssd_chunked_ref(*map(_t, (x, dt, A, Bm, Cm, D)), 64, return_states=True)
    got = ssd_bwd(*map(_t, (x, dt, A, Bm, Cm, D)), states, _t(dy), None, 64)
    for g, w in zip(got[:6], want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) < SSD_TOL
