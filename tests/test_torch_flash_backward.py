"""The port's differentiable flash attention (``layers.attention._Flash``)
on the CPU against the JAX package's custom VJP: ``jax.vjp`` of
``repro.layers.attention.chunked_attention`` (``_flash_fwd`` and
``_flash_bwd``) on the same numpy inputs and output gradient, for causal,
sliding-window, soft-capped, GQA, MQA, ``q_offset`` and the non-causal
cross shape (Sq != Sk), with key chunks that leave a ragged last chunk.
The plain version's log-sum-exp (``chunked_attention_ref(return_lse=True)``)
is held against ``_flash_fwd``'s residual, and ``flash_bwd`` against the
same gradients when fed that residual.

Tolerances (relative L2): f32 1e-5 (summation order only); bf16 2e-2 (the
reference's bf16 bar, ``tests/test_kernels.py``: inputs, q/sqrt(D), p and
the outputs are rounded to bf16 at the same places, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as JA
from repro_torch.kernels.flash_attention.ref import chunked_attention_ref
from repro_torch.layers import attention as TA

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (B, Sq, Sk, H, Hkv, D, causal, window, logit_cap, q_offset, chunk)
CASES = {
    "causal": (2, 40, 40, 4, 4, 16, True, 0, 0.0, 0, 16),
    "gqa": (2, 37, 37, 8, 2, 16, True, 0, 0.0, 0, 16),
    "mqa_window": (1, 50, 50, 4, 1, 32, True, 12, 0.0, 0, 16),
    "softcap": (2, 33, 33, 4, 2, 16, True, 0, 5.0, 0, 8),
    "window_softcap": (1, 45, 45, 4, 4, 8, True, 9, 3.0, 0, 16),
    "q_offset": (2, 12, 40, 4, 2, 16, True, 0, 0.0, 28, 16),
    "cross": (2, 9, 30, 4, 4, 16, False, 0, 0.0, 0, 16),
    "not_causal": (2, 25, 25, 4, 2, 16, False, 0, 0.0, 0, 8),
}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(case, dtype, seed=0):
    """q, k, v and the output gradient as numpy f32 arrays holding values
    of ``dtype`` (bf16-rounded through JAX for bf16), so that both packages
    take the same numbers."""
    B, Sq, Sk, H, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, H, D))]
    return [np.array(jnp.asarray(a, dtype).astype(jnp.float32)) for a in arrs]


def _spec(case):
    causal, window, cap, chunk = case[6], case[7], case[8], case[10]
    return (JA.AttnSpec(causal=causal, window=window, logit_cap=cap, chunk=chunk),
            TA.AttnSpec(causal=causal, window=window, logit_cap=cap, chunk=chunk))


def _jax_vjp(case, arrs, dtype):
    jspec, _ = _spec(case)
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrs)
    out, vjp = jax.vjp(lambda q, k, v: JA.chunked_attention(q, k, v, jspec, case[9]),
                       q, k, v)
    return out, vjp(do)


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_grads_match_reference(name, dtype):
    case = CASES[name]
    arrs = _inputs(case, getattr(jnp, dtype))
    want_out, want_grads = _jax_vjp(case, arrs, getattr(jnp, dtype))
    _, tspec = _spec(case)
    q, k, v, do = _torch(arrs, getattr(torch, dtype))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = TA.chunked_attention(q, k, v, tspec, case[9])
    assert out.dtype == q.dtype and out.grad_fn is not None
    out.backward(do)
    assert _rel(out.detach().float(), np.asarray(want_out, np.float32)) <= TOL[dtype]
    for t, want, what in zip((q, k, v), want_grads, "qkv"):
        got = t.grad
        assert got.dtype == t.dtype and got.shape == t.shape
        err = _rel(got.float(), np.asarray(want, np.float32))
        assert err <= TOL[dtype], (name, dtype, f"d{what}", err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_lse_matches_flash_fwd_residual(name, dtype):
    case = CASES[name]
    B, Sq, Sk, H, Hkv, D = case[:6]
    arrs = _inputs(case, getattr(jnp, dtype))
    jspec, _ = _spec(case)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs[:3])
    _, (*_, jlse) = JA._flash_fwd(jq, jk, jv, jspec, case[9])
    q, k, v, _ = _torch(arrs, getattr(torch, dtype))
    out, lse = chunked_attention_ref(q, k, v, case[6], case[7], case[8], case[10],
                                     q_offset=case[9], return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    want = np.asarray(jlse, np.float32).reshape(B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, chunked_attention_ref(q, k, v, case[6], case[7], case[8],
                                                  case[10], q_offset=case[9]))


@pytest.mark.parametrize("name", ["gqa", "softcap", "q_offset"])
def test_flash_bwd_fed_the_reference_residual(name):
    """``flash_bwd`` given the JAX forward's own output and lse gives the
    JAX backward's gradients (f32): the backward alone, apart from the
    forward it is usually fed."""
    case = CASES[name]
    B, Sq, Sk, H, Hkv, D = case[:6]
    arrs = _inputs(case, jnp.float32)
    jspec, tspec = _spec(case)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    jo, res = JA._flash_fwd(jq, jk, jv, jspec, case[9])
    want = JA._flash_bwd(jspec, case[9], res, jdo)
    q, k, v, do = _torch(arrs, torch.float32)
    lse = torch.from_numpy(np.array(res[-1])).reshape(B, H, Sq)
    got = TA.flash_bwd(q, k, v, torch.from_numpy(np.array(jo)), lse, do, tspec, case[9])
    for g, w, what in zip(got, want, "qkv"):
        assert _rel(g, np.asarray(w)) <= TOL["float32"], f"d{what}"


def test_no_grad_takes_the_forward_only_call(monkeypatch):
    """Without a gradient to take (grad mode off, or no input requiring
    one) the op is asked for no lse: the serving paths' call."""
    case = CASES["gqa"]
    _, tspec = _spec(case)
    q, k, v, _ = _torch(_inputs(case, jnp.float32), torch.float32)
    seen = []
    real = TA.flash_ops.flash_attention

    def spy(*a, **kw):
        seen.append(kw.get("return_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(TA.flash_ops, "flash_attention", spy)
    TA.chunked_attention(q, k, v, tspec)
    with torch.no_grad():
        TA.chunked_attention(q.requires_grad_(True), k, v, tspec)
    with torch.inference_mode():
        TA.chunked_attention(q, k, v, tspec)
    assert seen == [False, False, False]
    TA.chunked_attention(q, k, v, tspec).sum().backward()
    assert seen[-1] is True and q.grad is not None


def test_kv_valid_len_differentiates_through_the_plain_scan_on_cpu():
    """The reference differentiates ``kv_valid_len`` calls by autodiff of
    its scan; on the CPU the port's autograd runs through the plain one."""
    case = CASES["q_offset"]
    B = case[0]
    jspec, tspec = _spec(case)
    arrs = _inputs(case, jnp.float32)
    lens = np.array([35, 31], np.int32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: JA.chunked_attention(
        q, k, v, jspec, case[9], jnp.asarray(lens)), jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = _torch(arrs, torch.float32)
    for t in (q, k, v):
        t.requires_grad_(True)
    TA.chunked_attention(q, k, v, tspec, case[9], torch.from_numpy(lens)).backward(do)
    assert B == len(lens)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert _rel(g, np.asarray(w)) <= 1e-5
