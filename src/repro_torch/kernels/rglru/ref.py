"""Plain PyTorch versions of the RG-LRU recurrence.

* ``rglru_rec_ref``: the sequential recurrence h_t = exp(log_a_t) h_{t-1}
  + u_t (a copy of the JAX package's oracle).
* ``rglru_ref``: the kernel's plain version, gates and recurrence, all in
  f32 as the JAX layer (``repro/layers/rglru.py``) keeps them: y in x's
  dtype, h_last in f32.
* ``rglru_chunked_ref``: the same function in the kernel's order of
  arithmetic: sub-segments scanned from h = 0, then combined with the
  carry (``csrc/rglru.cu``).
* ``rglru_bwd_ref``: its gradient, the reverse recurrence g_t = dy_t +
  a_{t+1} g_{t+1} and the gate gradients, sequential in f32 (the JAX
  package's gradient is autodiff of its layer's associative scan);
  ``rglru_bwd_chunked_ref`` the same in the backward kernel's order of
  arithmetic.

Both forwards can also return the state entering each ``CHUNK``-step chunk
(``return_carries``), which the backwards start from.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_C = 8.0  # Griffin decay sharpness
CHUNK = 128  # the kernels' chunk (steps x segments of rglru_chunked_ref)


def rglru_rec_ref(log_a: torch.Tensor, u: torch.Tensor,
                  h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, u: (B, S, N); h0: (B, N).  Returns (y in u's dtype, h_last f32)."""
    a = torch.exp(log_a.float())
    uf = u.float()
    h = h0.float()
    ys = torch.empty_like(uf)
    for t in range(uf.shape[1]):
        h = a[:, t] * h + uf[:, t]
        ys[:, t] = h
    return ys.to(u.dtype), h


def gate_terms(r: torch.Tensor, i: torch.Tensor, x: torch.Tensor,
               a_param: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, u) in f32: log_a = -8 softplus(a_param) r and
    u = sqrt(max(1 - exp(2 log_a), 1e-12)) i x."""
    log_a = -_C * F.softplus(a_param.float()) * r.float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * (i.float() * x.float())


def _carries(hs: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The state entering each CHUNK-step chunk, (B, chunks, N), from the f32
    states hs (B, S, N) after each step and the initial h0."""
    S = hs.shape[1]
    before = torch.cat([h0[:, None], hs[:, :-1]], 1)
    return before[:, 0:S:CHUNK].contiguous()


def rglru_ref(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
              a_param: torch.Tensor, h0: Optional[torch.Tensor] = None,
              return_carries: bool = False):
    """x, r, i: (B, S, N); a_param: (N,); h0: (B, N) or None (zeros).
    Returns (y (B, S, N) in x's dtype, h_last (B, N) f32), and with
    ``return_carries`` the f32 state entering each chunk (B, chunks, N)."""
    B, _, N = x.shape
    log_a, u = gate_terms(r, i, x, a_param)
    h0 = (torch.zeros((B, N), dtype=torch.float32, device=x.device) if h0 is None
          else h0.float())
    hs, h_last = rglru_rec_ref(log_a, u, h0)
    if return_carries:
        return hs.to(x.dtype), h_last, _carries(hs, h0)
    return hs.to(x.dtype), h_last


def rglru_chunked_ref(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                      a_param: torch.Tensor, h0: Optional[torch.Tensor] = None,
                      steps: int = 8, segments: int = 16, return_carries: bool = False):
    """``rglru_ref`` in the order of the kernel's arithmetic.  Time goes in
    chunks of ``segments`` sub-segments of ``steps`` steps (past S: a = 1,
    u = 0).  Each sub-segment is scanned from h = 0 with the running product
    P of a; each gets h_in, the previous chunk's carry combined with the
    sub-segments before it (combine((P1, h1), (P2, h2)) = (P1 P2, P2 h1 +
    h2)); then y = h + P h_in.  Returns (y in x's dtype, h_last f32)."""
    B, S, N = x.shape
    log_a, u = gate_terms(r, i, x, a_param)
    a = torch.exp(log_a)
    chunk = steps * segments
    chunks = -(-S // chunk)
    pad = chunks * chunk - S
    a = torch.cat([a, a.new_ones((B, pad, N))], 1).view(B, chunks, segments, steps, N)
    u = torch.cat([u, u.new_zeros((B, pad, N))], 1).view(B, chunks, segments, steps, N)
    hs, ps = torch.empty_like(u), torch.empty_like(a)
    h, p = u[:, :, :, 0], a[:, :, :, 0]
    hs[:, :, :, 0], ps[:, :, :, 0] = h, p
    for j in range(1, steps):
        h = a[:, :, :, j] * h + u[:, :, :, j]
        p = p * a[:, :, :, j]
        hs[:, :, :, j], ps[:, :, :, j] = h, p
    carry = (torch.zeros((B, N), dtype=torch.float32, device=x.device) if h0 is None
             else h0.float())
    ys = torch.empty_like(hs)
    carries = torch.empty((B, chunks, N), dtype=torch.float32, device=x.device)
    for c in range(chunks):
        carries[:, c] = carry
        h_in = torch.empty((B, segments, N), dtype=torch.float32, device=x.device)
        for w in range(segments):
            h_in[:, w] = carry
            carry = ps[:, c, w, -1] * carry + hs[:, c, w, -1]
        ys[:, c] = hs[:, c] + ps[:, c] * h_in[:, :, None]
    y = ys.view(B, chunks * chunk, N)[:, :S]
    if return_carries:
        return y.to(x.dtype), carry, carries
    return y.to(x.dtype), carry


def _gate_grads(x, r, i, a_param, g, h_prev):
    """The gate gradients of one step's h = a h_prev + beta i x from g, the
    gradient of h (f32, any shape broadcast with x): (dx, dr, di, the
    d a_param terms before the sum, all f32).  dlog_a = g h_prev a minus,
    where 1 - a^2 lies above the 1e-12 floor (``jnp.maximum``'s gradient),
    g i x a^2 / beta."""
    xf, rf, i_f, ap = x.float(), r.float(), i.float(), a_param.float()
    c = -_C * F.softplus(ap)
    log_a = c * rf
    a = torch.exp(log_a)
    a2 = torch.exp(2.0 * log_a)
    om = 1.0 - a2
    beta = torch.sqrt(torch.clamp(om, min=1e-12))
    dlog = g * h_prev * a - torch.where(om > 1e-12, g * (i_f * xf) * a2 / beta, 0.0)
    return g * beta * i_f, c * dlog, g * beta * xf, -_C * torch.sigmoid(ap) * rf * dlog


def rglru_bwd_ref(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                  a_param: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor,
                  dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``rglru_ref`` (y and h_last) from dy (B, S, N) and
    dh_last (B, N) or None, sequential in f32: h is recomputed step by step,
    then g_t = dy_t + a_{t+1} g_{t+1} (g_{S-1} gets dh_last) from the last
    step back.  Returns (dx, dr, di in x's dtype, d a_param (N,) f32, dh0
    (B, N) f32)."""
    B, S, N = x.shape
    log_a, u = gate_terms(r, i, x, a_param)
    a = torch.exp(log_a)
    h = (torch.zeros((B, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    hs = torch.empty((B, S + 1, N), dtype=torch.float32, device=x.device)
    hs[:, 0] = h
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        hs[:, t + 1] = h
    dyf = dy.float()
    g = torch.empty_like(dyf)
    e = (torch.zeros((B, N), dtype=torch.float32, device=x.device) if dh_last is None
         else dh_last.float())
    for t in range(S - 1, -1, -1):
        g[:, t] = dyf[:, t] + e
        e = a[:, t] * g[:, t]
    dx, dr, di, dap = _gate_grads(x, r, i, a_param, g, hs[:, :S])
    return dx.to(x.dtype), dr.to(x.dtype), di.to(x.dtype), dap.sum((0, 1)), e


def rglru_bwd_chunked_ref(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                          a_param: torch.Tensor, carries: torch.Tensor, dy: torch.Tensor,
                          dh_last: Optional[torch.Tensor] = None, steps: int = 8,
                          segments: int = 16) -> Tuple[torch.Tensor, ...]:
    """``rglru_bwd_ref`` in the backward kernel's order of arithmetic, from
    the forward's ``carries``.  Chunks are walked from last to first
    (past S: a = 1, u = 0, dy = 0).  In each, h is recomputed from the
    chunk's carry as ``rglru_chunked_ref`` forms it; each sub-segment runs
    e_t = a_t (dy_t + e_{t+1}) from e = 0 and gives (P, e_first); its e_in
    is the carry from the chunk after combined with the sub-segments after
    it (P e_in + e_first), then g_t = dy_t + e_{t+1} from e_in.  d a_param
    is summed per (b, chunk) over the sub-segments in order, then over
    (b, chunk).  The gate terms are formed as ``gate_terms`` forms them;
    the kernel forms a^2 as a a and 1 / beta with one reciprocal square
    root, a few f32 ulps apart.  Same results as ``rglru_bwd_ref``."""
    B, S, N = x.shape
    chunk = steps * segments
    chunks = -(-S // chunk)
    pad = chunks * chunk - S

    def padded(t):
        t = t.float()
        return torch.cat([t, t.new_zeros((B, pad, N))], 1).view(B, chunks, segments, steps, N)

    xp, rp, ip, dyp = padded(x), padded(r), padded(i), padded(dy)
    log_a, u = gate_terms(rp, ip, xp, a_param)
    a = torch.exp(log_a)
    # the forward's sub-segment scans from h = 0
    hs, ps = torch.empty_like(u), torch.empty_like(a)
    h, p = u[..., 0, :], a[..., 0, :]
    hs[..., 0, :], ps[..., 0, :] = h, p
    for j in range(1, steps):
        h = a[..., j, :] * h + u[..., j, :]
        p = p * a[..., j, :]
        hs[..., j, :], ps[..., j, :] = h, p
    # the reverse sub-segment scans from e = 0
    e = torch.zeros_like(dyp[..., 0, :])
    for j in range(steps - 1, -1, -1):
        e = a[..., j, :] * (dyp[..., j, :] + e)
    e_first = e                                                  # (B, chunks, segments, N)
    g = torch.empty_like(dyp)
    h_prev = torch.empty_like(dyp)
    part = torch.empty((B, chunks, N), dtype=torch.float32, device=x.device)
    e_carry = (torch.zeros((B, N), dtype=torch.float32, device=x.device) if dh_last is None
               else dh_last.float())
    for c in range(chunks - 1, -1, -1):
        h = carries[:, c].float()
        h_in = []
        for w in range(segments):
            h_in.append(h)
            h = ps[:, c, w, -1] * h + hs[:, c, w, -1]
        e_in = [None] * segments
        for w in range(segments - 1, -1, -1):
            e_in[w] = e_carry
            e_carry = ps[:, c, w, -1] * e_carry + e_first[:, c, w]
        for w in range(segments):
            e = e_in[w]
            for j in range(steps - 1, -1, -1):
                g[:, c, w, j] = dyp[:, c, w, j] + e
                h_prev[:, c, w, j] = (h_in[w] if j == 0
                                      else hs[:, c, w, j - 1] + ps[:, c, w, j - 1] * h_in[w])
                e = a[:, c, w, j] * g[:, c, w, j]
    dx, dr, di, dap = _gate_grads(xp, rp, ip, a_param, g, h_prev)
    for c in range(chunks):
        s = torch.zeros((B, N), dtype=torch.float32, device=x.device)
        for w in range(segments):
            s = s + dap[:, c, w].sum(1)
        part[:, c] = s

    def unpadded(t):
        return t.reshape(B, chunks * chunk, N)[:, :S].to(x.dtype)

    return unpadded(dx), unpadded(dr), unpadded(di), part.sum((0, 1)), e_carry
