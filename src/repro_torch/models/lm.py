"""Decoder-only LM: the training loss, prefill and single-token decode (the
JAX package's ``models/lm.py`` in PyTorch).

One code path, driven by ``ModelConfig.segments``.  Conventions kept from
the reference, so that its parameters carry across as a copy:

* params: flat dict ``"seg{i}/l{j}/<block>/<leaf>"`` -> (U, ...) tensors
  stacked over the segment's U units;
* cache:  flat dict ``"seg{i}/l{j}/<leaf>"`` -> (U, B, ...) stacked.

The reference's ``lax.scan`` over units is a Python loop over the unit
index.  Its sharding constraints are ``dist.context``'s ``constrain`` and
``constrain_param`` at the same points (unit boundaries and the loss's
hidden state on ("batch", "seq_model"): the sequence split on "model"
where it divides; per-unit parameters on their spec; vocab-sharded
logits): DTensor redistributions inside a ``launch/steps.py`` program, the
identity on plain tensors.  Its remat
(``jax.checkpoint`` with ``nothing_saveable`` around each unit) is
``torch.utils.checkpoint`` around each unit in ``backbone(remat=True)``,
and around each block of ``xent_loss``.
Every block kind of the reference runs: ``attn`` (attention + MLP), ``moe``
(attention + MoE FFN), ``rglru`` (RG-LRU + MLP), ``ssm`` (the Mamba-2 block)
and ``xattn`` (whisper's decoder layer: self-attention, cross-attention over
the encoder's output, MLP), in ``prefill``, ``decode_step`` and ``backbone``
(which ``lm_loss`` and ``models/encdec.py`` run).  Training differentiates
``lm_loss`` with autograd; on the card the ``attn``, ``moe`` and ``xattn``
kinds train (the flash kernel's forward with ``layers/attention.py``'s
backward), while the RG-LRU and SSD kernels raise under grad (no backward
yet).  Nothing on the training path writes in place into a tensor that
autograd saved.
Cross-attention K/V are computed once from the encoder's output in
``prefill`` and kept in the cache as ``xk``/``xv``; a decode step reads
them there.  ``check_ported`` raises on a kind the reference does not know.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import Partial

from ..device import DeviceLike
from ..dist.context import (act_placements, active_mesh, constrain, constrain_param,
                            dtensor_mesh, gathered, is_dtensor, local_region, mesh_axes,
                            shard_start, to_placements)
from ..layers.attention import AttnSpec, chunked_attention, decode_attention
from ..layers.common import (apply_rope, gated_mlp, layer_norm, matmul, mlp, rms_norm,
                             sinusoidal_at)
from ..layers.moe import MoESpec, moe_ffn
from ..layers.rglru import rglru_scan, rglru_step, short_conv1d
from ..layers.ssd import ssd_chunked, ssd_step
from .config import ModelConfig, Segment
from .params import ParamSpec, Params, Specs, init_params, params_from_numpy

Cache = Dict[str, torch.Tensor]

PORTED_KINDS = ("attn", "moe", "rglru", "ssm", "xattn")

# Logical axes of the residual stream at a unit boundary and of the loss's
# hidden state, as the reference stores both: sequence-parallel on "model"
# (where S divides by it, else whole).  Under remat a unit's input is what
# the backward keeps, so the split cuts it by the "model" size a card.
# Inside a unit the residual stream and the norms stay split; each block's
# norm output is gathered back to the whole sequence (``WHOLE_AXES``) for
# its products, and ``_residual`` lays a block's output out as the stream
# before adding it, so no product, and no product's gradient, meets a split
# sequence (a view that flattens one is refused by some versions' DTensor).
UNIT_AXES = ("batch", "seq_model", None)
WHOLE_AXES = ("batch", None, None)


# ===========================================================================
# Parameter specs
# ===========================================================================

def _attn_specs(cfg: ModelConfig, u: int, p: str) -> Specs:
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s: Specs = {
        f"{p}/norm": ParamSpec((u, D), ("layers", "embed"), init="zeros"),
        f"{p}/wq": ParamSpec((u, D, H, Dh), ("layers", "embed", "heads", None)),
        f"{p}/wk": ParamSpec((u, D, Hkv, Dh), ("layers", "embed", "kv_heads", None)),
        f"{p}/wv": ParamSpec((u, D, Hkv, Dh), ("layers", "embed", "kv_heads", None)),
        f"{p}/wo": ParamSpec((u, H, Dh, D), ("layers", "heads", None, "embed"),
                             fan_in_axis=1),
    }
    if cfg.norm == "ln":
        s[f"{p}/norm_bias"] = ParamSpec((u, D), ("layers", "embed"), init="zeros")
    if cfg.bias:
        s[f"{p}/bq"] = ParamSpec((u, H, Dh), ("layers", "heads", None), init="zeros")
        s[f"{p}/bk"] = ParamSpec((u, Hkv, Dh), ("layers", "kv_heads", None), init="zeros")
        s[f"{p}/bv"] = ParamSpec((u, Hkv, Dh), ("layers", "kv_heads", None), init="zeros")
        s[f"{p}/bo"] = ParamSpec((u, D), ("layers", "embed"), init="zeros")
    return s


def _mlp_specs(cfg: ModelConfig, u: int, p: str) -> Specs:
    D, F_ = cfg.d_model, cfg.d_ff
    s: Specs = {
        f"{p}/norm": ParamSpec((u, D), ("layers", "embed"), init="zeros"),
    }
    if cfg.norm == "ln":
        s[f"{p}/norm_bias"] = ParamSpec((u, D), ("layers", "embed"), init="zeros")
    if cfg.mlp_gated:
        s[f"{p}/w_gate"] = ParamSpec((u, D, F_), ("layers", "embed", "ffn"))
        s[f"{p}/w_up"] = ParamSpec((u, D, F_), ("layers", "embed", "ffn"))
        s[f"{p}/w_down"] = ParamSpec((u, F_, D), ("layers", "ffn", "embed"))
    else:
        s[f"{p}/w_up"] = ParamSpec((u, D, F_), ("layers", "embed", "ffn"))
        s[f"{p}/w_down"] = ParamSpec((u, F_, D), ("layers", "ffn", "embed"))
        if cfg.bias:
            s[f"{p}/b_up"] = ParamSpec((u, F_), ("layers", "ffn"), init="zeros")
            s[f"{p}/b_down"] = ParamSpec((u, D), ("layers", "embed"), init="zeros")
    return s


def _moe_specs(cfg: ModelConfig, u: int, p: str) -> Specs:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.expert_d_ff or cfg.d_ff
    return {
        f"{p}/norm": ParamSpec((u, D), ("layers", "embed"), init="zeros"),
        f"{p}/router": ParamSpec((u, D, E), ("layers", "embed", None)),
        f"{p}/w_gate": ParamSpec((u, E, D, F_), ("layers", "experts", "embed", "ffn")),
        f"{p}/w_up": ParamSpec((u, E, D, F_), ("layers", "experts", "embed", "ffn")),
        f"{p}/w_down": ParamSpec((u, E, F_, D), ("layers", "experts", "ffn", "embed"),
                                 fan_in_axis=2),
    }


def _rglru_specs(cfg: ModelConfig, u: int, p: str) -> Specs:
    D, N, T = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {
        f"{p}/norm": ParamSpec((u, D), ("layers", "embed"), init="zeros"),
        f"{p}/w_x": ParamSpec((u, D, N), ("layers", "embed", "rnn")),
        f"{p}/w_gate": ParamSpec((u, D, N), ("layers", "embed", "rnn")),
        f"{p}/conv_w": ParamSpec((u, T, N), ("layers", None, "rnn")),
        f"{p}/w_r": ParamSpec((u, N, N), ("layers", "rnn_in", "rnn")),
        f"{p}/w_i": ParamSpec((u, N, N), ("layers", "rnn_in", "rnn")),
        f"{p}/a_param": ParamSpec((u, N), ("layers", "rnn"), init="rglru_a"),
        f"{p}/w_out": ParamSpec((u, N, D), ("layers", "rnn", "embed")),
    }


def _ssm_specs(cfg: ModelConfig, u: int, p: str) -> Specs:
    D, Din, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    H, T = cfg.ssm_num_heads, cfg.conv_width
    return {
        f"{p}/norm": ParamSpec((u, D), ("layers", "embed"), init="zeros"),
        f"{p}/w_z": ParamSpec((u, D, Din), ("layers", "embed", "rnn")),
        f"{p}/w_x": ParamSpec((u, D, Din), ("layers", "embed", "rnn")),
        f"{p}/w_B": ParamSpec((u, D, N), ("layers", "embed", "state")),
        f"{p}/w_C": ParamSpec((u, D, N), ("layers", "embed", "state")),
        f"{p}/w_dt": ParamSpec((u, D, H), ("layers", "embed", None)),
        f"{p}/dt_bias": ParamSpec((u, H), ("layers", None), init="ssm_dt"),
        f"{p}/a_log": ParamSpec((u, H), ("layers", None), init="ones"),
        f"{p}/d_skip": ParamSpec((u, H), ("layers", None), init="ones"),
        f"{p}/conv_w": ParamSpec((u, T, Din), ("layers", None, "rnn")),
        f"{p}/gate_norm": ParamSpec((u, Din), ("layers", "rnn"), init="zeros"),
        f"{p}/w_out": ParamSpec((u, Din, D), ("layers", "rnn", "embed")),
    }


_KIND_SPECS = {
    "attn": lambda cfg, u, p: {**_attn_specs(cfg, u, f"{p}/attn"),
                               **_mlp_specs(cfg, u, f"{p}/mlp")},
    "moe": lambda cfg, u, p: {**_attn_specs(cfg, u, f"{p}/attn"),
                              **_moe_specs(cfg, u, f"{p}/moe")},
    "rglru": lambda cfg, u, p: {**_rglru_specs(cfg, u, f"{p}/rglru"),
                                **_mlp_specs(cfg, u, f"{p}/mlp")},
    "ssm": lambda cfg, u, p: _ssm_specs(cfg, u, p + "/ssm"),
    "xattn": lambda cfg, u, p: {**_attn_specs(cfg, u, f"{p}/attn"),
                                **_attn_specs(cfg, u, f"{p}/xattn"),
                                **_mlp_specs(cfg, u, f"{p}/mlp")},
}


def build_specs(cfg: ModelConfig) -> Specs:
    specs: Specs = {
        "embed/tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "embed"), fan_in_axis=1),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    if cfg.norm == "ln":
        specs["final_norm_bias"] = ParamSpec((cfg.d_model,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    for si, seg in enumerate(cfg.segments):
        for li, kind in enumerate(seg.pattern):
            specs.update(_KIND_SPECS[kind](cfg, seg.num_units, f"seg{si}/l{li}"))
    return specs


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` if ``cfg`` (decoder or encoder) has a
    block kind the port does not know."""
    for seg in (*cfg.segments, *cfg.encoder_segments):
        for kind in seg.pattern:
            if kind not in PORTED_KINDS:
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {kind!r} is not ported: unknown kind")


# ===========================================================================
# Blocks (per-unit application; params already sliced to this unit)
# ===========================================================================

def _norm(cfg: ModelConfig, x, p, prefix):
    """The block's norm, its output laid out for the block's products (on
    DTensors: batch on the data-parallel axes, the rest whole)."""
    if cfg.norm == "ln":
        h = layer_norm(x, p[f"{prefix}/norm"], p[f"{prefix}/norm_bias"])
    else:
        h = rms_norm(x, p[f"{prefix}/norm"])
    return constrain(h, *WHOLE_AXES)


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``, a block's output ``y`` added to the residual stream ``x``.
    On DTensors y is first laid out as x (a chunk of each rank's rows where
    x's sequence is split), so y's gradient comes back to its producer laid
    out as y was."""
    if is_dtensor(x) and is_dtensor(y) and x.placements != y.placements:
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def _pin(t: torch.Tensor, *logical_axes: Optional[str], heads: int = 0) -> torch.Tensor:
    """A DTensor laid out by ``constrain``'s rules, where a "model" dim is
    split only when ``heads`` (the number of heads it holds; 0: its size)
    divides the "model" axis: on each side of a reshape that splits or
    merges heads, so that neither the reshape nor its gradient meets a split
    that does not fall between heads.  Identity on a plain tensor."""
    mesh = dtensor_mesh(t)
    if mesh is None:
        return t
    if heads and heads % mesh_axes(mesh).get("model", 1):
        logical_axes = tuple(None if a == "model" else a for a in logical_axes)
    shape = [heads if a == "model" and heads else n for n, a in zip(t.shape, logical_axes)]
    return t.redistribute(mesh, act_placements(mesh, shape, *logical_axes))


def _attn_spec(cfg: ModelConfig, causal: bool = True) -> AttnSpec:
    return AttnSpec(causal=causal, window=cfg.window,
                    logit_cap=cfg.logit_cap, chunk=cfg.attn_chunk)


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): one (D, H*K) matmul.  On DTensors the
    product is laid out with its heads on "model" where they divide it,
    else whole, before it is split into heads (DTensor may have split the
    H*K columns anywhere)."""
    D, H, K = w.shape
    y = matmul(x, _pin(w.reshape(D, H * K), None, "model", heads=H))
    return _pin(y, "batch", *(None,) * (y.dim() - 2), "model", heads=H).unflatten(-1, (H, K))


def _qkv(cfg, p, prefix, x, positions, rope=True):
    q = _proj_heads(x, p[f"{prefix}/wq"])
    k = _proj_heads(x, p[f"{prefix}/wk"])
    v = _proj_heads(x, p[f"{prefix}/wv"])
    if cfg.bias:
        q = q + p[f"{prefix}/bq"]
        k = k + p[f"{prefix}/bk"]
        v = v + p[f"{prefix}/bv"]
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_frac)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_frac)
    return q, k, v


def _attn_out(cfg, p, prefix, o):
    """einsum("bshk,hkd->bsd"): one (H*K, D) matmul."""
    w = p[f"{prefix}/wo"]
    H, K, D = w.shape
    of = _pin(o.flatten(-2), "batch", *(None,) * (o.dim() - 3), "model", heads=H)
    y = matmul(of, _pin(w.reshape(H * K, D), "model", None, heads=H))
    if cfg.bias:
        y = y + p[f"{prefix}/bo"]
    return y


def _self_attn_block(cfg, p, prefix, x, positions, causal=True):
    """Norm, self-attention, residual.  Returns (y, (k, v))."""
    h = _norm(cfg, x, p, prefix)
    q, k, v = _qkv(cfg, p, prefix, h, positions)
    o = chunked_attention(q, k, v, _attn_spec(cfg, causal))
    return _residual(x, _attn_out(cfg, p, prefix, o)), (k, v)


def _cross_kv(cfg, p, prefix, enc_out):
    """The cross-attention's K and V from the encoder's output."""
    enc_out = constrain(enc_out, "batch", None, None)
    xk = _proj_heads(enc_out, p[f"{prefix}/wk"])
    xv = _proj_heads(enc_out, p[f"{prefix}/wv"])
    if cfg.bias:
        xk = xk + p[f"{prefix}/bk"]
        xv = xv + p[f"{prefix}/bv"]
    return xk, xv


def _cross_attn_block(cfg, p, prefix, x, xk, xv, step=False):
    """Norm, cross-attention over the encoder's K/V (no mask, no soft-cap),
    residual.  ``step``: x is one decode token and the attention is
    ``decode_attention`` over all ``xk.shape[1]`` frames instead of the
    flash attention."""
    h = _norm(cfg, x, p, prefix)
    q = _proj_heads(h, p[f"{prefix}/wq"])
    if cfg.bias:
        q = q + p[f"{prefix}/bq"]
    if step:
        o = decode_attention(q, xk, xv, xk.shape[1], AttnSpec(causal=False))
    else:
        o = chunked_attention(q, xk, xv, AttnSpec(causal=False, chunk=cfg.attn_chunk))
    return _residual(x, _attn_out(cfg, p, prefix, o))


def _mlp_block(cfg, p, prefix, x):
    h = _norm(cfg, x, p, prefix)
    if cfg.mlp_gated:
        y = gated_mlp(h, p[f"{prefix}/w_gate"], p[f"{prefix}/w_up"],
                      p[f"{prefix}/w_down"], cfg.act)
    else:
        y = mlp(h, p[f"{prefix}/w_up"], p[f"{prefix}/w_down"],
                p.get(f"{prefix}/b_up"), p.get(f"{prefix}/b_down"), cfg.act)
    return _residual(x, y)


def _moe_block(cfg, p, prefix, x):
    """Norm, MoE FFN, residual.  Returns (y, aux_loss)."""
    h = _norm(cfg, x, p, prefix)
    spec = MoESpec(num_experts=cfg.num_experts, top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor, act=cfg.act,
                   group_size=cfg.moe_group_size)
    y, aux = moe_ffn(h, p[f"{prefix}/router"], p[f"{prefix}/w_gate"],
                     p[f"{prefix}/w_up"], p[f"{prefix}/w_down"], spec)
    return _residual(x, y), aux


def _rglru_block(cfg, p, prefix, x, conv_state=None, h_state=None, step=False):
    """Griffin recurrent block.  Returns (y, (conv_state, h_state)).
    ``step``: x is one decode token and the recurrence takes its single-step
    update (``rglru_step``) instead of the scan."""
    h = _norm(cfg, x, p, prefix)
    xb = matmul(h, p[f"{prefix}/w_x"])
    gate = F.gelu(matmul(h, p[f"{prefix}/w_gate"]), approximate="tanh")
    xb, conv_state = short_conv1d(xb, p[f"{prefix}/conv_w"], conv_state)
    r = torch.sigmoid(matmul(xb, p[f"{prefix}/w_r"]))
    i = torch.sigmoid(matmul(xb, p[f"{prefix}/w_i"]))
    if step:
        y, h_last = rglru_step(xb[:, 0], r[:, 0], i[:, 0], p[f"{prefix}/a_param"],
                               h_state)
        y = y[:, None]
    else:
        y, h_last = rglru_scan(xb, r, i, p[f"{prefix}/a_param"], h_state)
    y = y * gate
    return _residual(x, matmul(y, p[f"{prefix}/w_out"])), (conv_state, h_last)


def _ssm_block(cfg, p, prefix, x, conv_state=None, h_state=None, step=False):
    """Mamba-2 block.  Returns (y, (conv_state, h_state)).  B and C are
    shared by the heads: they go to the chunked SSD as (B, S, N) (the kernel
    reads them through stride-0 head views, and their gradients are summed
    over the heads inside ``ssd_bwd``), to ``ssd_step`` as head views.
    ``step``: x is one decode token and the state takes its single-step
    update (``ssd_step``) instead of the chunked SSD."""
    B_, S, _ = x.shape
    Hs, P, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    h = _norm(cfg, x, p, prefix)
    z = matmul(h, p[f"{prefix}/w_z"])
    xi = matmul(h, p[f"{prefix}/w_x"])
    xi, conv_state = short_conv1d(xi, p[f"{prefix}/conv_w"], conv_state)
    xi = F.silu(xi)
    Bm = matmul(h, p[f"{prefix}/w_B"])
    Cm = matmul(h, p[f"{prefix}/w_C"])
    dt = F.softplus(matmul(h, p[f"{prefix}/w_dt"]) + p[f"{prefix}/dt_bias"])
    A = -F.softplus(p[f"{prefix}/a_log"].float())
    xh = _pin(xi, "batch", None, "model", heads=Hs).reshape(B_, S, Hs, P)
    if step:
        y, h_last = ssd_step(xh[:, 0], dt[:, 0], A, Bm[:, 0, None].expand(B_, Hs, N),
                             Cm[:, 0, None].expand(B_, Hs, N), p[f"{prefix}/d_skip"],
                             h_state)
        y = y[:, None]
    else:
        y, h_last = ssd_chunked(xh, dt, A, Bm, Cm, p[f"{prefix}/d_skip"],
                                chunk=cfg.ssm_chunk, h0=h_state)
    y = _pin(y.reshape(B_, S, -1), "batch", None, "model", heads=Hs)
    y = rms_norm(y, p[f"{prefix}/gate_norm"]) * F.silu(z)
    return _residual(x, matmul(y, p[f"{prefix}/w_out"])), (conv_state, h_last)


# ===========================================================================
# Full forward (training, the encoder): a loop over units per segment
# ===========================================================================

def _unit_forward(cfg: ModelConfig, seg: Segment, si: int, x, positions,
                  unit_params, enc_out=None, key_prefix: str = "seg",
                  causal: bool = True):
    """One pattern unit.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, kind in enumerate(seg.pattern):
        pref = f"{key_prefix}{si}/l{li}"
        if kind in ("attn", "moe", "xattn"):
            x, _ = _self_attn_block(cfg, unit_params, f"{pref}/attn", x, positions,
                                    causal=causal)
            if kind == "xattn":
                xk, xv = _cross_kv(cfg, unit_params, f"{pref}/xattn", enc_out)
                x = _cross_attn_block(cfg, unit_params, f"{pref}/xattn", x, xk, xv)
            if kind == "moe":
                x, a = _moe_block(cfg, unit_params, f"{pref}/moe", x)
                aux = aux + a
            else:
                x = _mlp_block(cfg, unit_params, f"{pref}/mlp", x)
        elif kind == "rglru":
            x, _ = _rglru_block(cfg, unit_params, f"{pref}/rglru", x)
            x = _mlp_block(cfg, unit_params, f"{pref}/mlp", x)
        elif kind == "ssm":
            x, _ = _ssm_block(cfg, unit_params, f"{pref}/ssm", x)
        else:
            raise ValueError(kind)
    return x, aux


def _units(sp: Params) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Each stacked (U, ...) leaf as its U unit slices (one ``unbind``: one
    gradient node a leaf, and on DTensors one sharding rule, where indexing
    unit by unit would make U)."""
    return {k: v.unbind(0) for k, v in sp.items()}


def _segment_params(params: Params, si: int, key_prefix: str = "seg") -> Params:
    pref = f"{key_prefix}{si}/"
    return {k: v for k, v in params.items() if k.startswith(pref)}


def backbone(cfg: ModelConfig, params: Params, x: torch.Tensor,
             positions: torch.Tensor, enc_out: Optional[torch.Tensor] = None,
             remat: bool = True, segments: Optional[Tuple[Segment, ...]] = None,
             key_prefix: str = "seg", causal: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply all segments (``cfg.segments`` unless ``segments`` is given,
    their weights under ``{key_prefix}{i}/``) to the embedded sequence x.
    Returns (hidden, total aux loss).  ``enc_out`` feeds the ``xattn``
    layers' cross-attention.  ``remat``: under grad mode each unit runs in
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only its input
    and recomputes it in the backward, as the reference's ``jax.checkpoint``
    with ``nothing_saveable`` does; it changes no value."""
    check_ported(cfg)
    from .encdec import build_encdec_specs

    segs = cfg.segments if segments is None else segments
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    all_specs = build_encdec_specs(cfg) if cfg.encoder_segments else build_specs(cfg)
    x = constrain(x, *UNIT_AXES)  # so that the first unit's kept input is split too
    for si, seg in enumerate(segs):
        sp = _segment_params(params, si, key_prefix)
        units = _units(sp)
        for u in range(seg.num_units):
            unit_params = {k: v[u] for k, v in units.items()}

            def unit(h, unit_params=unit_params, seg=seg, si=si):
                # The unit boundary: batch on the data-parallel axes, the
                # sequence split on "model" (UNIT_AXES); per-unit parameter
                # slices (and so their gradients) pinned to the parameter
                # sharding.
                h = constrain(h, *UNIT_AXES)
                unit_params = {k: gathered(constrain_param(v, all_specs[k].axes[1:])
                                           if k in all_specs else v)
                               for k, v in unit_params.items()}
                h, a = _unit_forward(cfg, seg, si, h, positions, unit_params,
                                     enc_out=enc_out, key_prefix=key_prefix, causal=causal)
                return constrain(h, *UNIT_AXES), a

            if remat:
                x, a = torch.utils.checkpoint.checkpoint(unit, x, use_reentrant=False)
            else:
                x, a = unit(x)
            total_aux = total_aux + a
    return x, total_aux


# ===========================================================================
# Embedding, unembedding, the loss, cache
# ===========================================================================

def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = _lookup(tokens, gathered(params["embed/tokens"]))
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def _lookup(tokens: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w[tokens]``.  On DTensors the lookup runs on the local shards: a
    shard of a vocab-split table looks up the tokens in its range, gives 0
    for the others, and the shards' rows are added (DTensor's own rule for
    this keeps a mask that not every version carries through) at once, an
    exact sum: a residual stream left pending (``Partial``) would take each
    block's output split over the shards and rounded in bf16 on every add,
    and be summed again at every norm."""
    mesh = dtensor_mesh(tokens, w)
    if mesh is None:
        return F.embedding(tokens.long(), w)
    pt = act_placements(mesh, tokens.shape, "batch", None)
    v0, split = shard_start(mesh, w.placements, 0, w.shape[0])

    def lookup(tok, w_local):
        idx = tok.long() - v0
        inside = (idx >= 0) & (idx < w_local.shape[0])
        rows = F.embedding(idx.clamp(0, w_local.shape[0] - 1), w_local)
        return torch.where(inside[..., None], rows, 0.0)

    out = tuple(Partial() if i in split else p for i, p in enumerate(pt))
    rows = local_region(lookup, (tokens, w), (pt, w.placements), out)
    return rows.redistribute(mesh, pt) if split else rows


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "ln":
        x = layer_norm(x, gathered(params["final_norm"]), gathered(params["final_norm_bias"]))
    else:
        x = rms_norm(x, gathered(params["final_norm"]))
    x = constrain(x, "batch", None, None)
    if cfg.tie_embeddings:
        return matmul(x, gathered(params["embed/tokens"]).T)
    return matmul(x, gathered(params["unembed"]))


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss.  batch: tokens (B, S) int, labels (B, S) int (-1 =
    masked), and for a vision config patches (B, P, D), precomputed stub
    embeddings prepended to the tokens' and stripped before the loss.  With
    experts, ``0.01 * aux`` (the load-balance loss) is added.  Returns
    (loss, {"xent", "tokens", "aux"})."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    if cfg.frontend == "vision":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = backbone(cfg, params, x, positions, remat=remat)
    if cfg.frontend == "vision":
        x = constrain(x, *WHOLE_AXES)[:, batch["patches"].shape[1]:]
    loss, metrics = xent_loss(cfg, params, x, batch["labels"])
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    metrics["aux"] = aux
    return loss, metrics


def xent_loss(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
              labels: torch.Tensor, block: int = 1024
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Blockwise next-token cross-entropy: the sequence in ``nb`` blocks
    (the reference's search: ``S // block``, lowered until it divides S),
    each block's f32 logits, log-sum-exp and label logit computed inside
    ``torch.utils.checkpoint`` under grad mode, so that the backward
    recomputes them block by block and never holds the whole (B, S, V)
    logits.  The row max is detached (``stop_gradient``); the label logit is
    a gather (the same value and gradient as the reference's one-hot
    contraction); labels of -1 are masked.  Where the hidden state's
    sequence is split (on DTensors, into ``n`` pieces on "model"), block
    ``i`` takes rows ``i * blk .. (i + 1) * blk`` of each piece
    (``_piece_rows``), so that what a block's checkpoint keeps is split as
    the pieces are and no block holds the whole hidden state (the search
    then runs on a piece's S / n rows); the block gathers its rows for its
    products.  The loss is a sum over rows, which only their order of
    summation changes.  Returns (mean loss over the unmasked labels,
    {"xent", "tokens"})."""
    hidden = constrain(hidden, *UNIT_AXES)
    labels = constrain(labels, *UNIT_AXES[:2])
    B, S, D = hidden.shape
    rows = S // _seq_pieces(hidden)
    nb = max(S // block, 1)
    while rows % nb:
        nb -= 1
    blk = rows // nb

    def block_loss(h, lab):
        h, lab = constrain(h, *WHOLE_AXES), constrain(lab, *WHOLE_AXES[:2])
        logits = constrain(unembed(cfg, params, h).float(), "batch", None, "model")
        mask = (lab >= 0).float()
        shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(shifted).sum(dim=-1))
        label_logit = _label_logit(shifted, lab)
        return -((label_logit - lse) * mask).sum(), mask.sum()

    remat = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nb):
        h, lab = _piece_rows(hidden, i, blk), _piece_rows(labels, i, blk)
        if remat:
            b_nll, b_cnt = torch.utils.checkpoint.checkpoint(block_loss, h, lab,
                                                             use_reentrant=False)
        else:
            b_nll, b_cnt = block_loss(h, lab)
        nll, cnt = nll + b_nll, cnt + b_cnt
    loss = nll / torch.clamp(cnt, min=1.0)
    return loss, {"xent": loss, "tokens": cnt}


def _seq_pieces(t: torch.Tensor) -> int:
    """The number of pieces dim 1 of ``t`` is split into: 1 for a plain
    tensor or a DTensor that keeps it whole."""
    mesh = dtensor_mesh(t)
    if mesh is None:
        return 1
    _, split = shard_start(mesh, t.placements, 1, t.shape[1])
    return mesh.shape[split[0]] if split else 1


def _piece_rows(t: torch.Tensor, i: int, blk: int) -> torch.Tensor:
    """Rows ``i * blk .. (i + 1) * blk`` of each piece of ``t``'s dim 1: of
    the whole dim where it is not split, else sliced on the local shards
    and laid out as ``t`` (a DTensor of ``blk`` rows a piece)."""
    if _seq_pieces(t) == 1:
        return t[:, i * blk:(i + 1) * blk]
    return local_region(lambda local: local[:, i * blk:(i + 1) * blk], (t,), (t.placements,),
                        t.placements)


def _label_logit(shifted: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``shifted[b, s, labels[b, s]]`` (labels of -1 read entry 0).  On
    DTensors the gather runs on the local shards: a shard of a
    vocab-sharded ("model") block reads the labels in its range, gives 0
    elsewhere, and the shards' values are added."""
    mesh = dtensor_mesh(shifted, labels)
    if mesh is None:
        return _gather_labels(shifted, labels, 0)
    ps = act_placements(mesh, shifted.shape, "batch", None, "model")
    pl = act_placements(mesh, labels.shape, "batch", None)
    v0, split = shard_start(mesh, ps, 2, shifted.shape[-1])
    out = tuple(Partial() if i in split else p for i, p in enumerate(pl))
    return local_region(lambda sh, lab: _gather_labels(sh, lab, v0), (shifted, labels),
                        (ps, pl), out)


def _gather_labels(shifted: torch.Tensor, labels: torch.Tensor, v0: int) -> torch.Tensor:
    """The label logits of vocab entries ``v0 .. v0 + shifted.shape[-1]``
    (0 for a label outside them)."""
    idx = labels.clamp(min=0).long() - v0
    inside = (idx >= 0) & (idx < shifted.shape[-1])
    got = shifted.gather(-1, idx.clamp(0, shifted.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(inside, got, 0.0)


def cache_shape_specs(cfg: ModelConfig, batch: int, cache_size: int,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every decode-cache leaf.  Attention KV caches are
    ring buffers of min(cache_size, window) slots when the arch is
    windowed."""
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    attn_S = min(cache_size, cfg.window) if cfg.window > 0 else cache_size
    for si, seg in enumerate(cfg.segments):
        U = seg.num_units
        for li, kind in enumerate(seg.pattern):
            pref = f"seg{si}/l{li}"
            if kind in ("attn", "moe", "xattn"):
                kv = (U, batch, attn_S, cfg.num_kv_heads, cfg.head_dim)
                out[f"{pref}/k"] = (kv, dtype)
                out[f"{pref}/v"] = (kv, dtype)
                if kind == "xattn":
                    xkv = (U, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
                    out[f"{pref}/xk"] = (xkv, dtype)
                    out[f"{pref}/xv"] = (xkv, dtype)
            elif kind == "rglru":
                N, T = cfg.lru_width, cfg.conv_width
                out[f"{pref}/conv"] = ((U, batch, T - 1, N), dtype)
                out[f"{pref}/h"] = ((U, batch, N), torch.float32)
            elif kind == "ssm":
                Din, T = cfg.ssm_d_inner, cfg.conv_width
                Hs, N, P = cfg.ssm_num_heads, cfg.ssm_state, cfg.ssm_head_dim
                out[f"{pref}/conv"] = ((U, batch, T - 1, Din), dtype)
                out[f"{pref}/h"] = ((U, batch, Hs, N, P), torch.float32)
    return out


def _write(dst: torch.Tensor, src: torch.Tensor, put) -> None:
    """``put(dst, src)``: write ``src`` into cache leaf (slice) ``dst`` in
    place.  On DTensors the write runs on each rank's local shards, ``src``
    laid out as ``dst`` first (an index write has no sharding rule in every
    DTensor version, and an in-place write must not change ``dst``'s
    placements)."""
    if not is_dtensor(dst):
        put(dst, src)
        return
    pl = dst.placements
    local_region(lambda d, t: (put(d, t), d)[1], (dst, src), (pl, pl), pl)


def init_cache(cfg: ModelConfig, batch: int, cache_size: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> Cache:
    """Zeroed cache leaves; inside a program's mesh (``active_mesh``),
    DTensors laid out by ``dist.sharding.cache_pspecs`` (batch on the
    data-parallel axes)."""
    specs = cache_shape_specs(cfg, batch, cache_size, dtype)
    mesh = active_mesh()
    if mesh is not None:
        from torch.distributed.tensor import zeros

        from ..dist.sharding import cache_pspecs

        return {k: zeros(shape, dtype=dt, device_mesh=mesh,
                         placements=to_placements(spec, mesh))
                for (k, (shape, dt)), spec in zip(specs.items(),
                                                   cache_pspecs(cfg, specs, mesh).values())}
    return {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in specs.items()}


# ===========================================================================
# Prefill
# ===========================================================================

def serving(fn):
    """Run ``fn`` under ``torch.inference_mode()``; inside a program's mesh
    under ``torch.no_grad()`` (a DTensor view of a parameter made outside
    inference mode cannot be taken in it).  The values are the same."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad() if active_mesh() is not None else torch.inference_mode():
            return fn(*args, **kwargs)
    return run


@serving
def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_size: int, patches: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache, int]:
    """Run the full prompt, build the decode cache.  Returns (last-position
    logits (B, V) f32, cache, cache_len).  Runs on the device of
    ``tokens`` (the parameters must be there too).  ``enc_out`` (B,
    encoder_seq, D), the encoder's output, is needed by ``xattn`` layers.

    With cfg.prefill_row_chunks > 1 the batch rows are processed in
    sequential chunks, bounding activation memory."""
    check_ported(cfg)
    if enc_out is None and any("xattn" in seg.pattern for seg in cfg.segments):
        raise ValueError(f"{cfg.name}: xattn layers need the encoder's output (enc_out=)")
    nchunks = max(cfg.prefill_row_chunks, 1)
    if nchunks > 1 and tokens.shape[0] % (nchunks * _batch_shards(tokens)) == 0:
        return _prefill_row_chunked(cfg, params, tokens, cache_size, patches, enc_out,
                                    nchunks)
    B = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens)
    if cfg.frontend == "vision" and patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    S_total = x.shape[1]
    positions = torch.arange(S_total, device=x.device)
    if cfg.abs_positions:
        x = x + sinusoidal_at(positions, cfg.d_model, x.dtype)
    # The cache dtype follows the embedding table, as in the reference.  Each
    # unit writes its slot of the zeroed cache in place; the RG-LRU and SSM
    # blocks start from the zero states they overwrite.
    cache = init_cache(cfg, B, cache_size, dtype=params["embed/tokens"].dtype,
                       device=x.device)

    for si, seg in enumerate(cfg.segments):
        sp = _segment_params(params, si)
        units = _units(sp)
        for u in range(seg.num_units):
            unit_params = {k: gathered(v[u]) for k, v in units.items()}
            for li, kind in enumerate(seg.pattern):
                pref = f"seg{si}/l{li}"
                if kind in ("attn", "moe", "xattn"):
                    x, (k, v) = _self_attn_block(cfg, unit_params, f"{pref}/attn", x,
                                                 positions)
                    kc, vc = cache[f"{pref}/k"][u], cache[f"{pref}/v"][u]
                    size = kc.shape[1]
                    ins = min(size, S_total)
                    # Ring buffer: slot t % size holds token t, so decode's
                    # write pointer (cache_len % size) evicts the oldest.
                    slots = torch.arange(S_total - ins, S_total, device=x.device) % size

                    def put(d, t, slots=slots):
                        d[:, slots] = t

                    _write(kc, k[:, -ins:].to(kc.dtype), put)
                    _write(vc, v[:, -ins:].to(vc.dtype), put)
                    if kind == "xattn":
                        xk, xv = _cross_kv(cfg, unit_params, f"{pref}/xattn", enc_out)
                        x = _cross_attn_block(cfg, unit_params, f"{pref}/xattn", x, xk, xv)
                        _write(cache[f"{pref}/xk"][u], xk, torch.Tensor.copy_)
                        _write(cache[f"{pref}/xv"][u], xv, torch.Tensor.copy_)
                    if kind == "moe":
                        x, _ = _moe_block(cfg, unit_params, f"{pref}/moe", x)
                    else:
                        x = _mlp_block(cfg, unit_params, f"{pref}/mlp", x)
                elif kind in ("rglru", "ssm"):
                    block = _rglru_block if kind == "rglru" else _ssm_block
                    conv, hst = cache[f"{pref}/conv"][u], cache[f"{pref}/h"][u]
                    x, (conv_new, h_new) = block(
                        cfg, unit_params, f"{pref}/{kind}", x, conv_state=conv,
                        h_state=hst)
                    _write(conv, conv_new, torch.Tensor.copy_)
                    _write(hst, h_new, torch.Tensor.copy_)
                    if kind == "rglru":
                        x = _mlp_block(cfg, unit_params, f"{pref}/mlp", x)

    logits = unembed(cfg, params, x[:, -1:]).float()[:, 0]
    return logits, cache, S_total


def _batch_shards(t: torch.Tensor) -> int:
    """How many shards a DTensor's batch dim (dim 0) is split into; 1 for a
    plain tensor."""
    if not is_dtensor(t):
        return 1
    n = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        n *= size if p.is_shard(0) else 1
    return n


def _rows(t: torch.Tensor, dim: int, dp: int, nchunks: int, c: int) -> torch.Tensor:
    """Chunk ``c`` of ``nchunks`` along batch dim ``dim``, taken from each of
    the ``dp`` batch shards in turn (rows c*b .. (c+1)*b of each shard's
    block, b = rows / (dp * nchunks)): (..., dp, b, ...)."""
    return t.unflatten(dim, (dp, nchunks, -1)).select(dim + 1, c)


def _prefill_row_chunked(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                         cache_size: int, patches, enc_out, nchunks: int):
    """Sequential batch-row chunks; each writes its rows (dim 1) of every
    cache leaf.  A batch split into ``dp`` shards is chunked inside each
    shard, so every chunk keeps the same split; with one shard, chunk c is
    rows c*b .. (c+1)*b."""
    B = tokens.shape[0]
    dp = _batch_shards(tokens)
    inner_cfg = dataclasses.replace(cfg, prefill_row_chunks=1)
    cache = init_cache(cfg, B, cache_size, dtype=params["embed/tokens"].dtype,
                       device=tokens.device)
    logits = []
    S_total = tokens.shape[1]
    for c in range(nchunks):
        def rows(t):
            return None if t is None else _rows(t, 0, dp, nchunks, c).flatten(0, 1)

        logits_c, cache_c, S_total = prefill(inner_cfg, params, rows(tokens), cache_size,
                                             rows(patches), rows(enc_out))
        for k in cache:
            _rows(cache[k], 1, dp, nchunks, c).copy_(
                cache_c[k].unflatten(1, (dp, -1)).to(cache[k].dtype))
        logits.append(logits_c.unflatten(0, (dp, -1)))
    return torch.stack(logits, 1).flatten(0, 2), cache, S_total


# ===========================================================================
# Decode
# ===========================================================================

@serving
def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                cache_len, tokens: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens: (B, 1); cache_len: int or 0-d tensor, the
    number of tokens already in the cache.  Returns (logits (B, 1, V) f32,
    cache).  The cache's tensors are updated IN PLACE and the same dict is
    returned: copy a leaf first where its old value is still needed.

    Attention caches are ring buffers of size min(cache, window): the new
    token's K/V go to slot ``cache_len % size`` with RoPE at the absolute
    position ``cache_len``, and the attention sees the
    ``min(cache_len + 1, size)`` live slots with no window mask (the ring
    is the window).  An ``xattn`` layer's cross-attention reads the cached
    ``xk``/``xv`` over all their frames (``enc_out`` is not read, as in the
    reference).  The RG-LRU and SSM blocks take their single-step updates;
    no kernel is launched."""
    check_ported(cfg)
    x = embed_tokens(cfg, params, tokens)
    clen = torch.as_tensor(cache_len, dtype=torch.int64, device=x.device).reshape(())
    positions = clen.reshape(1)
    if cfg.abs_positions:
        x = x + sinusoidal_at(positions, cfg.d_model, x.dtype)
    spec = AttnSpec(causal=True, window=0, logit_cap=cfg.logit_cap)

    for si, seg in enumerate(cfg.segments):
        sp = _segment_params(params, si)
        units = _units(sp)
        for u in range(seg.num_units):
            unit_params = {k: gathered(v[u]) for k, v in units.items()}
            for li, kind in enumerate(seg.pattern):
                pref = f"seg{si}/l{li}"
                if kind in ("attn", "moe", "xattn"):
                    hh = _norm(cfg, x, unit_params, f"{pref}/attn")
                    q, k, v = _qkv(cfg, unit_params, f"{pref}/attn", hh, positions)
                    kc, vc = cache[f"{pref}/k"][u], cache[f"{pref}/v"][u]
                    size = kc.shape[1]
                    slot = (clen % size).reshape(1)
                    def put(d, t, slot=slot):
                        d.index_copy_(1, slot, t)

                    _write(kc, k.to(kc.dtype), put)
                    _write(vc, v.to(vc.dtype), put)
                    valid = torch.clamp(clen + 1, max=size)
                    o = decode_attention(q, kc, vc, valid, spec)
                    x = x + _attn_out(cfg, unit_params, f"{pref}/attn", o)
                    if kind == "xattn":
                        x = _cross_attn_block(cfg, unit_params, f"{pref}/xattn", x,
                                              cache[f"{pref}/xk"][u],
                                              cache[f"{pref}/xv"][u], step=True)
                    if kind == "moe":
                        x, _ = _moe_block(cfg, unit_params, f"{pref}/moe", x)
                    else:
                        x = _mlp_block(cfg, unit_params, f"{pref}/mlp", x)
                elif kind in ("rglru", "ssm"):
                    block = _rglru_block if kind == "rglru" else _ssm_block
                    conv, hst = cache[f"{pref}/conv"][u], cache[f"{pref}/h"][u]
                    x, (conv_new, h_new) = block(
                        cfg, unit_params, f"{pref}/{kind}", x, conv_state=conv,
                        h_state=hst, step=True)
                    _write(conv, conv_new, torch.Tensor.copy_)
                    _write(hst, h_new, torch.Tensor.copy_)
                    if kind == "rglru":
                        x = _mlp_block(cfg, unit_params, f"{pref}/mlp", x)

    logits = unembed(cfg, params, x).float()
    return logits, cache


# ===========================================================================
# Module
# ===========================================================================

def _param_name(key: str) -> str:
    """A JAX key as an ``nn.Module`` parameter name ('/' -> '__'); the keys
    hold no '__', so the map is one to one."""
    return key.replace("/", "__")


class CausalLM(nn.Module):
    """The LM's parameters as an ``nn.Module``: every JAX key
    ``seg{i}/l{j}/<block>/<leaf>`` is the parameter ``seg{i}__l{j}__...``.
    ``prefill`` and ``decode_step`` are the entry points."""

    _specs = staticmethod(build_specs)  # the parameter table of a seeded init

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        if params is None:
            params = init_params(self._specs(cfg), seed, device)
        for k, v in params.items():
            self.register_parameter(_param_name(k), nn.Parameter(v, requires_grad=False))

    @classmethod
    def from_numpy(cls, cfg: ModelConfig, np_params, device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> "CausalLM":
        """The JAX package's parameters (numpy arrays by JAX key)."""
        return cls(cfg, params_from_numpy(np_params, device, dtype))

    def params(self) -> Params:
        """The parameters keyed by their JAX keys."""
        return {n.replace("__", "/"): p for n, p in self.named_parameters()}

    def _here(self, x) -> torch.Tensor:
        """``x`` as a tensor on this model's device."""
        x = x if torch.is_tensor(x) else torch.as_tensor(x)
        return x.to(next(self.parameters()).device)

    def prefill(self, tokens: torch.Tensor, cache_size: Optional[int] = None):
        """``prefill`` on this model's parameters; ``cache_size`` defaults to
        the prompt length."""
        tokens = self._here(tokens)
        return prefill(self.cfg, self.params(), tokens,
                       tokens.shape[1] if cache_size is None else cache_size)

    def decode_step(self, tokens: torch.Tensor, cache: Cache, cache_len):
        """``decode_step`` on this model's parameters: tokens (B, 1) after
        ``cache_len`` tokens; updates ``cache`` in place and returns
        (logits (B, 1, V) f32, cache)."""
        return decode_step(self.cfg, self.params(), cache, cache_len, self._here(tokens))

    forward = prefill
