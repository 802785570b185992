"""Encoder-decoder backbone (whisper-medium): the JAX package's
``models/encdec.py`` in PyTorch.

The conv/mel frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, encoder_seq, d_model).  Positions are
sinusoidal on both sides.  ``encode`` runs the encoder segments through
``lm.backbone`` (non-causal self-attention, the flash kernel on the card);
``encdec_prefill`` encodes and prefills the decoder, whose ``xattn`` layers
compute the cross-attention K/V once and cache them; ``encdec_decode_step``
is ``lm.decode_step``, which reads them from the cache.  ``encdec_loss`` is
the training loss: the encoder, then the decoder over the tokens with
cross-attention (Sq != Sk, not causal) through ``lm.backbone``, then
``lm.xent_loss``.

Params: ``"enc{si}/..."`` encoder segments, ``"seg{si}/..."`` decoder
segments, keyed as the reference keys them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .config import ModelConfig
from .lm import (
    Cache,
    CausalLM,
    _KIND_SPECS,
    backbone,
    decode_step,
    embed_tokens,
    prefill,
    serving,
    xent_loss,
)
from ..dist.context import gathered
from .params import ParamSpec, Params, Specs
from ..layers.common import layer_norm, rms_norm, sinusoidal_at


def sinusoidal_positions(S: int, D: int, dtype: torch.dtype = torch.float32,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """(S, D) sinusoidal position embeddings of positions 0..S-1."""
    return sinusoidal_at(torch.arange(S, device=device), D, dtype)


def build_encdec_specs(cfg: ModelConfig) -> Specs:
    specs: Specs = {
        "embed/tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "embed"), fan_in_axis=1),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "enc_final_norm": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    if cfg.norm == "ln":
        specs["final_norm_bias"] = ParamSpec((cfg.d_model,), ("embed",), init="zeros")
        specs["enc_final_norm_bias"] = ParamSpec((cfg.d_model,), ("embed",),
                                                 init="zeros")
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    for si, seg in enumerate(cfg.encoder_segments):
        for li, kind in enumerate(seg.pattern):
            specs.update(_KIND_SPECS[kind](cfg, seg.num_units, f"enc{si}/l{li}"))
    for si, seg in enumerate(cfg.segments):
        for li, kind in enumerate(seg.pattern):
            specs.update(_KIND_SPECS[kind](cfg, seg.num_units, f"seg{si}/l{li}"))
    return specs


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frontend embeddings (the stub).
    Returns the encoder's output (B, S_enc, D) in the frames' dtype.
    ``remat``: each encoder unit in a checkpoint under grad mode
    (``lm.backbone``)."""
    S = frames.shape[1]
    x = frames + sinusoidal_positions(S, cfg.d_model, frames.dtype, frames.device)
    positions = torch.arange(S, device=frames.device)
    x, _ = backbone(cfg, params, x, positions, remat=remat,
                    segments=cfg.encoder_segments, key_prefix="enc", causal=False)
    if cfg.norm == "ln":
        return layer_norm(x, gathered(params["enc_final_norm"]),
                          gathered(params["enc_final_norm_bias"]))
    return rms_norm(x, gathered(params["enc_final_norm"]))


def encdec_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
                remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: frames (B, S_enc, D), tokens (B, S), labels (B, S) (-1 =
    masked).  The decoder's tokens get sinusoidal positions, as the
    encoder's frames do.  The frames are cast to the weights' dtype, as
    ``lm_loss`` casts vision patches (the reference lets f32 frames promote
    the encoder to f32; the flash kernel takes bf16).  Returns (loss,
    {"xent", "tokens"})."""
    frames = batch["frames"].to(params["embed/tokens"].dtype)
    enc_out = encode(cfg, params, frames, remat=remat)
    x = embed_tokens(cfg, params, batch["tokens"])
    S = x.shape[1]
    x = x + sinusoidal_positions(S, cfg.d_model, x.dtype, x.device)
    positions = torch.arange(S, device=x.device)
    x, _ = backbone(cfg, params, x, positions, enc_out=enc_out, remat=remat)
    return xent_loss(cfg, params, x, batch["labels"])


@serving
def encdec_prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor, cache_size: int
                   ) -> Tuple[torch.Tensor, Cache, int, torch.Tensor]:
    """Encode, then prefill the decoder on the prompt (its cross-attention
    K/V computed and cached).  Returns (last-position logits (B, V) f32,
    cache, cache_len, enc_out)."""
    enc_out = encode(cfg, params, frames, remat=False)
    logits, cache, clen = prefill(cfg, params, tokens, cache_size, enc_out=enc_out)
    return logits, cache, clen, enc_out


def encdec_decode_step(cfg: ModelConfig, params: Params, cache: Cache, cache_len,
                       tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decoder step; the cross-attention K/V come from the cache, which
    is updated in place (``lm.decode_step``)."""
    return decode_step(cfg, params, cache, cache_len, tokens)


class EncDecLM(CausalLM):
    """The encoder-decoder's parameters as an ``nn.Module``, keyed as
    ``CausalLM`` keys them (``enc0/l0/attn/wq`` is ``enc0__l0__attn__wq``).
    ``encode``, ``prefill`` and ``decode_step`` are the entry points."""

    _specs = staticmethod(build_encdec_specs)

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 seed: int = 0, device=None):
        if not cfg.encoder_segments:
            raise ValueError(f"{cfg.name} has no encoder")
        super().__init__(cfg, params, seed=seed, device=device)

    def _frames(self, frames) -> torch.Tensor:
        """``frames`` on this model's device, in its parameters' dtype."""
        return self._here(frames).to(self.embed__tokens.dtype)

    @torch.inference_mode()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """``encode`` on this model's parameters (serving: inference mode)."""
        return encode(self.cfg, self.params(), self._frames(frames), remat=False)

    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor,
                cache_size: Optional[int] = None):
        """``encdec_prefill`` on this model's parameters; ``cache_size``
        defaults to the prompt length."""
        tokens = self._here(tokens)
        return encdec_prefill(self.cfg, self.params(), self._frames(frames), tokens,
                              tokens.shape[1] if cache_size is None else cache_size)

    forward = prefill
