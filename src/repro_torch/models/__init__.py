"""Model configurations, parameter tables, the decoder-only LM (loss,
prefill, decode) and the encoder-decoder (whisper: loss, encode, prefill,
decode)."""
from .encdec import (
    EncDecLM,
    build_encdec_specs,
    encdec_decode_step,
    encdec_loss,
    encdec_prefill,
    encode,
    sinusoidal_positions,
)
from .lm import CausalLM, backbone, lm_loss, xent_loss

__all__ = ["CausalLM", "EncDecLM", "backbone", "build_encdec_specs", "encdec_decode_step",
           "encdec_loss", "encdec_prefill", "encode", "lm_loss", "sinusoidal_positions",
           "xent_loss"]
