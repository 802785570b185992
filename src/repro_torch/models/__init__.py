"""Model configurations, parameter tables, the decoder-only LM (prefill,
decode) and the encoder-decoder (whisper: encode, prefill, decode)."""
from .encdec import (
    EncDecLM,
    build_encdec_specs,
    encdec_decode_step,
    encdec_prefill,
    encode,
    sinusoidal_positions,
)
from .lm import CausalLM, backbone

__all__ = ["CausalLM", "EncDecLM", "backbone", "build_encdec_specs", "encdec_decode_step",
           "encdec_prefill", "encode", "sinusoidal_positions"]
