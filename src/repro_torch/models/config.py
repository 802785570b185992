"""Unified model configuration covering the 10 assigned architectures (a copy
of the JAX package's ``models/config.py``; pure data).

A model is a stack of SEGMENTS; each segment is ``num_units`` repetitions of
a layer PATTERN (a tuple of layer kinds).  Uniform models have one segment
with pattern ("attn",); recurrentgemma has ("rglru", "rglru", "attn") x 12
plus a ("rglru", "rglru") tail.  Segments are scanned over units, which keeps
the lowered HLO (and compile time) independent of depth.

Layer kinds:
  attn   — self-attention mixer + dense MLP
  moe    — self-attention mixer + MoE FFN
  rglru  — RG-LRU recurrent mixer (+ short conv) + dense MLP
  ssm    — Mamba-2 SSD block (no separate MLP; d_ff == 0)
  xattn  — self-attention + cross-attention + MLP (whisper decoder)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple



@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[str, ...]
    num_units: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.num_units


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    # attention
    window: int = 0                 # sliding/local attention window (0 = full)
    logit_cap: float = 0.0
    rope_theta: float = 10_000.0
    rotary_frac: float = 1.0
    norm: str = "rms"               # rms | ln
    act: str = "silu"
    mlp_gated: bool = True
    bias: bool = False              # projection biases (whisper)
    tie_embeddings: bool = False
    abs_positions: bool = False     # sinusoidal absolute positions (whisper)
    # MoE
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_group_size: int = 2048
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 128
    # RG-LRU (recurrentgemma)
    lru_width: int = 0              # recurrent width N (== d_model for RG-9B)
    # encoder-decoder (whisper)
    encoder_segments: Tuple[Segment, ...] = ()
    encoder_seq: int = 0            # whisper: 1500 frames
    # modality frontend stub
    frontend: str = "none"          # none | audio | vision
    num_patches: int = 0            # vision prefix length (internvl2)
    # dry-run costing: unroll inner chunk scans so XLA cost_analysis (which
    # counts while bodies once) sees every chunk.  Never used in production.
    inner_unroll: bool = False
    # KV-chunk length of the online-softmax attention scan (the jnp flash
    # path materialises one (Sq x chunk) f32 block per step; the Pallas
    # kernel keeps it in VMEM).  Smaller chunk = smaller transient on the
    # XLA-lowered path.
    attn_chunk: int = 256
    # Memory/throughput knobs for the assigned production shapes:
    # gradient-accumulation microbatches (train) and sequential batch-row
    # chunks (prefill).  Set per-arch where a cell would exceed 16 GiB HBM.
    train_microbatches: int = 1
    prefill_row_chunks: int = 1
    # Cost-attribution variant (dry-run only): replace the attention chunk
    # scan with an identity of the same shape, keeping qkv/out projections.
    # The delta vs the real program isolates exactly the HBM traffic the
    # Pallas flash kernel eliminates (its tiles live in VMEM); see
    # EXPERIMENTS.md section Perf iteration K1.
    attn_skip: bool = False
    note: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.segments)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True if decode-time state is bounded (SSM / windowed attention):
        the archs eligible for the long_500k cell."""
        kinds = {k for s in self.segments for k in s.pattern}
        if kinds <= {"ssm"}:
            return True
        has_full_attn = any(
            k in ("attn", "moe", "xattn") for s in self.segments for k in s.pattern
        )
        return not has_full_attn or self.window > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration: same family/pattern, tiny dims."""
        def shrink_segments(segs):
            out = []
            for s in segs:
                out.append(Segment(pattern=s.pattern, num_units=1))
            return tuple(out)

        return dataclasses.replace(
            self,
            segments=shrink_segments(self.segments),
            encoder_segments=shrink_segments(self.encoder_segments),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2))
            if self.num_kv_heads < self.num_heads
            else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_d_ff=32 if self.expert_d_ff else 0,
            moe_group_size=64,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            lru_width=64 if self.lru_width else 0,
            window=min(self.window, 16) if self.window else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            num_patches=4 if self.num_patches else 0,
        )


def uniform(kind: str, n: int) -> Tuple[Segment, ...]:
    return (Segment(pattern=(kind,), num_units=n),)


def patterned(pattern: Tuple[str, ...], total_layers: int) -> Tuple[Segment, ...]:
    """Repeat ``pattern`` as many full times as fits; the remainder becomes a
    tail segment (recurrentgemma: 38 = 12 x (R,R,A) + (R,R))."""
    plen = len(pattern)
    full, rem = divmod(total_layers, plen)
    segs = []
    if full:
        segs.append(Segment(pattern=pattern, num_units=full))
    if rem:
        segs.append(Segment(pattern=pattern[:rem], num_units=1))
    return tuple(segs)
