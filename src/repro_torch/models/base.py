"""Architecture registry, the assigned shape cells and their input specs (the
JAX package's ``models/base.py``).

Every assigned architecture is a selectable config (``--arch <id>``); each
(arch x shape) cell is exercised by ``repro_torch.launch.dryrun`` through
``input_specs`` (meta tensors: the shape and dtype, no allocation).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

import torch

from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

ARCH_IDS: List[str] = [
    "recurrentgemma_9b",
    "yi_6b",
    "starcoder2_7b",
    "granite_8b",
    "chatglm3_6b",
    "olmoe_1b_7b",
    "mixtral_8x22b",
    "internvl2_76b",
    "whisper_medium",
    "mamba2_370m",
]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.config()


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None if the (arch x shape) cell runs; else the skip reason."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return (f"{cfg.name}: pure full-attention arch — long_500k needs "
                "sub-quadratic attention (see DESIGN.md)")
    return None


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Model inputs for one cell, as meta tensors (``device="meta"``: the
    shape and dtype, nothing allocated)."""
    B, S = cell.global_batch, cell.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.frontend == "vision":
        s_text = S - cfg.num_patches
        specs = {"tokens": spec((B, s_text), i32),
                 "patches": spec((B, cfg.num_patches, cfg.d_model), bf16)}
        if cell.kind == "train":
            specs["labels"] = spec((B, s_text), i32)
        return specs
    if cfg.frontend == "audio":
        specs = {"frames": spec((B, cfg.encoder_seq, cfg.d_model), bf16),
                 "tokens": spec((B, S), i32)}
        if cell.kind == "train":
            specs["labels"] = spec((B, S), i32)
        return specs
    specs = {"tokens": spec((B, S), i32)}
    if cell.kind == "train":
        specs["labels"] = spec((B, S), i32)
    return specs
