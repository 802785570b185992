"""Device selection for the port's entry points.

The port runs on the CUDA card.  The CPU is used only when the caller asks
for it by name (the CPU tests do); there is no quiet fallback, so a run that
was meant for the card never measures the host instead.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); ``"cpu"`` ->
    the CPU; ``"cuda"``/``"cuda:N"`` -> that card (raises without CUDA)."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the host")
    return dev
