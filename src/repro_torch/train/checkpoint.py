"""Checkpoints with an integrity manifest (the JAX package's
``train/checkpoint.py`` in PyTorch, with the same on-disk layout, so that a
checkpoint either package writes is read by the other).

Layout: <dir>/step_<N>/  (N zero-padded to 8 digits)
    manifest.json        — step, leaf paths, shapes, dtypes, checksums
                           (the first 16 hex digits of sha256 of the bytes)
    <escaped-path>.npy   — one file per leaf ('/' in the path as '__')

Restore verifies shapes, dtypes and checksums, so a half-written checkpoint
(a killed writer) is detected and ``latest_valid`` takes the previous step.
Writes go to a temporary directory and an atomic rename, so a crash in the
middle of a save never corrupts an older step.  Leaves are copied to the
host to be written; ``restore_checkpoint`` puts them on ``device``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _esc(path: str) -> str:
    return path.replace("/", "__")


def save_checkpoint(directory: str | os.PathLike, step: int,
                    state_tree: Dict[str, torch.Tensor],
                    extra: Optional[Dict] = None) -> pathlib.Path:
    """Write ``state_tree`` (path -> tensor) as ``<directory>/step_<step>``
    and return that path.  A bf16 leaf raises (numpy has no bf16)."""
    base = pathlib.Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix=".tmp_ckpt_"))
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    try:
        for key, t in state_tree.items():
            host = t.detach().cpu().numpy()
            np.save(tmp / f"{_esc(key)}.npy", host)
            manifest["leaves"][key] = {
                "shape": list(host.shape),
                "dtype": str(host.dtype),
                "sha256": hashlib.sha256(host.tobytes()).hexdigest()[:16],
            }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _validate(ckpt: pathlib.Path) -> bool:
    mf = ckpt / "manifest.json"
    if not mf.exists():
        return False
    manifest = json.loads(mf.read_text())
    for key, meta in manifest["leaves"].items():
        fn = ckpt / f"{_esc(key)}.npy"
        if not fn.exists():
            return False
        try:
            arr = np.load(fn)
        except Exception:  # truncated/garbled file from a dying writer
            return False
        if list(arr.shape) != meta["shape"] or str(arr.dtype) != meta["dtype"]:
            return False
        if hashlib.sha256(arr.tobytes()).hexdigest()[:16] != meta["sha256"]:
            return False
    return True


def latest_valid(directory: str | os.PathLike) -> Optional[pathlib.Path]:
    """The newest ``step_*`` under ``directory`` that validates, or None."""
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    for ckpt in sorted(base.glob("step_*"), reverse=True):
        if _validate(ckpt):
            return ckpt
    return None


def restore_checkpoint(ckpt: pathlib.Path, device: DeviceLike = None
                       ) -> Tuple[int, Dict[str, torch.Tensor], Dict]:
    """(step, path -> tensor on ``device`` (the card unless "cpu"), extra)."""
    dev = resolve_device(device)
    manifest = json.loads((ckpt / "manifest.json").read_text())
    tree: Dict[str, torch.Tensor] = {}
    for key in manifest["leaves"]:
        tree[key] = torch.from_numpy(np.load(ckpt / f"{_esc(key)}.npy")).to(dev)
    return manifest["step"], tree, manifest.get("extra", {})
