"""Training state: mixed-precision AdamW (``optimizer``) and checkpoints
with an integrity manifest (``checkpoint``), the JAX package's
``repro.train`` in PyTorch."""
from .checkpoint import latest_valid, restore_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, TrainState, apply_updates, cast_params, init_state

__all__ = ["AdamWConfig", "TrainState", "apply_updates", "cast_params", "init_state",
           "latest_valid", "restore_checkpoint", "save_checkpoint"]
