"""Model construction and checkpoints (the trainers arrive with the training slice)."""

from .build import absorption_arrays, build_gfdn_model
from .checkpoints import load_checkpoint, load_latest_checkpoint, save_checkpoint

__all__ = [
    "absorption_arrays",
    "build_gfdn_model",
    "load_checkpoint",
    "load_latest_checkpoint",
    "save_checkpoint",
]
