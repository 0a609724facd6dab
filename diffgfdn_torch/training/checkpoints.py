"""Per-epoch checkpoints in the JAX package's format.

A checkpoint ``<train_dir>/checkpoints/model_e{epoch}.ckpt`` is a pickle of
the flax parameter tree as nested dicts of numpy arrays (epoch -1 is the
initialization). The port reads and writes that format unchanged, so
checkpoints cross between the two packages; ``utils/params.py`` maps the
tree onto the port's modules.
"""

import logging
import os
from pathlib import Path
import pickle
from typing import Any, Optional

logger = logging.getLogger("diffgfdn_torch")


def checkpoint_path(train_dir, epoch: int) -> Path:
    return Path(train_dir) / "checkpoints" / f"model_e{epoch}.ckpt"


def save_checkpoint(train_dir, epoch: int, params: Any) -> Path:
    """Save a numpy parameter tree for the given epoch (atomic tmp + rename)."""
    path = checkpoint_path(train_dir, epoch)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(params, f)
    os.replace(tmp, path)
    return path


def load_checkpoint(train_dir, epoch: int) -> Any:
    """Load the parameter tree of the given epoch."""
    with open(checkpoint_path(train_dir, epoch), "rb") as f:
        return pickle.load(f)


def load_latest_checkpoint(train_dir, max_epoch: int) -> Optional[Any]:
    """Walk epochs backwards (down to -1) until a checkpoint loads; None if none do."""
    for e in range(max_epoch, -2, -1):
        path = checkpoint_path(train_dir, e)
        if path.exists():
            try:
                return load_checkpoint(train_dir, e)
            except (pickle.UnpicklingError, EOFError) as exc:  # truncated/corrupt file
                logger.warning(
                    "checkpoint %s unreadable (%r): falling back to the previous epoch",
                    path, exc,
                )
    return None
