"""Per-epoch checkpoints in the JAX package's format, and optimizer-state sidecars.

A checkpoint ``<train_dir>/checkpoints/model_e{epoch}.ckpt`` is a pickle of
the flax parameter tree as nested dicts of numpy arrays (epoch -1 is the
initialization). The port reads and writes that format unchanged, so
checkpoints cross between the two packages; ``utils/params.py`` maps the
tree onto the port's modules.

The optimizer state (Adam moments and the step-decay position) is the
port's own sidecar, ``opt_e{epoch}.pt`` (``torch.save`` of the optimizer's
and the scheduler's ``state_dict``), beside the checkpoint of the same
epoch; resuming loads both.
"""

import logging
import os
from pathlib import Path
import pickle
from typing import Any, Optional, Tuple

import torch

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


def load_latest_checkpoint_with_epoch(train_dir, max_epoch: int) -> Optional[Tuple[Any, int]]:
    """(tree, epoch) of the newest checkpoint that loads, walking epochs
    backwards down to -1; None if none do."""
    for e in range(max_epoch, -2, -1):
        path = checkpoint_path(train_dir, e)
        if path.exists():
            try:
                return load_checkpoint(train_dir, e), e
            except (pickle.UnpicklingError, EOFError) as exc:  # truncated/corrupt file
                logger.warning(
                    "checkpoint %s unreadable (%r): falling back to the previous epoch",
                    path, exc,
                )
    return None


def load_latest_checkpoint(train_dir, max_epoch: int) -> Optional[Any]:
    """The newest checkpoint's parameter tree (see above); None if none loads."""
    found = load_latest_checkpoint_with_epoch(train_dir, max_epoch)
    return None if found is None else found[0]


def opt_state_path(train_dir, epoch: int) -> Path:
    return Path(train_dir) / "checkpoints" / f"opt_e{epoch}.pt"


def save_opt_state(train_dir, epoch: int, state: dict) -> Path:
    """Save an optimizer-state sidecar (atomic tmp + rename)."""
    path = opt_state_path(train_dir, epoch)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_opt_state(train_dir, epoch: int, device=None) -> Optional[dict]:
    """The optimizer-state sidecar of the given epoch, or None if there is none."""
    path = opt_state_path(train_dir, epoch)
    if not path.exists():
        return None
    return torch.load(path, map_location=device, weights_only=True)
