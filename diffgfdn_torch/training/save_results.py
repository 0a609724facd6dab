"""Result export: learned parameters and loss curves to .mat (port of ``training/save_results.py``).

Same file names and keys as the JAX package, so downstream MATLAB and
analysis workflows read either package's output.
"""

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.io import savemat
import torch


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def gfdn_param_dict(model: torch.nn.Module) -> Dict:
    """Numpy dict of the learned GFDN parameters (the JAX ``gfdn_param_dict`` keys)."""
    fl = model.feedback_loop
    out: Dict = {"delays": np.asarray(model.delays)}
    if fl.gains is not None:
        out["gains_per_sample"] = _np(fl.gains)
    out["input_gains"] = _np(model.input_gains).squeeze()
    out["output_gains"] = _np(model.output_gains).squeeze()
    out["individual_mixing_matrix"] = _np(fl.M)
    out["coupled_feedback_matrix"] = _np(fl.coupled_feedback_matrix())
    if isinstance(fl.alpha, torch.nn.Parameter):
        out["coupling_coefficient"] = _np(fl.alpha).squeeze()
    return out


def save_diff_gfdn_parameters(
    model: torch.nn.Module, directory, filename: str = "parameters_opt.mat"
) -> Dict:
    """Export learned parameters as a .mat file; returns the dict."""
    Path(directory).mkdir(parents=True, exist_ok=True)
    out = gfdn_param_dict(model)
    savemat(str(Path(directory) / filename), out)
    return out


def save_loss(
    train_loss: List[float],
    valid_loss: Optional[List[float]],
    directory,
    filename: str = "losses",
) -> None:
    """Save loss histories to ``<directory>/<filename>.mat``."""
    Path(directory).mkdir(parents=True, exist_ok=True)
    data = {"train_loss": np.asarray(train_loss)}
    if valid_loss is not None:
        data["valid_loss"] = np.asarray(valid_loss)
    savemat(str(Path(directory) / f"{filename}.mat"), data)
