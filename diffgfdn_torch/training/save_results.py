"""Result export: learned parameters and loss curves to .mat, colorless
prototypes to pickles (port of ``training/save_results.py``).

Same file names and keys as the JAX package, so downstream MATLAB and
analysis workflows read either package's output.
"""

from pathlib import Path
import pickle
from typing import Dict, List, Optional

import numpy as np
from scipy.io import savemat
import torch

from .build import colorless_result_path, ColorlessFDNResults


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def gfdn_param_dict(model: torch.nn.Module) -> Dict:
    """Numpy dict of the learned GFDN parameters (the JAX ``gfdn_param_dict``
    keys): only learned io gains and io scalars are written (fixed ones are
    the colorless prototypes')."""
    fl = model.feedback_loop
    params = dict(model.named_parameters())
    out: Dict = {"delays": np.asarray(model.delays)}
    if fl.gains is not None:
        out["gains_per_sample"] = _np(fl.gains)
    for name in ("input_gains", "output_gains", "input_scalars", "output_scalars"):
        if name in params:
            out[name] = _np(params[name]).squeeze()
    if "feedback_loop.M" in params:
        out["individual_mixing_matrix"] = _np(fl.M)
    out["coupled_feedback_matrix"] = _np(fl.coupled_feedback_matrix())
    if "feedback_loop.alpha" in params:
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


@torch.no_grad()
def save_colorless_fdn_parameters(model: torch.nn.Module, directory,
                                  group_idx: int) -> ColorlessFDNResults:
    """Pickle a trained :class:`ColorlessFDN`'s io gains and orthogonal
    feedback matrix as ``parameters_opt_group={group_idx + 1}.pkl``; returns
    the results."""
    results = ColorlessFDNResults(
        opt_input_gains=_np(model.input_gains).squeeze(),
        opt_output_gains=_np(model.output_gains).squeeze(),
        opt_feedback_matrix=_np(model.feedback_matrix()),
    )
    Path(directory).mkdir(parents=True, exist_ok=True)
    with open(colorless_result_path(directory, group_idx), "wb") as f:
        pickle.dump(results, f)
    return results


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
