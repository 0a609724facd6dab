"""Result export: learned parameters and loss curves to .mat, colorless
prototypes to pickles, the coupled feedback matrix's animation over the
epoch checkpoints (port of ``training/save_results.py``).

Same file names and keys as the JAX package, so downstream MATLAB and
analysis workflows read either package's output.
"""

import copy
from pathlib import Path
import pickle
from typing import Dict, List, Optional

import numpy as np
from scipy.io import savemat
import torch

from ..config.schema import CouplingMatrixType
from ..utils.params import load_jax_params
from .build import colorless_result_path, ColorlessFDNResults
from .checkpoints import checkpoint_path, load_checkpoint


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


@torch.no_grad()
def feedback_matrices(model: torch.nn.Module, train_dir, max_epochs: int):
    """([A] of every epoch checkpoint from -1 to ``max_epochs`` - 1 under
    ``train_dir``, [|coupling matrix|] of each with SCALAR coupling, else
    None), as host arrays; ``model`` (a GFDN) is left as it was."""
    probe = copy.deepcopy(model)
    fl = probe.feedback_loop
    mats, coups = [], []
    for epoch in range(-1, max_epochs):
        if not checkpoint_path(train_dir, epoch).exists():
            continue
        load_jax_params(probe, load_checkpoint(train_dir, epoch))
        mats.append(_np(fl.coupled_feedback_matrix()))
        if fl.coupling_matrix_type is CouplingMatrixType.SCALAR:
            coups.append(np.abs(_np(fl.coupling_matrix())))
    return mats, (coups or None)


def save_feedback_matrix_animation(
    model: torch.nn.Module, train_dir, max_epochs: int,
    save_name: str = "feedback_matrix.gif",
) -> Optional[str]:
    """Animate the coupled feedback matrix across the epoch checkpoints (the
    z^0 tap with FILTER coupling), beside the room-coupling matrix with
    SCALAR coupling, as ``<train_dir>/<save_name>``. Returns the written
    path, or None when fewer than two checkpoints exist."""
    from ..utils.plot import animate_coupled_feedback_matrix

    mats, coups = feedback_matrices(model, train_dir, max_epochs)
    if len(mats) < 2:
        return None
    if mats[0].ndim == 3:  # FILTER coupling: the order-0 tap
        mats = [m[0] for m in mats]
    path = str(Path(train_dir) / save_name)
    animate_coupled_feedback_matrix(mats, coups, save_path=path)
    return path
