"""Colorless-FDN losses (port of ``diffgfdn_tpu/losses/colorless.py``)."""

import numpy as np
import torch


def mse_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Mean squared error between |y_pred| and |y_true|."""
    return torch.mean((torch.abs(y_pred) - torch.abs(y_true)) ** 2)


def amse_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Asymmetric MSE: the power-4 penalty applies once the magnitude
    overshoot exceeds 1 (the reference's ``p_loss`` threshold)."""
    diff = torch.abs(y_pred) - torch.abs(y_true)
    exponent = 2.0 + 2.0 * (diff > 1.0).to(diff.dtype)
    return torch.mean(torch.pow(torch.abs(diff), exponent))


def sparsity_loss(a: torch.Tensor) -> torch.Tensor:
    """Rewards dense (Hadamard-like) orthogonal feedback matrices:
    -(sum|A| - N sqrt(N)) / (N (sqrt(N) - 1)), in [-1, 0] for orthogonal A."""
    n = a.shape[-1]
    return -(torch.sum(torch.abs(a)) - n * np.sqrt(n)) / (n * (np.sqrt(n) - 1.0))
