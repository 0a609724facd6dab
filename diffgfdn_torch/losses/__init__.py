"""Training losses: EDC and EDR against precomputed targets, colorless losses."""

from .colorless import amse_loss, mse_loss, sparsity_loss
from .gfdn import edc_loss_from_rir, edc_mask, edr_loss_from_rir

__all__ = [
    "amse_loss",
    "edc_loss_from_rir",
    "edc_mask",
    "edr_loss_from_rir",
    "mse_loss",
    "sparsity_loss",
]
