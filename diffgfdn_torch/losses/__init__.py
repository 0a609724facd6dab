"""Training losses: EDC and EDR against precomputed targets, the directional
EDC loss, colorless losses."""

from .colorless import amse_loss, mse_loss, sparsity_loss
from .gfdn import (
    directional_edc_loss,
    directional_edc_loss_from_sh,
    edc_loss_from_rir,
    edc_mask,
    edr_loss_from_rir,
)
from .spatial import make_decay_envelopes

__all__ = [
    "amse_loss",
    "directional_edc_loss",
    "directional_edc_loss_from_sh",
    "edc_loss_from_rir",
    "edc_mask",
    "edr_loss_from_rir",
    "make_decay_envelopes",
    "mse_loss",
    "sparsity_loss",
]
