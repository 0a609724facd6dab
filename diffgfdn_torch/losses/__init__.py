"""Training losses: EDC and EDR against precomputed targets or raw spectra,
the directional EDC loss, colorless losses, the common-slopes
spatial-sampling losses."""

from .colorless import amse_loss, mse_loss, sparsity_loss
from .gfdn import (
    directional_edc_loss,
    directional_edc_loss_from_sh,
    edc_loss,
    edc_loss_from_rir,
    edc_mask,
    edr_loss,
    edr_loss_from_rir,
    frequency_weighting,
    reg_loss,
    scaled_shifted_sigmoid_inverse,
)
from .spatial import (
    find_position_idx,
    make_decay_envelopes,
    make_smoothness_kernel,
    spatial_edc_loss,
    spatial_mse_loss,
    spatial_smoothness_loss,
)

__all__ = [
    "amse_loss",
    "directional_edc_loss",
    "directional_edc_loss_from_sh",
    "edc_loss",
    "edc_loss_from_rir",
    "edc_mask",
    "edr_loss",
    "edr_loss_from_rir",
    "find_position_idx",
    "frequency_weighting",
    "make_decay_envelopes",
    "make_smoothness_kernel",
    "mse_loss",
    "reg_loss",
    "scaled_shifted_sigmoid_inverse",
    "sparsity_loss",
    "spatial_edc_loss",
    "spatial_mse_loss",
    "spatial_smoothness_loss",
]
