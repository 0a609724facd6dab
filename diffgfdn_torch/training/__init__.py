"""Model construction, checkpoints, grid-of-receivers, directional and
common-slopes spatial-sampling training."""

from .build import absorption_arrays, build_gfdn_model
from .checkpoints import (
    load_checkpoint,
    load_latest_checkpoint,
    load_latest_checkpoint_with_epoch,
    load_opt_state,
    save_checkpoint,
    save_opt_state,
)
from .optim import make_optimizer, param_labels
from .save_results import gfdn_param_dict, save_diff_gfdn_parameters, save_loss
from .solver import run_training_anisotropic_decay_var_receiver_pos, run_training_var_receiver_pos
from .spatial_trainer import (
    build_spatial_model,
    collapse_amplitudes_to_omni,
    run_training_spatial_sampling,
    SpatialSamplingTrainer,
)
from .trainer import DirectionalGFDNTrainer, exact_valid_batches, GFDNTrainer, padded_batches

__all__ = [
    "DirectionalGFDNTrainer",
    "GFDNTrainer",
    "SpatialSamplingTrainer",
    "absorption_arrays",
    "build_gfdn_model",
    "build_spatial_model",
    "collapse_amplitudes_to_omni",
    "exact_valid_batches",
    "gfdn_param_dict",
    "load_checkpoint",
    "load_latest_checkpoint",
    "load_latest_checkpoint_with_epoch",
    "load_opt_state",
    "make_optimizer",
    "padded_batches",
    "param_labels",
    "run_training_anisotropic_decay_var_receiver_pos",
    "run_training_spatial_sampling",
    "run_training_var_receiver_pos",
    "save_checkpoint",
    "save_diff_gfdn_parameters",
    "save_loss",
    "save_opt_state",
]
