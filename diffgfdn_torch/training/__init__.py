"""Model construction, checkpoints, grid-of-receivers, single-position,
directional, colorless-prototype and common-slopes spatial-sampling training."""

from .build import (
    absorption_arrays,
    build_colorless_fdn,
    build_gfdn_model,
    colorless_to_init,
    ColorlessFDNResults,
    load_colorless_fdn_params,
    load_colorless_result,
    skew_preimage,
)
from .checkpoints import (
    load_checkpoint,
    load_latest_checkpoint,
    load_latest_checkpoint_with_epoch,
    load_opt_state,
    save_checkpoint,
    save_opt_state,
)
from .colorless_trainer import ColorlessFDNTrainer
from .optim import make_optimizer, param_labels
from .save_results import (
    gfdn_param_dict,
    save_colorless_fdn_parameters,
    save_diff_gfdn_parameters,
    save_loss,
)
from .solver import (
    parse_position_from_filename,
    run_training_anisotropic_decay_var_receiver_pos,
    run_training_colorless_fdn,
    run_training_single_pos,
    run_training_var_receiver_pos,
)
from .spatial_trainer import (
    build_spatial_model,
    collapse_amplitudes_to_omni,
    make_cnn_batch,
    run_training_spatial_sampling,
    run_training_spatial_sampling_cnn,
    SpatialSamplingTrainer,
)
from .trainer import (
    DirectionalGFDNTrainer,
    exact_valid_batches,
    GFDNTrainer,
    padded_batches,
    SinglePosGFDNTrainer,
)

__all__ = [
    "ColorlessFDNResults",
    "ColorlessFDNTrainer",
    "DirectionalGFDNTrainer",
    "GFDNTrainer",
    "SinglePosGFDNTrainer",
    "SpatialSamplingTrainer",
    "absorption_arrays",
    "build_colorless_fdn",
    "build_gfdn_model",
    "build_spatial_model",
    "collapse_amplitudes_to_omni",
    "colorless_to_init",
    "exact_valid_batches",
    "gfdn_param_dict",
    "load_checkpoint",
    "load_colorless_fdn_params",
    "load_colorless_result",
    "load_latest_checkpoint",
    "load_latest_checkpoint_with_epoch",
    "load_opt_state",
    "make_cnn_batch",
    "make_optimizer",
    "padded_batches",
    "param_labels",
    "parse_position_from_filename",
    "run_training_anisotropic_decay_var_receiver_pos",
    "run_training_colorless_fdn",
    "run_training_single_pos",
    "run_training_spatial_sampling",
    "run_training_spatial_sampling_cnn",
    "run_training_var_receiver_pos",
    "save_checkpoint",
    "save_colorless_fdn_parameters",
    "save_diff_gfdn_parameters",
    "save_loss",
    "save_opt_state",
    "skew_preimage",
]
