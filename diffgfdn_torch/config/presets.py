"""The serving slice's two configurations as Python mappings.

Each mapping is exactly what ``yaml.safe_load`` returns for its file, so
``chip_smoke.py`` needs no YAML parser on the card:

* ``fullband_grid_colorless``: ``configs/presets/fullband/fullband_grid_colorless.yml``
  (SVF output heads, GEQ-fitted SOS absorption, 10 x 64 MLP, 20 Fourier
  features, nfft 131072, batch 32);
* ``three_room_example``: ``configs/three_room_example.yml`` (scalar heads
  and scalar absorption, 3 x 128 MLP, 10 Fourier features).
"""

import copy
from typing import Dict

from .schema import DiffGFDNConfig

FULLBAND_GRID_COLORLESS = {
    "ambi_order": None,
    "colorless_fdn_config": {
        "alpha": 1.0,
        "batch_size": 2000,
        "lr": 0.01,
        "max_epochs": 20,
        "saved_param_path": None,
        "train_valid_split": 0.8,
        "use_colorless_prototype": False,
    },
    "decay_filter_config": {
        "initialise_with_opt_values": True,
        "learn_common_decay_times": False,
        "use_absorption_filters": True,
    },
    "delay_range_ms": [20.0, 50.0],
    "feedback_loop_config": {
        "coupling_matrix_type": "scalar_matrix",
        "pu_matrix_order": 32,
        "use_zero_coupling": True,
    },
    "input_filter_config": {
        "beamformer_type": None,
        "compress_pole_factor": 1.0,
        "encoding_type": "sinusoidal",
        "mlp_tuning_config": None,
        "num_fourier_features": 10,
        "num_hidden_layers": 3,
        "num_neurons_per_layer": 128,
        "use_skip_connections": False,
        "use_svfs": True,
    },
    "ir_path": None,
    "num_delay_lines": 12,
    "num_groups": 3,
    "output_filter_config": {
        "beamformer_type": None,
        "compress_pole_factor": 1.0,
        "encoding_type": "sinusoidal",
        "mlp_tuning_config": None,
        "num_fourier_features": 20,
        "num_hidden_layers": 10,
        "num_neurons_per_layer": 64,
        "use_skip_connections": False,
        "use_svfs": True,
    },
    "room_dataset_path": "resources/Georg_3room_FDTD/srirs.pkl",
    "sample_rate": 32000.0,
    "seed": 235265,
    "trainer_config": {
        "alias_attenuation_db": None,
        "batch_size": 32,
        "coupling_angle_lr": 0.01,
        "device": "tpu",
        "edc_loss_weight": 1.0,
        "edr_loss_weight": 1.0,
        "grid_resolution_m": None,
        "hold_out_test_set": {"ratio": 0.1, "seed": 4314},
        "io_lr": 0.01,
        "ir_dir": "output/fullband_grid/audio/",
        "lr": 0.01,
        "max_epochs": 15,
        "num_freq_bins": 131072,
        "output_filt_ir_len_ms": 500.0,
        "reduced_pole_radius": 1.0,
        "save_true_irs": True,
        "sparsity_loss_weight": 1.0,
        "spectral_loss_weight": 1.0,
        "subband_process_config": None,
        "train_dir": "output/fullband_grid/",
        "train_valid_split": 0.8,
        "use_asym_spectral_loss": True,
        "use_colorless_loss": True,
        "use_edc_mask": True,
        "use_erb_edr_loss": False,
        "use_freq_parallel": None,
        "use_frequency_weighting": False,
        "use_reg_loss": False,
    },
}

THREE_ROOM_EXAMPLE = {
    "seed": 1234,
    "room_dataset_path": "resources/three_room_srirs.pkl",
    "num_groups": 3,
    "sample_rate": 32000.0,
    "num_delay_lines": 12,
    "delay_range_ms": [20.0, 45.0],
    "trainer_config": {
        "batch_size": 32,
        "num_freq_bins": 131072,
        "max_epochs": 20,
        "lr": 1.0e-3,
        "io_lr": 1.0e-3,
        "coupling_angle_lr": 1.0e-3,
        "train_dir": "output/three_room",
        "ir_dir": "output/three_room/audio",
    },
    "output_filter_config": {
        "use_svfs": False,
        "num_hidden_layers": 3,
        "num_neurons_per_layer": 128,
        "num_fourier_features": 10,
    },
    "decay_filter_config": {
        "use_absorption_filters": False,
        "learn_common_decay_times": False,
    },
    "colorless_fdn_config": {"use_colorless_prototype": False},
}

PRESETS: Dict[str, dict] = {
    "fullband_grid_colorless": FULLBAND_GRID_COLORLESS,
    "three_room_example": THREE_ROOM_EXAMPLE,
}


def preset_config(name: str, **overrides) -> DiffGFDNConfig:
    """Validated config of a named preset; ``overrides`` replace top-level keys."""
    raw = copy.deepcopy(PRESETS[name])
    raw.update(overrides)
    return DiffGFDNConfig.from_dict(raw)
