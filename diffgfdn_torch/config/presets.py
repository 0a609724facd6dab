"""The ported configurations as Python mappings.

Each mapping is exactly what ``yaml.safe_load`` returns for its file, so
``chip_smoke.py`` needs no YAML parser on the card:

* ``fullband_grid_colorless``: ``configs/presets/fullband/fullband_grid_colorless.yml``
  (SVF output heads, GEQ-fitted SOS absorption, 10 x 64 MLP, 20 Fourier
  features, nfft 131072, batch 32);
* ``three_room_example``: ``configs/three_room_example.yml`` (scalar heads
  and scalar absorption, 3 x 128 MLP, 10 Fourier features);
* ``subband_<f>Hz``: ``configs/presets/subband/subband_<f>Hz.yml``;
* ``directional_<f>Hz_res<r>m``: ``configs/presets/directional/`` (ambi
  order 2, 27 lines in 3 groups, a skip-connection MLP, the
  max-directivity beamformer, the band's response in the loss);
* ``single_rir_example``: ``configs/single_rir_example.yml`` (a single-RIR
  fit: 12 lines in 3 groups, SVF output heads, nfft 131072, fs 32 kHz);
* ``single_rir_<variant>``: ``configs/presets/single_rir/`` (8 lines in 2
  groups, or 1 for the single room; SVF input heads; the colorless loss or
  the colorless prototype; fs 48 kHz, nfft from the data);
* ``synth_broadband_colorless_proto``:
  ``configs/presets/synth/synth_broadband_colorless_proto.yml`` (a grid fit
  warm-started from colorless prototypes).
"""

import copy
from typing import Dict

from .schema import DiffGFDNConfig, SpatialSamplingConfig

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

# the per-band MLP (hidden layers, neurons) of the subband presets
SUBBAND_MLP = {63: (3, 64), 125: (3, 64), 250: (3, 128), 500: (3, 128), 1000: (3, 128),
               2000: (3, 128), 4000: (4, 128), 8000: (4, 128)}


def _subband_preset(freq: int) -> dict:
    """``configs/presets/subband/subband_<freq>Hz.yml``."""
    raw = copy.deepcopy(FULLBAND_GRID_COLORLESS)
    layers, neurons = SUBBAND_MLP[freq]
    raw["output_filter_config"].update(
        num_fourier_features=10, num_hidden_layers=layers, num_neurons_per_layer=neurons,
        use_svfs=False,
    )
    raw["room_dataset_path"] = f"resources/Georg_3room_FDTD/srirs_band_centre={freq}Hz.pkl"
    raw["seed"] = 235 + freq
    raw["trainer_config"].update(
        coupling_angle_lr=0.001, hold_out_test_set=None, io_lr=0.001,
        ir_dir=f"output/subband/band_{freq}Hz/audio/", lr=0.001, max_epochs=20,
        save_true_irs=False,
        subband_process_config={
            "centre_frequency": float(freq),
            "frequency_range": [63.0, 16000.0],
            "num_fraction_octaves": 1,
            "use_amp_preserving_filterbank": True,
        },
        train_dir=f"output/subband/band_{freq}Hz/", use_asym_spectral_loss=False,
        use_edc_mask=False,
    )
    return raw


# what differs between the directional presets: per (band, grid resolution)
# the seed and max_epochs, per band the MLP's hidden layers and Fourier features
DIRECTIONAL_RUNS = {
    (63, 0.6): (123637, 15), (63, 0.9): (123637, 15),
    (125, 0.6): (12335, 15), (125, 0.9): (12335, 15),
    (250, 0.6): (23644, 15), (250, 0.9): (23644, 15),
    (500, 0.6): (27359, 15), (500, 0.9): (27360, 20),
    (1000, 0.6): (23649, 15), (1000, 0.9): (23680, 20),
    (2000, 0.6): (25647, 15), (2000, 0.9): (25647, 20),
    (4000, 0.6): (23649, 15), (4000, 0.9): (23645, 15),
    (8000, 0.6): (26854, 15), (8000, 0.9): (26854, 15),
}
DIRECTIONAL_MLP = {63: (5, 20), 125: (5, 20), 250: (5, 20), 500: (10, 20), 1000: (10, 20),
                   2000: (10, 20), 4000: (10, 20), 8000: (10, 10)}


def _directional_preset(freq: int, res: float) -> dict:
    """``configs/presets/directional/directional_<freq>Hz_res<res>m.yml``."""
    raw = copy.deepcopy(FULLBAND_GRID_COLORLESS)
    seed, epochs = DIRECTIONAL_RUNS[(freq, res)]
    layers, fourier = DIRECTIONAL_MLP[freq]
    out = f"output/directional_fdn/band_{freq}Hz/grid_resolution={res}m/"
    raw.update(ambi_order=2, num_delay_lines=27, seed=seed,
               room_dataset_path=f"resources/Georg_3room_FDTD/srirs_spatial_band_centre={freq}Hz.pkl")
    raw["decay_filter_config"]["use_absorption_filters"] = False
    raw["output_filter_config"].update(
        beamformer_type="max_directivity", num_fourier_features=fourier,
        num_hidden_layers=layers, num_neurons_per_layer=128, use_skip_connections=True,
        use_svfs=False,
    )
    raw["trainer_config"].update(
        coupling_angle_lr=0.01, edc_loss_weight=10.0, grid_resolution_m=res,
        hold_out_test_set=None, io_lr=0.001, ir_dir=out + "audio/", lr=0.01,
        max_epochs=epochs, save_true_irs=True, sparsity_loss_weight=2.0,
        subband_process_config={
            "centre_frequency": float(freq),
            "frequency_range": [63.0, 8000.0],
            "num_fraction_octaves": 1,
            "use_amp_preserving_filterbank": True,
        },
        train_dir=out, train_valid_split=None, use_asym_spectral_loss=True, use_edc_mask=True,
    )
    return raw


SINGLE_RIR_EXAMPLE = {
    "seed": 42,
    "ir_path": "resources/single_rir.wav",
    "num_groups": 3,
    "sample_rate": 32000.0,
    "num_delay_lines": 12,
    "delay_range_ms": [20.0, 45.0],
    "trainer_config": {
        "batch_size": 1,
        "num_freq_bins": 131072,
        "max_epochs": 50,
        "lr": 1.0e-2,
        "train_dir": "output/single_rir",
        "ir_dir": "output/single_rir/audio",
    },
    "output_filter_config": {
        "use_svfs": True,
        "num_hidden_layers": 1,
        "num_neurons_per_layer": 16,
        "num_fourier_features": 4,
    },
    "decay_filter_config": {"use_absorption_filters": False},
    "colorless_fdn_config": {"use_colorless_prototype": False},
}

TWO_ROOMS = "audio/synthetic_true/two_coupled_rooms/"
SINGLE_ROOM = "audio/synthetic_true/single_room/"


def _synth_preset(name: str, ir_path, trainer: dict, colorless: dict, output: dict = None,
                  absorption_filters: bool = False, **top) -> dict:
    """A preset of ``configs/presets/single_rir/`` (``name`` its output
    directory's) or ``synth/``: the two-room colorless-loss fit's settings
    with the given ir_path, trainer, colorless-FDN and output-head updates
    and top-level keys."""
    raw = copy.deepcopy(FULLBAND_GRID_COLORLESS)
    out = f"output/{name}/"
    raw.update(ir_path=ir_path, num_delay_lines=8, num_groups=2, sample_rate=48000.0,
               seed=46434,
               room_dataset_path="resources/synthetic_dataset/two_coupled_rooms/bb_wgn_0000.pkl")
    raw["decay_filter_config"]["use_absorption_filters"] = absorption_filters
    raw["output_filter_config"].update(num_fourier_features=10, num_hidden_layers=3,
                                       num_neurons_per_layer=128, use_svfs=False)
    raw["output_filter_config"].update(output or {})
    raw["trainer_config"].update(
        hold_out_test_set=None, io_lr=0.1, ir_dir=out + "audio/", max_epochs=50,
        num_freq_bins=None, save_true_irs=False, train_dir=out,
        use_asym_spectral_loss=False, use_edc_mask=False)
    raw["trainer_config"].update(trainer)
    raw["colorless_fdn_config"].update(colorless)
    raw.update(top)
    return raw


PROTO = {"use_colorless_prototype": True}
PROTO_15 = {"use_colorless_prototype": True, "batch_size": 4000, "max_epochs": 15}
SINGLE_ROOM_DATA = "resources/synthetic_dataset/single_room/bb_wgn_0000.pkl"
SINGLE_RIR_PRESETS = {
    "single_rir_two_stage_colorless_loss": _synth_preset(
        "single_rir/two_stage_colorless_loss", TWO_ROOMS + "ir_(6.90, 2.70, 0.68).wav", {}, {}),
    "single_rir_two_stage_colorless_loss_pos2": _synth_preset(
        "single_rir/two_stage_colorless_loss_pos2", TWO_ROOMS + "ir_(1.21, 2.92, 0.83).wav",
        {"use_edc_mask": True}, {}),
    "single_rir_two_stage_colorless_proto": _synth_preset(
        "single_rir/two_stage_colorless_proto", TWO_ROOMS + "ir_(6.90, 2.70, 0.68).wav",
        {"use_colorless_loss": False}, dict(PROTO, max_epochs=5)),
    "single_rir_two_stage_colorless_proto_pos2": _synth_preset(
        "single_rir/two_stage_colorless_proto_pos2", TWO_ROOMS + "ir_(1.21, 2.92, 0.83).wav",
        {"use_colorless_loss": False, "use_edc_mask": True}, PROTO_15),
    "single_rir_single_room_colorless_loss": _synth_preset(
        "single_rir/single_room_colorless_loss", SINGLE_ROOM + "ir_(2.11, 6.06, 0.81).wav", {},
        {}, num_groups=1, room_dataset_path=SINGLE_ROOM_DATA),
    "single_rir_single_room_colorless_proto": _synth_preset(
        "single_rir/single_room_colorless_proto", SINGLE_ROOM + "ir_(2.11, 6.06, 0.81).wav",
        {"use_colorless_loss": False}, PROTO_15, num_groups=1,
        room_dataset_path=SINGLE_ROOM_DATA),
    "single_rir_freq_dep_colorless_loss": _synth_preset(
        "single_rir/freq_dep_colorless_loss",
        "audio/synthetic_true/two_coupled_rooms_freq_dep/ir_(2.41, 5.54, 1.10).wav",
        {"max_epochs": 20, "num_freq_bins": 96000}, {}, {"use_svfs": True},
        absorption_filters=True, room_dataset_path="resources/synthetic_dataset/two_coupled_rooms_freq_dep/"
        "bb_wgn_0000.pkl"),
    "synth_broadband_colorless_proto": _synth_preset(
        "synth_grid/broadband_colorless_proto", None,
        {"batch_size": 10, "edr_loss_weight": 0.0, "io_lr": 0.01, "max_epochs": 10,
         "train_valid_split": 0.9, "use_colorless_loss": False}, PROTO_15,
        {"num_neurons_per_layer": 32}, input_filter_config=None),
}

PRESETS: Dict[str, dict] = {
    "fullband_grid_colorless": FULLBAND_GRID_COLORLESS,
    "three_room_example": THREE_ROOM_EXAMPLE,
    **{f"subband_{f}Hz": _subband_preset(f) for f in SUBBAND_MLP},
    **{f"directional_{f}Hz_res{r}m": _directional_preset(f, r) for f, r in DIRECTIONAL_RUNS},
    "single_rir_example": SINGLE_RIR_EXAMPLE,
    **SINGLE_RIR_PRESETS,
}


def preset_config(name: str, **overrides) -> DiffGFDNConfig:
    """Validated config of a named preset; ``overrides`` replace top-level keys."""
    raw = copy.deepcopy(PRESETS[name])
    raw.update(overrides)
    return DiffGFDNConfig.from_dict(raw)


SPATIAL_DIRECTIONAL_1000HZ = {
    "batch_size": 50,
    "device": "tpu",
    "dnn_config": {
        "beamformer_type": "max_directivity",
        "cnn_config": None,
        "mlp_config": {"num_hidden_layers": 12, "num_neurons_per_layer": 128},
        "num_fourier_features": 20,
    },
    "lr": 0.001,
    "max_epochs": 20,
    "num_grid_spacing": 3,
    "room_dataset_path": "resources/Georg_3room_FDTD/srirs_spatial_band_centre=1000Hz.pkl",
    "seed": 241924,
    "train_dir": "output/spatial_sampling/band_1000Hz_directional/",
    "use_directional_rirs": True,
}

SPATIAL_OMNI_1000HZ = {
    "batch_size": 50,
    "device": "tpu",
    "dnn_config": {
        "beamformer_type": "max_directivity",
        "cnn_config": None,
        "mlp_config": {"num_hidden_layers": 5, "num_neurons_per_layer": 16},
        "num_fourier_features": 20,
    },
    "lr": 0.001,
    "max_epochs": 20,
    "num_grid_spacing": 10,
    "room_dataset_path": "resources/Georg_3room_FDTD/srirs_band_centre=1000Hz.pkl",
    "seed": 24521,
    "train_dir": "output/spatial_sampling/band_1000Hz_omni/",
    "use_directional_rirs": False,
}

SPATIAL_DIRECTIONAL_1000HZ_CNN = {
    "batch_size": 25,
    "device": "tpu",
    "dnn_config": {
        "beamformer_type": "max_directivity",
        "cnn_config": {"kernel_size": [3, 3], "num_hidden_channels": 32, "num_layers": 4},
        "mlp_config": None,
        "num_fourier_features": 10,
    },
    "lr": 0.001,
    "max_epochs": 15,
    "num_grid_spacing": 3,
    "room_dataset_path": "resources/Georg_3room_FDTD/srirs_spatial_band_centre=1000Hz.pkl",
    "seed": 24051,
    "train_dir": "output/spatial_sampling/band_1000Hz_directional_cnn/",
    "use_directional_rirs": True,
}

SPATIAL_PRESETS: Dict[str, dict] = {
    "spatial_directional_1000Hz": SPATIAL_DIRECTIONAL_1000HZ,
    "spatial_directional_1000Hz_cnn": SPATIAL_DIRECTIONAL_1000HZ_CNN,
    "spatial_omni_1000Hz": SPATIAL_OMNI_1000HZ,
}


def spatial_preset_config(name: str, **overrides) -> SpatialSamplingConfig:
    """Validated config of a named spatial-sampling preset; ``overrides``
    replace top-level keys."""
    raw = copy.deepcopy(SPATIAL_PRESETS[name])
    raw.update(overrides)
    return SpatialSamplingConfig.from_dict(raw)
