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
* ``synth_<variant>``: ``configs/presets/synth/`` (grid fits of 8 lines in
  2 groups at 48 kHz on the synthetic datasets: scalar or SVF heads, the
  colorless loss or prototype; ``synth_subband_single_room`` one group with
  a RANDOM feedback matrix, ``synth_subband_hyp_tuning`` the MLP search);
* ``spatial_<directional|omni>_<f>Hz`` and ``spatial_directional_1000Hz_cnn``:
  ``configs/presets/spatial/`` (the 17 common-slopes presets).

:func:`fullband_grid`, :func:`subband_band`, :func:`directional_band`,
:func:`spatial_band`, :func:`single_rir_fit` and :func:`synth_grid` are the
JAX package's preset factories (its names and arguments: the dataset and
output paths), built on these mappings; :func:`preset_library` names the
production presets by them as the JAX package's ``preset_library`` does;
:func:`write_preset_library` writes them as YAML.
"""

import copy
import functools
from pathlib import Path
from typing import Callable, Dict, Optional, Union

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
}

SYNTH_DATA = "resources/synthetic_dataset/"


def _synth_grid_preset(name: str, trainer: dict, output: dict = None, colorless: dict = None,
                       absorption_filters: bool = False, room: str = "two_coupled_rooms",
                       **top) -> dict:
    """A preset of ``configs/presets/synth/``: a grid fit (``name`` its output
    directory's under ``synth_grid/``) on the synthetic dataset ``room``, a
    3 x 32 output MLP, no input heads, batch 10, with the given trainer,
    output-head, colorless-FDN and top-level updates."""
    return _synth_preset(
        f"synth_grid/{name}", None,
        {"batch_size": 10, "io_lr": 0.01, "train_valid_split": 0.9, "use_colorless_loss": False,
         **trainer},
        colorless or {}, {"num_neurons_per_layer": 32, **(output or {})},
        absorption_filters=absorption_filters, input_filter_config=None,
        room_dataset_path=f"{SYNTH_DATA}{room}/bb_wgn_0000.pkl", **top)


FREQ_DEP = "two_coupled_rooms_freq_dep"
MULTI_SOURCE = "two_coupled_rooms_multi_source"
SYNTH_96K = {"num_freq_bins": 96000}
SYNTH_PRESETS = {
    "synth_broadband": _synth_grid_preset(
        "broadband", {"batch_size": 100, "max_epochs": 20}, room="two_coupled_rooms_more_data"),
    "synth_broadband_colorless_loss": _synth_grid_preset(
        "broadband_colorless_loss",
        {"max_epochs": 20, "use_colorless_loss": True, "use_edc_mask": True}),
    "synth_broadband_colorless_proto": _synth_grid_preset(
        "broadband_colorless_proto", {"edr_loss_weight": 0.0, "max_epochs": 10},
        colorless=PROTO_15),
    "synth_low_rank_proto": _synth_grid_preset(
        "low_rank_proto", {"batch_size": 1, "max_epochs": 10, **SYNTH_96K}, colorless=PROTO_15,
        room=MULTI_SOURCE),
    "synth_subband": _synth_grid_preset(
        "subband", {"max_epochs": 20, **SYNTH_96K}, {"use_svfs": True}, absorption_filters=True,
        room=FREQ_DEP),
    "synth_subband_colorless_loss": _synth_grid_preset(
        "subband_colorless_loss", {"max_epochs": 10, "use_colorless_loss": True, **SYNTH_96K},
        {"num_hidden_layers": 5, "use_svfs": True}, absorption_filters=True, room=FREQ_DEP),
    "synth_subband_hyp_tuning": _synth_grid_preset(
        "subband_hyp_tuning", {"max_epochs": 20, **SYNTH_96K},
        {"use_svfs": True, "mlp_tuning_config": {
            "max_layers": 20, "max_neurons": 128, "min_layers": 1, "min_neurons": 16,
            "num_trials": 50, "sampler": "tpe", "step_size": 16, "trial_epochs": 2,
            "tune_hyperparameters": True}},
        absorption_filters=True, room=FREQ_DEP),
    "synth_subband_single_room": _synth_grid_preset(
        "subband_single_room", {"max_epochs": 10, **SYNTH_96K}, {"use_svfs": True},
        absorption_filters=True, room="single_room_freq_dep", num_groups=1,
        feedback_loop_config={"coupling_matrix_type": "random_matrix", "pu_matrix_order": 32,
                              "use_zero_coupling": True}),
}
# the multi-source fit names input heads like its output heads (7 x 128
# scalar MLPs); neither package's grid build reads them
SYNTH_PRESETS["synth_multi_source_colorless_loss"] = _synth_grid_preset(
    "multi_source_colorless_loss",
    {"batch_size": 100, "max_epochs": 10, "use_colorless_loss": True, "use_edc_mask": True,
     **SYNTH_96K},
    {"num_hidden_layers": 7, "num_neurons_per_layer": 128}, room=MULTI_SOURCE)
SYNTH_PRESETS["synth_multi_source_colorless_loss"]["input_filter_config"] = copy.deepcopy(
    SYNTH_PRESETS["synth_multi_source_colorless_loss"]["output_filter_config"])

PRESETS: Dict[str, dict] = {
    "fullband_grid_colorless": FULLBAND_GRID_COLORLESS,
    "three_room_example": THREE_ROOM_EXAMPLE,
    **{f"subband_{f}Hz": _subband_preset(f) for f in SUBBAND_MLP},
    **{f"directional_{f}Hz_res{r}m": _directional_preset(f, r) for f, r in DIRECTIONAL_RUNS},
    "single_rir_example": SINGLE_RIR_EXAMPLE,
    **SINGLE_RIR_PRESETS,
    **SYNTH_PRESETS,
}


def preset_config(name: str, **overrides) -> DiffGFDNConfig:
    """Validated config of a named preset; ``overrides`` replace top-level keys."""
    raw = copy.deepcopy(PRESETS[name])
    raw.update(overrides)
    return DiffGFDNConfig.from_dict(raw)


# the spatial_<kind>_<f>Hz presets of configs/presets/spatial/, one per octave band
_SPATIAL_OMNI = {  # band -> (layers, neurons, seed, epochs)
    63: (1, 8, 23526, 15), 125: (1, 16, 23644, 15), 250: (5, 16, 23759, 15),
    500: (10, 128, 24051, 15), 1000: (5, 16, 24521, 20), 2000: (3, 128, 25500, 15),
    4000: (3, 128, 27515, 15), 8000: (3, 128, 31474, 15),
}
_SPATIAL_DIR = {  # band -> (layers, epochs); 128 neurons, the schema's default seed
    63: (5, 20), 125: (5, 20), 250: (10, 20), 500: (12, 20), 1000: (12, 20),
    2000: (10, 15), 4000: (10, 20), 8000: (10, 20),
}
_TREBLE = "resources/Georg_3room_FDTD"


def _spatial_preset(freq: int, directional: bool) -> dict:
    """The common-slopes MLP preset of one octave band, as its YAML."""
    kind = "directional" if directional else "omni"
    if directional:
        (layers, epochs), neurons, seed, grid = _SPATIAL_DIR[freq], 128, 241924, 3
    else:
        (layers, neurons, seed, epochs), grid = _SPATIAL_OMNI[freq], 10
    stem = "srirs_spatial" if directional else "srirs"
    return {
        "batch_size": 50,
        "device": "tpu",
        "dnn_config": {
            "beamformer_type": "max_directivity",
            "cnn_config": None,
            "mlp_config": {"num_hidden_layers": layers, "num_neurons_per_layer": neurons},
            "num_fourier_features": 20,
        },
        "lr": 0.001,
        "max_epochs": epochs,
        "num_grid_spacing": grid,
        "room_dataset_path": f"{_TREBLE}/{stem}_band_centre={freq}Hz.pkl",
        "seed": seed,
        "train_dir": f"output/spatial_sampling/band_{freq}Hz_{kind}/",
        "use_directional_rirs": directional,
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
    "room_dataset_path": f"{_TREBLE}/srirs_spatial_band_centre=1000Hz.pkl",
    "seed": 24051,
    "train_dir": "output/spatial_sampling/band_1000Hz_directional_cnn/",
    "use_directional_rirs": True,
}

SPATIAL_PRESETS: Dict[str, dict] = {
    **{f"spatial_{kind}_{f}Hz": _spatial_preset(f, kind == "directional")
       for kind in ("directional", "omni") for f in _SPATIAL_OMNI},
    "spatial_directional_1000Hz_cnn": SPATIAL_DIRECTIONAL_1000HZ_CNN,
}


def spatial_preset_config(name: str, **overrides) -> SpatialSamplingConfig:
    """Validated config of a named spatial-sampling preset; ``overrides``
    replace top-level keys."""
    raw = copy.deepcopy(SPATIAL_PRESETS[name])
    raw.update(overrides)
    return SpatialSamplingConfig.from_dict(raw)


# the JAX package's preset factories: each preset with its dataset and output
# paths as arguments, returned as the port's config dataclasses
OCTAVE_BANDS = (63, 125, 250, 500, 1000, 2000, 4000, 8000)
_SYNTH = "resources/synthetic_dataset"


def _with_paths(raw: dict, dataset: str, out: str) -> dict:
    """``raw`` reading ``dataset``, writing its checkpoints under ``out`` and
    its audio under ``out/audio``."""
    raw = copy.deepcopy(raw)
    raw["room_dataset_path"] = dataset
    raw["trainer_config"].update(train_dir=f"{out}/", ir_dir=f"{out}/audio/")
    return raw


def fullband_grid(dataset: str = f"{_TREBLE}/srirs.pkl",
                  out: str = "output/fullband_grid") -> DiffGFDNConfig:
    """Full-band omni grid training with SVF heads and the colorless loss."""
    return DiffGFDNConfig.from_dict(_with_paths(FULLBAND_GRID_COLORLESS, dataset, out))


def subband_band(freq: float, dataset: str = f"{_TREBLE}/srirs_band_centre={{freq}}Hz.pkl",
                 out: str = "output/subband") -> DiffGFDNConfig:
    """One octave band of the 8-band subband training (the subband CLI's
    ``create_config`` at the presets' widths)."""
    from ..cli.run_subband_training import create_config

    return create_config(float(freq), dataset.replace("{freq}", f"{freq:.0f}"), out,
                         num_freq_bins=131072, sample_rate=32000.0, max_epochs=20, batch_size=32)


def directional_band(freq: float, grid_resolution_m: float = 0.6,
                     dataset: str = f"{_TREBLE}/srirs_spatial_band_centre={{freq}}Hz.pkl",
                     out: str = "output/directional_fdn") -> DiffGFDNConfig:
    """The directional (SH-domain) FDN of one octave band and grid resolution."""
    f, res = int(freq), grid_resolution_m
    return DiffGFDNConfig.from_dict(_with_paths(
        _directional_preset(f, res), dataset.replace("{freq}", str(f)),
        f"{out}/band_{f}Hz/grid_resolution={res:.1f}m"))


def spatial_band(freq: float, directional: bool = True, cnn: bool = False,
                 dataset: Optional[str] = None, out: str = "output/spatial_sampling"
                 ) -> SpatialSamplingConfig:
    """The common-slopes amplitude model of one octave band: an MLP, or the
    floor-plan CNN (directional only)."""
    f = int(freq)
    kind = "directional" if directional else "omni"
    if dataset is None:
        dataset = f"{_TREBLE}/{'srirs_spatial' if directional else 'srirs'}_band_centre={f}Hz.pkl"
    if cnn and not directional:
        raise ValueError("the common-slopes CNN presets are directional")
    raw = copy.deepcopy(SPATIAL_DIRECTIONAL_1000HZ_CNN) if cnn else _spatial_preset(f, directional)
    raw.update(room_dataset_path=dataset,
               train_dir=f"{out}/band_{f}Hz_{kind}{'_cnn' if cnn else ''}/")
    return SpatialSamplingConfig.from_dict(raw)


def _variant(presets: Dict[str, dict], family: str, variant: str, dataset_root: str, out: str
             ) -> DiffGFDNConfig:
    name = f"{family}_{variant}"
    if name not in presets:
        variants = sorted(k[len(family) + 1:] for k in presets)
        raise ValueError(f"unknown {family} variant {variant!r}; one of {variants}")
    room = Path(presets[name]["room_dataset_path"]).parent.name
    return DiffGFDNConfig.from_dict(_with_paths(
        presets[name], f"{dataset_root}/{room}/bb_wgn_0000.pkl", f"{out}/{variant}"))


# the variants in the JAX package's order (its library lists them so)
SINGLE_RIR_VARIANTS = (
    "two_stage_colorless_loss", "two_stage_colorless_proto", "two_stage_colorless_loss_pos2",
    "two_stage_colorless_proto_pos2", "single_room_colorless_loss",
    "single_room_colorless_proto", "freq_dep_colorless_loss",
)
SYNTH_GRID_VARIANTS = (
    "broadband", "broadband_colorless_loss", "broadband_colorless_proto",
    "multi_source_colorless_loss", "subband", "subband_colorless_loss", "subband_single_room",
    "subband_hyp_tuning", "low_rank_proto",
)


def single_rir_fit(variant: str = "two_stage_colorless_loss", dataset_root: str = _SYNTH,
                   out: str = "output/single_rir") -> DiffGFDNConfig:
    """A single-RIR fit preset: one of :data:`SINGLE_RIR_VARIANTS`."""
    return _variant(SINGLE_RIR_PRESETS, "single_rir", variant, dataset_root, out)


def synth_grid(variant: str = "broadband", dataset_root: str = _SYNTH,
               out: str = "output/synth_grid") -> DiffGFDNConfig:
    """A synthetic-data grid study: one of :data:`SYNTH_GRID_VARIANTS`."""
    return _variant(SYNTH_PRESETS, "synth", variant, dataset_root, out)


# the library: every preset of the JAX package's ``preset_library``, by name
_LIBRARY_FAMILIES = {"fullband": "fullband", "subband": "subband", "directional": "directional",
                     "spatial": "spatial", "single": "single_rir", "synth": "synth"}


def preset_library() -> Dict[str, Callable[[], Union[DiffGFDNConfig, SpatialSamplingConfig]]]:
    """name -> zero-argument factory of every production preset (the JAX
    package's names: the grid, subband, directional, single-RIR and synth
    presets of :data:`PRESETS` and the 17 common-slopes presets; not the
    two example configs), built by the factories above."""
    lib: Dict[str, Callable] = {"fullband_grid_colorless": fullband_grid}
    for f in OCTAVE_BANDS:
        lib[f"subband_{f}Hz"] = functools.partial(subband_band, float(f))
        for res in (0.6, 0.9):
            lib[f"directional_{f}Hz_res{res:.1f}m"] = functools.partial(
                directional_band, float(f), res)
        lib[f"spatial_omni_{f}Hz"] = functools.partial(spatial_band, float(f), False)
        lib[f"spatial_directional_{f}Hz"] = functools.partial(spatial_band, float(f), True)
    lib["spatial_directional_1000Hz_cnn"] = functools.partial(spatial_band, 1000.0, True, True)
    for v in SINGLE_RIR_VARIANTS:
        lib[f"single_rir_{v}"] = functools.partial(single_rir_fit, v)
    for v in SYNTH_GRID_VARIANTS:
        lib[f"synth_{v}"] = functools.partial(synth_grid, v)
    return lib


def write_preset_library(dest: Union[str, Path]) -> Dict[str, Path]:
    """Write every preset of :func:`preset_library` as YAML under ``dest``,
    one subdirectory a family (``fullband``, ``subband``, ``directional``,
    ``spatial``, ``single_rir``, ``synth``); each file loads back through
    :func:`load_and_validate_config` with its schema. Returns {name: path}."""
    from .loader import dump_config

    dest = Path(dest)
    paths: Dict[str, Path] = {}
    for name, factory in preset_library().items():
        path = dest / _LIBRARY_FAMILIES[name.split("_")[0]] / f"{name}.yml"
        path.parent.mkdir(parents=True, exist_ok=True)
        dump_config(factory(), path)
        paths[name] = path
    return paths
