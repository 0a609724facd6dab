"""Training entry points (port of ``training/solver.py``).

:func:`run_training_var_receiver_pos` parses the dataset, builds the model,
draws the same test / train / valid splits as the JAX package for the seed,
trains through :class:`GFDNTrainer.fit_indexed` and exports the parameters,
loss curves and (optionally) RIR wavs. Every entry point runs on CUDA unless
the caller passes ``device="cpu"``.

:func:`run_training_anisotropic_decay_var_receiver_pos` trains a
directional FDN on a spatial dataset: the model built for the dataset's
directions, the grid-resolution split (or the seeded random one), the decay
envelopes of the common decay times, and :class:`DirectionalGFDNTrainer`.

:func:`run_training_single_pos` fits one RIR read from ``config.ir_path``
(the position parsed from its name): :class:`DiffGFDNSinglePos`, one
full-spectrum batch an epoch, :class:`SinglePosGFDNTrainer`.

With ``use_colorless_prototype`` each solver first trains one colorless
prototype FDN per group (:func:`run_training_colorless_fdn`, skipping groups
whose results are cached under ``<train_dir>/colorless-fdn``), or, with
``saved_param_path``, loads saved ones (grid and directional solvers, as in
JAX); the prototypes fix the io gains and start the feedback blocks.

A config with ``subband_process_config`` trains one octave band: the
trainer multiplies H by the band filter's response on the training grid
(:func:`subband_resp`), as the JAX solver does.

A grid config with ``mlp_tuning_config.tune_hyperparameters`` first
searches the output MLP's architecture (``training/hypertuning.py``), one
short training run a trial, then trains the winner.

A single-position fit under a process group of more than one rank shards
its rFFT bins over the ranks (``use_freq_parallel``, default auto:
:func:`_resolve_freq_mesh`; ``parallel/freq_parallel.py``); only rank 0
writes to the training directory.
"""

import copy
import gc
import logging
import os
from pathlib import Path
import re
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config.schema import DiffGFDNConfig
from ..data.audio import write_wav
from ..data.batching import (
    arrays_from_room_dataset,
    fixed_test_split,
    index_batches,
    train_valid_split,
)
from ..data.room_dataset import RIRData, RoomDataset, ThreeRoomDataset
from ..data.spatial_dataset import (
    arrays_from_spatial_dataset,
    SpatialRoomDataset,
    split_by_grid_resolution,
)
from ..losses.spatial import make_decay_envelopes
from ..ops.basic import ms_to_samps
from ..ops.filterbanks import subband_filter_response
from ..utils.device import resolve_device
from .build import (
    build_colorless_fdn,
    build_gfdn_model,
    colorless_result_path,
    ColorlessFDNResults,
    load_colorless_fdn_params,
    load_colorless_result,
)
from . import hypertuning
from .colorless_trainer import ColorlessFDNTrainer
from .save_results import save_colorless_fdn_parameters, save_diff_gfdn_parameters, save_loss
from .trainer import DirectionalGFDNTrainer, GFDNTrainer, SinglePosGFDNTrainer

logger = logging.getLogger("diffgfdn_torch")


def check_sample_rate(config: DiffGFDNConfig, dataset) -> None:
    """Fail fast on a config / dataset sample-rate mismatch (delay lengths,
    EDC windows and losses all derive from it)."""
    ds_fs = getattr(dataset, "sample_rate", None)
    if ds_fs is not None and float(ds_fs) != float(config.sample_rate):
        raise ValueError(
            f"config.sample_rate={config.sample_rate:g} Hz but the dataset is sampled at "
            f"{ds_fs:g} Hz: set sample_rate to match the dataset"
        )


def subband_resp(config: DiffGFDNConfig, num_freq_bins: Optional[int] = None
                 ) -> Optional[np.ndarray]:
    """The band filter's response (F,) complex on the training grid of a
    subband config, None for a fullband one. ``num_freq_bins`` (nfft)
    replaces the config's where the dataset sets the grid (a spatial
    dataset's nfft follows its decay times)."""
    sb = config.trainer_config.subband_process_config
    if sb is None:
        return None
    return subband_filter_response(
        sb.centre_frequency,
        sb.frequency_range,
        sb.num_fraction_octaves,
        config.sample_rate,
        num_freq_bins or config.trainer_config.num_freq_bins,
        use_amp_preserving=sb.use_amp_preserving_filterbank,
    )


def steps_per_epoch(num_train: int, batch_size: int) -> int:
    """fit_indexed's padded batch count: ceil(n / min(bs, n))."""
    n = max(1, num_train)
    return -(-n // min(batch_size, n))


def run_training_colorless_fdn(
    config: DiffGFDNConfig, num_freq_samples: int, device: Union[str, torch.device] = "cuda"
) -> List[ColorlessFDNResults]:
    """Train (or load cached) colorless prototypes, one per group, on
    ``num_freq_samples`` bins; each group's results are pickled under
    ``<train_dir>/colorless-fdn`` and a group whose pickle exists is not
    trained again."""
    dev = resolve_device(device)
    colorless_dir = Path(config.trainer_config.train_dir) / "colorless-fdn"
    results: List[ColorlessFDNResults] = []
    for g in range(config.num_groups):
        cached = colorless_result_path(colorless_dir, g)
        if cached.exists():
            results.append(load_colorless_result(cached))
            continue
        model = build_colorless_fdn(config, g, device=dev)
        trainer = ColorlessFDNTrainer(
            model, config.colorless_fdn_config, str(colorless_dir / f"group{g}"),
            use_asym_loss=config.trainer_config.use_asym_spectral_loss, device=dev,
        )
        trainer.fit(num_freq_samples, seed=config.seed + g)
        results.append(save_colorless_fdn_parameters(model, colorless_dir, g))
    return results


def colorless_prototypes(config: DiffGFDNConfig, num_freq_bins: int,
                         device: torch.device) -> Optional[List[ColorlessFDNResults]]:
    """The grid and directional solvers' warm start: None without
    ``use_colorless_prototype``, else the saved results at ``saved_param_path``
    or prototypes trained on nfft / 16 bins."""
    ccfg = config.colorless_fdn_config
    if not ccfg.use_colorless_prototype:
        return None
    if ccfg.load_fixed_parameters:
        return load_colorless_fdn_params(config, ccfg.saved_param_path)
    return run_training_colorless_fdn(config, num_freq_bins // 16, device)


def run_training_var_receiver_pos(
    config: DiffGFDNConfig,
    room_data: Optional[RoomDataset] = None,
    export_irs: bool = False,
    resume: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[GFDNTrainer, torch.nn.Module]:
    """Grid-of-receivers training (the flagship path); returns (trainer, model).

    ``resume=True`` continues an interrupted run from the newest checkpoint
    in the training directory (parameters and optimizer state).
    """
    dev = resolve_device(device)
    tc = config.trainer_config
    if room_data is None:
        room_data = ThreeRoomDataset(config.room_dataset_path, nfft=tc.num_freq_bins)
    check_sample_rate(config, room_data)
    colorless_params = colorless_prototypes(config, room_data.num_freq_bins, dev)
    tuning = config.output_filter_config.mlp_tuning_config
    if tuning is not None and tuning.tune_hyperparameters:
        config = _tuned_config(config, tuning, room_data, dev)
        tc = config.trainer_config

    model = build_gfdn_model(
        config, common_decay_times=room_data.common_decay_times,
        band_centre_hz=room_data.band_centre_hz, device=dev, colorless_params=colorless_params,
    )
    arrays = arrays_from_room_dataset(
        room_data,
        new_sampling_radius=None if tc.reduced_pole_radius == 1.0 else 1.0 / tc.reduced_pole_radius,
    )
    indices = np.arange(arrays.num_items)
    if tc.hold_out_test_set is not None:
        _, indices = fixed_test_split(
            arrays.num_items, tc.hold_out_test_set.ratio, tc.hold_out_test_set.seed
        )
    train_idx, valid_idx = train_valid_split(indices, tc.train_valid_split, seed=config.seed)

    trainer = GFDNTrainer(
        model, tc, steps_per_epoch=steps_per_epoch(len(train_idx), tc.batch_size),
        common_decay_times=room_data.common_decay_times,
        subband_filter_resp=subband_resp(config), sample_rate=config.sample_rate, device=dev,
    )
    t = time.time()
    trainer.precompute_target_features(arrays)
    logger.info("target features: %.1fs", time.time() - t)
    t = time.time()
    trainer.fit_indexed(arrays, train_idx, valid_idx, seed=config.seed, resume=resume)
    logger.info("fit_indexed total: %.1fs", time.time() - t)

    save_diff_gfdn_parameters(model, tc.train_dir)
    save_loss(trainer.train_loss, trainer.valid_loss, tc.train_dir)
    if export_irs:
        bs = min(tc.batch_size, max(1, len(train_idx)))
        trainer.save_irs(index_batches(train_idx, bs, shuffle=True, seed=config.seed), tc.ir_dir)
        trainer.save_irs(
            index_batches(valid_idx, min(tc.batch_size, max(1, len(valid_idx))), shuffle=False),
            tc.ir_dir, filename_prefix="valid_ir",
        )
        if tc.save_true_irs:
            _save_true_irs(room_data, indices, tc.ir_dir)
    return trainer, model


def _tuned_config(config: DiffGFDNConfig, tuning, room_data: RoomDataset,
                  device: torch.device) -> DiffGFDNConfig:
    """The MLP search of ``mlp_tuning_config``: each trial trains the
    candidate (``trial_epochs`` epochs at most, under ``<train_dir>/tuning``)
    and is scored by its last validation loss, or its last training loss
    without a validation split. Each trial's trainer and step graphs are
    dropped, and the card's cached blocks released, before the next trial,
    so that the trials' graph memory pools do not pile up. Returns the
    winner's config, its ``mlp_tuning_config`` set to None."""

    def trial(cand: DiffGFDNConfig) -> float:
        trial_cfg = copy.deepcopy(cand)
        trial_cfg.output_filter_config.mlp_tuning_config = None
        if tuning.trial_epochs is not None:
            trial_cfg.trainer_config.max_epochs = min(tuning.trial_epochs,
                                                      config.trainer_config.max_epochs)
        trial_cfg.trainer_config.train_dir = str(Path(config.trainer_config.train_dir) / "tuning")
        trainer, _ = run_training_var_receiver_pos(trial_cfg, room_data=room_data, device=device)
        objective = trainer.valid_loss[-1] if trainer.valid_loss else trainer.train_loss[-1]
        trainer.graphs.clear()
        del trainer
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return objective

    best, _ = hypertuning.mlp_hyperparameter_tuning(config, trial, num_trials=tuning.num_trials,
                                                    seed=config.seed)
    best.output_filter_config.mlp_tuning_config = None
    return best


def run_training_anisotropic_decay_var_receiver_pos(
    config: DiffGFDNConfig,
    room_data: SpatialRoomDataset,
    resume: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[DirectionalGFDNTrainer, torch.nn.Module]:
    """Directional FDN over a spatial receiver grid; returns (trainer, model).

    The dataset sets nfft (from its longest decay time) and the beamformer's
    directions. ``resume=True`` continues an interrupted run from the newest
    checkpoint in the training directory.
    """
    dev = resolve_device(device)
    check_sample_rate(config, room_data)
    tc = config.trainer_config
    model = build_gfdn_model(
        config, common_decay_times=room_data.common_decay_times,
        band_centre_hz=room_data.band_centre_hz, variant="directional", device=dev,
        desired_directions=room_data.desired_directions,
        colorless_params=colorless_prototypes(config, room_data.num_freq_bins, dev),
    )
    arrays = arrays_from_spatial_dataset(
        room_data,
        new_sampling_radius=None if tc.reduced_pole_radius == 1.0 else 1.0 / tc.reduced_pole_radius,
    )
    if tc.grid_resolution_m is not None:
        train_idx, valid_idx = split_by_grid_resolution(room_data, tc.grid_resolution_m)
    else:
        train_idx, valid_idx = train_valid_split(
            np.arange(arrays.num_items), tc.train_valid_split, seed=config.seed
        )
    cdt = np.asarray(room_data.common_decay_times)
    envelopes = make_decay_envelopes(
        cdt.reshape(-1)[: config.num_groups],
        ms_to_samps(float(np.max(cdt)) * 1e3, config.sample_rate),
        config.sample_rate,
    )
    trainer = DirectionalGFDNTrainer(
        model, tc, steps_per_epoch=steps_per_epoch(len(train_idx), tc.batch_size),
        common_decay_times=cdt,
        subband_filter_resp=subband_resp(config, room_data.num_freq_bins),
        sample_rate=config.sample_rate, device=dev, directional_envelopes=envelopes,
    )
    t = time.time()
    trainer.fit_indexed(arrays, train_idx, valid_idx, seed=config.seed, resume=resume)
    logger.info("fit_indexed total: %.1fs", time.time() - t)
    save_diff_gfdn_parameters(model, tc.train_dir)
    save_loss(trainer.train_loss, trainer.valid_loss, tc.train_dir)
    return trainer, model


def parse_position_from_filename(path) -> Optional[np.ndarray]:
    """The "(x, y, z)" receiver coordinates of an IR file name such as
    ``ir_(1.74, 4.50, 1.50).wav`` as float32 (3,), or None."""
    m = re.search(r"\(\s*(-?[\d.]+),\s*(-?[\d.]+),\s*(-?[\d.]+)\s*\)", str(path))
    if m is None:
        return None
    return np.array([float(g) for g in m.groups()], np.float32)


def single_pos_batch(config: DiffGFDNConfig, rir_data: RIRData) -> dict:
    """The full-spectrum batch of a single-position fit (numpy): z on the
    (reduced-radius) circle, the position parsed from ``ir_path`` (zeros
    when it names none), and the early, late and whole target spectra."""
    tc = config.trainer_config
    radius = 1.0 if tc.reduced_pole_radius == 1.0 else 1.0 / tc.reduced_pole_radius
    z = (radius * np.exp(1j * rir_data.freq_bins_rad)).astype(np.complex64)
    early, late = rir_data.split_responses()
    pos = None if config.ir_path is None else parse_position_from_filename(config.ir_path)
    pos = np.zeros(3, np.float32) if pos is None else pos
    return {
        "z_values": z,
        "listener_position": pos[None, :],
        "norm_listener_position": np.zeros((1, 3), np.float32),
        "target_early_response": early.astype(np.complex64),
        "target_late_response": late.astype(np.complex64),
        "target_rir_response": rir_data.rir_mag_response.astype(np.complex64),
    }


def _resolve_freq_mesh(config: DiffGFDNConfig, world: Optional[int] = None):
    """The mesh to shard a single-position fit's bins over, or None.

    ``use_freq_parallel``: None = auto (shard when more than one rank runs),
    True = require (warn and train unsharded when one rank runs), False =
    off. ``world``: the ranks of the initialized process group by default
    (one without a group); each rank is one device, as a device of JAX's
    mesh.
    """
    use = config.trainer_config.use_freq_parallel
    if use is False:
        return None
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if world <= 1:
        if use:
            logger.warning("use_freq_parallel=true but only one device is visible; "
                           "training unsharded")
        return None
    from ..parallel.mesh import make_mesh

    logger.info("single-pos fit: sharding the rFFT bin axis over %d devices", world)
    return make_mesh(1, world_size=world)


def run_training_single_pos(
    config: DiffGFDNConfig,
    rir_data: Optional[RIRData] = None,
    device: Union[str, torch.device] = "cuda",
    freq_mesh="auto",
) -> Tuple[SinglePosGFDNTrainer, torch.nn.Module]:
    """Single-RIR fit on whole-spectrum batches; returns (trainer, model).

    ``rir_data`` defaults to the wav at ``config.ir_path`` with a broadband
    0.5 s decay time per group (nfft from ``num_freq_bins``, else the next
    power of 2 of 0.5 s). Under an initialized process group of more than
    one rank the bins are sharded over the ranks (``use_freq_parallel``,
    default auto: :func:`_resolve_freq_mesh`); only rank 0 writes to
    ``train_dir`` (the colorless prototypes first, which the other ranks
    then read). ``freq_mesh``: a ``parallel/mesh.Mesh`` (or None) to use
    instead of that resolution, as JAX's ``devices`` argument chooses the
    devices.
    """
    dev = resolve_device(device)
    tc = config.trainer_config
    if rir_data is None:
        rir_data = RIRData.from_wav(
            config.ir_path, common_decay_times=np.array([0.5] * config.num_groups),
            nfft=tc.num_freq_bins,
        )
    check_sample_rate(config, rir_data)
    if isinstance(freq_mesh, str):
        freq_mesh = _resolve_freq_mesh(config)
    colorless_params = None
    if config.colorless_fdn_config.use_colorless_prototype:
        writer = freq_mesh is None or freq_mesh.index == 0
        if writer:
            colorless_params = run_training_colorless_fdn(config, rir_data.num_freq_bins // 16,
                                                          dev)
        if freq_mesh is not None and freq_mesh.distributed:
            dist.barrier()
        if not writer:  # rank 0's prototypes, read back
            colorless_params = run_training_colorless_fdn(config, rir_data.num_freq_bins // 16,
                                                          dev)
    model = build_gfdn_model(
        config, common_decay_times=rir_data.common_decay_times,
        band_centre_hz=rir_data.band_centre_hz, variant="single_pos", device=dev,
        colorless_params=colorless_params,
    )
    trainer = SinglePosGFDNTrainer(
        model, tc, steps_per_epoch=1, common_decay_times=rir_data.common_decay_times,
        subband_filter_resp=subband_resp(config), sample_rate=config.sample_rate, device=dev,
        freq_mesh=freq_mesh,
    )
    trainer.fit(single_pos_batch(config, rir_data), seed=config.seed)
    if trainer.writes:
        save_diff_gfdn_parameters(model, tc.train_dir)
        save_loss(trainer.train_loss, None, tc.train_dir)
    return trainer, model


def _save_true_irs(room_data: RoomDataset, rec_indices: np.ndarray, ir_dir) -> None:
    """Ground-truth RIR wavs beside the synthesized ones, peak-normalized."""
    os.makedirs(ir_dir, exist_ok=True)
    for i in np.asarray(rec_indices):
        pos = room_data.receiver_position[i]
        rir = np.asarray(room_data.rirs[i], np.float32)
        name = f"true_ir_({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}).wav"
        write_wav(os.path.join(ir_dir, name), rir / (np.max(np.abs(rir)) + 1e-12),
                  room_data.sample_rate)
