"""Grid-of-receivers training entry points (port of ``training/solver.py``).

:func:`run_training_var_receiver_pos` parses the dataset, builds the model,
draws the same test / train / valid splits as the JAX package for the seed,
trains through :class:`GFDNTrainer.fit_indexed` and exports the parameters,
loss curves and (optionally) RIR wavs. It runs on CUDA unless the caller
passes ``device="cpu"``.

:func:`run_training_anisotropic_decay_var_receiver_pos` trains a
directional FDN on a spatial dataset: the model built for the dataset's
directions, the grid-resolution split (or the seeded random one), the decay
envelopes of the common decay times, and :class:`DirectionalGFDNTrainer`.

A config with ``subband_process_config`` trains one octave band: the
trainer multiplies H by the band filter's response on the training grid
(:func:`subband_resp`), as the JAX solver does.

Not ported yet, each raising NotImplementedError: the colorless prototype
(ROADMAP A10) and the MLP hyper-parameter search (ROADMAP A10).
"""

import logging
import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config.schema import DiffGFDNConfig
from ..data.audio import write_wav
from ..data.batching import (
    arrays_from_room_dataset,
    fixed_test_split,
    index_batches,
    train_valid_split,
)
from ..data.room_dataset import RoomDataset, ThreeRoomDataset
from ..data.spatial_dataset import (
    arrays_from_spatial_dataset,
    SpatialRoomDataset,
    split_by_grid_resolution,
)
from ..losses.spatial import make_decay_envelopes
from ..ops.basic import ms_to_samps
from ..ops.filterbanks import subband_filter_response
from ..utils.device import resolve_device
from .build import build_gfdn_model
from .save_results import save_diff_gfdn_parameters, save_loss
from .trainer import DirectionalGFDNTrainer, GFDNTrainer

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


def _check_ported(config: DiffGFDNConfig) -> None:
    tuning = config.output_filter_config.mlp_tuning_config
    if tuning is not None and tuning.tune_hyperparameters:
        raise NotImplementedError(
            "the MLP hyper-parameter search (mlp_tuning_config) is not ported yet (ROADMAP A10)"
        )
    if config.colorless_fdn_config.use_colorless_prototype:
        raise NotImplementedError(
            "use_colorless_prototype (colorless warm start) is not ported yet (ROADMAP A10)"
        )


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
    _check_ported(config)
    tc = config.trainer_config
    if room_data is None:
        room_data = ThreeRoomDataset(config.room_dataset_path, nfft=tc.num_freq_bins)
    check_sample_rate(config, room_data)

    model = build_gfdn_model(
        config, common_decay_times=room_data.common_decay_times,
        band_centre_hz=room_data.band_centre_hz, device=dev,
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
    _check_ported(config)
    check_sample_rate(config, room_data)
    tc = config.trainer_config
    model = build_gfdn_model(
        config, common_decay_times=room_data.common_decay_times,
        band_centre_hz=room_data.band_centre_hz, variant="directional", device=dev,
        desired_directions=room_data.desired_directions,
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


def _save_true_irs(room_data: RoomDataset, rec_indices: np.ndarray, ir_dir) -> None:
    """Ground-truth RIR wavs beside the synthesized ones, peak-normalized."""
    os.makedirs(ir_dir, exist_ok=True)
    for i in np.asarray(rec_indices):
        pos = room_data.receiver_position[i]
        rir = np.asarray(room_data.rirs[i], np.float32)
        name = f"true_ir_({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}).wav"
        write_wav(os.path.join(ir_dir, name), rir / (np.max(np.abs(rir)) + 1e-12),
                  room_data.sample_rate)
