"""Grid-of-receivers training entry point (port of ``training/solver.py``).

:func:`run_training_var_receiver_pos` parses the dataset, builds the model,
draws the same test / train / valid splits as the JAX package for the seed,
trains through :class:`GFDNTrainer.fit_indexed` and exports the parameters,
loss curves and (optionally) RIR wavs. It runs on CUDA unless the caller
passes ``device="cpu"``.

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
from ..ops.filterbanks import subband_filter_response
from ..utils.device import resolve_device
from .build import build_gfdn_model
from .save_results import save_diff_gfdn_parameters, save_loss
from .trainer import GFDNTrainer

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


def subband_resp(config: DiffGFDNConfig) -> Optional[np.ndarray]:
    """The band filter's response (F,) complex on the training grid of a
    subband config, None for a fullband one."""
    sb = config.trainer_config.subband_process_config
    if sb is None:
        return None
    return subband_filter_response(
        sb.centre_frequency,
        sb.frequency_range,
        sb.num_fraction_octaves,
        config.sample_rate,
        config.trainer_config.num_freq_bins,
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


def _save_true_irs(room_data: RoomDataset, rec_indices: np.ndarray, ir_dir) -> None:
    """Ground-truth RIR wavs beside the synthesized ones, peak-normalized."""
    os.makedirs(ir_dir, exist_ok=True)
    for i in np.asarray(rec_indices):
        pos = room_data.receiver_position[i]
        rir = np.asarray(room_data.rirs[i], np.float32)
        name = f"true_ir_({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}).wav"
        write_wav(os.path.join(ir_dir, name), rir / (np.max(np.abs(rir)) + 1e-12),
                  room_data.sample_rate)
