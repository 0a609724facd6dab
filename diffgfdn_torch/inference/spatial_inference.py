"""Serving common-slopes models: trained CS-MLP checkpoints -> SRIRs (port of
``diffgfdn_tpu/inference/spatial_inference.py``).

Per-band checkpoints give CS amplitudes at the query positions; shaped noise
synthesizes the tails on the device (``cs_synthesis.py``); a directional set
converts to ambisonics. The floor-plan CNN predicts its whole grid once and
each query takes its nearest cell. The entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

import copy
import pickle
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..config.schema import DNNType, SpatialSamplingConfig
from ..data.spatial_dataset import SpatialRoomDataset
from ..training.checkpoints import load_latest_checkpoint
from ..training.spatial_trainer import (
    build_spatial_model,
    make_cnn_batch,
    SpatialSamplingTrainer,
)
from ..utils.device import resolve_device
from ..utils.params import load_jax_params
from .cs_synthesis import get_rirs_from_common_slopes_model

Device = Union[str, torch.device]


def get_output_from_trained_model(
    config: SpatialSamplingConfig,
    room_data: SpatialRoomDataset,
    rec_pos_list: np.ndarray,
    grid_resolution_m: Optional[float] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """CS amplitudes at the query positions from the newest checkpoint of a
    training directory (JAX's or the port's): (num_pos, num_slopes) omni or
    (num_pos, J, num_slopes) directional, on ``device``.

    An MLP normalizes the query positions by the dataset's own receiver
    extents. The CNN predicts once on the grid of all the dataset's
    receivers, and each query takes the cell nearest to it in (x, y).
    """
    dev = resolve_device(device)
    model = build_spatial_model(config, room_data.num_rooms, room_data.ambi_order, dev)
    ckpt_dir = Path(config.train_dir)
    if grid_resolution_m is not None:
        ckpt_dir = ckpt_dir / f"grid_resolution={grid_resolution_m:.1f}"
    tree = load_latest_checkpoint(ckpt_dir, config.max_epochs)
    if tree is None:
        raise FileNotFoundError(f"Trained model does not exist under {ckpt_dir}")
    load_jax_params(model, tree)
    trainer = SpatialSamplingTrainer(model, config, room_data, use_edc_loss=False,
                                     grid_resolution_m=grid_resolution_m, device=dev)
    if config.network_type == DNNType.CNN:
        batch = make_cnn_batch(room_data)
        grid_amps = trainer.predict_amplitudes(batch)  # (H*W, J, num_slopes)
        cells = torch.as_tensor(batch["mesh_2d_raw"].reshape(-1, 2), device=dev)
        q = torch.as_tensor(np.asarray(rec_pos_list, np.float32)[:, :2], device=dev)
        dist = torch.linalg.vector_norm(cells[None, :, :] - q[:, None, :], dim=-1)
        return grid_amps[torch.argmin(dist, dim=1)]
    lo = room_data.receiver_position.min(axis=0)
    hi = room_data.receiver_position.max(axis=0)
    norm = (np.asarray(rec_pos_list) - lo) / (hi - lo + 1e-12)
    return trainer.predict_amplitudes({
        "listener_position": np.asarray(rec_pos_list, np.float32),
        "norm_listener_position": norm.astype(np.float32),
    })


def get_soundfield_from_trained_model(
    configs: List[SpatialSamplingConfig],
    room_data: SpatialRoomDataset,
    rec_pos_list: np.ndarray,
    ir_len_samps: int,
    grid_resolution_m: Optional[float] = None,
    apply_spatial_bandlimiting: bool = False,
    seed: int = 0,
    device: Device = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-band inference, one config per octave band: (rirs, amplitudes) on
    the device, rirs (num_pos, (N+1)^2, T) directional or (num_pos, T) omni,
    amplitudes (num_pos, [J,] num_slopes, num_bands)."""
    freq_bands = list(np.atleast_1d(room_data.band_centre_hz))
    if len(freq_bands) != len(configs):
        raise ValueError(f"one config per frequency band required: {len(configs)} configs "
                         f"for {len(freq_bands)} bands")
    amplitudes = torch.stack([
        get_output_from_trained_model(cfg, room_data, rec_pos_list, grid_resolution_m, device)
        for cfg in configs
    ], dim=-1)
    # directional iff the trained heads emit per-direction amplitudes (an
    # omni model trained on a directional dataset gives (P, G, bands))
    is_directional = amplitudes.ndim == 4 and room_data.sph_directions is not None
    rirs = get_rirs_from_common_slopes_model(
        room_data.sample_rate, np.asarray(rec_pos_list), freq_bands, ir_len_samps, amplitudes,
        np.asarray(room_data.common_decay_times),
        ambi_order=room_data.ambi_order if is_directional else None,
        des_directions=room_data.sph_directions if is_directional else None,
        beamformer_type=configs[0].dnn_config.beamformer_type,
        apply_spatial_bandlimiting=apply_spatial_bandlimiting, seed=seed,
    )
    return rirs, amplitudes


def get_ambisonic_rirs(
    rec_pos_list: np.ndarray,
    full_band_room_data: SpatialRoomDataset,
    use_trained_model: bool = False,
    configs: Optional[List[SpatialSamplingConfig]] = None,
    grid_resolution_m: Optional[float] = None,
    output_pkl_path: Optional[str] = None,
    apply_spatial_bandlimiting: bool = False,
    max_ir_len_ms: float = 2000.0,
    seed: int = 0,
    device: Device = "cuda",
) -> SpatialRoomDataset:
    """Synthesize ambisonic (or omni) RIRs at the query positions.

    From a trained per-band stack (``use_trained_model``) or from the
    dataset's stored amplitudes at the nearest receivers. Returns a shallow
    copy of the dataset with the positions and RIRs (host numpy) replaced;
    the input dataset is not changed. ``output_pkl_path`` pickles it.
    """
    dev = resolve_device(device)
    cs_room = copy.copy(full_band_room_data)
    ir_len = min(full_band_room_data.rir_length,
                 int(max_ir_len_ms * 1e-3 * cs_room.sample_rate))
    rec_pos_list = np.asarray(rec_pos_list)
    if use_trained_model:
        rirs, _ = get_soundfield_from_trained_model(
            configs, full_band_room_data, rec_pos_list, ir_len, grid_resolution_m,
            apply_spatial_bandlimiting=apply_spatial_bandlimiting, seed=seed, device=dev,
        )
    else:
        idx = full_band_room_data.find_rec_idx(rec_pos_list)
        amps = full_band_room_data.amplitudes[idx]
        # directional iff the dataset carries directions: (P, J, S, B), else (P, S, B)
        is_directional = full_band_room_data.sph_directions is not None
        want_ndim = 4 if is_directional else 3
        if amps.ndim == want_ndim - 1:
            amps = amps[..., None]  # add the band axis
        if amps.ndim != want_ndim:
            raise ValueError(
                f"amplitudes shape {amps.shape} inconsistent with "
                f"{'directional' if is_directional else 'omni'} dataset"
            )
        rirs = get_rirs_from_common_slopes_model(
            cs_room.sample_rate, rec_pos_list,
            list(np.atleast_1d(full_band_room_data.band_centre_hz)), ir_len,
            torch.as_tensor(np.asarray(amps, np.float32), device=dev),
            np.asarray(full_band_room_data.common_decay_times),
            ambi_order=cs_room.ambi_order if is_directional else None,
            des_directions=cs_room.sph_directions, beamformer_type=None,
            apply_spatial_bandlimiting=apply_spatial_bandlimiting, seed=seed,
        )
    cs_room.update_receiver_pos(rec_pos_list)
    cs_room.update_rirs(rirs.cpu().numpy())
    if output_pkl_path is not None:
        with open(output_pkl_path, "wb") as f:
            pickle.dump(cs_room, f)
    return cs_room
