"""The system under test: the PyTorch/CUDA port (``diffgfdn_torch``), built
from a configuration file, a grid and weights that the benchmark makes.

This module is the only one of the harness that imports the port.
"""

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .data import Grid


def port_config(raw: dict):
    """The port's validated configuration of a benchmark configuration file's
    ``preset`` (the reference's YAML keys)."""
    from diffgfdn_torch.config.schema import DiffGFDNConfig

    return DiffGFDNConfig.from_dict(raw)


def room_dataset(grid: Grid, nfft: int):
    """The port's receiver-grid container over the benchmark's grid."""
    from diffgfdn_torch.data.room_dataset import RoomDataset

    return RoomDataset(
        num_rooms=len(grid.room_dims), sample_rate=grid.fs, source_position=grid.source[None],
        receiver_position=grid.receivers, rirs=grid.rirs,
        common_decay_times=grid.decay_times, room_dims=grid.room_dims,
        room_start_coord=grid.room_starts, band_centre_hz=grid.band_hz,
        amplitudes=grid.amplitudes, noise_floor=np.full((grid.rirs.shape[0], 1), 1e-6),
        nfft=nfft)


def weight_rule(name: str, shape: Tuple[int, ...]):
    """How a parameter is drawn from u ~ U(-1, 1) and n ~ N(0, 1) of its size."""
    leaf = name.rsplit(".", 1)[-1]
    if ".dense." in name and leaf == "weight":
        return lambda u, n: u * math.sqrt(6.0 / shape[1])  # He-uniform
    if ".norm." in name and leaf == "weight":
        return lambda u, n: 1.0 + 0.1 * u
    if name in ("input_gains", "output_gains"):
        return lambda u, n: (2.0 * n - 1.0) / shape[0]
    if name.endswith(".M"):  # skew pre-images of the feedback blocks
        return lambda u, n: u / math.sqrt(shape[-1])
    return lambda u, n: 0.1 * u  # biases and the rest


def draw_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} drawn on ``device`` from ``seed``: one uniform and
    one normal draw of the total size, cut in name order."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    u = 2.0 * torch.rand(sum(sizes), generator=gen, device=device) - 1.0
    n = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        out[name] = weight_rule(name, shape)(u[at:at + size], n[at:at + size]).reshape(shape)
        at += size
    return out


def build_model(cfg, grid: Grid, seed: int, device):
    """The port's grid model with the benchmark's weights: (model, weights)."""
    from diffgfdn_torch.training import build_gfdn_model

    model = build_gfdn_model(cfg, common_decay_times=grid.decay_times,
                             band_centre_hz=grid.band_hz, device=device)
    params = dict(model.named_parameters())
    weights = draw_weights({k: tuple(p.shape) for k, p in params.items()}, seed, device)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    return model, weights


def splits(cfg, num_items: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, valid) receiver indices as the port's grid solver splits them."""
    from diffgfdn_torch.data.batching import fixed_test_split, train_valid_split

    tc = cfg.trainer_config
    indices = np.arange(num_items)
    if tc.hold_out_test_set is not None:
        _, indices = fixed_test_split(num_items, tc.hold_out_test_set.ratio,
                                      tc.hold_out_test_set.seed)
    return train_valid_split(indices, tc.train_valid_split, seed=cfg.seed)


def trainer_for(cfg, room, model, train_idx: np.ndarray, device):
    """A ``GFDNTrainer`` with its targets on the device, its optimizer and its
    schedule: what ``fit_indexed`` makes before its first epoch."""
    from diffgfdn_torch.data.batching import arrays_from_room_dataset
    from diffgfdn_torch.training.optim import make_optimizer
    from diffgfdn_torch.training.trainer import GFDNTrainer

    tc = cfg.trainer_config
    bs = min(tc.batch_size, len(train_idx))
    trainer = GFDNTrainer(model, tc, steps_per_epoch=-(-len(train_idx) // bs),
                          common_decay_times=room.common_decay_times,
                          sample_rate=cfg.sample_rate, device=device)
    arrays = arrays_from_room_dataset(room)
    trainer.precompute_target_features(arrays)
    trainer.optimizer, trainer.scheduler = make_optimizer(tc, model, trainer.steps_per_epoch)
    trainer.upload_arrays(arrays)
    return trainer


def padded_batches(idx: np.ndarray, batch_size: int) -> List[np.ndarray]:
    from diffgfdn_torch.training.trainer import padded_batches as batches

    return list(batches(idx, batch_size))


def valid_batches(idx: np.ndarray, batch_size: int) -> List[np.ndarray]:
    from diffgfdn_torch.training.trainer import exact_valid_batches

    full, rest = exact_valid_batches(idx, batch_size)
    return full + ([rest] if len(rest) else [])


def build_kernels() -> None:
    """Build (or find built, under the checkout's ``build/``) the port's kernels."""
    from diffgfdn_torch.kernels._build import build_all

    build_all()
