"""Common-slopes spatial-sampling trainer and sweep (port of ``training/spatial_trainer.py``).

DNNs map receiver positions to omni common-slope (CS) amplitudes or to SH
beamforming weights per slope (directional), trained with Adam and
StepLR(20 epochs, 0.1) at several grid resolutions, one checkpoint directory
``grid_resolution=<res>`` per resolution. Two heads, two epoch loops:

* the position MLPs train on receiver batches (:meth:`SpatialSamplingTrainer.fit_indexed`):
  the positions and CS targets are uploaded once (:meth:`upload_arrays`);
  batches are gathered on the device from an index matrix uploaded once per
  epoch, in the order ``np.random.RandomState(seed)`` draws, wrap-padded;
  the validation loss is the exact item-weighted mean over full batches and
  the unpadded remainder;
* the floor-plan CNN (``spatial_directional_1000Hz_cnn``) trains on one
  full-grid batch per resolution (:func:`make_cnn_batch`: the normalized
  mesh, the labels nearest-interpolated onto it, the floor mask), through
  the generator-batch loop :meth:`SpatialSamplingTrainer.fit`; cells outside
  the floor plan take their targets, so they add nothing to the loss but
  still count in its mean.

In both, the losses are summed on the device and read by the host once per
epoch, and with ``scan_epochs`` (the default) each step and each full
validation batch runs through a step graph (``training/scan.py``), captured
once on the card and replayed: the batch's indices, or the generator's
batch, are its static inputs. Each resolution's trainer of a sweep captures
its own. Checkpoints are flax trees (``utils/params.py``), readable by the
JAX package. After each resolution of a directional MLP sweep, the predicted
amplitudes at the first training receiver are drawn as beamformer maps
(``utils/plot.py``) under ``train_dir``; a failure to plot is logged, not
raised, as in the JAX package.
"""

import copy
import logging
from pathlib import Path
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config.schema import CNNConfig, DNNType, MLPConfig, SpatialSamplingConfig
from ..data.spatial_dataset import (
    arrays_from_spatial_dataset,
    create_2d_grid_data,
    SpatialRoomDataset,
    split_by_grid_resolution,
)
from ..losses.spatial import (
    find_position_idx,
    make_decay_envelopes,
    make_smoothness_kernel,
    spatial_edc_loss,
    spatial_mse_loss,
    spatial_smoothness_loss,
)
from ..models.spatial import (
    build_analysis_matrix,
    directional_amplitudes,
    DirectionalBeamformerWeightsCNN,
    DirectionalBeamformerWeightsMLP,
    OmniAmplitudesMLP,
)
from ..utils.device import resolve_device
from ..utils.params import jax_params_from_torch
from .checkpoints import save_checkpoint
from .optim import make_single_lr_optimizer
from .scan import GraphedSteps
from .trainer import exact_valid_batches, padded_batches

logger = logging.getLogger("diffgfdn_torch")

Batch = Dict[str, torch.Tensor]
DECAY_EPOCHS = 20  # StepLR(20, 0.1), as the JAX trainer's exponential_decay
SMOOTHNESS_WEIGHT = 1e-4


def build_spatial_model(
    config: SpatialSamplingConfig,
    num_slopes: int,
    ambi_order: Optional[int],
    device: Union[str, torch.device] = "cuda",
) -> torch.nn.Module:
    """The configured CS-amplitude DNN on ``device``, parameters drawn from a
    ``torch.Generator`` seeded with ``config.seed``.

    A missing ``mlp_config`` or ``cnn_config`` means default hyperparameters,
    as in the JAX package; a directional config without ``mlp_config`` is
    the floor-plan CNN (``network_type``).
    """
    dev = resolve_device(device)
    dnn = config.dnn_config
    mlp = dnn.mlp_config or MLPConfig()
    generator = torch.Generator().manual_seed(config.seed)
    if config.use_directional_rirs and config.network_type == DNNType.CNN:
        cnn = dnn.cnn_config or CNNConfig()
        model = DirectionalBeamformerWeightsCNN(
            num_groups=num_slopes, ambi_order=ambi_order,
            num_fourier_features=dnn.num_fourier_features,
            num_hidden_channels=cnn.num_hidden_channels, num_layers=cnn.num_layers,
            kernel_size=tuple(cnn.kernel_size), generator=generator,
        )
    elif config.use_directional_rirs:
        model = DirectionalBeamformerWeightsMLP(
            num_groups=num_slopes, ambi_order=ambi_order,
            num_fourier_features=dnn.num_fourier_features,
            num_hidden_layers=mlp.num_hidden_layers, num_neurons=mlp.num_neurons_per_layer,
            generator=generator,
        )
    else:
        model = OmniAmplitudesMLP(
            num_groups=num_slopes, num_fourier_features=dnn.num_fourier_features,
            num_hidden_layers=mlp.num_hidden_layers, num_neurons=mlp.num_neurons_per_layer,
            gain_limits=(1e-5, 1.0), generator=generator,
        )
    return model.to(dev)


class SpatialSamplingTrainer(GraphedSteps):
    """Trainer of a CS-amplitude DNN: the position MLPs (omni amplitudes or
    directional weights) or the floor-plan CNN.

    ``device`` defaults to CUDA and raises without a card unless the caller
    passes ``device="cpu"``; the model is moved there.
    """

    _INDEXED_KEYS = ("norm_listener_position", "listener_position", "target_common_slope_amps")

    def __init__(
        self,
        model: torch.nn.Module,
        config: SpatialSamplingConfig,
        room_data: SpatialRoomDataset,
        use_edc_loss: bool = True,
        use_smoothness_loss: bool = False,
        grid_resolution_m: Optional[float] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = config
        self.use_directional = config.use_directional_rirs
        self.grid_resolution_m = grid_resolution_m
        self.train_loss: List[float] = []
        self.valid_loss: List[float] = []
        self.epoch_s: List[float] = []  # wall time of each epoch, checkpoint included
        self.init_graphs(self.device)
        self.scheduler = None
        self.data: Optional[Batch] = None

        self.analysis_matrix = None
        if self.use_directional:
            self.analysis_matrix = torch.as_tensor(build_analysis_matrix(
                room_data.ambi_order, room_data.sph_directions, config.dnn_config.beamformer_type,
            ), device=self.device)
        slopes = np.squeeze(np.asarray(room_data.common_decay_times)).reshape(-1)
        slopes = slopes[: room_data.num_rooms]
        edc_len = int(float(np.max(slopes)) * room_data.sample_rate)
        self.envelopes = (
            make_decay_envelopes(slopes, edc_len, room_data.sample_rate).to(self.device)
            if use_edc_loss else None
        )
        self.kernel_weights = (
            torch.as_tensor(make_smoothness_kernel(room_data.receiver_position),
                            device=self.device)
            if use_smoothness_loss else None
        )
        self._all_positions = torch.as_tensor(
            room_data.receiver_position.astype(np.float32), device=self.device)

    # ------------------------------ loss -----------------------------------

    def _predict(self, batch: Batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(amplitudes, raw weights or None) for a batch."""
        if self.use_directional:
            weights = self.model(batch)
            return directional_amplitudes(self.analysis_matrix, weights), weights
        return self.model(batch), None

    def _losses(self, batch: Batch) -> Dict[str, torch.Tensor]:
        amps, weights = self._predict(batch)
        target = batch["target_common_slope_amps"]
        if "floor_mask" in batch:
            # the CNN's grid: cells outside the floor plan take their targets
            mask = batch["floor_mask"].reshape((-1,) + (1,) * (amps.ndim - 1))
            amps = amps * mask + (1.0 - mask) * target
        out: Dict[str, torch.Tensor] = {}
        if self.envelopes is not None:
            out["edc_loss"] = spatial_edc_loss(amps, target, self.envelopes)
        else:
            out["mse_loss"] = spatial_mse_loss(amps, target)
        if self.kernel_weights is not None and weights is not None:
            pos_idx = find_position_idx(self._all_positions, batch["listener_position"])
            out["smoothness_loss"] = SMOOTHNESS_WEIGHT * spatial_smoothness_loss(
                self.kernel_weights, pos_idx, weights)
        return out

    def loss_and_grads(self, batch: Batch) -> torch.Tensor:
        """Zero the gradients, then the total loss of one batch and its
        backward: the parameters' ``.grad`` hold the step's gradients."""
        for p in self.model.parameters():
            p.grad = None
        total = sum(self._losses(batch).values())
        total.backward()
        return total.detach()

    def _train_step(self, idx: torch.Tensor) -> torch.Tensor:
        """The step closure: loss, backward and optimizer step on the batch."""
        total = self.loss_and_grads(self.gather(idx))
        self.optimizer.step()
        return total

    def _valid_step(self, idx: torch.Tensor) -> torch.Tensor:
        """The validation closure: the batch's total loss, no gradient."""
        with torch.no_grad():
            return sum(self._losses(self.gather(idx)).values())

    def fit_step(self, idx: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the receivers ``idx`` (a device tensor),
        graphed with ``scan_epochs``; returns the device-resident loss (no
        host sync; with ``scan_epochs`` on the card, valid until the next
        step)."""
        total = self.run_step("train", self._train_step, idx=idx)
        self.scheduler.step()
        return total

    # --------------------- device-resident indexed path ---------------------

    @torch.no_grad()
    def upload_arrays(self, arrays) -> Batch:
        """The positions and CS targets on the device, uploaded once."""
        self.data = {
            k: torch.as_tensor(np.asarray(getattr(arrays, k), np.float32), device=self.device)
            for k in self._INDEXED_KEYS if getattr(arrays, k) is not None
        }
        self.graphs.clear()
        return self.data

    def gather(self, idx: torch.Tensor) -> Batch:
        """One batch gathered on the device."""
        return {k: v[idx] for k, v in self.data.items()}

    def _checkpoint_dir(self) -> str:
        base = Path(self.cfg.train_dir)
        if self.grid_resolution_m is not None:
            return str(base / f"grid_resolution={self.grid_resolution_m:.1f}")
        return str(base)

    def fit_indexed(
        self,
        arrays,
        train_idx: np.ndarray,
        valid_idx: Optional[np.ndarray] = None,
        seed: int = 0,
    ) -> torch.nn.Module:
        """Epoch loop over device-resident data; returns the trained model.

        Training batches are wrap-padded (``padded_batches``); validation is
        the item-weighted mean over full batches and the unpadded remainder.
        Each epoch writes its checkpoint; the host reads the losses once.
        """
        if len(train_idx) == 0:
            raise ValueError("no training items: train_idx is empty (check "
                             "split_by_grid_resolution / dataset size) - training "
                             "would silently run zero steps")
        train_idx = np.asarray(train_idx)
        self.upload_arrays(arrays)
        bs = min(self.cfg.batch_size, len(train_idx))
        steps_per_epoch = -(-len(train_idx) // bs)  # padded_batches' count
        self.optimizer, self.scheduler = make_single_lr_optimizer(
            self.model, self.cfg.lr, steps_per_epoch, DECAY_EPOCHS)

        valid_batches = []
        if valid_idx is not None and len(valid_idx):
            vbs = min(self.cfg.batch_size, len(valid_idx))
            vfull, vrem = exact_valid_batches(np.asarray(valid_idx), vbs)
            valid_batches = [
                torch.as_tensor(b, dtype=torch.long, device=self.device)
                for b in vfull + ([vrem] if len(vrem) else [])
            ]
        rng = np.random.RandomState(seed)
        for epoch in range(self.cfg.max_epochs):
            t0 = time.time()
            perm = train_idx[rng.permutation(len(train_idx))]
            idx_mat = torch.as_tensor(np.stack(list(padded_batches(perm, bs))),
                                      dtype=torch.long, device=self.device)
            ep_total = torch.zeros((), device=self.device)
            for idx in idx_mat:
                ep_total = ep_total + self.fit_step(idx)
            v_total, v_weight = torch.zeros((), device=self.device), 0
            for vidx in valid_batches:
                loss = self.run_valid(self._valid_step, vbs, idx=vidx)
                v_total = v_total + loss * len(vidx)
                v_weight += len(vidx)
            host = torch.stack([ep_total, v_total]).tolist()  # the epoch's one read
            self.train_loss.append(host[0] / idx_mat.shape[0])
            if v_weight:
                self.valid_loss.append(host[1] / v_weight)
            save_checkpoint(self._checkpoint_dir(), epoch, jax_params_from_torch(self.model))
            self.epoch_s.append(time.time() - t0)
            logger.info("spatial epoch %d train %.4f%s (%.2fs)", epoch, self.train_loss[-1],
                        f" valid {self.valid_loss[-1]:.4f}" if v_weight else "",
                        self.epoch_s[-1])
        return self.model

    def _batch_step(self, **batch: torch.Tensor) -> torch.Tensor:
        """The step closure of :meth:`fit`: loss, backward and optimizer step."""
        total = self.loss_and_grads(batch)
        self.optimizer.step()
        return total

    def _batch_valid_step(self, **batch: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return sum(self._losses(batch).values())

    def to_device(self, batch: Dict) -> Batch:
        """A batch of arrays as float32 tensors on the trainer's device."""
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                if not torch.is_tensor(v) else v.to(self.device) for k, v in batch.items()}

    def fit_batch(self, batch: Batch) -> torch.Tensor:
        """One optimizer step on a batch of device tensors (:meth:`to_device`),
        through the step graph of its layout with ``scan_epochs``; returns the
        device-resident loss (no host sync; graphed on the card, valid until
        the next step)."""
        total = self.run_step("train", self._batch_step, **batch)
        self.scheduler.step()
        return total

    def _epoch_losses(self, batches: List[Batch], train: bool) -> Tuple[torch.Tensor, int]:
        """(sum of the batches' losses on the device, number of batches): the
        optimizer steps of an epoch, or its validation, through
        :meth:`run_batches`."""
        step = self._batch_step if train else self._batch_valid_step
        total = torch.zeros((), device=self.device)
        for out in self.run_batches("train" if train else "valid", step, batches):
            if train:
                self.scheduler.step()
            total = total + out
        return total, len(batches)

    def fit(
        self,
        train_batches: Callable[[int], Iterable[Dict]],
        valid_batches: Optional[Callable[[], Iterable[Dict]]] = None,
        static_batches: bool = False,
    ) -> torch.nn.Module:
        """Generator-batch epoch loop (the CNN's grids, custom batch sources);
        returns the trained model.

        ``train_batches(epoch)`` yields the epoch's batches (dicts of arrays or
        tensors); the decay of StepLR(20 epochs) counts epoch 0's batches.
        ``static_batches=True`` declares that every epoch yields the same
        batches (the CNN's one full-grid batch): they are uploaded once. The
        train loss is the mean of the epoch's batch losses, the valid loss the
        mean over ``valid_batches()``. Each epoch writes its checkpoint; the
        host reads the losses once an epoch.
        """
        steps_per_epoch = max(1, sum(1 for _ in train_batches(0)))
        self.optimizer, self.scheduler = make_single_lr_optimizer(
            self.model, self.cfg.lr, steps_per_epoch, DECAY_EPOCHS)
        static = [self.to_device(b) for b in train_batches(0)] if static_batches else None
        valid = None if valid_batches is None else [self.to_device(b) for b in valid_batches()]
        for epoch in range(self.cfg.max_epochs):
            t0 = time.time()
            batches = static if static is not None else [
                self.to_device(b) for b in train_batches(epoch)]
            ep_total, nb = self._epoch_losses(batches, train=True)
            v_total, nv = (torch.zeros((), device=self.device), 0) if valid is None else \
                self._epoch_losses(valid, train=False)
            host = torch.stack([ep_total, v_total]).tolist()  # the epoch's one read
            self.train_loss.append(host[0] / max(nb, 1))
            if valid is not None:
                self.valid_loss.append(host[1] / max(nv, 1))
            save_checkpoint(self._checkpoint_dir(), epoch, jax_params_from_torch(self.model))
            self.epoch_s.append(time.time() - t0)
            logger.info("spatial epoch %d train %.4f%s (%.2fs)", epoch, self.train_loss[-1],
                        f" valid {self.valid_loss[-1]:.4f}" if valid is not None else "",
                        self.epoch_s[-1])
        return self.model

    @torch.no_grad()
    def predict_amplitudes(self, batch: Dict) -> torch.Tensor:
        """CS amplitudes at the batch positions (the CNN: at every cell of the
        batch's grid, unmasked), on the trainer's device."""
        return self._predict(self.to_device(batch))[0]


def make_cnn_batch(
    room_data: SpatialRoomDataset, indices: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    """One full-grid CNN batch (float32 numpy) from the receivers ``indices``
    (all by default): the normalized mesh ``mesh_2d`` (H, W, 2), the mesh in
    metres ``mesh_2d_raw``, the labels ``target_common_slope_amps``
    (H*W, J, num_slopes) and the flattened floor mask ``floor_mask`` (H*W,)."""
    if indices is None:
        indices = np.arange(room_data.num_rec)
    mesh, norm_mesh, labels = create_2d_grid_data(room_data, indices)
    return {
        "mesh_2d": norm_mesh,
        "mesh_2d_raw": mesh,
        "target_common_slope_amps": labels,
        "floor_mask": room_data.get_binary_mask(mesh).ravel().astype(np.float32),
    }


def run_training_spatial_sampling_cnn(
    config: SpatialSamplingConfig,
    room_data: SpatialRoomDataset,
    grid_resolutions: Optional[List[float]] = None,
    use_edc_loss: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Dict[float, Tuple[SpatialSamplingTrainer, torch.nn.Module]]:
    """The CNN's resolution sweep (by default ``grid_spacing_m * k`` for k =
    ``num_grid_spacing`` (1 if unset) .. 1): per resolution one full-grid
    batch of its training receivers, ``max_epochs`` steps on it from the
    same seeded initialization. Returns {resolution: (trainer, model)}."""
    dev = resolve_device(device)
    if grid_resolutions is None:
        n = config.num_grid_spacing or 1
        grid_resolutions = [room_data.grid_spacing_m * k for k in range(n, 0, -1)]
    results = {}
    for res in grid_resolutions:
        train_idx, _ = split_by_grid_resolution(room_data, res)
        batch = make_cnn_batch(room_data, train_idx)
        model = build_spatial_model(config, room_data.num_rooms, room_data.ambi_order, dev)
        trainer = SpatialSamplingTrainer(model, config, room_data, use_edc_loss=use_edc_loss,
                                         grid_resolution_m=res, device=dev)
        trainer.fit(lambda epoch, b=batch: iter([b]), static_batches=True)
        results[res] = (trainer, model)
    return results


def collapse_amplitudes_to_omni(room_data: SpatialRoomDataset) -> SpatialRoomDataset:
    """A copy of a directional dataset with its CS amplitudes averaged over
    directions (axis 1); a dataset without directions is returned as it is.
    The input is not changed."""
    if room_data.amplitudes is None or room_data.sph_directions is None:
        return room_data
    logger.info("collapsing directional amplitudes to omni (mean over directions) for "
                "use_directional_rirs=false")
    room_data = copy.copy(room_data)
    room_data.amplitudes = room_data.amplitudes.mean(axis=1)
    room_data.sph_directions = None
    return room_data


def run_training_spatial_sampling(
    config: SpatialSamplingConfig,
    room_data: Optional[SpatialRoomDataset] = None,
    grid_resolutions: Optional[List[float]] = None,
    use_edc_loss: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Dict[float, Tuple[SpatialSamplingTrainer, torch.nn.Module]]:
    """Sweep the grid resolutions (by default ``grid_spacing_m * k`` for k =
    ``num_grid_spacing`` (3 if unset) .. 1), training one model per
    resolution from the same seeded initialization. Returns
    {resolution: (trainer, model)}. The CNN goes to
    :func:`run_training_spatial_sampling_cnn`."""
    dev = resolve_device(device)
    if room_data is None:
        from ..data.spatial_dataset import SpatialThreeRoomDataset

        room_data = SpatialThreeRoomDataset(config.room_dataset_path)
    if not config.use_directional_rirs:
        room_data = collapse_amplitudes_to_omni(room_data)
    if config.network_type == DNNType.CNN:
        return run_training_spatial_sampling_cnn(config, room_data, grid_resolutions,
                                                 use_edc_loss, dev)
    if grid_resolutions is None:
        n = config.num_grid_spacing or 3
        grid_resolutions = [room_data.grid_spacing_m * k for k in range(n, 0, -1)]

    arrays = arrays_from_spatial_dataset(room_data)
    results = {}
    for res in grid_resolutions:
        train_idx, valid_idx = split_by_grid_resolution(room_data, res)
        model = build_spatial_model(config, room_data.num_rooms, room_data.ambi_order, dev)
        trainer = SpatialSamplingTrainer(model, config, room_data, use_edc_loss=use_edc_loss,
                                         grid_resolution_m=res, device=dev)
        trainer.fit_indexed(arrays, train_idx, valid_idx, seed=config.seed)
        results[res] = (trainer, model)
        _save_beamformer_maps(config, room_data, trainer, arrays, train_idx, res)
    return results


def _save_beamformer_maps(config: SpatialSamplingConfig, room_data: SpatialRoomDataset,
                          trainer: SpatialSamplingTrainer, arrays, train_idx: np.ndarray,
                          resolution: float) -> None:
    """The directional amplitudes at the first training receiver as
    beamformer maps, ``beamformer_map_grid_resolution_m=<res>.png`` under
    ``train_dir``; a plotting failure (matplotlib missing) is logged."""
    if not trainer.use_directional or config.train_dir is None:
        return
    try:
        from ..utils.plot import plot_beamformer_map

        first = train_idx[:1]
        amps = trainer.predict_amplitudes({
            "listener_position": arrays.listener_position[first],
            "norm_listener_position": arrays.norm_listener_position[first],
        }).cpu().numpy()
        plot_beamformer_map(
            amps[0], room_data.sph_directions, room_data.ambi_order, room_data.num_rooms,
            save_path=str(Path(config.train_dir)
                          / f"beamformer_map_grid_resolution_m={resolution:.3f}.png"),
        )
    except Exception as exc:  # plotting must never stop a training run
        logger.warning("beamformer map plotting failed: %s", exc)
