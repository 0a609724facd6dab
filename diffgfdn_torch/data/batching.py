"""Batch arrays gathered by receiver index, and the dataset splits (port of ``data/batching.py``).

The splits and the batch order (:func:`iterate_batches`, the batches of a
trainer's ``fit``; :func:`index_batches`, their indices) draw from
``np.random.RandomState`` exactly as the JAX package does, so both packages
train and validate on the same receivers for a seed.
"""

from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np

from .room_dataset import RoomDataset

# a spectra field may be a zero-arg thunk, resolved and cached on first read
_ArrayOrThunk = Union[np.ndarray, Callable[[], np.ndarray], None]


class BatchArrays:
    """Full-dataset feature arrays from which batches are gathered."""

    def __init__(
        self,
        z_values: np.ndarray,                  # (F,) complex64
        source_position: np.ndarray,           # (R, 3)
        listener_position: np.ndarray,         # (R, 3)
        norm_listener_position: np.ndarray,    # (R, 3)
        target_early_response: _ArrayOrThunk = None,  # (R, F) complex64
        target_late_response: _ArrayOrThunk = None,   # (R, F) complex64
        target_rir_response: _ArrayOrThunk = None,    # (R, F) complex64
        target_common_slope_amps: Optional[np.ndarray] = None,
        mesh_2d: Optional[np.ndarray] = None,  # (L, 2)
        target_early_time: Optional[np.ndarray] = None,  # (R, mixing time) float32
        target_rir_time: Optional[np.ndarray] = None,    # (R, T) float32
        # per-receiver loss features (target EDC / EDR in dB; numpy, or
        # tensors on a device), gathered with the batch: a trainer's
        # precompute_target_features fills them
        precomputed: Optional[Dict] = None,
    ):
        self.z_values = z_values
        self.source_position = source_position
        self.listener_position = listener_position
        self.norm_listener_position = norm_listener_position
        self._spectra = {
            "target_early_response": target_early_response,
            "target_late_response": target_late_response,
            "target_rir_response": target_rir_response,
        }
        self.target_common_slope_amps = target_common_slope_amps
        self.mesh_2d = mesh_2d
        # time-domain targets: the trainer uploads these and takes every
        # spectrum and loss feature on the device
        self.target_early_time = target_early_time
        self.target_rir_time = target_rir_time
        self.precomputed = precomputed

    def _spectrum(self, key: str) -> Optional[np.ndarray]:
        value = self._spectra[key]
        if callable(value):
            value = self._spectra[key] = value()
        return value

    @property
    def target_early_response(self) -> np.ndarray:
        return self._spectrum("target_early_response")

    @property
    def target_late_response(self) -> np.ndarray:
        return self._spectrum("target_late_response")

    @property
    def target_rir_response(self) -> np.ndarray:
        return self._spectrum("target_rir_response")

    @property
    def num_items(self) -> int:
        return self.listener_position.shape[0]


def arrays_from_room_dataset(
    room_data: RoomDataset, new_sampling_radius: Optional[float] = None
) -> BatchArrays:
    """Flatten a RoomDataset into batch arrays (spectra computed lazily)."""
    radius = 1.0 if new_sampling_radius in (None, 1.0) else new_sampling_radius
    if radius < 1.0:
        raise ValueError(f"sampling radius must be >= 1, got {radius}")
    z = (radius * np.exp(1j * room_data.freq_bins_rad)).astype(np.complex64)
    src = room_data.source_position.astype(np.float32)
    if src.shape[0] == 1:
        src = np.broadcast_to(src, (room_data.num_rec, 3)).copy()
    amps = room_data.amplitudes
    return BatchArrays(
        z_values=z,
        source_position=src,
        listener_position=room_data.receiver_position.astype(np.float32, copy=False),
        norm_listener_position=room_data.norm_receiver_position.astype(
            np.float32, copy=False
        ),
        target_early_response=lambda: room_data.early_rir_mag_response.astype(
            np.complex64, copy=False
        ),
        target_late_response=lambda: room_data.late_rir_mag_response.astype(
            np.complex64, copy=False
        ),
        target_rir_response=lambda: room_data.rir_mag_response.astype(
            np.complex64, copy=False
        ),
        target_common_slope_amps=None if amps is None else np.asarray(amps, np.float32),
        mesh_2d=room_data.mesh_2d.points.astype(np.float32),
        target_early_time=room_data.early_rir_time,
        target_rir_time=room_data.rirs32,
    )


def gather_batch(arrays: BatchArrays, idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Materialize one batch dict (z values and mesh are shared constants).
    Precomputed loss features that live on a device are gathered there."""
    batch = {
        "z_values": arrays.z_values,
        "source_position": arrays.source_position[idx],
        "listener_position": arrays.listener_position[idx],
        "norm_listener_position": arrays.norm_listener_position[idx],
        "target_early_response": arrays.target_early_response[idx],
        "target_late_response": arrays.target_late_response[idx],
        "target_rir_response": arrays.target_rir_response[idx],
    }
    if arrays.target_common_slope_amps is not None:
        batch["target_common_slope_amps"] = arrays.target_common_slope_amps[idx]
    if arrays.mesh_2d is not None:
        batch["mesh_2d"] = arrays.mesh_2d
    for k, v in (arrays.precomputed or {}).items():
        batch[k] = v[idx]
    return batch


def fixed_test_split(
    num_items: int, test_ratio: float = 0.1, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """(test_indices, remaining_indices): seeded, stable across runs."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(num_items)
    test_size = int(num_items * test_ratio)
    return idx[:test_size], idx[test_size:]


def train_valid_split(
    indices: np.ndarray, split: float, seed: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Random split of the given indices into train / valid subsets."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(indices))
    n_train = int(len(indices) * split)
    return indices[perm[:n_train]], indices[perm[n_train:]]


def index_batches(
    indices: np.ndarray, batch_size: int, shuffle: bool = True, seed: Optional[int] = None
) -> Iterator[np.ndarray]:
    """Full batches of indices, the tail dropped, in the order the JAX
    package's ``iterate_batches`` draws them (optionally shuffled by seed)."""
    idx = np.array(indices)
    if shuffle:
        idx = idx[np.random.RandomState(seed).permutation(len(idx))]
    for k in range(len(idx) // batch_size):
        yield idx[k * batch_size : (k + 1) * batch_size]


def iterate_batches(
    arrays: BatchArrays,
    indices: np.ndarray,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: Optional[int] = None,
    pad_to_batch: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batches (:func:`gather_batch` dicts) over ``indices``, shuffled by
    ``np.random.RandomState(seed)`` as the JAX package draws them.

    ``drop_last=True`` keeps every batch the same shape; otherwise the tail
    is a last, shorter batch, or with ``pad_to_batch`` a full one whose
    missing items repeat ``indices`` from the start (tiled, so that it fills
    even when there are fewer indices than ``batch_size``).
    """
    idx = np.array(indices)
    if shuffle:
        idx = idx[np.random.RandomState(seed).permutation(len(idx))]
    n = len(idx)
    num_full = n // batch_size
    for k in range(num_full):
        yield gather_batch(arrays, idx[k * batch_size : (k + 1) * batch_size])
    rem = n - num_full * batch_size
    if rem and not drop_last:
        tail = idx[num_full * batch_size :]
        if pad_to_batch:
            reps = int(np.ceil((batch_size - rem) / max(n, 1)))
            tail = np.concatenate([tail, np.tile(idx, reps)[: batch_size - rem]])
        yield gather_batch(arrays, tail)


def num_batches(num_items: int, batch_size: int, drop_last: bool = True) -> int:
    """The number of batches :func:`iterate_batches` yields."""
    if drop_last:
        return num_items // batch_size
    return int(np.ceil(num_items / batch_size))
