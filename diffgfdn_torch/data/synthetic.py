"""Synthetic coupled-room dataset generator (port of ``data/synthetic.py``).

Receivers on the 3-room floor plan, RIRs as common-slopes shaped noise whose
per-room amplitudes vary smoothly with the receiver's position. Same schema,
same seed, same numbers as the JAX package's generator.
"""

import pickle
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ..ops.basic import LOG10E6
from .room_dataset import THREE_ROOM_DIMS, THREE_ROOM_START, ThreeRoomDataset


def room_centers() -> np.ndarray:
    """(3, 2) centres of the three rooms' floor plans."""
    return np.array(
        [
            (
                THREE_ROOM_START[k][0] + THREE_ROOM_DIMS[k][0] / 2,
                THREE_ROOM_START[k][1] + THREE_ROOM_DIMS[k][1] / 2,
            )
            for k in range(3)
        ]
    )


def synthesize_amplitudes(receiver_pos: np.ndarray, floor_db: float = -35.0) -> np.ndarray:
    """Smooth per-room CS amplitudes from receiver-to-room-centre distances."""
    centers = room_centers()
    d = np.linalg.norm(receiver_pos[:, None, :2] - centers[None, :, :], axis=-1)
    logits = -1.2 * d  # soft room membership: the closest room dominates
    amps = np.exp(logits - logits.max(axis=1, keepdims=True))
    amps = amps / amps.sum(axis=1, keepdims=True)
    return np.maximum(amps, 10 ** (floor_db / 10.0))


def generate_three_room_pickle(
    path: Union[str, Path],
    fs: float = 8000.0,
    num_rec_per_room: int = 12,
    rir_len_s: float = 0.75,
    decay_times: Tuple[float, float, float] = (0.3, 0.6, 0.45),
    seed: int = 0,
) -> Path:
    """Write a synthetic srirs.pkl with the three-room dataset's schema.

    Fields: fs, srcPos (3, 1), rcvPos (3, R), srirs (R, T), band_centre_hz,
    common_decay_times (1, 3), amplitudes (3, R), noise_floor (1, R).
    """
    rng = np.random.RandomState(seed)
    rec = []
    for k in range(3):
        x = rng.uniform(
            THREE_ROOM_START[k][0] + 0.3,
            THREE_ROOM_START[k][0] + THREE_ROOM_DIMS[k][0] - 0.3,
            num_rec_per_room,
        )
        y = rng.uniform(
            THREE_ROOM_START[k][1] + 0.3,
            THREE_ROOM_START[k][1] + THREE_ROOM_DIMS[k][1] - 0.3,
            num_rec_per_room,
        )
        z = np.full(num_rec_per_room, 1.5)
        rec.append(np.stack([x, y, z], axis=-1))
    receiver_pos = np.concatenate(rec, axis=0)
    num_rec = receiver_pos.shape[0]

    t_len = int(rir_len_s * fs)
    t = np.arange(t_len) / fs
    amps = synthesize_amplitudes(receiver_pos)  # (R, 3)
    decay = np.exp(-t[None, :] * (LOG10E6 / np.asarray(decay_times))[:, None])
    env = amps @ decay  # (R, T) energy envelopes
    rirs = rng.randn(num_rec, t_len) * np.sqrt(env)
    rirs[:, 0] += 1.0  # direct-path spike at the start for the early part

    data = {
        "fs": fs,
        "srcPos": np.array([[2.0], [4.0], [1.5]]),
        "rcvPos": receiver_pos.T,
        "srirs": rirs,
        "band_centre_hz": [
            63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0
        ][: max(1, int(np.log2(fs / 2 / 63)))],
        "common_decay_times": np.asarray(decay_times)[None, :],
        "amplitudes": amps.T,
        "noise_floor": np.full((1, num_rec), 1e-6),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def synthetic_three_room_dataset(
    tmpdir: Union[str, Path], nfft: Optional[int] = None, **kwargs
) -> ThreeRoomDataset:
    """Generate a synthetic pickle and parse it back."""
    path = generate_three_room_pickle(Path(tmpdir) / "srirs.pkl", **kwargs)
    return ThreeRoomDataset(path, nfft=nfft)
