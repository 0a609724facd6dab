"""The synthetic coupled-room receiver grid, made from a seed (host numpy).

Each room's receivers are drawn uniformly over its floor plan; each RIR is
common-slope shaped noise: Gaussian noise under the energy envelope
sum_k a_k exp(-t ln(10^6) / T60_k), with per-room amplitudes a_k falling
with the distance to each room's centre (a soft room membership), and a
unit spike at t = 0. Every seed gives the same sizes, decay times and
amplitude law; the seed moves the receivers and draws the noise.
"""

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

LN_1E6 = math.log(1e6)


@dataclass
class Grid:
    fs: float
    source: np.ndarray  # (3,)
    receivers: np.ndarray  # (R, 3) float32
    rirs: np.ndarray  # (R, T) float32
    amplitudes: np.ndarray  # (R, rooms)
    decay_times: np.ndarray  # (bands, rooms) per band, or (1, rooms) broadband
    band_hz: Optional[List[float]]
    room_dims: list
    room_starts: list

    @property
    def norm_receivers(self) -> np.ndarray:
        """Receiver coordinates min-max normalized to [0, 1] over the grid."""
        lo = self.receivers.min(axis=0, keepdims=True)
        hi = self.receivers.max(axis=0, keepdims=True)
        return ((self.receivers - lo) / (hi - lo + 1e-12)).astype(np.float32)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of a run's seed (any whole number)."""
    return np.random.default_rng([seed % 2 ** 63, stream])


def make_grid(recipe: dict, seed: int) -> Grid:
    """The grid of a configuration's ``data`` recipe for ``seed``."""
    rng = rng_for(seed, 0)
    fs = float(recipe["sample_rate"])
    rooms = recipe["rooms"]
    total = int(recipe["receivers"])
    counts = [total // len(rooms) + (k < total % len(rooms)) for k in range(len(rooms))]
    margin = float(recipe["wall_margin_m"])
    pos = []
    for room, n in zip(rooms, counts):
        (x0, y0), (dx, dy) = room["start"], room["dims"][:2]
        x = rng.uniform(x0 + margin, x0 + dx - margin, n)
        y = rng.uniform(y0 + margin, y0 + dy - margin, n)
        pos.append(np.stack([x, y, np.full(n, float(recipe["height_m"]))], axis=-1))
    receivers = np.concatenate(pos).astype(np.float32)

    centres = np.array([[r["start"][0] + r["dims"][0] / 2, r["start"][1] + r["dims"][1] / 2]
                        for r in rooms])
    dist = np.linalg.norm(receivers[:, None, :2] - centres[None], axis=-1)
    logits = -float(recipe["membership_per_m"]) * dist
    amps = np.exp(logits - logits.max(axis=1, keepdims=True))
    amps = np.maximum(amps / amps.sum(axis=1, keepdims=True),
                      10.0 ** (float(recipe["amplitude_floor_db"]) / 10.0))

    t60 = np.asarray(recipe["decay_times_s"], np.float64)
    length = int(round(float(recipe["rir_seconds"]) * fs))
    t = np.arange(length) / fs
    envelope = (amps @ np.exp(-t[None, :] * (LN_1E6 / t60)[:, None])).astype(np.float32)
    rirs = rng.standard_normal((total, length), dtype=np.float32)
    rirs *= np.sqrt(envelope)
    rirs[:, 0] += 1.0

    factors = recipe.get("band_decay_factors")
    decay = t60[None, :] if factors is None else \
        np.asarray(factors, np.float64)[:, None] * t60[None, :]
    return Grid(fs=fs, source=np.asarray(recipe["source_m"], np.float64), receivers=receivers,
                rirs=rirs, amplitudes=amps.astype(np.float32), decay_times=decay,
                band_hz=recipe.get("band_centre_hz"),
                room_dims=[tuple(r["dims"]) for r in rooms],
                room_starts=[tuple(r["start"]) + (0.0,) for r in rooms])
