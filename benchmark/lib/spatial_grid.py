"""The synthetic directional receiver grid, made from a seed (host numpy).

The receivers lie on a uniform grid over the three-room floor plan, from each
room's start plus one spacing, as the repository's synthetic spatial
generator lays them (so the grid-resolution split has a subgrid to keep).
Each receiver's common-slope amplitudes per direction follow that
generator's law: room amplitudes from the distance to each room's centre (a
soft membership, floored), each direction's share 0.5 + 0.5 max(0, cos(the
azimuth to the room's centre less the direction's azimuth)). The seed scales
each amplitude by a log-normal factor. The directions are the icosahedron's
12 vertices. No SRIR is made: the directional trainer reads the positions
and the amplitudes only.
"""

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from .data import rng_for

PHI = (1.0 + math.sqrt(5.0)) / 2.0
ICOSAHEDRON = np.array([
    [0, 1, PHI], [0, -1, PHI], [0, 1, -PHI], [0, -1, -PHI],
    [1, PHI, 0], [-1, PHI, 0], [1, -PHI, 0], [-1, -PHI, 0],
    [PHI, 0, 1], [-PHI, 0, 1], [PHI, 0, -1], [-PHI, 0, -1]], dtype=np.float64)


@dataclass
class SpatialGrid:
    fs: float
    spacing_m: float
    source: np.ndarray  # (3,)
    receivers: np.ndarray  # (R, 3) float64
    amplitudes: np.ndarray  # (R, J, rooms) float32
    decay_times: np.ndarray  # (1, rooms)
    directions: np.ndarray  # (2, J) azimuth, elevation (rad)
    band_hz: List[float]
    room_dims: list
    room_starts: list

    @property
    def norm_receivers(self) -> np.ndarray:
        """Receiver coordinates min-max normalized to [0, 1] over the grid
        (float64, then float32, as the model reads them)."""
        lo = self.receivers.min(axis=0, keepdims=True)
        hi = self.receivers.max(axis=0, keepdims=True)
        return ((self.receivers - lo) / (hi - lo + 1e-12)).astype(np.float32)


def directions() -> np.ndarray:
    """(2, 12) azimuth and elevation (rad) of the icosahedron's vertices."""
    xyz = ICOSAHEDRON / np.linalg.norm(ICOSAHEDRON, axis=1, keepdims=True)
    return np.stack([np.arctan2(xyz[:, 1], xyz[:, 0]), np.arcsin(xyz[:, 2])])


def make_grid(recipe: dict, seed: int) -> SpatialGrid:
    """The grid of a configuration's ``data`` recipe for ``seed``."""
    d = float(recipe["grid_spacing_m"])
    rooms = recipe["rooms"]
    pos = []
    for room in rooms:
        (x0, y0), (w, h) = room["start"], room["dims"][:2]
        xm, ym = np.meshgrid(np.arange(x0 + d, x0 + w - 1e-6, d),
                             np.arange(y0 + d, y0 + h - 1e-6, d))
        pos.append(np.stack([xm.ravel(), ym.ravel(), np.full(xm.size, recipe["height_m"])], -1))
    receivers = np.concatenate(pos).astype(np.float64)
    if receivers.shape[0] != int(recipe["receivers"]):
        raise ValueError(f"the recipe lays {receivers.shape[0]} receivers, not "
                         f"{recipe['receivers']}")

    centres = np.array([[r["start"][0] + r["dims"][0] / 2, r["start"][1] + r["dims"][1] / 2]
                        for r in rooms])
    to_room = centres[None] - receivers[:, None, :2]  # (R, rooms, 2)
    logits = -float(recipe["membership_per_m"]) * np.linalg.norm(to_room, axis=-1)
    omni = np.exp(logits - logits.max(axis=1, keepdims=True))
    omni = np.maximum(omni / omni.sum(axis=1, keepdims=True),
                      10.0 ** (float(recipe["amplitude_floor_db"]) / 10.0))
    dirs = directions()
    room_azi = np.arctan2(to_room[..., 1], to_room[..., 0])  # (R, rooms)
    share = 0.5 + 0.5 * np.clip(np.cos(room_azi[:, None, :] - dirs[0][None, :, None]), 0, None)
    amps = omni[:, None, :] * share  # (R, J, rooms)
    jitter = rng_for(seed, 0).standard_normal(amps.shape)
    amps = amps * 10.0 ** (float(recipe["amplitude_jitter_db"]) * jitter / 10.0)
    return SpatialGrid(
        fs=float(recipe["sample_rate"]), spacing_m=d,
        source=np.asarray(recipe["source_m"], np.float64), receivers=receivers,
        amplitudes=amps.astype(np.float32),
        decay_times=np.asarray(recipe["decay_times_s"], np.float64)[None, :],
        directions=dirs, band_hz=list(recipe["band_centre_hz"]),
        room_dims=[tuple(r["dims"]) for r in rooms],
        room_starts=[tuple(r["start"]) + (0.0,) for r in rooms])
