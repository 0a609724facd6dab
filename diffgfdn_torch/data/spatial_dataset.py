"""Spatial (directional) SRIR datasets, the grid-resolution split and a synthetic generator.

Port of ``diffgfdn_tpu/data/spatial_dataset.py`` (the directional trainer's
subset), host numpy: :class:`SpatialRoomDataset` and its three-room pickle
parser, :func:`arrays_from_spatial_dataset`, :func:`split_by_grid_resolution`
and :func:`generate_spatial_three_room_pickle`, whose numbers equal the JAX
package's for a seed.

The directional and common-slopes trainers read the positions and the
common-slope amplitudes (R, J, num_slopes) only; serving replaces the
receivers and RIRs of a copy (:meth:`SpatialRoomDataset.update_receiver_pos`,
:meth:`SpatialRoomDataset.update_rirs`). The three target spectra of
:func:`arrays_from_spatial_dataset` are computed lazily, on first read: at
847 receivers, 9 SH channels and 65537 bins each is some 4 GB of host memory.
The floor-plan CNN reads the receivers as a 2-D grid: the floor mask
(:meth:`SpatialRoomDataset.get_binary_mask`), the grid's inputs and targets
(:func:`create_2d_grid_data`) and square patches of it
(:func:`square_patch_indices`).
"""

import math
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
from scipy.fft import rfftfreq
from scipy.interpolate import griddata

from ..ops.basic import LOG10E6
from ..ops.sph import t_design_directions
from .batching import BatchArrays
from .room_dataset import (
    early_split,
    late_split,
    THREE_ROOM_APERTURES,
    THREE_ROOM_DIMS,
    THREE_ROOM_START,
)
from .synthetic import room_centers, synthesize_amplitudes


class SpatialRoomDataset:
    """SRIR grid dataset: directional / ambisonic RIRs and common-slope amplitudes.

    ``rirs``: (num_rec, num_channels, T); ``amplitudes``:
    (num_rec, num_directions, num_slopes); ``sph_directions``: (2, J)
    (azimuth, elevation) in radians.
    """

    def __init__(
        self,
        num_rooms: int,
        sample_rate: float,
        source_position: np.ndarray,
        receiver_position: np.ndarray,
        rirs: np.ndarray,
        common_decay_times: np.ndarray,
        room_dims: List,
        room_start_coord: List,
        band_centre_hz=None,
        amplitudes: Optional[np.ndarray] = None,
        noise_floor: Optional[np.ndarray] = None,
        sph_directions: Optional[np.ndarray] = None,
        ambi_order: Optional[int] = None,
        grid_spacing_m: float = 0.3,
        mixing_time_ms: float = 50.0,
        aperture_coords: Optional[List] = None,
    ):
        self.num_rooms = num_rooms
        self.sample_rate = sample_rate
        self.source_position = np.atleast_2d(np.asarray(source_position))
        self.receiver_position = np.asarray(receiver_position)
        self.rirs = np.asarray(rirs)
        self.common_decay_times = np.asarray(common_decay_times)
        self.band_centre_hz = band_centre_hz
        self.amplitudes = None if amplitudes is None else np.asarray(amplitudes)
        self.noise_floor = noise_floor
        self.room_dims = room_dims
        self.room_start_coord = room_start_coord
        self.aperture_coords = aperture_coords  # the floor plan's openings, for plots
        self.sph_directions = sph_directions
        self.ambi_order = ambi_order
        self.grid_spacing_m = grid_spacing_m
        self.mixing_time_ms = mixing_time_ms
        self._eps = 1e-12
        self.num_rec = self.receiver_position.shape[0]
        self.rir_length = self.rirs.shape[-1]

    @property
    def desired_directions(self) -> Optional[np.ndarray]:
        """(2, J) (azimuth, elevation) pairs for the beamformer design."""
        return self.sph_directions

    @property
    def norm_receiver_position(self) -> np.ndarray:
        p = self.receiver_position
        lo = p.min(axis=0, keepdims=True)
        hi = p.max(axis=0, keepdims=True)
        return (p - lo) / (hi - lo + self._eps)

    @property
    def num_freq_bins(self) -> int:
        """nfft: the next power of two above the longest decay time in samples."""
        max_rt60_samps = float(np.max(self.common_decay_times)) * self.sample_rate
        return int(2 ** np.ceil(np.log2(max_rt60_samps)))

    @property
    def freq_bins_rad(self) -> np.ndarray:
        return rfftfreq(self.num_freq_bins) * 2 * np.pi

    @property
    def freq_bins_hz(self) -> np.ndarray:
        return rfftfreq(self.num_freq_bins, d=1.0 / self.sample_rate)

    def find_rec_idx(self, rec_pos_list: np.ndarray) -> np.ndarray:
        """Index of the dataset receiver nearest each query position."""
        d = np.linalg.norm(
            self.receiver_position[:, None, :] - np.atleast_2d(rec_pos_list), axis=2
        )
        return np.argmin(d, axis=0)

    def update_receiver_pos(self, new_receiver_pos: np.ndarray) -> None:
        self.receiver_position = np.asarray(new_receiver_pos)
        self.num_rec = self.receiver_position.shape[0]

    def update_rirs(self, new_rirs: np.ndarray) -> None:
        self.rirs = np.asarray(new_rirs)
        self.rir_length = self.rirs.shape[-1]

    def split_rirs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(early, late) time-domain split with crossfades at the mixing time."""
        return (early_split(self.rirs, self.mixing_time_ms, self.sample_rate),
                late_split(self.rirs, self.mixing_time_ms, self.sample_rate))

    def get_binary_mask(self, mesh_2d: np.ndarray) -> np.ndarray:
        """True where the (..., 2) mesh points lie inside a room's floor plan
        (the rooms' edges included)."""
        x, y = mesh_2d[..., 0], mesh_2d[..., 1]
        mask = np.zeros(x.shape, dtype=bool)
        for i in range(self.num_rooms):
            sx, sy = self.room_start_coord[i][:2]
            w, h = self.room_dims[i][:2]
            mask |= (x >= sx) & (x <= sx + w) & (y >= sy) & (y <= sy + h)
        return mask


class SpatialThreeRoomDataset(SpatialRoomDataset):
    """Parser for the directional three-room SRIR pickle."""

    def __init__(self, filepath: Union[str, Path]):
        filepath = str(filepath)
        if not filepath.endswith(".pkl"):
            raise ValueError("provide the path to the .pkl file")
        with open(filepath, "rb") as f:
            srir_mat = pickle.load(f)
        sph_directions = (
            np.deg2rad(srir_mat["directions"]) if "directions" in srir_mat else None
        )
        amps_key = "amplitudes_norm" if "amplitudes_norm" in srir_mat else "amplitudes"
        nf_key = "noise_floor_norm" if "noise_floor_norm" in srir_mat else "noise_floor"
        super().__init__(
            num_rooms=3,
            sample_rate=srir_mat["fs"],
            source_position=np.asarray(srir_mat["srcPos"]).T,
            receiver_position=np.asarray(srir_mat["rcvPos"]).T,
            rirs=np.squeeze(np.asarray(srir_mat["srirs"])).T,
            common_decay_times=np.asarray(srir_mat["common_decay_times"]),
            room_dims=THREE_ROOM_DIMS,
            room_start_coord=THREE_ROOM_START,
            aperture_coords=THREE_ROOM_APERTURES,
            band_centre_hz=srir_mat.get("band_centre_hz"),
            amplitudes=np.asarray(srir_mat[amps_key]).T,
            noise_floor=np.asarray(srir_mat[nf_key]).T,
            sph_directions=sph_directions,
            ambi_order=2,
            grid_spacing_m=0.3,
        )


def arrays_from_spatial_dataset(
    room_data: SpatialRoomDataset, new_sampling_radius: Optional[float] = None
) -> BatchArrays:
    """Flatten a SpatialRoomDataset into batch arrays: z, positions and the
    common-slope amplitudes (the directional trainer's targets); the (R, L, F)
    spectra of the early, late and whole RIRs are computed on first read."""
    radius = 1.0 if new_sampling_radius in (None, 1.0) else new_sampling_radius
    z = (radius * np.exp(1j * room_data.freq_bins_rad)).astype(np.complex64)
    src = room_data.source_position.astype(np.float32)
    if src.shape[0] == 1:
        src = np.broadcast_to(src, (room_data.num_rec, 3)).copy()
    nfft = room_data.num_freq_bins

    def spectrum(part: Optional[int]):
        def compute() -> np.ndarray:
            rirs = room_data.rirs if part is None else room_data.split_rirs()[part]
            return np.fft.rfft(rirs, nfft, axis=-1).astype(np.complex64)
        return compute

    return BatchArrays(
        z_values=z,
        source_position=src,
        listener_position=room_data.receiver_position.astype(np.float32),
        norm_listener_position=room_data.norm_receiver_position.astype(np.float32),
        target_early_response=spectrum(0),
        target_late_response=spectrum(1),
        target_rir_response=spectrum(None),
        target_common_slope_amps=(
            None if room_data.amplitudes is None
            else np.asarray(room_data.amplitudes, np.float32)
        ),
    )


def find_start_coords(room_data: SpatialRoomDataset) -> Tuple[np.ndarray, np.ndarray]:
    """First receiver location found in each room (the split's anchor points);
    a room with no receivers is anchored at its own start coordinate."""
    nr = room_data.num_rooms
    sx = np.empty(nr)
    sy = np.empty(nr)
    for k in range(nr):
        rsx, rsy = room_data.room_start_coord[k][:2]
        w, h = room_data.room_dims[k][:2]
        sx[k], sy[k] = rsx, rsy
        for idx in range(room_data.num_rec):
            x, y = room_data.receiver_position[idx, :2]
            if rsx <= x < rsx + w and rsy <= y < rsy + h:
                sx[k], sy[k] = x, y
                break
    return sx, sy


def split_by_grid_resolution(
    room_data: SpatialRoomDataset, x_d: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_indices, valid_indices): the receivers on an every-``x_d``-metre
    subgrid anchored at each room's first receiver train, the rest validate."""
    if x_d < room_data.grid_spacing_m:
        raise ValueError("desired grid spacing must be >= the measured grid spacing")

    def is_multiple(value, d, tol=1e-6):
        return math.isclose(value / d, round(value / d), abs_tol=tol)

    sx, sy = find_start_coords(room_data)

    def room_of(x, y, eps=0.0):
        for k in range(room_data.num_rooms):
            rsx, rsy = room_data.room_start_coord[k][:2]
            w, h = room_data.room_dims[k][:2]
            if rsx - eps <= x < rsx + w + eps and rsy - eps <= y < rsy + h + eps:
                return k
        return -1

    train_idx, valid_idx = [], []
    for idx in range(room_data.num_rec):
        x, y = room_data.receiver_position[idx, :2]
        room = room_of(x, y)
        if room == -1:  # far-wall receivers: the rooms' upper bounds are exclusive
            room = room_of(x, y, eps=1e-6)
        if room == -1:
            raise ValueError(
                f"receiver {idx} at ({x:g}, {y:g}) lies in no room: cannot anchor the grid split"
            )
        xc, yc = x - sx[room], y - sy[room]
        if is_multiple(xc, x_d) and is_multiple(yc, x_d):
            train_idx.append(idx)
        else:
            valid_idx.append(idx)
    return np.asarray(train_idx), np.asarray(valid_idx)


def create_2d_grid_data(
    room_data: SpatialRoomDataset, indices: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The CNN's 2-D inputs and targets from a set of receiver indices.

    The grid is the product of the receivers' distinct x and y coordinates.
    Returns float32 (mesh (H, W, 2), normalized mesh (H, W, 2), labels
    (H*W, J, num_slopes)): every cell takes the amplitudes of the nearest
    dataset receiver (any receiver, not only ``indices``), and cells outside
    the floor plan take zeros.
    """
    pos = room_data.receiver_position[indices]
    norm = room_data.norm_receiver_position[indices]
    xm, ym = np.meshgrid(np.unique(pos[:, 0]), np.unique(pos[:, 1]))
    mesh = np.stack([xm, ym], axis=-1)
    xn, yn = np.meshgrid(np.unique(norm[:, 0]), np.unique(norm[:, 1]))
    norm_mesh = np.stack([xn, yn], axis=-1)

    labels = room_data.amplitudes  # (R, J, num_slopes)
    interp = griddata(
        (room_data.receiver_position[:, 0], room_data.receiver_position[:, 1]),
        labels, (mesh[..., 0], mesh[..., 1]), method="nearest",
    )
    interp[~room_data.get_binary_mask(mesh), ...] = 0.0
    h, w = mesh.shape[:2]
    return (mesh.astype(np.float32), norm_mesh.astype(np.float32),
            interp.reshape(h * w, *labels.shape[1:]).astype(np.float32))


def square_patch_indices(
    coords: np.ndarray,
    patch_size: int,
    grid_spacing_m: float,
    step_size: int = 1,
    drop_incomplete: bool = False,
    shuffle: bool = False,
    seed: Optional[int] = None,
) -> List[np.ndarray]:
    """Square 2-D patches of receiver indices for CNN batching.

    ``coords``: (R, >=2) receiver coordinates on a (possibly incomplete)
    uniform ``grid_spacing_m`` grid. A patch of ``patch_size`` x
    ``patch_size`` cells starts at every ``step_size``-th cell and holds the
    indices of the receivers in it (x outer, y inner); empty patches are
    left out, and with ``drop_incomplete`` those missing a receiver too.
    ``shuffle`` orders them by ``np.random.RandomState(seed)``.
    """
    xy = np.round(coords[:, :2] / grid_spacing_m).astype(np.int64)
    xy -= xy.min(axis=0, keepdims=True)
    occupancy: Dict[Tuple[int, int], int] = {(int(x), int(y)): i for i, (x, y) in enumerate(xy)}
    nx, ny = xy.max(axis=0) + 1
    patches = []
    for px in range(0, int(nx), step_size):
        for py in range(0, int(ny), step_size):
            idx = [occupancy[(px + dx, py + dy)] for dx in range(patch_size)
                   for dy in range(patch_size) if (px + dx, py + dy) in occupancy]
            if not idx or (drop_incomplete and len(idx) < patch_size ** 2):
                continue
            patches.append(np.asarray(idx))
    if shuffle:
        rng = np.random.RandomState(seed)
        patches = [patches[i] for i in rng.permutation(len(patches))]
    return patches


def generate_spatial_three_room_pickle(
    path: Union[str, Path],
    fs: float = 8000.0,
    grid_spacing_m: float = 0.6,
    rir_len_s: float = 0.75,
    decay_times: Tuple[float, float, float] = (0.3, 0.6, 0.45),
    seed: int = 0,
) -> Path:
    """Synthetic directional SRIR dataset on a uniform grid.

    Receivers lie on a uniform ``grid_spacing_m`` grid (so grid-resolution
    splits work); amplitudes vary per direction (the 12 t-design
    directions) and per room; RIRs are 2nd-order ambisonic shaped noise.
    """
    rng = np.random.RandomState(seed)
    rec = []
    for k in range(3):
        sx, sy = THREE_ROOM_START[k][:2]
        w, h = THREE_ROOM_DIMS[k][:2]
        xs = np.arange(sx + grid_spacing_m, sx + w - 1e-6, grid_spacing_m)
        ys = np.arange(sy + grid_spacing_m, sy + h - 1e-6, grid_spacing_m)
        xm, ym = np.meshgrid(xs, ys)
        rec.append(np.stack([xm.ravel(), ym.ravel(), np.full(xm.size, 1.5)], axis=-1))
    receiver_pos = np.concatenate(rec, axis=0)
    num_rec = receiver_pos.shape[0]

    dirs = t_design_directions(5)  # (2, 12): (azi, colat)
    directions_deg = np.rad2deg(np.stack([dirs[0], np.pi / 2 - dirs[1]]))  # (azi, elevation)

    omni_amps = synthesize_amplitudes(receiver_pos)  # (R, 3)
    # each room's energy comes mostly from the direction of that room's centre
    to_room = room_centers()[None, :, :] - receiver_pos[:, None, :2]  # (R, 3, 2)
    room_azi = np.arctan2(to_room[..., 1], to_room[..., 0])  # (R, 3)
    ang = np.cos(room_azi[:, None, :] - dirs[0][None, :, None])  # (R, J, 3)
    amps = omni_amps[:, None, :] * (0.5 + 0.5 * np.clip(ang, 0, None))  # (R, J, 3)

    t_len = int(rir_len_s * fs)
    t = np.arange(t_len) / fs
    decay = np.exp(-t[None, :] * (LOG10E6 / np.asarray(decay_times))[:, None])
    env = np.einsum("rk,kt->rt", omni_amps, decay)
    n_ch = 9  # 2nd-order ambisonics
    rirs = rng.randn(num_rec, n_ch, t_len) * np.sqrt(env)[:, None, :]
    rirs[:, 0, 0] += 1.0

    data = {
        "fs": fs,
        "srcPos": np.array([[2.0], [4.0], [1.5]]),
        "rcvPos": receiver_pos.T,
        "srirs": rirs.T,
        "band_centre_hz": [1000.0],
        "common_decay_times": np.asarray(decay_times)[None, :],
        "amplitudes_norm": amps.T,
        "noise_floor_norm": np.full((num_rec, amps.shape[1], 1), 1e-6).T,
        "directions": directions_deg,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path
