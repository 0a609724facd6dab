"""RIR dataset containers and the three-room pickle parser (host numpy).

Port of ``diffgfdn_tpu/data/room_dataset.py``: a single RIR read from a wav
(:class:`RIRData`, for single-position fits) and the receiver grid
(:class:`RoomDataset`): parse once, compute spectra lazily on first access,
hand batches to the model.
"""

from dataclasses import dataclass
import pickle
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.fft import rfft, rfftfreq

from ..ops.basic import hann_fade_windows, ms_to_samps


@dataclass
class Meshgrid:
    """Flattened (x, y) floor-plan mesh of the coupled space."""

    xmesh: np.ndarray
    ymesh: np.ndarray

    @property
    def points(self) -> np.ndarray:
        """(L, 2) stacked mesh points."""
        return np.stack([self.xmesh, self.ymesh], axis=-1)


def _next_pow2(x: float) -> int:
    return int(2 ** np.ceil(np.log2(x)))


def early_split(
    rirs: np.ndarray, mixing_time_ms: float, fs: float, win_len_ms: float = 5.0
) -> np.ndarray:
    """Faded early segment (first mixing_time samples)."""
    mix = ms_to_samps(mixing_time_ms, fs)
    wl = ms_to_samps(win_len_ms, fs)
    _, fade_out = hann_fade_windows(wl)
    early = np.array(rirs[..., :mix])
    early[..., -(wl // 2):] *= fade_out
    return early


def late_split(
    rirs: np.ndarray, mixing_time_ms: float, fs: float, win_len_ms: float = 5.0
) -> np.ndarray:
    """Faded late segment (samples from the mixing time on)."""
    mix = ms_to_samps(mixing_time_ms, fs)
    wl = ms_to_samps(win_len_ms, fs)
    fade_in, _ = hann_fade_windows(wl)
    late = np.array(rirs[..., mix:])
    late[..., : wl // 2] *= fade_in
    return late


def early_late_split(
    rirs: np.ndarray, mixing_time_ms: float, fs: float, win_len_ms: float = 5.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Split RIRs at the mixing time with half-Hann crossfades: (early, late),
    early the first mixing-time samples and late the remainder."""
    return (
        early_split(rirs, mixing_time_ms, fs, win_len_ms),
        late_split(rirs, mixing_time_ms, fs, win_len_ms),
    )


@dataclass
class RIRData:
    """A single measured or simulated RIR with its spectral representations."""

    rir: np.ndarray
    sample_rate: float
    common_decay_times: np.ndarray
    band_centre_hz: Optional[np.ndarray] = None
    amplitudes: Optional[np.ndarray] = None
    room_dims: Optional[List] = None
    absorption_coeffs: Optional[List] = None
    mixing_time_ms: float = 20.0
    nfft: Optional[int] = None

    @staticmethod
    def from_wav(wav_path: Union[str, Path], **kwargs) -> "RIRData":
        """Load the RIR from a wav file."""
        from .audio import read_wav

        rir, fs = read_wav(wav_path)
        return RIRData(rir=rir, sample_rate=fs, **kwargs)

    @property
    def num_freq_bins(self) -> int:
        """nfft: as given, else the next power of 2 of the longest decay time."""
        if self.nfft is not None:
            return self.nfft
        return _next_pow2(float(np.max(self.common_decay_times)) * self.sample_rate)

    @property
    def freq_bins_rad(self) -> np.ndarray:
        return rfftfreq(self.num_freq_bins) * 2 * np.pi

    @property
    def rir_mag_response(self) -> np.ndarray:
        return rfft(self.rir, n=self.num_freq_bins)

    def split_responses(self) -> Tuple[np.ndarray, np.ndarray]:
        """(early, late) frequency responses after the crossfaded split."""
        early, late = early_late_split(self.rir, self.mixing_time_ms, self.sample_rate)
        return rfft(early, n=self.num_freq_bins), rfft(late, n=self.num_freq_bins)


class RoomDataset:
    """A grid of RIR measurements over receiver positions.

    Spectra are computed on first access and cached.
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
        mixing_time_ms: float = 20.0,
        nfft: Optional[int] = None,
        grid_spacing_m: float = 0.3,
    ):
        self.num_rooms = num_rooms
        self.sample_rate = sample_rate
        self.source_position = np.atleast_2d(np.asarray(source_position))
        self.receiver_position = np.asarray(receiver_position)
        self.rirs = np.asarray(rirs)
        self.common_decay_times = np.asarray(common_decay_times)
        self.band_centre_hz = band_centre_hz
        self.amplitudes = amplitudes
        self.noise_floor = noise_floor
        self.room_dims = room_dims
        self.room_start_coord = room_start_coord
        self.mixing_time_ms = mixing_time_ms
        self.nfft = nfft
        self.grid_spacing_m = grid_spacing_m
        self._eps = 1e-12
        self.num_rec = self.receiver_position.shape[0]
        self.rir_length = self.rirs.shape[-1]
        self._rirs32 = np.ascontiguousarray(self.rirs, dtype=np.float32)
        self._lazy = {}
        self.mesh_2d = self.get_2d_meshgrid()

    @property
    def rirs32(self) -> np.ndarray:
        """Contiguous float32 time-domain RIRs (R, T)."""
        return self._rirs32

    @property
    def early_rir_time(self) -> np.ndarray:
        """Faded early segment (R, mixing time samples), cached."""
        if "early_t" not in self._lazy:
            self._lazy["early_t"] = early_split(
                self._rirs32, self.mixing_time_ms, self.sample_rate
            )
        return self._lazy["early_t"]

    @property
    def rir_mag_response(self) -> np.ndarray:
        if "rir" not in self._lazy:
            self._lazy["rir"] = rfft(self._rirs32, n=self.num_freq_bins, axis=-1)
        return self._lazy["rir"]

    @property
    def early_rir_mag_response(self) -> np.ndarray:
        if "early" not in self._lazy:
            self._lazy["early"] = rfft(self.early_rir_time, n=self.num_freq_bins, axis=-1)
        return self._lazy["early"]

    @property
    def late_rir_mag_response(self) -> np.ndarray:
        if "late" not in self._lazy:
            late = late_split(self._rirs32, self.mixing_time_ms, self.sample_rate)
            self._lazy["late"] = rfft(late, n=self.num_freq_bins, axis=-1)
        return self._lazy["late"]

    @property
    def num_freq_bins(self) -> int:
        if self.nfft is not None:
            return self.nfft
        max_rt60_samps = float(np.max(self.common_decay_times)) * self.sample_rate
        return _next_pow2(max_rt60_samps)

    @property
    def freq_bins_rad(self) -> np.ndarray:
        return rfftfreq(self.num_freq_bins) * 2 * np.pi

    @property
    def norm_receiver_position(self) -> np.ndarray:
        """Receiver coordinates min-max normalized to [0, 1] per axis."""
        p = self.receiver_position
        lo = p.min(axis=0, keepdims=True)
        hi = p.max(axis=0, keepdims=True)
        return (p - lo) / (hi - lo + self._eps)

    def find_rec_idx(self, rec_pos_list: np.ndarray) -> np.ndarray:
        """Nearest dataset receiver index for each query position."""
        d = np.linalg.norm(
            self.receiver_position[:, None, :] - np.atleast_2d(rec_pos_list), axis=2
        )
        return np.argmin(d, axis=0)

    def get_2d_meshgrid(self) -> Meshgrid:
        """Union of per-room uniform floor-plan grids."""
        xs, ys = [], []
        for nroom in range(self.num_rooms):
            nx = int(self.room_dims[nroom][0] / self.grid_spacing_m)
            ny = int(self.room_dims[nroom][1] / self.grid_spacing_m)
            x = np.linspace(
                self.room_start_coord[nroom][0],
                self.room_start_coord[nroom][0] + self.room_dims[nroom][0],
                nx,
            )
            y = np.linspace(
                self.room_start_coord[nroom][1],
                self.room_start_coord[nroom][1] + self.room_dims[nroom][1],
                ny,
            )
            xm, ym = np.meshgrid(x, y)
            xs.append(xm.ravel())
            ys.append(ym.ravel())
        return Meshgrid(np.concatenate(xs), np.concatenate(ys))


# Three-room coupled-space geometry of the Treble FDTD dataset
THREE_ROOM_DIMS = [(4.0, 8.0, 3.0), (6.0, 3.0, 3.0), (4.0, 8.0, 3.0)]
THREE_ROOM_START = [(0.0, 0.0, 0.0), (4.0, 2.0, 0.0), (6.0, 5.0, 0.0)]


class ThreeRoomDataset(RoomDataset):
    """Parser for the three-coupled-room SRIR pickle (``srirs.pkl`` schema)."""

    def __init__(self, filepath: Union[str, Path], nfft: Optional[int] = None):
        filepath = str(filepath)
        if not filepath.endswith(".pkl"):
            raise ValueError("provide the path to the .pkl file")
        with open(filepath, "rb") as f:
            srir_mat = pickle.load(f)
        super().__init__(
            num_rooms=3,
            sample_rate=srir_mat["fs"],
            source_position=np.asarray(srir_mat["srcPos"]).T,
            receiver_position=np.asarray(srir_mat["rcvPos"]).T,
            rirs=np.squeeze(np.asarray(srir_mat["srirs"])),
            common_decay_times=np.asarray(srir_mat["common_decay_times"]),
            room_dims=THREE_ROOM_DIMS,
            room_start_coord=THREE_ROOM_START,
            band_centre_hz=srir_mat.get("band_centre_hz"),
            amplitudes=np.asarray(srir_mat["amplitudes"]).T,
            noise_floor=np.asarray(srir_mat["noise_floor"]).T,
            nfft=nfft,
            grid_spacing_m=0.3,
        )
