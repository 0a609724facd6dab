"""Minimal SOFA (Spatially Oriented Format for Acoustics) I/O via h5py
(port of ``diffgfdn_tpu/inference/sofa.py``).

Replaces the reference's sofar/soundfile stack (sofa_parser.py:265-532):
* :class:`HRIRSOFAReader` — reads SimpleFreeFieldHRIR-style files
  (Data.IR (M, R, N), SourcePosition (M, 3)), resampling, SH projection;
* :class:`SRIRSOFAWriter` — writes SingleRoomSRIR-style files;
* :func:`convert_srir_to_brir` — SRIR -> BRIR for head orientations.

SOFA files are netCDF4 (=HDF5); h5py reads them directly. Files we write
are netCDF4-conformant HDF5: every SOFA dimension (M, R, N, E, C, I) is an
HDF5 dimension-scale dataset carrying netCDF-c's ``CLASS``/``NAME``/
``_Netcdf4Dimid`` attribute contract, every variable attaches those scales
(producing the ``DIMENSION_LIST``/``REFERENCE_LIST`` pairs netCDF-c walks),
and the root carries ``_NCProperties`` plus the SingleRoomSRIR convention's
global metadata — so sofar / netCDF4-python / the Matlab SOFA API read the
files, not just this module. The files carry the same global metadata as
the JAX package's writer (``APIName``, ``_NCProperties``), so the two write
equal files for equal data.

The file I/O is host numpy and imports h5py inside the functions that read
or write: the rest of the module, and the conversion on the device, work
without it. :meth:`HRIRSOFAReader.from_arrays` builds a reader from arrays
in memory. :func:`convert_srir_to_brir` runs its FFTs and both einsums on
``device`` (CUDA unless the caller asks for the CPU) in complex64, a chunk
of receivers at a time.
"""

import datetime
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
from scipy.signal import resample_poly
import torch

from ..ops.sph import sh_matrix, sh_rotation_yaw_pitch_roll
from ..utils.device import resolve_device

logger = logging.getLogger("diffgfdn_torch")

# device bytes of one chunk's rotated spectra (P_chunk, O, F, Q) complex64 in
# convert_srir_to_brir; the other per-chunk buffers are smaller
BRIR_CHUNK_BYTES = 2 ** 30

# netCDF-c identifies a pure dimension (one with no same-named variable) by
# this NAME prefix on its dimension-scale dataset; the trailing %10d is the
# dimension length, exactly as netCDF-c and h5netcdf write it.
_NC_PHONY_DIM = "This is a netCDF dimension but not a netCDF variable."


class _NetCDF4Builder:
    """Write netCDF4-conformant structure into an open h5py file.

    netCDF4 is a strict subset of HDF5: named dimensions are HDF5
    dimension-scale datasets (``CLASS="DIMENSION_SCALE"`` plus netCDF-c's
    ``NAME`` and ``_Netcdf4Dimid`` attributes) and each variable axis is
    attached to its scale, which materialises the ``DIMENSION_LIST`` /
    ``REFERENCE_LIST`` attribute pair netCDF-c requires. This mirrors what
    sofar produces for the reference (sofa_parser.py:507-532 writes through
    sofar.write_sofa -> netCDF4).
    """

    def __init__(self, f):
        self.f = f
        self.scales: Dict[str, "object"] = {}
        # netCDF-c records its superblock properties here; readers only
        # check presence/prefix, writers identify themselves.
        f.attrs.create(
            "_NCProperties", np.bytes_("version=2,diffgfdn_tpu=0.1.0")
        )

    def dim(self, name: str, size: int):
        """Create a named dimension of ``size`` (a dimension-scale dataset)."""
        d = self.f.create_dataset(name, shape=(size,), dtype="f4")
        d.make_scale(f"{_NC_PHONY_DIM}{size:10d}")
        d.attrs.create("_Netcdf4Dimid", np.int32(len(self.scales)))
        self.scales[name] = d

    def var(
        self,
        name: str,
        data: np.ndarray,
        dims: Sequence[str],
        attrs: Optional[Dict[str, str]] = None,
    ):
        """Create a variable with its axes attached to named dimensions."""
        ds = self.f.create_dataset(name, data=data)
        for axis, dim_name in enumerate(dims):
            ds.dims[axis].attach_scale(self.scales[dim_name])
        for key, val in (attrs or {}).items():
            ds.attrs[key] = val
        return ds


def _fraction(ratio: float, max_den: int = 1000) -> Tuple[int, int]:
    from fractions import Fraction

    f = Fraction(ratio).limit_denominator(max_den)
    return f.numerator, f.denominator


class HRIRSOFAReader:
    """HRIR SOFA reader (listener-view HRIR sets).

    ``HRIRSOFAReader(path)`` reads a file (h5py); :meth:`from_arrays` builds
    the same reader from arrays in memory.
    """

    def __init__(self, path: Union[str, Path]):
        import h5py

        with h5py.File(str(path), "r") as f:
            ir_data = np.asarray(f["Data.IR"])  # (M, R, N)
            fs = np.asarray(f["Data.SamplingRate"]).ravel()
            source_position = np.asarray(f["SourcePosition"])
            listener_position = np.asarray(
                f["ListenerPosition"]
            ) if "ListenerPosition" in f else None
            spu = f["SourcePosition"].attrs.get("Units", b"")
            source_units = spu.decode() if isinstance(spu, bytes) else str(spu)
        self._set_state(ir_data, float(fs[0]), source_position, source_units,
                        listener_position)

    @classmethod
    def from_arrays(
        cls,
        ir_data: np.ndarray,
        fs: float,
        source_position: np.ndarray,
        source_units: str = "degree, degree, metre",
        listener_position: Optional[np.ndarray] = None,
    ) -> "HRIRSOFAReader":
        """A reader of ``ir_data`` (M, R, N) measured from ``source_position``
        (M, 3) in ``source_units``, as a file holding them would give."""
        reader = cls.__new__(cls)
        reader._set_state(np.asarray(ir_data), float(fs), np.asarray(source_position),
                          source_units, listener_position)
        return reader

    def _set_state(self, ir_data, fs, source_position, source_units, listener_position):
        self.ir_data = ir_data
        self.fs = fs
        self.source_position = source_position
        self.listener_position = listener_position
        self.source_units = source_units
        self.num_meas, self.num_receivers, self.ir_length = self.ir_data.shape

    @property
    def listener_view(self) -> np.ndarray:
        """(M, 3) direction of each measurement: (azi_deg, ele_deg, r)."""
        sp = self.source_position
        if "degree" in self.source_units or self.source_units == "":
            return sp
        # cartesian -> spherical degrees
        x, y, z = sp[:, 0], sp[:, 1], sp[:, 2]
        r = np.linalg.norm(sp, axis=-1)
        azi = np.rad2deg(np.arctan2(y, x))
        ele = np.rad2deg(np.arcsin(np.clip(z / np.maximum(r, 1e-9), -1, 1)))
        return np.stack([azi, ele, r], axis=-1)

    def resample_hrirs(self, new_fs: float):
        """Polyphase resample all HRIRs to ``new_fs``."""
        if new_fs == self.fs:
            return
        up, down = _fraction(new_fs / self.fs)
        self.ir_data = resample_poly(self.ir_data, up, down, axis=-1)
        self.fs = new_fs
        self.ir_length = self.ir_data.shape[-1]

    def get_ir_from_view(self, des_views_deg: np.ndarray) -> np.ndarray:
        """Nearest-measurement HRIRs for (azi_deg, ele_deg) queries."""
        des_views_deg = np.atleast_2d(des_views_deg)
        view = self.listener_view
        azi = np.deg2rad(view[:, 0])
        ele = np.deg2rad(view[:, 1])
        xyz = np.stack(
            [np.cos(ele) * np.cos(azi), np.cos(ele) * np.sin(azi), np.sin(ele)],
            axis=-1,
        )
        azi_q = np.deg2rad(des_views_deg[:, 0])
        ele_q = np.deg2rad(des_views_deg[:, 1])
        q = np.stack(
            [np.cos(ele_q) * np.cos(azi_q), np.cos(ele_q) * np.sin(azi_q),
             np.sin(ele_q)],
            axis=-1,
        )
        idx = np.argmax(xyz @ q.T, axis=0)
        return self.ir_data[idx]

    def get_spherical_harmonic_representation(self, ambi_order: int) -> np.ndarray:
        """SH-domain HRIRs: (n_sh, 2, T) via least-squares SH projection.

        Reference: sofa_parser.py:265-287 (Y^T-weighted fit).
        """
        fft_size = int(2 ** np.ceil(np.log2(self.ir_length)))
        hrtfs = np.fft.rfft(self.ir_data, fft_size, axis=-1)  # (M, R, F)
        azi = np.deg2rad(self.listener_view[:, 0])
        zen = np.deg2rad(90.0 - self.listener_view[:, 1])
        y = sh_matrix(ambi_order, azi, zen)  # (M, Q)
        # least squares: pinv handles non-uniform measurement grids
        proj = np.linalg.pinv(y)  # (Q, M)
        sh_hrtfs = np.einsum("nd,drf->nrf", proj, hrtfs)
        return np.fft.irfft(sh_hrtfs, fft_size, axis=-1)[..., : self.ir_length]


class SRIRSOFAWriter:
    """Write ambisonic SRIR sets as SingleRoomSRIR-style SOFA files."""

    def __init__(
        self,
        num_receivers: int,
        ambi_order: int,
        ir_length: int,
        samplerate: float = 48000.0,
    ):
        self.num_receivers = num_receivers
        self.ambi_order = ambi_order
        self.num_channels = (ambi_order + 1) ** 2
        self.ir_length = ir_length
        self.fs = float(samplerate)
        self.ir_data = np.zeros((num_receivers, self.num_channels, ir_length))
        self.receiver_positions = np.zeros((num_receivers, 3))
        self.source_positions = np.zeros((1, 3))

    def set_ir_data(self, irs: np.ndarray):
        assert irs.shape == self.ir_data.shape, (irs.shape, self.ir_data.shape)
        self.ir_data = np.asarray(irs)

    def set_receiver_positions(self, pos: np.ndarray):
        self.receiver_positions = np.atleast_2d(pos)

    def set_source_positions(self, pos: np.ndarray):
        self.source_positions = np.atleast_2d(pos)

    def resample_srirs(self, new_fs: float):
        if new_fs == self.fs:
            return
        up, down = _fraction(new_fs / self.fs)
        self.ir_data = resample_poly(self.ir_data, up, down, axis=-1)
        self.fs = new_fs
        self.ir_length = self.ir_data.shape[-1]

    def write_to_file(self, path: Union[str, Path]):
        """Write a netCDF4-conformant SingleRoomSRIR file.

        Matches the structure sofar produces for the reference
        (sofa_parser.py:290-449,507-532): the SingleRoomSRIR convention's
        mandatory global metadata, cartesian listener/source/receiver/emitter
        geometry with Type/Units attributes, and Data.IR of dims (M, R, N)
        with DataType "FIR" — all written as real netCDF4 (dimension scales
        attached on every variable axis) so external SOFA toolchains accept
        the file.
        """
        import h5py

        now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        cart = {"Type": "cartesian", "Units": "metre"}
        m, r, n = self.num_receivers, self.num_channels, self.ir_length
        with h5py.File(str(path), "w", track_order=True) as f:
            nc = _NetCDF4Builder(f)
            for k, v in {
                "Conventions": "SOFA",
                "Version": "2.1",
                "SOFAConventions": "SingleRoomSRIR",
                "SOFAConventionsVersion": "1.0",
                "APIName": "diffgfdn_tpu",
                "APIVersion": "0.1.0",
                "ApplicationName": "AmbisonicSRIRWriter",
                "AuthorContact": "",
                "Comment": f"ambisonics order {self.ambi_order}",
                "DataType": "FIR",
                "History": "",
                "License": (
                    "No license provided, ask the author for permission"
                ),
                "Organization": "",
                "References": "",
                "RoomType": "shoebox",
                "Origin": "",
                "DateCreated": now,
                "DateModified": now,
                "Title": "Ambisonic SRIR set",
                "DatabaseName": "",
                "RoomDescription": "",
            }.items():
                f.attrs[k] = v
            f.attrs.create("AmbisonicsOrder", np.int32(self.ambi_order))

            for name, size in (
                ("M", m), ("R", r), ("N", n), ("E", 1), ("C", 3), ("I", 1)
            ):
                nc.dim(name, size)

            facing_y = np.tile(
                np.array([0.0, 1.0, 0.0], np.float32), (r, 1)
            )[:, :, None]
            up_z = np.tile(
                np.array([0.0, 0.0, 1.0], np.float32), (r, 1)
            )[:, :, None]
            nc.var(
                "ListenerPosition",
                self.receiver_positions.astype(np.float64),
                ("M", "C"), cart,
            )
            nc.var(
                "ListenerView", np.array([[1.0, 0.0, 0.0]]), ("I", "C"), cart
            )
            nc.var("ListenerUp", np.array([[0.0, 0.0, 1.0]]), ("I", "C"))
            nc.var(
                "ReceiverPosition", np.zeros((r, 3, 1)), ("R", "C", "I"), cart
            )
            nc.var("ReceiverView", facing_y, ("R", "C", "I"), cart)
            nc.var("ReceiverUp", up_z, ("R", "C", "I"))
            # SourcePosition is (M, C): one source per measurement. A single
            # shared source is broadcast across all M measurements; a
            # per-measurement array is written as-is.
            src = np.atleast_2d(self.source_positions).astype(np.float64)
            if src.shape[0] == 1:
                src = np.tile(src, (m, 1))
            elif src.shape[0] != m:
                raise ValueError(
                    "SourcePosition must be one shared source or one per "
                    f"measurement: got {src.shape[0]} sources for {m} "
                    "measurements"
                )
            nc.var("SourcePosition", src, ("M", "C"), cart)
            nc.var(
                "SourceView", np.array([[1.0, 0.0, 0.0]]), ("I", "C"), cart
            )
            nc.var("SourceUp", np.array([[0.0, 0.0, 1.0]]), ("I", "C"))
            nc.var(
                "EmitterPosition", np.zeros((1, 3, 1)), ("E", "C", "I"), cart
            )
            nc.var("Data.IR", self.ir_data.astype(np.float64), ("M", "R", "N"))
            nc.var(
                "Data.SamplingRate",
                np.array([self.fs]),
                ("I",),
                {"Units": "hertz"},
            )
            nc.var("Data.Delay", np.zeros((1, r)), ("I", "R"))
            nc.var(
                "MeasurementDate", np.full(m, time.time()), ("M",)
            )
            desc = f.create_dataset(
                "ReceiverDescriptions",
                data=np.array(
                    ["AmbisonicChannel"] * r, dtype=h5py.string_dtype()
                ),
            )
            desc.dims[0].attach_scale(nc.scales["R"])
        logger.info("wrote SOFA file %s", path)


def convert_srir_to_brir(
    srirs: np.ndarray,
    hrtf_reader: HRIRSOFAReader,
    head_orientations: np.ndarray,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """SRIRs -> BRIRs for a set of head orientations.

    ``srirs``: (num_pos, (N+1)^2, T); ``head_orientations``: (num_ori, 2)
    yaw/pitch in radians. Returns host float64 (num_pos, num_ori, nfft, 2)
    (reference: sofa_parser.py:452-504).

    The SH rotation matrices are built on the host in float64 and uploaded
    once as (O, Q, Q); the SRIR spectra, both einsums and the irfft run on
    ``device`` in complex64 / float32, a chunk of receivers at a time, so
    that one chunk's rotated spectra stay within ``BRIR_CHUNK_BYTES``.
    """
    dev = resolve_device(device)
    srirs = np.asarray(srirs)
    ambi_order = int(np.sqrt(srirs.shape[1]) - 1)
    num_pos, num_sh, t_len = srirs.shape
    hrir_sh = hrtf_reader.get_spherical_harmonic_representation(ambi_order)
    # nfft covers the FULL linear convolution length T + hrir_len - 1
    # (the reference sizes to the SRIR alone, sofa_parser.py:467, wrapping
    # the conv tail onto the BRIR's direct-sound region)
    conv_len = t_len + hrir_sh.shape[-1] - 1
    nfft = int(2 ** np.ceil(np.log2(conv_len)))
    num_bins = nfft // 2 + 1
    # NB conj(HRTF): the reference beamforms with the conjugated HRTF
    # spectra (sofa_parser.py:498, sound_examples.py:466): for the real
    # HRIR-SH sets used here that is convolution with the time-REVERSED
    # HRIRs. Kept for output parity with the reference.
    hf_conj = torch.fft.rfft(
        torch.as_tensor(hrir_sh, dtype=torch.float32, device=dev), nfft, dim=-1
    ).conj()  # (Q, 2, F)
    num_ori = head_orientations.shape[0]
    rots = torch.as_tensor(np.stack([
        sh_rotation_yaw_pitch_roll(ambi_order, -o[0], -o[1], 0.0)
        for o in head_orientations
    ]), dtype=torch.complex64, device=dev)  # (O, Q, Q)

    chunk = max(1, BRIR_CHUNK_BYTES // (num_ori * num_bins * num_sh * 8))
    out = np.empty((num_pos, num_ori, nfft, 2), np.float64)
    for start in range(0, num_pos, chunk):
        stop = min(start + chunk, num_pos)
        x = torch.as_tensor(np.asarray(srirs[start:stop], np.float32), device=dev)
        rtfs = torch.fft.rfft(x, nfft, dim=-1)  # (P, Q, F)
        # rotated[p, o, f, q] = sum_n rtf[p, n, f] rot[o, q, n]
        rotated = torch.einsum("pnf,oqn->pofq", rtfs, rots)
        brtf = torch.einsum("nrf,pofn->pofr", hf_conj, rotated)
        brirs = torch.fft.irfft(brtf, nfft, dim=-2)  # (P, O, nfft, 2)
        out[start:stop] = brirs.cpu().numpy()
    return out
