"""CLI: MATLAB v7.3 SRIR sets -> the training pickles (port of
``cli/convert_dataset.py``).

    python -m diffgfdn_torch.cli.convert_dataset <srirs.mat> <srirs.pkl>
        [--ambi [--ambi-order N]] [--per-band-dir DIR] [--device cpu]

Reads a MATLAB v7.3 (HDF5) SRIR file (h5py, imported when a file is read),
estimates per-band common-slope amplitudes by least squares on the octave
bands of each RIR (``analysis.py``, host float64), and writes the pickle
that the grid trainers read; ``--per-band-dir`` adds one pickle a band.
``--ambi`` beamforms SH SRIRs into the t-design's directions with the SH
analysis filterbank (``ops/sph.py``) and writes the spatial trainers'
pickle. The beamforming product runs in float64 on CUDA unless ``--device
cpu`` is given; the device is resolved before anything is read or written.
"""

import argparse
import logging
from pathlib import Path
import pickle
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..analysis import calculate_amplitudes_least_squares, octave_filtering
from ..config.schema import BeamformerType
from ..ops.sph import design_sph_filterbank, modal_weights, t_design_directions
from ..utils.device import resolve_device

logger = logging.getLogger("diffgfdn_torch")

DEFAULT_BANDS = [63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0]


def load_mat_v73(path) -> Dict[str, np.ndarray]:
    """Every dataset of a MATLAB v7.3 (HDF5) file, by its last path part."""
    import h5py

    out = {}
    with h5py.File(str(path), "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name.split("/")[-1]] = np.asarray(obj)

        f.visititems(visit)
    return out


def estimate_band_amplitudes(
    rirs: np.ndarray,
    common_decay_times: np.ndarray,
    band_centre_hz: List[float],
    fs: float,
    mixing_time_ms: float = 20.0,
) -> np.ndarray:
    """(num_rec, num_slopes, num_bands) least-squares common-slope amplitudes
    of each RIR after the mixing time. ``common_decay_times``: (n_slopes,),
    (1, n_slopes) or (n_slopes, n_bands)."""
    common_decay_times = np.squeeze(np.asarray(common_decay_times))
    mix = int(mixing_time_ms * 1e-3 * fs)
    amps = []
    for r in range(rirs.shape[0]):
        trunc = rirs[r, mix:]
        if len(trunc) % 2:
            trunc = trunc[1:]
        filtered = octave_filtering(trunc, fs, band_centre_hz)
        a = calculate_amplitudes_least_squares(common_decay_times, fs, filtered, band_centre_hz)
        amps.append(a[0])
    return np.stack(amps, axis=0)


def process_srirs_to_directional(
    srirs: np.ndarray,
    ambi_order: int,
    desired_directions: Optional[np.ndarray] = None,
    beamformer_type: BeamformerType = BeamformerType.MAX_DI,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Ambisonic SRIRs (num_rec, (N+1)^2, T) -> directional RIRs (num_rec,
    J, T) through the SH analysis filterbank steered to
    ``desired_directions`` (2, J) as (azimuth, elevation), by default the
    t-design of degree 2N + 1. The product runs in float64 on ``device``;
    returns host float64."""
    dev = resolve_device(device)
    if desired_directions is None:
        dirs = t_design_directions(2 * ambi_order + 1)
        desired_directions = np.stack([dirs[0], np.pi / 2 - dirs[1]])
    c_n = modal_weights(beamformer_type, ambi_order)
    analysis, _ = design_sph_filterbank(ambi_order, desired_directions[0],
                                        np.pi / 2 - desired_directions[1], c_n, mode="energy")
    a = torch.as_tensor(analysis, dtype=torch.float64, device=dev)
    x = torch.as_tensor(np.asarray(srirs), dtype=torch.float64, device=dev)
    return torch.einsum("jq,rqt->rjt", a, x).cpu().numpy()


def convert_mat_to_pkl(
    mat_path,
    out_path,
    band_centre_hz: Optional[List[float]] = None,
    per_band_dir: Optional[str] = None,
    mixing_time_ms: float = 20.0,
) -> Path:
    """Omni conversion: .mat -> srirs.pkl (and one pickle a band under
    ``per_band_dir``); host numpy."""
    band_centre_hz = band_centre_hz or DEFAULT_BANDS
    mat = load_mat_v73(mat_path)
    fs = float(np.asarray(mat["fs"]).ravel()[0])
    rirs = np.atleast_2d(np.squeeze(mat["srirs"]))
    if rirs.shape[0] > rirs.shape[-1]:
        rirs = rirs.T  # (num_rec, T)
    cdt = np.asarray(mat["common_decay_times"])

    amps = estimate_band_amplitudes(rirs, cdt, band_centre_hz, fs, mixing_time_ms)
    data = {
        "fs": fs,
        "srcPos": np.asarray(mat["srcPos"]),
        "rcvPos": np.asarray(mat["rcvPos"]),
        "srirs": rirs,
        "band_centre_hz": band_centre_hz,
        "common_decay_times": cdt,
        "amplitudes": amps.mean(-1).T,  # broadband (slopes, R)
        "noise_floor": np.full((1, rirs.shape[0]), 1e-6),
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(data, f)

    if per_band_dir is not None:
        per_band_dir = Path(per_band_dir)
        per_band_dir.mkdir(parents=True, exist_ok=True)
        for b, fc in enumerate(band_centre_hz):
            band_data = dict(data)
            band_data["srirs"] = np.stack([octave_filtering(r, fs, [fc])[:, 0] for r in rirs])
            band_data["band_centre_hz"] = fc
            band_data["amplitudes"] = amps[..., b].T
            with open(per_band_dir / f"srirs_band={fc:.0f}Hz.pkl", "wb") as f:
                pickle.dump(band_data, f)
    return out_path


def convert_mat_to_pkl_ambi(
    mat_path,
    out_path,
    ambi_order: int = 2,
    band_centre_hz: Optional[List[float]] = None,
    mixing_time_ms: float = 20.0,
    device: Union[str, torch.device] = "cuda",
) -> Path:
    """Ambisonic conversion: SH SRIRs -> the directional common-slopes
    dataset pickle (the beamforming on ``device``)."""
    dev = resolve_device(device)
    band_centre_hz = band_centre_hz or DEFAULT_BANDS
    mat = load_mat_v73(mat_path)
    fs = float(np.asarray(mat["fs"]).ravel()[0])
    srirs = np.asarray(mat["srirs"])
    n_sh = (ambi_order + 1) ** 2
    if n_sh not in srirs.shape:
        raise ValueError(
            f"no axis of size (ambi_order+1)^2={n_sh} in srirs shape "
            f"{srirs.shape} — wrong --ambi-order for this file?"
        )
    sh_axis = srirs.shape.index(n_sh)
    if sh_axis != 1:
        srirs = np.moveaxis(srirs, sh_axis, 1)
    # time is the longest remaining axis (h5py reverses MATLAB's order, so a
    # (num_rec, n_sh, T) file reads as (T, n_sh, num_rec))
    if srirs.shape[0] > srirs.shape[-1]:
        srirs = srirs.transpose(2, 1, 0)
    cdt = np.asarray(mat["common_decay_times"])

    dirs = t_design_directions(2 * ambi_order + 1)
    desired = np.stack([dirs[0], np.pi / 2 - dirs[1]])
    drirs = process_srirs_to_directional(srirs, ambi_order, desired, device=dev)

    num_rec, num_dirs, _ = drirs.shape
    # the slope axis sized from the estimator's own output
    first = estimate_band_amplitudes(drirs[:, 0], cdt, band_centre_hz, fs, mixing_time_ms)
    amps = np.zeros((num_rec, num_dirs) + first.shape[1:])
    amps[:, 0] = first
    for j in range(1, num_dirs):
        amps[:, j] = estimate_band_amplitudes(drirs[:, j], cdt, band_centre_hz, fs,
                                              mixing_time_ms)
    data = {
        "fs": fs,
        "srcPos": np.asarray(mat["srcPos"]),
        "rcvPos": np.asarray(mat["rcvPos"]),
        "srirs": srirs.T,
        "band_centre_hz": band_centre_hz,
        "common_decay_times": cdt,
        "amplitudes_norm": amps.mean(-1).T,
        "noise_floor_norm": np.full((num_rec, num_dirs, 1), 1e-6).T,
        "directions": np.rad2deg(desired),
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(data, f)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert .mat SRIRs to pkl")
    parser.add_argument("mat_path")
    parser.add_argument("out_path")
    parser.add_argument("--ambi", action="store_true")
    parser.add_argument("--ambi-order", type=int, default=2)
    parser.add_argument("--per-band-dir", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # raises before anything is written
    logging.basicConfig(level=logging.INFO)
    if args.ambi:
        convert_mat_to_pkl_ambi(args.mat_path, args.out_path, args.ambi_order, device=device)
    else:
        convert_mat_to_pkl(args.mat_path, args.out_path, per_band_dir=args.per_band_dir)


if __name__ == "__main__":
    main()
