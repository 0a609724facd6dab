"""Rank-1 CS amplitude decomposition drives a TRAINED-FREE GFDN render.

Port of ``examples/low_rank_study.py`` (the reference's
``notebooks/low_rank_amplitude_matrix_decomposition.ipynb``): factor the
(num_src x num_rec) common-slopes amplitude matrix per slope with a rank-1
SVD and use the factors as the input / output gains of a GFDN WITHOUT ANY
TRAINING; position dependence separates into source gains x receiver gains.

1. synthesize a near-rank-1 multi-source CS amplitude tensor on the
   three-room grid (the product structure + small perturbation);
2. ``low_rank.get_source_receiver_gains`` -> per-slope source / receiver
   gains + explained-variance ratios (near 1 when the separation holds);
3. calibrate each group's kernel energy scale rho_k once from a unit-gain
   probe's Schroeder EDC, then render every (src, rec) pair through
   ``synthesize_rirs_time_domain`` (the time-domain kernel on CUDA tensors)
   with the rank-1 gains as input / output scalars, no training anywhere;
4. compare each rendered RIR's EDC (dB) with the ANALYTIC common-slopes EDC
   of the true amplitudes, mapped over the floor plan.

:func:`low_rank_render` returns the numbers, :func:`draw_error_map` the map,
:func:`run` does both.

Run: python -m diffgfdn_torch.examples.low_rank_study [--out /tmp/low_rank] [--device cpu]
"""

import argparse
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from ..data.room_dataset import THREE_ROOM_DIMS, THREE_ROOM_START
from ..data.synthetic import room_centers, synthesize_amplitudes
from ..kernels.tdgfdn import synthesize_rirs_time_domain
from ..low_rank import get_source_receiver_gains
from ..ops.absorption import decay_times_to_gain_per_sample
from ..ops.basic import LOG10E6
from ..ops.unitary import orthogonal_from_skew
from ..utils.device import resolve_device

Device = Union[str, torch.device]

FS = 8000.0
DECAYS = (0.05, 0.25, 0.12)  # well-separated slopes (one per room)
DELAYS = (163, 179, 191, 211, 223, 227, 233, 239, 251, 257, 263, 269)
NUM_GROUPS = 3


def make_amplitudes(num_src=3, seed=0):
    """Near-rank-1 (num_src, num_rec, num_slopes) CS amplitude tensor."""
    rng = np.random.RandomState(seed)
    rec = []
    for k in range(3):
        x = rng.uniform(THREE_ROOM_START[k][0] + 0.3,
                        THREE_ROOM_START[k][0] + THREE_ROOM_DIMS[k][0] - 0.3, 8)
        y = rng.uniform(THREE_ROOM_START[k][1] + 0.3,
                        THREE_ROOM_START[k][1] + THREE_ROOM_DIMS[k][1] - 0.3, 8)
        rec.append(np.stack([x, y, np.full(8, 1.5)], axis=-1))
    rec_pos = np.concatenate(rec)
    rec_amps = synthesize_amplitudes(rec_pos)  # (R, 3)

    centers = room_centers()
    src_pos = np.concatenate(
        [centers + rng.randn(3, 2) * 0.3, np.full((3, 1), 1.5)], axis=-1
    )[:num_src]
    src_amps = synthesize_amplitudes(src_pos)  # (S, 3)

    # product structure (rank-1 per slope) + 3% multiplicative noise
    amps = src_amps[:, None, :] * rec_amps[None, :, :]
    amps *= 1.0 + 0.03 * rng.randn(*amps.shape)
    return np.maximum(amps, 1e-6), rec_pos, src_pos


def _gfdn_statics(seed, device):
    """Per-line absorption gains + block-diagonal orthogonal mixing."""
    rng = np.random.RandomState(seed)
    nper = len(DELAYS) // NUM_GROUPS
    gains = np.concatenate([
        np.asarray(decay_times_to_gain_per_sample(
            DECAYS[k], np.asarray(DELAYS[k * nper:(k + 1) * nper]), FS))
        for k in range(NUM_GROUPS)
    ]).astype(np.float32)
    a = np.zeros((len(DELAYS), len(DELAYS)), np.float32)
    for k in range(NUM_GROUPS):
        x = torch.as_tensor(rng.randn(nper, nper), dtype=torch.float32, device=device)
        a[k * nper:(k + 1) * nper, k * nper:(k + 1) * nper] = orthogonal_from_skew(x).cpu().numpy()
    return gains, a, nper


def _render(device, gains, a, b, c, t_len: int) -> np.ndarray:
    """(B, t_len) RIRs of the delay lines for B output-gain vectors ``c``."""
    return synthesize_rirs_time_domain(
        DELAYS, *(torch.as_tensor(x, dtype=torch.float32, device=device) for x in (gains, a, b, c)),
        t_len).cpu().numpy()


def _calibrate_group_energies(device, gains, a, nper, t_len, t0):
    """Kernel energy scale rho_k per group from a unit-gain probe's EDC.

    After the onset ramp the group-k probe's energy envelope is
    ``rho_k e^{-lam_k t}``, so its Schroeder EDC obeys
    ``EDC(t0) = rho_k (fs / lam_k) e^{-lam_k t0}``: one closed-form read,
    no decay fitting."""
    lam = LOG10E6 / np.asarray(DECAYS)
    b1 = np.ones(len(DELAYS), np.float32) / np.sqrt(nper)
    c0 = np.zeros((NUM_GROUPS, len(DELAYS)), np.float32)
    for k in range(NUM_GROUPS):
        c0[k, k * nper:(k + 1) * nper] = 1.0 / np.sqrt(nper)
    probes = _render(device, gains, a, b1, c0, t_len)
    t = np.arange(t_len) / FS
    rho = np.zeros(NUM_GROUPS)
    for k in range(NUM_GROUPS):
        edc = np.flip(np.cumsum(np.flip(probes[k] ** 2)))
        rho[k] = edc[t0] * lam[k] / FS * np.exp(lam[k] * t[t0])
    return rho, lam


def low_rank_render(seed=0, device: Device = "cuda") -> Dict:
    """The study's numbers: the per-slope ``explained`` shares, the
    (num_src, num_rec) ``edc_err`` (mean |EDC error| in dB of each
    trained-free render) and its mean, the ``rendered`` RIRs
    (num_src, num_rec, T) and the receiver positions."""
    dev = resolve_device(device)
    amps, rec_pos, _ = make_amplitudes(seed=seed)
    num_src, num_rec, _ = amps.shape
    g_in, g_out, explained = get_source_receiver_gains(amps)

    gains, a, nper = _gfdn_statics(seed + 1, dev)
    t_len = int(4.0 * max(DECAYS) * FS)
    t0 = int(0.06 * FS)  # past the echo-density onset ramp
    t1 = int(2.0 * max(DECAYS) * FS)  # before the truncation tail
    rho, lam = _calibrate_group_energies(dev, gains, a, nper, t_len, t0)
    t = np.arange(t_len) / FS

    # render all (src, rec) pairs trained-free: per-group input taps
    # sqrt(g_in/rho), output taps sqrt(g_out) -> rendered energy envelope
    # is g_in*g_out*e^{-lam t} by construction
    edc_err = np.zeros((num_src, num_rec))
    rendered = []
    for s in range(num_src):
        b_vec = np.repeat(np.sqrt(np.maximum(g_in[s], 1e-9) / rho), nper
                          ).astype(np.float32) / np.sqrt(nper)
        c_mat = np.repeat(np.sqrt(np.maximum(g_out, 1e-9)), nper, axis=1
                          ).astype(np.float32) / np.sqrt(nper)
        rirs = _render(dev, gains, a, b_vec, c_mat, t_len)  # (num_rec, T)
        rendered.append(rirs)
        edc = np.flip(np.cumsum(np.flip(rirs ** 2, axis=-1), axis=-1), axis=-1)
        # analytic common-slopes EDC of the TRUE amplitudes
        target = (amps[s] / lam * FS) @ np.exp(-np.outer(lam, t))
        d = 10.0 * np.log10(edc[:, t0:t1] + 1e-30) - 10.0 * np.log10(target[:, t0:t1] + 1e-30)
        edc_err[s] = np.mean(np.abs(d), axis=-1)
    return {
        "explained": explained,
        "edc_err": edc_err,
        "mean_edc_err_db": float(np.mean(edc_err)),
        "rendered": np.stack(rendered),
        "rec_pos": rec_pos,
        "num_src": num_src,
        "num_rec": num_rec,
    }


def draw_error_map(res: Dict, out: Path) -> None:
    """``low_rank_edc_error_map.png``: each receiver's EDC error over the
    floor plan (matplotlib)."""
    from ..utils.plot import plot_position_map

    plot_position_map(
        res["rec_pos"], res["edc_err"].mean(axis=0), list(THREE_ROOM_DIMS),
        list(THREE_ROOM_START), title="rank-1 trained-free render: EDC error",
        cbar_label="dB", save_path=str(out / "low_rank_edc_error_map.png"),
    )


def run(out_dir="/tmp/low_rank", seed=0, device: Device = "cuda"):
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    res = low_rank_render(seed, dev)
    print("explained variance per slope:", np.round(res["explained"], 4))
    print(f"mean |EDC error| of the trained-free render: {res['mean_edc_err_db']:.2f} dB")
    draw_error_map(res, out)
    return {k: res[k] for k in ("explained", "mean_edc_err_db", "num_src", "num_rec")}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Rank-1 amplitudes drive a trained-free GFDN")
    parser.add_argument("--out", default="/tmp/low_rank")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    res = run(args.out, device=args.device)
    print(res)
    return res


if __name__ == "__main__":
    main()
