"""Graphic-equalizer design (Schlecht & Habets method), host-side numpy/scipy.

Copy of ``diffgfdn_tpu/ops/geq.py``: a cascade of [broadband gain,
low-shelf, peaking x n_bands, high-shelf] sections whose command gains are
fit by probing a 10 dB prototype at log-spaced control frequencies and
solving a bounded least-squares problem (``scipy.optimize.lsq_linear``).
"""

from typing import List, Tuple

import numpy as np
from scipy.optimize import lsq_linear

from .biquad import peak_filter_np, probe_sos_np, shelving_filter_np


def octave_bands(
    interval: int = 1, start_freq: float = 31.25, end_freq: float = 16000.0
) -> List[float]:
    """Octave-band centre frequencies: start*2^(1/i), doubling until end."""
    central_freq = []
    c_freq = start_freq
    while c_freq < end_freq:
        central_freq.append(c_freq * 2.0 ** (1.0 / interval))
        c_freq = central_freq[-1]
    return central_freq


def eq_freqs(
    interval: int = 1, start_freq: float = 31.25, end_freq: float = 16000.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(centre frequencies, shelving crossover frequencies) in Hz."""
    center_freq = np.asarray(
        octave_bands(interval=interval, start_freq=start_freq, end_freq=end_freq)
    )
    shelving_crossover = np.array(
        [
            center_freq[0] / 2.0 ** (1.0 / interval / 2.0),
            center_freq[-1] * 2.0 ** (1.0 / interval / 2.0),
        ]
    )
    return center_freq, shelving_crossover


def geq_sos(
    center_freq: np.ndarray,
    shelving_freq: np.ndarray,
    R: float,
    gain_db: np.ndarray,
    fs: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """SOS coefficients for the GEQ cascade at the given command gains.

    Band 0 is a pure broadband gain, band 1 a low shelf, the last band a high
    shelf, everything in between peaking filters with Q = sqrt(R)/(R-1).
    Returns (b, a) of shape (3, n_bands).
    """
    num_bands = len(center_freq) + len(shelving_freq) + 1
    if len(gain_db) != num_bands:
        raise ValueError("The number of gains must equal the number of frequencies.")
    sos = np.zeros((6, num_bands))
    for band in range(num_bands):
        g_lin = 10.0 ** (float(gain_db[band]) / 20.0)
        if band == 0:
            b = np.array([g_lin, 0.0, 0.0])
            a = np.array([1.0, 0.0, 0.0])
        elif band == 1:
            b, a = shelving_filter_np(shelving_freq[0], g_lin, "low", fs)
        elif band == num_bands - 1:
            b, a = shelving_filter_np(shelving_freq[1], g_lin, "high", fs)
        else:
            q = np.sqrt(R) / (R - 1.0)
            b, a = peak_filter_np(center_freq[band - 2], g_lin, q, fs)
        sos[:3, band] = b
        sos[3:, band] = a
    return sos[:3], sos[3:]


def design_geq(
    target_gain_db: np.ndarray,
    center_freq: np.ndarray,
    shelving_crossover: np.ndarray,
    fs: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit GEQ command gains to a target magnitude (dB) per band.

    ``target_gain_db`` has len(center_freq) + 2 entries (low-shelf target,
    per-band targets, high-shelf target). Returns (b, a) of shape
    (3, n_bands) for the fitted cascade.
    """
    target_gain_db = np.asarray(target_gain_db, dtype=np.float64)
    if len(target_gain_db) != len(center_freq) + 2:
        raise ValueError("need len(center_freq) + 2 target gains")

    num_freq = len(center_freq) + len(shelving_crossover)
    R = 2.7

    # log-spaced control frequencies; interpolate the target on them
    num_control = 100
    control_freq = np.round(
        np.logspace(np.log10(1.0), np.log10(fs / 2.1), num_control + 1)
    )
    target_freqs = np.concatenate(([1.0], np.asarray(center_freq), [fs / 2.1]))
    if np.any(np.diff(target_freqs) <= 0):
        # band centres past fs/2.1 make xp non-monotonic, for which np.interp
        # returns nonsense: keep a point only if it exceeds the last kept one
        keep = np.zeros(len(target_freqs), dtype=bool)
        keep[0] = True
        last = target_freqs[0]
        for i in range(1, len(target_freqs)):
            if target_freqs[i] > last:
                keep[i] = True
                last = target_freqs[i]
        target_freqs = target_freqs[keep]
        target_gain_db = target_gain_db[keep]
    target_interp = np.interp(control_freq, target_freqs, target_gain_db)

    # probe a 10 dB prototype to build the interaction matrix (dB per dB)
    prototype_gain_db = 10.0
    proto_gains = np.full(num_freq + 1, prototype_gain_db)
    proto_b, proto_a = geq_sos(center_freq, shelving_crossover, R, proto_gains, fs)
    proto_sos = np.vstack([proto_b, proto_a])
    G = probe_sos_np(proto_sos, control_freq, fs) / prototype_gain_db

    # bounded least squares on command gains (broadband gain unbounded)
    upper = np.array([np.inf] + [2.0 * prototype_gain_db] * num_freq)
    lower = -upper
    sol = lsq_linear(G, target_interp, bounds=(lower, upper), max_iter=200)
    return geq_sos(center_freq, shelving_crossover, R, sol.x, fs)
