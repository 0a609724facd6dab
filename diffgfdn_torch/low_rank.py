"""Rank-1 decomposition of common-slope amplitude matrices (port of
``low_rank.py``; host numpy in float64).

An SVD of the (num_src x num_rec) amplitude matrix of each slope (and each
band) factors the position dependence into source gains times receiver
gains, which can drive a single-position GFDN without training. The per-band
variant fits a graphic-equalizer cascade (``ops/geq.py``) to each
position's octave-band gains.
"""

from typing import Tuple

import numpy as np

from .ops.geq import design_geq


def rank1_decompose(amp_matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """A ~= g_in g_out^T from the leading singular triple.

    ``amp_matrix``: (num_src, num_rec). Returns (g_in (num_src,), g_out
    (num_rec,), the leading singular value's share of their sum), signs
    chosen so that g_in sums to a non-negative value.
    """
    u, s, vh = np.linalg.svd(np.asarray(amp_matrix, np.float64))
    g_in = np.sqrt(s[0]) * u[:, 0]
    g_out = np.sqrt(s[0]) * vh[0, :]
    if np.sum(g_in) < 0:
        g_in, g_out = -g_in, -g_out
    return g_in, g_out, float(s[0] / (np.sum(s) + 1e-12))


def get_source_receiver_gains(amplitudes: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Broadband source and receiver gains per slope.

    ``amplitudes``: (num_src, num_rec, num_slopes). Returns (g_in (num_src,
    num_slopes), g_out (num_rec, num_slopes), explained (num_slopes,)).
    """
    amplitudes = np.asarray(amplitudes)
    num_src, num_rec, num_slopes = amplitudes.shape
    g_in = np.zeros((num_src, num_slopes))
    g_out = np.zeros((num_rec, num_slopes))
    explained = np.zeros(num_slopes)
    for k in range(num_slopes):
        g_in[:, k], g_out[:, k], explained[k] = rank1_decompose(amplitudes[..., k])
    return g_in, g_out, explained


def get_source_receiver_filters(
    amplitudes: np.ndarray,
    band_centre_hz: np.ndarray,
    fs: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-band rank-1 gains fitted as GEQ cascades.

    ``amplitudes``: (num_src, num_rec, num_slopes, num_bands). Each
    position's and slope's gains in dB, extended by a shelf 6 dB below the
    outer bands, give a cascade of num_bands + 3 sections. Returns the
    source and receiver coefficients, (num_src, num_slopes, n_sections, 3,
    2) and (num_rec, num_slopes, n_sections, 3, 2), numerator and
    denominator stacked last.
    """
    amplitudes = np.asarray(amplitudes)
    num_src, num_rec, num_slopes, num_bands = amplitudes.shape
    band_centre_hz = np.asarray(band_centre_hz, np.float64)
    if len(band_centre_hz) != num_bands:
        raise ValueError(f"{len(band_centre_hz)} band centres for {num_bands} bands")
    shelving = np.array([band_centre_hz[0] / 2 ** 0.5, band_centre_hz[-1] * 2 ** 0.5])

    g_in = np.zeros((num_src, num_slopes, num_bands))
    g_out = np.zeros((num_rec, num_slopes, num_bands))
    for k in range(num_slopes):
        for b in range(num_bands):
            g_in[:, k, b], g_out[:, k, b], _ = rank1_decompose(amplitudes[..., k, b])

    def fit(gains):
        n_pos = gains.shape[0]
        out = np.zeros((n_pos, num_slopes, num_bands + 3, 3, 2))
        for p in range(n_pos):
            for k in range(num_slopes):
                target_db = 20 * np.log10(np.abs(gains[p, k]) + 1e-9)
                target_pad = np.concatenate(
                    [[target_db[0] - 6.0], target_db, [target_db[-1] - 6.0]])
                bq, aq = design_geq(target_pad, band_centre_hz, shelving, fs)
                out[p, k, :, :, 0] = bq.T
                out[p, k, :, :, 1] = aq.T
        return out

    return fit(g_in), fit(g_out)
