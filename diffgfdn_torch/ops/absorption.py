"""Absorption gains / filters for GFDN delay lines (host-side numpy).

Port of the host branches of ``diffgfdn_tpu/ops/absorption.py``: both run
once when a model is built, never inside the forward pass.
"""

import numpy as np

from .geq import design_geq


def decay_times_to_gain_per_sample(common_decay_times, delay_length_samp, fs: float):
    """gain = 10^(-3 * delay / (fs * T60)) per delay line, float32.

    The per-pass gain that makes energy drop 60 dB in T60 seconds after
    fs*T60/delay passes through a delay line of ``delay`` samples.
    """
    t = np.asarray(common_decay_times, dtype=np.float32)
    d = np.asarray(delay_length_samp, dtype=np.float32)
    return np.power(np.float32(10.0), -3.0 * d / (fs * t))


def decay_times_to_gain_filters_geq(
    band_centre_hz,
    common_decay_times,
    delay_length_samp,
    fs: float,
) -> np.ndarray:
    """Per-delay-line GEQ absorption filters from octave-band decay times.

    For each delay line, fit a GEQ cascade whose magnitude matches the
    per-band target gain ``(10^(-3/(fs*T60_band)))^delay``. Returns an array
    (num_delay_lines, n_sections, 3, 2) stacking (num, den) on the last axis.
    """
    band_centre_hz = np.asarray(band_centre_hz, dtype=np.float64)
    common_decay_times = np.asarray(common_decay_times, dtype=np.float64)
    delay_length_samp = np.asarray(delay_length_samp, dtype=np.int64)
    shelving_crossover_hz = np.array(
        [band_centre_hz[0] / 2 ** 0.5, band_centre_hz[-1] * 2 ** 0.5]
    )

    # per-band per-line target linear gains
    per_sample = 10.0 ** (-3.0 / fs / common_decay_times)  # (num_bands,)
    target = per_sample[:, None] ** delay_length_samp[None, :]  # (bands, lines)
    # pad with 0.5x of the edge values for the shelving sections
    target_pad = np.concatenate(
        [target[0:1] * 0.5, target, target[-1:] * 0.5], axis=0
    )

    num_lines = len(delay_length_samp)
    n_sections = len(band_centre_hz) + 3
    out = np.zeros((num_lines, n_sections, 3, 2))
    for i in range(num_lines):
        b, a = design_geq(
            20.0 * np.log10(target_pad[:, i] + 1e-12),
            center_freq=band_centre_hz,
            shelving_crossover=shelving_crossover_hz,
            fs=fs,
        )
        out[i, :, :, 0] = b.T
        out[i, :, :, 1] = a.T
    return out
