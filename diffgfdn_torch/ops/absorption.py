"""Absorption gains / filters for GFDN delay lines (port of ``diffgfdn_tpu/ops/absorption.py``).

* :func:`decay_times_to_gain_per_sample` is differentiable when handed
  tensors (learnable common decay times, inside the model's forward), and
  host numpy otherwise (gains fixed when a model is built);
* the GEQ and warped-Prony filter fits run once on the host when a model is
  built, never inside the forward pass.
"""

from typing import List, Tuple

import numpy as np
import torch

from .basic import db2lin_np
from .geq import design_geq
from .prony import (
    interpolate_magnitude_spectrum,
    prony_warped,
    stabilize_denominator,
    tf2minphase,
)


def decay_times_to_gain_per_sample(common_decay_times, delay_length_samp, fs: float):
    """gain = 10^(-3 * delay / (fs * T60)) per delay line, float32.

    The per-pass gain that makes energy drop 60 dB in T60 seconds after
    fs*T60/delay passes through a delay line of ``delay`` samples. A tensor
    among the inputs gives a tensor (differentiable in the decay times);
    otherwise numpy.
    """
    if isinstance(common_decay_times, torch.Tensor) or isinstance(delay_length_samp, torch.Tensor):
        t = torch.as_tensor(common_decay_times, dtype=torch.float32)
        d = torch.as_tensor(delay_length_samp, dtype=torch.float32, device=t.device)
        return torch.pow(10.0, -3.0 * d / (fs * t))
    t = np.asarray(common_decay_times, dtype=np.float32)
    d = np.asarray(delay_length_samp, dtype=np.float32)
    return np.power(np.float32(10.0), -3.0 * d / (fs * t))


def absorption_to_gain_per_sample(room_dims: Tuple, absorption_coeff: float,
                                  delay_length_samp: List[int], fs: float
                                  ) -> Tuple[float, np.ndarray]:
    """(Sabine T60 of a room with a uniform absorption coefficient, each delay
    line's gain per sample for it); 2-D ``room_dims`` take the perimeter."""
    volume = float(np.prod(room_dims))
    if len(room_dims) == 3:
        area = 2.0 * (room_dims[0] * room_dims[1] + room_dims[1] * room_dims[2]
                      + room_dims[2] * room_dims[0])
    else:
        area = 2.0 * (room_dims[0] + room_dims[1])
    rt60 = 0.161 * volume / (area * absorption_coeff)
    return rt60, db2lin_np(-60.0 * np.asarray(delay_length_samp) / (fs * rt60))


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


def decay_times_to_gain_filters_prony(
    band_centre_hz,
    common_decay_times,
    delay_length_samp,
    fs: float,
    filter_order: int = 8,
    num_freq_bins: int = 2 ** 10,
) -> np.ndarray:
    """Per-delay-line IIR absorption filters by warped Prony fitting.

    Each line's target magnitude, the per-band gain over ``delay + order``
    samples, is interpolated onto ``num_freq_bins`` bins, made minimum phase
    and fitted by a Bark-warped Prony fit whose poles and zeros are pulled
    inside radius 0.98. Returns (num_delay_lines, filter_order + 1, 2),
    (num, den) on the last axis.
    """
    band_centre_hz = np.asarray(band_centre_hz, dtype=np.float64)
    common_decay_times = np.asarray(common_decay_times, dtype=np.float64)
    delay_length_samp = np.asarray(delay_length_samp, dtype=np.int64)
    num_lines = len(delay_length_samp)
    out = np.zeros((num_lines, filter_order + 1, 2))
    for i in range(num_lines):
        target = db2lin_np(
            -60.0 * (delay_length_samp[i] + filter_order) / (fs * common_decay_times)
        )
        interp, _ = interpolate_magnitude_spectrum(
            target,
            band_centre_hz,
            fs,
            n_fft=num_freq_bins,
            cutoff=(20.0, fs // 2 - 4e3),
            rolloff_dc_db=-60.0,
            rolloff_nyq_db=-100.0,
            return_one_sided=True,
        )
        min_phase_ir = tf2minphase(interp, axis=0, is_even_fft=True, is_time_domain=True)
        b, a = prony_warped(min_phase_ir, fs, filter_order, filter_order)
        out[i, :, 0] = stabilize_denominator(b)
        out[i, :, 1] = stabilize_denominator(a)
    return out
