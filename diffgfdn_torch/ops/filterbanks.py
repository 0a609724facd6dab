"""Fractional-octave filterbanks (a copy of ``diffgfdn_tpu/ops/filterbanks.py``).

Two designs, as used by the reference for subband training and resynthesis
(trainer.py:112-150, run_subband_training_treble.py:216-232):

* ``reconstructing_fractional_octave_bands`` — amplitude-preserving
  linear-phase FIR bank whose magnitude responses sum to exactly 1
  (perfect reconstruction up to a constant delay). Rectangular bands with
  sine-squared crossfades in log-frequency, first/last bands extended to
  DC/Nyquist.
* ``fractional_octave_bands_sos`` — energy-preserving Butterworth bandpass
  bank (scipy), returned as second-order sections.

Also provides the time-reversed FIR filterbank used for subband resynthesis
(reference: utils.py:361-469).
"""

from typing import Tuple

import numpy as np
from scipy.fft import irfft, rfft, rfftfreq
from scipy.signal import butter, fftconvolve

# IEC 61260 octave ratio
_G = 10.0 ** (3.0 / 10.0)


def exact_center_frequencies(
    num_fractions: int = 1, frequency_range: Tuple[float, float] = (63.0, 16000.0)
) -> np.ndarray:
    """Exact base-10 fractional-octave centre frequencies within the range."""
    f_lo, f_hi = frequency_range
    # indices around 1 kHz reference
    n_lo = int(np.floor(num_fractions * np.log(f_lo / 1000.0) / np.log(_G))) - 1
    n_hi = int(np.ceil(num_fractions * np.log(f_hi / 1000.0) / np.log(_G))) + 1
    idx = np.arange(n_lo, n_hi + 1)
    if num_fractions % 2 == 0:
        freqs = 1000.0 * _G ** ((2 * idx + 1) / (2.0 * num_fractions))
    else:
        freqs = 1000.0 * _G ** (idx / float(num_fractions))
    mask = (freqs >= f_lo / _G ** (1e-6)) & (freqs <= f_hi * _G ** (1e-6))
    freqs = freqs[mask]
    # clip to range inclusively (tolerate float fuzz)
    return freqs[(freqs > f_lo * 0.999) & (freqs < f_hi * 1.001)]


def fractional_octave_frequencies(
    num_fractions: int = 1,
    frequency_range: Tuple[float, float] = (63.0, 16000.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """(exact centre frequencies, (lower, upper) cutoffs) for the bands."""
    centers = exact_center_frequencies(num_fractions, frequency_range)
    half = _G ** (1.0 / (2.0 * num_fractions))
    cutoffs = np.stack([centers / half, centers * half], axis=-1)
    return centers, cutoffs


def reconstructing_fractional_octave_bands(
    num_fractions: int = 1,
    frequency_range: Tuple[float, float] = (63.0, 16000.0),
    n_samples: int = 2 ** 12,
    sampling_rate: float = 44100.0,
    overlap: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Amplitude-preserving linear-phase FIR fractional-octave filterbank.

    Returns ``(coefficients, frequencies)`` with coefficients of shape
    (num_bands, n_samples). The magnitude responses sum to 1 at every
    frequency: band edges crossfade with sin^2/cos^2 ramps in log-frequency,
    the first band is extended flat to DC and the last to Nyquist. Each FIR
    is the irfft of its magnitude with a linear phase of n_samples/2, so the
    bank reconstructs a delayed impulse exactly.
    """
    centers = exact_center_frequencies(num_fractions, frequency_range)
    num_bands = len(centers)
    half = _G ** (1.0 / (2.0 * num_fractions))
    f_lower = centers / half
    f_upper = centers * half

    freqs = rfftfreq(n_samples, d=1.0 / sampling_rate)
    log_f = np.log2(np.maximum(freqs, 1e-12))

    # transition half-width in octaves around each internal band edge
    trans_width = overlap * 0.5 / num_fractions  # octaves

    def ramp_up(edge_hz: np.ndarray) -> np.ndarray:
        """sin^2 ramp from 0 to 1 centred (in log2-f) on the band edge."""
        le = np.log2(edge_hz)
        x = (log_f - (le - trans_width / 2)) / trans_width
        x = np.clip(x, 0.0, 1.0)
        return np.sin(0.5 * np.pi * x) ** 2

    mags = np.zeros((num_bands, len(freqs)))
    for b in range(num_bands):
        lo = ramp_up(f_lower[b]) if b > 0 else np.ones_like(freqs)
        hi = 1.0 - ramp_up(f_upper[b]) if b < num_bands - 1 else np.ones_like(freqs)
        mags[b] = lo * hi

    # force exact unity sum (normalizes any ramp overlap mismatch)
    total = mags.sum(axis=0)
    mags = mags / np.maximum(total, 1e-12)

    # linear phase: group delay of n_samples/2
    n0 = n_samples // 2
    phase = np.exp(-1j * 2.0 * np.pi * freqs * n0 / sampling_rate)
    coeffs = irfft(mags * phase[None, :], n=n_samples, axis=-1)
    return coeffs, centers


def fractional_octave_bands_sos(
    num_fractions: int = 1,
    frequency_range: Tuple[float, float] = (63.0, 16000.0),
    sampling_rate: float = 44100.0,
    order: int = 14,
) -> Tuple[np.ndarray, np.ndarray]:
    """Butterworth fractional-octave bandpass bank as SOS.

    Returns (sos, centers) with sos of shape (num_bands, n_sections, 6).
    """
    centers, cutoffs = fractional_octave_frequencies(num_fractions, frequency_range)
    nyq = sampling_rate / 2.0
    sos_list = []
    for lo, hi in cutoffs:
        hi = min(hi, nyq * 0.999)
        sos = butter(order, [lo / nyq, hi / nyq], btype="bandpass", output="sos")
        sos_list.append(sos)
    return np.stack(sos_list, axis=0), centers


def get_time_reversed_fir_filterbank(
    h: np.ndarray, freq_bins_rad: np.ndarray, num_freq_bins: int
) -> np.ndarray:
    """Frequency response of the time-reversed (dual) FIR filterbank.

    flip{H}_k(z) = H_k(z^-1) / sum_i H_i(z) H_i(z^-1)
    (reference: utils.py:361-418). ``h``: (num_bands, num_coeffs).
    """
    num_bands, num_coeffs = h.shape
    num = np.conj(rfft(h, n=num_freq_bins, axis=-1))
    norm_factor = np.zeros((num_bands, len(freq_bins_rad)))
    k_axis = np.arange(num_coeffs)
    for b_idx in range(num_bands):
        cur = h[b_idx]
        # autocorrelation r[k] = sum_n h[n] h[n+k]
        r = np.array([np.dot(cur[: num_coeffs - k], cur[k:]) for k in range(num_coeffs)])
        r[0] /= 2.0
        norm_factor[b_idx] = 2.0 * np.sum(
            r[:, None] * np.cos(k_axis[:, None] * freq_bins_rad), axis=0
        )
    return num / np.sum(norm_factor, axis=0)


def time_reversed_filtering(
    input_signal: np.ndarray,
    subband_filters: np.ndarray,
    time_axis: int = 0,
) -> np.ndarray:
    """Filter per-band signals with the time-reversed dual filterbank.

    ``input_signal``: (num_samps, [num_chans,] num_bands);
    ``subband_filters``: (num_bands, num_coeffs). Returns
    (num_samps + num_coeffs - 1, [num_chans,] num_bands)
    (reference: utils.py:421-469).
    """
    ir_len = input_signal.shape[time_axis]
    num_bands, fft_size = subband_filters.shape
    freq_bins_rad = rfftfreq(fft_size) * 2.0 * np.pi
    resp = get_time_reversed_fir_filterbank(subband_filters, freq_bins_rad, fft_size)
    time_rev = irfft(resp, n=fft_size, axis=-1)

    squeeze = input_signal.ndim == 2
    if squeeze:
        input_signal = input_signal[:, None, :]
    num_chans = input_signal.shape[1]

    out = np.zeros((ir_len + fft_size - 1, num_chans, num_bands))
    for b_idx in range(num_bands):
        filt = np.tile(time_rev[b_idx][:, None], (1, num_chans))
        out[..., b_idx] = fftconvolve(input_signal[..., b_idx], filt, mode="full", axes=0)
    return out.squeeze() if squeeze else out


def subband_filter_response(
    centre_frequency: float,
    frequency_range: Tuple[float, float],
    num_fractions: int,
    sampling_rate: float,
    num_freq_bins: int,
    use_amp_preserving: bool = True,
    fir_n_samples: int = 2 ** 12,
) -> np.ndarray:
    """rFFT-grid frequency response of the subband filter nearest a centre.

    Used for in-loss subband filtering of H (reference: trainer.py:112-150).
    Returns a complex array of num_freq_bins//2 + 1 points.
    """
    if use_amp_preserving:
        # design the FIR no longer than the rFFT grid: rfft(x, n) TRUNCATES
        # x to its first n samples, and the linear-phase filter's energy
        # sits at fir_n_samples/2 — a 4096-tap filter sampled on a 512-bin
        # grid used to silently return an all-but-zero response
        n_fir = min(fir_n_samples, num_freq_bins)
        coeffs, freqs = reconstructing_fractional_octave_bands(
            num_fractions=num_fractions,
            frequency_range=frequency_range,
            n_samples=n_fir,
            sampling_rate=sampling_rate,
        )
        idx = int(np.argmin(np.abs(freqs - centre_frequency)))
        return rfft(coeffs[idx], n=num_freq_bins)
    sos, freqs = fractional_octave_bands_sos(
        num_fractions=num_fractions,
        frequency_range=frequency_range,
        sampling_rate=sampling_rate,
    )
    idx = int(np.argmin(np.abs(freqs - centre_frequency)))
    from .biquad import sos_response_np

    freqs_hz = rfftfreq(num_freq_bins, d=1.0 / sampling_rate)
    return sos_response_np(sos[idx], freqs_hz, sampling_rate)
