"""The port's copy of the fractional-octave filterbanks against the JAX package's.

Both are float64 numpy and scipy, so every function must agree to 1e-12
(max abs difference) at fs 8 and 32 kHz and nfft 2^10 and 2^14; the subband
filter response in both of its designs (the amplitude-preserving FIR bank
and the Butterworth SOS bank).
"""

import numpy as np
import pytest

from diffgfdn_torch.ops import biquad, filterbanks
from diffgfdn_tpu.ops import biquad as jax_biquad
from diffgfdn_tpu.ops import filterbanks as jax_filterbanks

TOL = 1e-12
GRIDS = [(8000.0, 2 ** 10), (8000.0, 2 ** 14), (32000.0, 2 ** 10), (32000.0, 2 ** 14)]
IDS = ["8k-1024", "8k-16384", "32k-1024", "32k-16384"]


def _range(fs: float):
    return (63.0, min(16000.0, fs / 2))


def _close(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= TOL


@pytest.mark.parametrize("fractions", [1, 2, 3])
@pytest.mark.parametrize("fs,nfft", GRIDS, ids=IDS)
def test_centre_frequencies_and_cutoffs(fs, nfft, fractions):
    del nfft  # the centres depend on the range only
    _close(filterbanks.exact_center_frequencies(fractions, _range(fs)),
           jax_filterbanks.exact_center_frequencies(fractions, _range(fs)))
    for a, b in zip(filterbanks.fractional_octave_frequencies(fractions, _range(fs)),
                    jax_filterbanks.fractional_octave_frequencies(fractions, _range(fs))):
        _close(a, b)


@pytest.mark.parametrize("fs,nfft", GRIDS, ids=IDS)
def test_reconstructing_bands(fs, nfft):
    coeffs, centres = filterbanks.reconstructing_fractional_octave_bands(
        1, _range(fs), n_samples=nfft, sampling_rate=fs)
    ref_coeffs, ref_centres = jax_filterbanks.reconstructing_fractional_octave_bands(
        1, _range(fs), n_samples=nfft, sampling_rate=fs)
    _close(coeffs, ref_coeffs)
    _close(centres, ref_centres)
    # the bank reconstructs a delayed impulse
    total = np.sum(coeffs, axis=0)
    assert abs(total[nfft // 2] - 1.0) < 1e-9


@pytest.mark.parametrize("fs,nfft", GRIDS, ids=IDS)
def test_butterworth_bands_and_their_response(fs, nfft):
    sos, centres = filterbanks.fractional_octave_bands_sos(1, _range(fs), sampling_rate=fs)
    ref_sos, ref_centres = jax_filterbanks.fractional_octave_bands_sos(
        1, _range(fs), sampling_rate=fs)
    _close(sos, ref_sos)
    _close(centres, ref_centres)
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    _close(biquad.sos_response_np(sos[2], freqs, fs),
           jax_biquad.sos_response_np(ref_sos[2], freqs, fs))


@pytest.mark.parametrize("amp_preserving", [True, False], ids=["fir", "sos"])
@pytest.mark.parametrize("fs,nfft", GRIDS, ids=IDS)
def test_subband_filter_response(fs, nfft, amp_preserving):
    for centre in (63.0, 500.0, 1000.0, 2000.0):
        resp = filterbanks.subband_filter_response(
            centre, _range(fs), 1, fs, nfft, use_amp_preserving=amp_preserving)
        ref = jax_filterbanks.subband_filter_response(
            centre, _range(fs), 1, fs, nfft, use_amp_preserving=amp_preserving)
        assert resp.shape == (nfft // 2 + 1,)
        _close(resp, ref)


@pytest.mark.parametrize("fs,nfft", GRIDS, ids=IDS)
def test_time_reversed_filterbank(fs, nfft):
    """The dual (time-reversed) bank and the filtering through it, on a
    256-tap bank (its autocorrelation loop is quadratic in the taps)."""
    coeffs, _ = jax_filterbanks.reconstructing_fractional_octave_bands(
        1, _range(fs), n_samples=256, sampling_rate=fs)
    w = np.fft.rfftfreq(nfft) * 2.0 * np.pi
    _close(filterbanks.get_time_reversed_fir_filterbank(coeffs, w, nfft),
           jax_filterbanks.get_time_reversed_fir_filterbank(coeffs, w, nfft))
    rng = np.random.RandomState(int(fs) + nfft)
    signal = rng.randn(min(nfft, 2048), 2, coeffs.shape[0])
    _close(filterbanks.time_reversed_filtering(signal, coeffs),
           jax_filterbanks.time_reversed_filtering(signal, coeffs))
