"""Prony / warped-Prony IIR fitting (host-side, init-time only).

Fits absorption filters to octave-band decay times before training
(reference behaviour: filters/prony.py:48-288, absorption_filters.py:56-105
— reimplemented here from the underlying published methods: Prony's method
on a Toeplitz system, Bark-scale allpass warping [Smith & Abel 1999], and
real-cepstrum minimum-phase reconstruction [Oppenheim & Schafer §13]).
These fits are non-differentiable and run once at model build, so they stay
in numpy/scipy and never enter the autograd graph. A copy of
``diffgfdn_tpu/ops/prony.py``.
"""

from typing import Optional, Tuple

import numpy as np
from scipy.fft import fft, ifft, irfft, rfftfreq
from scipy.interpolate import CubicSpline, make_interp_spline
from scipy.linalg import toeplitz
from scipy.signal import tf2zpk, zpk2tf

from .basic import db2lin_np, db_np

_EPS = np.finfo(np.float64).eps


def one_to_two_sided_spectrum(one_sided: np.ndarray, is_even: bool = True):
    """Conjugate-symmetric full spectrum from a one-sided (rFFT-style) half.

    ``is_even`` says whether the underlying FFT length was even (the last
    bin is then the Nyquist bin and must be real, as must DC).
    """
    half = np.asarray(one_sided).astype(complex).copy()
    half[0] = half[0].real
    if is_even:
        half[-1] = half[-1].real
        mirrored = half[1:-1]
    else:
        mirrored = half[1:]
    return np.concatenate([half, mirrored[::-1].conj()], axis=0)


def wrap_phase(ph_uw: np.ndarray, positive: bool = True) -> np.ndarray:
    """Wrap phase to [0, 2pi) (``positive``) or [-pi, pi)."""
    twopi = 2.0 * np.pi
    if positive:
        return np.mod(ph_uw, twopi)
    return np.mod(np.asarray(ph_uw) + np.pi, twopi) - np.pi


def tf2minphase(
    tf: np.ndarray,
    axis: int = 0,
    is_even_fft: bool = True,
    is_time_domain: bool = False,
) -> np.ndarray:
    """Minimum-phase system with the same magnitude as ``tf``.

    Real-cepstrum method: fold the log-magnitude cepstrum onto positive
    quefrencies and exponentiate — equivalent to assigning the Hilbert
    transform of -log|H| as the phase, without an explicit Hilbert step.
    ``tf`` is a one-sided spectrum along ``axis``; returns the one-sided
    minimum-phase spectrum, or its impulse response if ``is_time_domain``.
    """
    h_half = np.moveaxis(np.asarray(tf), axis, 0)
    n_bins = h_half.shape[0]
    h_full = one_to_two_sided_spectrum(h_half, is_even_fft)
    n_full = h_full.shape[0]

    ceps = np.real(ifft(np.log(np.abs(h_full) + _EPS), axis=0))
    # fold: keep quefrency 0 (and Nyquist for even n), double the rest
    fold = np.zeros(n_full)
    fold[0] = 1.0
    fold[1 : (n_full + 1) // 2] = 2.0
    if n_full % 2 == 0:
        fold[n_full // 2] = 1.0
    shape = (n_full,) + (1,) * (h_full.ndim - 1)
    h_mp = np.exp(fft(ceps * fold.reshape(shape), axis=0))[:n_bins]

    h_mp = np.moveaxis(h_mp, 0, axis)
    if is_time_domain:
        # irfft needs the true FFT length: its even default would treat an
        # odd-n_full spectrum's last bin as a Nyquist bin (short, wrong IR)
        return irfft(h_mp, n=n_full, axis=axis)
    return h_mp


def interpolate_magnitude_spectrum(
    mag_spec: np.ndarray,
    freqs: np.ndarray,
    fs: float,
    n_fft: int,
    cutoff: Tuple[float, float] = (63.0, 16000.0),
    rolloff_dc_db: Optional[float] = None,
    rolloff_nyq_db: Optional[float] = None,
    return_one_sided: bool = True,
    bands_per_octave: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Resample an octave-band magnitude onto the dense rFFT grid.

    A quadratic spline covers the measured band range; outside ``cutoff``
    the curve is extended with gentle linear ramps toward DC and Nyquist.
    Parity note (matches the reference's published behaviour, which our
    absorption-filter fits must reproduce): the per-bin ramp slope is
    ``db2lin(rate_db)`` — the *linear* value of the dB rate — and the
    Nyquist ramp spans ``(fs/2) / (2 max(freqs))`` of that slope over the
    remaining bins.
    """
    mag_spec = np.asarray(mag_spec, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    # default ramp rates from the outermost band-to-band differences
    if rolloff_nyq_db is None:
        rolloff_nyq_db = bands_per_octave * db_np(mag_spec[-1] - mag_spec[-2])
    if rolloff_dc_db is None:
        rolloff_dc_db = -bands_per_octave * db_np(abs(mag_spec[1] - mag_spec[0]))

    grid = rfftfreq(n_fft, d=1.0 / fs)
    dense = make_interp_spline(freqs, mag_spec, k=2)(grid)

    lo = int(np.searchsorted(grid, cutoff[0]))
    hi = int(np.searchsorted(grid, cutoff[1]))
    # descend from the low-cutoff anchor toward DC
    dense[:lo] = dense[lo] - db2lin_np(rolloff_dc_db) * np.arange(
        lo - 1, -1, -1, dtype=np.float64
    )
    # descend from the high-cutoff anchor toward Nyquist
    span = 0.5 * fs / (2.0 * float(freqs.max()))
    dense[hi:] = dense[hi] - db2lin_np(rolloff_nyq_db) * np.linspace(
        0.0, span, grid.size - hi
    )
    if not return_one_sided:
        dense = one_to_two_sided_spectrum(dense, n_fft % 2 == 0)
    return dense, grid


def prony(h: np.ndarray, nb: int, na: int) -> Tuple[np.ndarray, np.ndarray]:
    """Prony's method: IIR (b, a) of orders (nb, na) matching ``h``.

    The denominator solves the shifted linear-prediction system over the
    tail samples in least squares; the numerator then follows by
    convolving ``a`` with the head of the impulse response.
    """
    h = np.asarray(h, dtype=np.float64)
    k = len(h) - 1
    # columns of the prediction matrix are h delayed by 0..na samples
    hmat = toeplitz(h, np.r_[1.0, np.zeros(k)])[:, : na + 1]
    tail = slice(nb + 1, k + 1)
    a_rest = -np.linalg.lstsq(hmat[tail, 1:], hmat[tail, 0], rcond=None)[0]
    a = np.r_[1.0, a_rest]
    b = hmat[: nb + 1] @ a
    return b, a


def bark_warping_coefficient(fs: float) -> float:
    """Allpass coefficient approximating the Bark scale at ``fs``
    (Smith & Abel 1999), rounded to 3 decimals."""
    lam = 1.0674 * np.sqrt(2.0 / np.pi * np.arctan(6.583e-5 * fs)) - 0.1916
    return -np.round(lam * 1000.0) / 1000.0


def allpass_warp(ir: np.ndarray, rho: float) -> np.ndarray:
    """Frequency-warp an impulse response through z -> (z - rho)/(1 - rho z).

    Implemented by resampling the spectrum at the warped frequencies and
    transforming back; the FFT size is stretched so the warped grid stays
    adequately sampled.
    """
    n_samp = len(ir)
    stretch = (1.0 + abs(rho)) / (1.0 - abs(rho))
    n_bins = 2 ** int(np.ceil(np.log2(n_samp * stretch)))
    n_bins = min(n_bins, 1 << 16)

    # include the Nyquist bin: omitting it shifted the whole negative-
    # frequency half by one slot, corrupting even the identity (rho=0)
    # warp by ~7% (np.real silently discarded the non-Hermitian error)
    omega = np.pi * np.arange(n_bins + 1) / n_bins
    z = np.exp(1j * omega)
    warped_omega = np.angle((z - rho) / (1.0 - rho * z))
    warped_omega[-1] = np.pi  # the allpass maps pi -> pi exactly

    spec = fft(ir, 2 * n_bins)[: n_bins + 1]
    spec_w = CubicSpline(omega, spec, extrapolate=True)(warped_omega)
    full = np.r_[spec_w, spec_w[1:n_bins][::-1].conj()]
    return np.real(ifft(full, 2 * n_bins))[:n_samp]


def allpass_warp_roots(
    rho: float, b: np.ndarray, a: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Warp filter coefficients by mapping each pole/zero through the
    allpass z -> (z + rho)/(1 + rho z); excess poles or zeros (from a
    degree mismatch) map to the warping point itself."""
    zeros, poles, gain = tf2zpk(b, a)
    warp = lambda r: (r + rho) / (1.0 + rho * r)  # noqa: E731
    zw = warp(zeros)
    pw = warp(poles)
    excess = len(poles) - len(zeros)
    if excess > 0:
        zw = np.r_[zw, np.full(excess, rho)]
    elif excess < 0:
        pw = np.r_[pw, np.full(-excess, rho)]
    gain_w = gain * np.prod(1.0 + rho * zeros) / np.prod(1.0 + rho * poles)
    bw, aw = zpk2tf(zw, pw, gain_w)
    return np.real(bw), np.real(aw)


def stabilize_denominator(a: np.ndarray, max_radius: float = 0.98) -> np.ndarray:
    """Clamp denominator pole radii to ``max_radius``.

    Prony least-squares fits can place poles essentially ON the unit circle
    (observed |den(z)| ~ 2e-8 at a frequency-sampling grid point), which
    makes the frequency-sampled response an f32 rounding lottery and blows
    up the loop-matrix inverse. Shrinking the radius keeps conjugate pairs
    symmetric, so the polynomial stays real.
    """
    a = np.asarray(a, np.float64)
    p = np.roots(a)
    r = np.abs(p)
    if np.all(r <= max_radius):
        return a
    p = np.where(r > max_radius, p * (max_radius / np.maximum(r, 1e-12)), p)
    return np.real(np.poly(p)) * a[0]


def prony_warped(
    h: np.ndarray, fs: float, nb: int, na: int, rho: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Prony fit on the Bark-warped axis (perceptually weighted accuracy):
    warp the IR, fit, then unwarp the fitted poles/zeros."""
    if rho is None:
        rho = bark_warping_coefficient(fs)
    bw, aw = prony(allpass_warp(h, rho), nb, na)
    return allpass_warp_roots(-rho, bw, aw)
