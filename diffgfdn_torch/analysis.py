"""EDC analysis: decay-parameter estimation and least-squares amplitudes
(port of ``diffgfdn_tpu/analysis.py``).

Decay parameters are estimated with a multi-exponential nonlinear
least-squares fit of the Schroeder EDC (variable projection: NNLS
amplitudes, bounded NLS decay times, optional model-order selection), and
common-slope amplitudes with the closed-form least-squares fit against
decay kernels. Host-side numpy and scipy in float64, on the port's own
``ops`` (``basic``, ``filterbanks``, ``geq``): offline analysis tools for
dataset conversion and baseline comparison, not training-path code.
"""

from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import nnls
from scipy.signal import sosfilt

from .ops.basic import db2lin_np, LOG10E6, ms_to_samps
from .ops.filterbanks import fractional_octave_bands_sos
from .ops.geq import octave_bands


def octave_filtering(
    signal: np.ndarray,
    fs: float,
    band_centre_hz: List[float],
    get_filter_ir: bool = False,
) -> np.ndarray:
    """Filter a signal into octave bands (Butterworth SOS, zero-state).

    Returns (num_samples, num_bands). ``get_filter_ir`` filters an impulse
    instead (band filter IRs). Replaces slope2noise.octave_filtering.
    """
    # widen the range slightly so single-band requests still yield a filter
    sos, centers = fractional_octave_bands_sos(
        num_fractions=1,
        frequency_range=(
            min(band_centre_hz) / 2 ** 0.5,
            min(max(band_centre_hz) * 2 ** 0.5, fs / 2),
        ),
        sampling_rate=fs,
        order=5,
    )
    idx = [int(np.argmin(np.abs(centers - fc))) for fc in band_centre_hz]
    x = signal
    if get_filter_ir:
        x = np.zeros_like(signal)
        x[..., 0] = 1.0
    out = np.stack([sosfilt(sos[i], x, axis=-1) for i in idx], axis=-1)
    return out


def schroeder_edc(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Backward-integrated energy decay curve (host)."""
    return np.flip(np.cumsum(np.flip(x ** 2, axis=axis), axis=axis), axis=axis)


def calculate_amplitudes_least_squares(
    common_decay_times: np.ndarray,
    fs: float,
    filtered_rir: np.ndarray,
    band_centre_hz: List[float],
    leave_out_ms: float = 10.0,
    include_noise_term: bool = True,
) -> np.ndarray:
    """Least-squares CS amplitudes per band from band-filtered RIRs.

    NNLS fit of the Schroeder EDC against backward-integrated exponential
    kernels (+ noise ramp). Returned amplitudes are in the ENERGY-ENVELOPE
    convention used throughout this package (data/synthetic.py,
    inference/cs_synthesis.py): ``E[p^2](t) = sum_k a_kb exp(-t LOG10E6/T_kb)``,
    so noise shaped by these amplitudes reproduces the rir's EDC in
    expectation. EDC-convention
    amplitudes (DecayFitNet-style, EDC = sum_k A exp) relate by
    ``A_kb = a_kb * fs * T_kb / LOG10E6``. ``common_decay_times``:
    (n_slopes, n_bands) or (n_slopes,); ``filtered_rir``:
    (n_samples, n_bands). Returns (1, n_slopes, n_bands) matching the
    reference's axis convention.
    """
    n_samples, n_bands = filtered_rir.shape
    cdt = np.asarray(common_decay_times, np.float64)
    if cdt.ndim == 1:
        cdt = np.repeat(cdt[:, None], n_bands, axis=1)
    n_slopes = cdt.shape[0]
    cut = ms_to_samps(leave_out_ms, fs)
    t = np.arange(n_samples - cut) / fs

    amps = np.zeros((1, n_slopes, n_bands))
    for b in range(n_bands):
        edc = schroeder_edc(filtered_rir[: n_samples - cut, b])
        # EDC of exp-decaying noise: integral of the energy envelope
        kernels = []
        for k in range(n_slopes):
            tau = LOG10E6 / cdt[k, b]
            kernels.append(np.exp(-t * tau) / tau * fs)  # backward integral
        if include_noise_term:
            kernels.append(np.flip(np.arange(1, len(t) + 1)).astype(np.float64))
        K = np.stack(kernels, axis=-1)
        sol, _ = nnls(K, edc)
        # the kernels already carry the fs/tau backward-integration factor,
        # so the raw solution IS the envelope amplitude (a spurious tau/fs
        # rescale here used to distort the relative slope weights)
        amps[0, :, b] = sol[:n_slopes]
    return amps


def get_amps_for_rir(
    rir: np.ndarray,
    common_decay_times: np.ndarray,
    band_centre_hz: List[float],
    fs: float,
    mixing_time_ms: float = 20.0,
    leave_out_ms: float = 10.0,
) -> np.ndarray:
    """CS amplitudes of one RIR per octave band (reference: analysis.py:172-207).

    Returns (n_bands, 1, n_slopes).
    """
    mix = ms_to_samps(mixing_time_ms, fs)
    trunc = rir[mix:] if (len(rir) - mix) % 2 == 0 else rir[mix + 1 :]
    filtered = octave_filtering(trunc, fs, band_centre_hz)
    amps = calculate_amplitudes_least_squares(
        common_decay_times, fs, filtered, band_centre_hz, leave_out_ms
    )
    return np.moveaxis(amps, -1, 0)


def _edc_design_matrix(
    t: np.ndarray, t60s: np.ndarray, noise_ramp: Optional[np.ndarray] = None
) -> np.ndarray:
    """[exp(-t ln1e6 / T_k) | noise column], shape (T, K+1).

    The noise column is the Schroeder backward integral of a constant
    noise floor — LINEAR IN REMAINING TIME, not in array index. On a
    uniform grid that's flip(arange(1, T+1)); callers fitting on a
    subsampled grid must pass the true remaining-sample counts via
    ``noise_ramp``.
    """
    cols = [np.exp(-t * LOG10E6 / T) for T in np.atleast_1d(t60s)]
    if noise_ramp is None:
        noise_ramp = np.flip(np.arange(1, len(t) + 1)).astype(np.float64)
    cols.append(np.asarray(noise_ramp, np.float64))
    return np.stack(cols, axis=-1)


def _fit_edc_fixed_order(
    edc: np.ndarray,
    t: np.ndarray,
    n_slopes: int,
    t60_grid: np.ndarray,
    refine: bool = True,
    noise_ramp: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """(T60s, amps, noise, mean-abs-dB error) for one EDC at a fixed order.

    Variable projection: for candidate decay times the amplitudes are the
    closed-form NNLS solution; the decay times themselves are grid-
    initialized (best n_slopes-subset of ``t60_grid``) then refined with
    bounded nonlinear least squares on the dB-domain residual.
    ``noise_ramp``: remaining-sample counts at each ``t`` (required when
    the EDC is subsampled non-uniformly).
    """
    from itertools import combinations

    from scipy.optimize import least_squares

    log_edc = 10.0 * np.log10(edc + 1e-20)

    def amps_and_err(t60s):
        k = _edc_design_matrix(t, t60s, noise_ramp)
        sol, _ = nnls(k, edc)
        resid = 10.0 * np.log10(k @ sol + 1e-20) - log_edc
        return sol, resid

    best = (np.inf, None, None)
    for combo in combinations(range(len(t60_grid)), n_slopes):
        cand = t60_grid[list(combo)]
        sol, resid = amps_and_err(cand)
        err = float(np.mean(resid ** 2))
        if err < best[0]:
            best = (err, cand, sol)
    _, t60_init, sol = best

    t60_fit = np.asarray(t60_init, np.float64)
    if refine:
        lo, hi = np.log(t60_grid[0] * 0.25), np.log(t60_grid[-1] * 4.0)

        def residual(log_t60s):
            return amps_and_err(np.exp(log_t60s))[1]

        res = least_squares(
            residual, np.log(t60_fit), bounds=(lo, hi), method="trf",
            xtol=1e-8, max_nfev=60,
        )
        t60_fit = np.exp(res.x)
    sol, resid = amps_and_err(t60_fit)
    order = np.argsort(t60_fit)
    return (
        t60_fit[order],
        sol[:n_slopes][order],
        float(sol[-1]),
        float(np.mean(np.abs(resid))),
    )


def estimate_decay_params(
    rir: np.ndarray,
    n_slopes: int,
    fs: float,
    f_bands: Optional[List[float]] = None,
    t60_grid: Optional[np.ndarray] = None,
    max_slopes: int = 3,
    order_tol_db: float = 0.25,
    filtered: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Estimate (T60s, amplitudes, noise levels) per octave band of one RIR.

    Multi-slope nonlinear least squares on the Schroeder EDC with model-
    order selection — a dependency-free replacement for the reference's
    DecayFitNet wrapper (analysis.py:41-99, also n-slope with order
    selection): grid-initialized decay times are refined by bounded NLS
    (variable projection, NNLS amplitudes), and ``n_slopes=0`` selects the
    smallest order (1..``max_slopes``) whose mean |dB| error is within
    ``order_tol_db`` of the best order's, per band (inactive slots return
    zero amplitude and T60). The last 5% of the EDC is discarded like the
    reference does. Returns (n_bands, K), (n_bands, K), (n_bands,) with
    K = n_slopes or max_slopes.
    """
    if f_bands is None:
        f_bands = octave_bands(end_freq=min(16000.0, fs / 2))
    if t60_grid is None:
        t60_grid = np.geomspace(0.05, 3.0, 14)
    if filtered is None:
        filtered = octave_filtering(rir, fs, f_bands)
    n_bands = filtered.shape[-1]

    auto = n_slopes == 0
    k_out = max_slopes if auto else n_slopes
    t60s = np.zeros((n_bands, k_out))
    amps = np.zeros((n_bands, k_out))
    noise = np.zeros(n_bands)
    for b in range(n_bands):
        edc = schroeder_edc(filtered[:, b])
        edc = edc[: int(len(edc) * 0.95)]  # discard the last 5%
        # subsample on a LOG time grid (~2k points): a fast early slope
        # occupies a tiny time fraction — uniform sampling would leave it
        # almost unconstrained in the fit. Skip the analysis filter's
        # transient (a few periods of the band centre) at the start.
        start = max(1, int(4.0 * fs / float(f_bands[b])))
        start = min(start, max(1, len(edc) // 4))
        pick = np.unique(
            np.geomspace(start, len(edc), min(2048, len(edc)))
            .astype(np.int64) - 1
        )
        edc_ds = edc[pick]
        t = pick / fs
        # Schroeder noise floor integrates to remaining SAMPLES, which on
        # this non-uniform grid is NOT linear in subsample index
        ramp = (len(edc) - pick).astype(np.float64)

        if auto:
            fits = [
                _fit_edc_fixed_order(edc_ds, t, n, t60_grid, noise_ramp=ramp)
                for n in range(1, max_slopes + 1)
            ]
            errs = np.array([f[3] for f in fits])
            chosen = int(np.argmax(errs <= errs.min() + order_tol_db))
            tt, aa, nn, _ = fits[chosen]
            t60s[b, : chosen + 1] = tt
            amps[b, : chosen + 1] = aa
            noise[b] = nn
        else:
            tt, aa, nn, _ = _fit_edc_fixed_order(
                edc_ds, t, n_slopes, t60_grid, noise_ramp=ramp
            )
            t60s[b], amps[b], noise[b] = tt, aa, nn
    return t60s, amps, noise


def estimate_edc_parameters(
    rir: np.ndarray,
    filter_frequencies: List[float],
    n_slopes: int = 1,
    fs: float = 48000.0,
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], np.ndarray, np.ndarray]:
    """Reference-contract wrapper (analysis.py:41-99 get_decay_fit_net_params).

    Returns ((T60s, amplitudes, noise), norm_vals, fitted_edc): parameters
    are estimated on PEAK-NORMALIZED per-band EDCs (like DecayFitNet, whose
    EDCs are normalized to 0 dB), ``norm_vals`` restores absolute level,
    and ``fitted_edc`` is the model EDC per band on the full time axis.
    ``n_slopes=0`` auto-selects the order per band (1..3).
    """
    filtered = octave_filtering(np.asarray(rir, np.float64), fs,
                                list(filter_frequencies))
    # EDC peak per band = total band energy (integrate over TIME, axis 0)
    norm_vals = schroeder_edc(filtered, axis=0)[0]  # (n_bands,)

    t60s, amps, noise = estimate_decay_params(
        rir, n_slopes, fs, f_bands=list(filter_frequencies),
        filtered=filtered,  # reuse the bank run above (it is the slow part)
    )
    # normalize amplitudes/noise by the EDC peak per band
    amps_n = amps / norm_vals[:, None]
    noise_n = noise / norm_vals
    t = np.arange(filtered.shape[0]) / fs
    fitted = np.stack(
        [
            _edc_design_matrix(t, np.where(t60s[b] > 0, t60s[b], 1.0))
            @ np.r_[amps[b], noise[b]]
            for b in range(t60s.shape[0])
        ]
    )
    return (t60s, amps_n, noise_n), norm_vals, fitted


def amplitudes_to_initial_level(
    decay_times: np.ndarray,
    amplitudes: np.ndarray,
    fs: float,
    ir_len: int,
    max_freq: float = 16e3,
    norm_vals: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Convert CS amplitudes to FDN initial levels (analysis.py:210-262).

    ``decay_times``/``amplitudes``: (n_bands, n_slopes). The level accounts
    for the octave filters' band energy and the delay feedback's geometric
    energy series.
    """
    if norm_vals is None:
        norm_vals = np.ones_like(amplitudes)
    n_slopes = amplitudes.shape[-1]
    amplitudes = amplitudes * norm_vals

    impulse = np.zeros(ir_len)
    impulse[0] = 1.0
    f_bands = octave_bands(end_freq=max_freq)
    band_irs = octave_filtering(impulse, fs, f_bands, get_filter_ir=True)
    band_energy = np.sum(band_irs ** 2, axis=0)
    band_energy = np.tile(band_energy[:, None], (1, n_slopes))

    slope = -60.0 / (decay_times * fs)
    gain_per_sample = db2lin_np(slope)
    decay_energy = 1.0 / (1.0 - gain_per_sample ** 2)
    return np.sqrt(amplitudes / band_energy / decay_energy)
