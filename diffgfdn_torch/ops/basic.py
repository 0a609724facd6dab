"""Basic DSP helpers (port of ``diffgfdn_tpu/ops/basic.py``).

Host-side helpers stay numpy (the unit conversions, the decay kernel, the
spectral flatness and the echo-density profile); :func:`get_frequency_samples`
and :func:`frequency_samples_from_rad` build z grids as torch tensors on the
requested device; :func:`db`, :func:`db2lin`, :func:`schroeder_backward_int`
and :func:`shaped_wgn` are tensor ops. The noise of :func:`shaped_wgn` comes
from the caller or from an explicit ``torch.Generator``.
"""

from typing import Optional, Tuple, Union

import numpy as np
import torch

# Energy decays by 60 dB in T60 seconds: exp(-t * LOG10E6 / T60).
LOG10E6 = float(np.log(10.0 ** 6))  # = 13.8155...
_EPS_F32 = float(np.finfo(np.float32).eps)


def db(x: torch.Tensor, is_squared: bool = False, min_value: float = -200.0) -> torch.Tensor:
    """Linear values to decibels, 10 or 20 log10(|x| + eps_f32), clipped below."""
    factor = 10.0 if is_squared else 20.0
    return torch.clamp(factor * torch.log10(torch.abs(x) + _EPS_F32), min=min_value)


def db2lin(x: torch.Tensor, is_squared: bool = False) -> torch.Tensor:
    """Decibels to linear scale, 10^(x / 10) or 10^(x / 20)."""
    return torch.pow(10.0, x * (0.1 if is_squared else 0.05))


def schroeder_backward_int(signal: torch.Tensor) -> torch.Tensor:
    """Schroeder backward integral along the last axis: EDC(t) = sum_{u>=t} signal(u)^2.

    Summed from the end (flip, cumsum, flip), as ``lax.cumsum(reverse=True)``
    does: small late values are added first, so the tail does not cancel.
    """
    s2 = signal * signal
    return torch.flip(torch.cumsum(torch.flip(s2, dims=(-1,)), dim=-1), dims=(-1,))


def db_np(x, is_squared: bool = False, min_value: float = -200.0):
    """Linear scale to decibels (host numpy), floored at ``min_value``."""
    factor = 10.0 if is_squared else 20.0
    y = factor * np.log10(np.abs(x) + np.finfo(np.float32).eps)
    return np.clip(y, a_min=min_value, a_max=None)


def db2lin_np(x, is_squared: bool = False):
    """Decibels to linear scale (host numpy)."""
    exp_factor = 0.1 if is_squared else 0.05
    return np.power(10.0, np.asarray(x) * exp_factor)


def ms_to_samps(ms, fs: float) -> Union[int, np.ndarray]:
    """Convert milliseconds to (integer) samples."""
    samp = np.asarray(ms) * 1e-3 * fs
    if samp.ndim == 0:
        return int(samp)
    return samp.astype(np.int32)


def samps_to_ms(samps, fs: float) -> np.ndarray:
    """Convert samples to milliseconds (float64)."""
    return np.asarray(samps, dtype=np.float64) / fs * 1e3


def hertz2rad(hertz, fs: float) -> np.ndarray:
    """Frequency in Hz -> normalized angular frequency in rad/sample (float64)."""
    return 2.0 * np.pi * np.asarray(hertz, dtype=np.float64) / fs


def rad2hertz(rad, fs: float) -> np.ndarray:
    """Normalized angular frequency in rad/sample -> Hz (float64)."""
    return np.asarray(rad, dtype=np.float64) * fs / (2.0 * np.pi)


def get_frequency_samples(
    num: int, radius: float = 1.0, device: Union[str, torch.device] = "cpu"
) -> torch.Tensor:
    """z points linearly spaced on the upper half circle of radius ``radius``.

    Angles in [0, pi] inclusive: the evaluation points of the rFFT grid.
    """
    angle = torch.linspace(0.0, np.pi, num, dtype=torch.float32, device=device)
    return (radius * torch.exp(1j * angle)).to(torch.complex64)


def frequency_samples_from_rad(
    freq_bins_rad, radius: float = 1.0, device: Union[str, torch.device] = "cpu"
) -> torch.Tensor:
    """z = radius * e^{j w} (complex64) for any grid of angles in rad/sample."""
    w = torch.as_tensor(np.asarray(freq_bins_rad), dtype=torch.float32, device=device)
    return (radius * torch.exp(1j * w)).to(torch.complex64)


def to_complex(x: torch.Tensor) -> torch.Tensor:
    """Promote a real tensor to complex64."""
    return x.to(torch.complex64)


def hann_fade_windows(win_len_samps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(fade_in, fade_out) half-Hann windows for early/late RIR splits.

    Both halves have length win_len_samps // 2 (an odd length drops the
    window's centre sample).
    """
    half = win_len_samps // 2
    window = np.hanning(win_len_samps)
    return window[:half], window[win_len_samps - half:]


def decay_kernel(decay_times, time_axis, normalize_envelope: bool = False) -> np.ndarray:
    """Common-slopes energy-decay envelopes (host numpy, float32).

    Columns ``exp(-t * ln(1e6) / T_k)`` over ``time_axis`` in seconds: shape
    ``(len(time_axis), num_slopes)``; ``normalize_envelope`` scales each
    column to unit L2 norm. Computed in float32 as the JAX package's numpy
    branch does.
    """
    t = np.asarray(time_axis, dtype=np.float32).reshape(-1)
    T = np.asarray(decay_times, dtype=np.float32).reshape(-1)
    env = np.exp(-t[:, None] * (LOG10E6 / T[None, :]))
    if normalize_envelope:
        norm = np.sqrt(np.sum(env ** 2, axis=0, keepdims=True))
        env = env / (norm + _EPS_F32)
    return env


def shaped_wgn(
    amplitudes: torch.Tensor,
    decay_times,
    num_samples: int,
    fs: float,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise_floor: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RIR tails as white Gaussian noise shaped by common-slopes envelopes.

    ``amplitudes`` (..., num_slopes) are energy-envelope amplitudes: the
    output's energy is E[p^2](t) = sum_k a_k exp(-t LOG10E6 / T_k), plus
    ``noise_floor`` (...,) when given. ``noise`` (..., num_samples) is the
    caller's standard normal noise on the amplitudes' device; without it the
    noise is drawn there from ``generator``, which is then required. Returns
    (..., num_samples) float32 on the amplitudes' device.
    """
    amplitudes = torch.as_tensor(amplitudes, dtype=torch.float32)
    device = amplitudes.device
    t = torch.arange(num_samples, dtype=torch.float32, device=device) / fs
    rate = torch.as_tensor(LOG10E6 / np.asarray(decay_times, np.float32).reshape(-1),
                           device=device)
    env = torch.einsum("...k,kt->...t", amplitudes, torch.exp(-t[None, :] * rate[:, None]))
    if noise_floor is not None:
        env = env + torch.as_tensor(noise_floor, dtype=torch.float32, device=device)[..., None]
    env = torch.clamp(env, min=0.0)
    if noise is None:
        if generator is None:
            raise ValueError("shaped_wgn needs the noise or a torch.Generator to draw it from")
        noise = torch.randn(env.shape, generator=generator, device=device, dtype=torch.float32)
    return noise * torch.sqrt(env)


def spectral_flatness(X, eps: float = 1e-10) -> float:
    """Geometric / arithmetic mean ratio of a magnitude spectrum (host numpy)."""
    X = np.abs(np.asarray(X))
    geometric_mean = np.exp(np.mean(np.log(X + eps)))
    arithmetic_mean = np.mean(X + eps)
    return float(geometric_mean / arithmetic_mean)


def normalized_echo_density(
    rir: np.ndarray,
    fs: float,
    window_length_ms: float = 30.0,
    window_type: str = "hann",
    use_local_avg: bool = False,
) -> np.ndarray:
    """Abel's normalized echo-density profile of an RIR (host numpy, float64).

    Per sample, the window-weighted share of samples in a sliding odd-length
    window whose magnitude exceeds the window's weighted standard deviation,
    over erfc(1 / sqrt(2)); the first ``len(rir) - window`` values.
    """
    rir = np.asarray(rir, dtype=np.float64)
    erfc = 0.3173  # erfc(1/sqrt(2))
    wl = ms_to_samps(window_length_ms, fs)
    if not wl % 2:
        wl += 1
    half = (wl - 1) // 2

    windows = {
        "rect": np.ones(wl),
        "hann": np.hanning(wl),
        "hamm": np.hamming(wl),
        "black": np.blackman(wl),
        "bart": np.bartlett(wl),
    }
    if window_type not in windows:
        raise ValueError("Unavailable window type.")
    w = windows[window_type]
    w = w / w.sum()

    padded = np.zeros(len(rir) + 2 * half)
    padded[half:-half] = rir
    frames = np.lib.stride_tricks.sliding_window_view(padded, wl)[: len(rir)]
    if use_local_avg:
        avg = frames @ w
        var = ((frames - avg[:, None]) ** 2) @ w
    else:
        var = (frames ** 2) @ w
    std = np.sqrt(var)
    counts = ((np.abs(frames) > std[:, None]) * w[None, :]).sum(axis=-1)
    ned = counts / erfc
    return ned[: len(rir) - wl] if len(rir) > wl else ned
