"""Basic DSP helpers (port of ``diffgfdn_tpu/ops/basic.py``, training subset).

Host-side helpers stay numpy; :func:`get_frequency_samples` builds the z
grid as a torch tensor on the requested device; :func:`db` and
:func:`schroeder_backward_int` are the differentiable tensor ops of the
training losses.
"""

from typing import Tuple, Union

import numpy as np
import torch

# Energy decays by 60 dB in T60 seconds: exp(-t * LOG10E6 / T60).
LOG10E6 = float(np.log(10.0 ** 6))  # = 13.8155...
_EPS_F32 = float(np.finfo(np.float32).eps)


def db(x: torch.Tensor, is_squared: bool = False, min_value: float = -200.0) -> torch.Tensor:
    """Linear values to decibels, 10 or 20 log10(|x| + eps_f32), clipped below."""
    factor = 10.0 if is_squared else 20.0
    return torch.clamp(factor * torch.log10(torch.abs(x) + _EPS_F32), min=min_value)


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


def get_frequency_samples(
    num: int, radius: float = 1.0, device: Union[str, torch.device] = "cpu"
) -> torch.Tensor:
    """z points linearly spaced on the upper half circle of radius ``radius``.

    Angles in [0, pi] inclusive: the evaluation points of the rFFT grid.
    """
    angle = torch.linspace(0.0, np.pi, num, dtype=torch.float32, device=device)
    return (radius * torch.exp(1j * angle)).to(torch.complex64)


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
