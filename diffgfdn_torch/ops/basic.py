"""Basic DSP helpers (port of ``diffgfdn_tpu/ops/basic.py``, serving subset).

Host-side helpers stay numpy; :func:`get_frequency_samples` builds the z
grid as a torch tensor on the requested device.
"""

from typing import Tuple, Union

import numpy as np
import torch

# Energy decays by 60 dB in T60 seconds: exp(-t * LOG10E6 / T60).
LOG10E6 = float(np.log(10.0 ** 6))  # = 13.8155...


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
