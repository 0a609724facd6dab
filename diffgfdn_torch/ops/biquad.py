"""Biquad / SVF filter primitives (port of ``diffgfdn_tpu/ops/biquad.py``).

* :func:`svf_to_biquad` — state-variable-filter parameters -> biquad
  coefficients for whole cascades at once (torch, batched);
* the host numpy designers the GEQ fit needs, and the host cascade response
  :func:`sos_response_np` of the subband filters' Butterworth design.

The cascade response at complex points z (the JAX package's
``sos_frequency_response``) is ``kernels.sos.sos_cascade_response``, which
has the same contract and runs the biquad-cascade kernel.
"""

from typing import Tuple

import numpy as np
import torch

# SVF filter-type ids for the vectorized mixing-coefficient table
SVF_LOWPASS = 0
SVF_HIGHPASS = 1
SVF_BANDPASS = 2
SVF_LOWSHELF = 3
SVF_HIGHSHELF = 4
SVF_PEAKING = 5


def _select(filter_type, choices, default):
    """``jnp.select`` over the SVF type ids 0..4 with a default."""
    out = default
    for t in range(len(choices) - 1, -1, -1):
        out = torch.where(filter_type == t, choices[t], out)
    return out


def svf_mixing_coeffs(
    filter_type: torch.Tensor, resonance: torch.Tensor, g_lin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mixing coefficients (m_LP, m_BP, m_HP) for a batch of SVFs.

    ``filter_type`` holds SVF_* ids; ``resonance`` and ``g_lin`` (linear gain)
    broadcast against it. Peaking (and any other id) takes the default.
    """
    ones = torch.ones_like(g_lin)
    zeros = torch.zeros_like(g_lin)
    sqrt_g = torch.sqrt(g_lin)
    # order: lowpass, highpass, bandpass, lowshelf, highshelf
    m_lp = _select(filter_type, [ones, zeros, zeros, g_lin, ones], ones)
    m_bp = _select(
        filter_type,
        [zeros, zeros, ones, 2.0 * resonance * sqrt_g, 2.0 * resonance * sqrt_g],
        2.0 * resonance * g_lin,
    )
    m_hp = _select(filter_type, [zeros, ones, zeros, ones, g_lin], ones)
    return m_lp, m_bp, m_hp


def svf_to_biquad(
    cutoff: torch.Tensor,
    resonance: torch.Tensor,
    filter_type: torch.Tensor,
    g_db: torch.Tensor,
    compress_pole_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convert batches of SVF params to biquad (num, den) coefficient triples.

    All inputs broadcast; outputs have shape ``broadcast_shape + (3,)``.
    ``cutoff`` is the normalized frequency variable f = pi * fc / fs.
    ``compress_pole_factor`` < 1 shrinks pole/zero radii.
    """
    cutoff, resonance, filter_type, g_db = torch.broadcast_tensors(
        cutoff, resonance, filter_type, g_db
    )
    g_lin = torch.pow(10.0, g_db * 0.05)
    m_lp, m_bp, m_hp = svf_mixing_coeffs(filter_type, resonance, g_lin)
    f = cutoff
    rho = compress_pole_factor

    b0 = f ** 2 * m_lp + f * m_bp + m_hp
    b1 = (2.0 * f ** 2 * m_lp - 2.0 * m_hp) * rho
    b2 = (f ** 2 * m_lp - f * m_bp + m_hp) * rho ** 2

    a0 = f ** 2 + 2.0 * resonance * f + 1.0
    a1 = (2.0 * f ** 2 - 2.0) * rho
    a2 = (f ** 2 - 2.0 * resonance * f + 1.0) * rho ** 2

    num = torch.stack([b0, b1, b2], dim=-1)
    den = torch.stack([a0, a1, a2], dim=-1)
    return num, den


# ------------------------------- RBJ recipes --------------------------------
# Host-side (numpy) designers used by the GEQ fit at build time.


def shelving_filter_np(
    fc: float, gain_lin: float, filt_type: str, fs: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Shelving biquad (low/high) coefficients."""
    omega = 2.0 * np.pi * fc / fs
    t = np.tan(omega / 2.0)
    t2 = t ** 2
    g2 = gain_lin ** 0.5
    g4 = gain_lin ** 0.25
    sqrt2 = np.sqrt(2.0)

    b = np.array(
        [
            g2 * t2 + sqrt2 * t * g4 + 1.0,
            2.0 * g2 * t2 - 2.0,
            g2 * t2 - sqrt2 * t * g4 + 1.0,
        ]
    )
    a = np.array(
        [
            g2 + sqrt2 * t * g4 + t2,
            2.0 * t2 - 2.0 * g2,
            g2 - sqrt2 * t * g4 + t2,
        ]
    )
    b = g2 * b
    if filt_type == "high":
        b, a = a * gain_lin, b
    return b, a


def peak_filter_np(
    fc: float, gain_lin: float, q: float, fs: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Peaking biquad coefficients."""
    omega = 2.0 * np.pi * fc / fs
    bw = omega / q
    t = np.tan(bw / 2.0)
    sg = np.sqrt(gain_lin)
    b = np.array([sg + gain_lin * t, -2.0 * sg * np.cos(omega), sg - gain_lin * t])
    a = np.array([sg + t, -2.0 * sg * np.cos(omega), sg - t])
    return b, a


def sos_response_np(sos: np.ndarray, freqs_hz: np.ndarray, fs: float) -> np.ndarray:
    """Exact cascade response at arbitrary frequencies (host-side).

    ``sos``: (n_sections, 6). Returns complex response at ``freqs_hz``.
    """
    z = np.exp(1j * 2.0 * np.pi * np.asarray(freqs_hz) / fs)
    zinv = 1.0 / z
    zpow = np.stack([np.ones_like(zinv), zinv, zinv ** 2], axis=0)
    num = sos[:, :3] @ zpow
    den = sos[:, 3:] @ zpow
    return np.prod(num / den, axis=0)


def probe_sos_np(
    sos: np.ndarray, control_freqs: np.ndarray, fs: float
) -> np.ndarray:
    """Magnitude (dB) of each SOS band at the control frequencies.

    ``sos``: (6, n_bands); each band is normalized by its a0 and evaluated
    exactly. Returns (len(control_freqs), n_bands) in dB.
    """
    n_bands = sos.shape[-1]
    G = np.zeros((len(control_freqs), n_bands))
    z = np.exp(1j * 2.0 * np.pi * np.asarray(control_freqs) / fs)
    zinv = 1.0 / z
    zpow = np.stack([np.ones_like(zinv), zinv, zinv ** 2], axis=0)
    for band in range(n_bands):
        coeffs = sos[:, band] / sos[3, band]
        h = (coeffs[:3] @ zpow) / (coeffs[3:] @ zpow + 1e-10)
        G[:, band] = 20.0 * np.log10(np.abs(h) + 1e-12)
    return G
