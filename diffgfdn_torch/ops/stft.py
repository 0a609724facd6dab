"""STFT, energy-decay relief and the ERB-grouping filterbank (port of ``diffgfdn_tpu/ops/stft.py``).

The framing and padding are the JAX package's (``torch.stft`` with
center=False, one-sided, a periodic Hann window), written out rather than
taken from ``torch.stft``'s defaults: the signal is zero-padded so the last
full window fits exactly, and with win = 2 hop the frames are consecutive
half-window blocks joined pairwise (a reshape, no gather).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .basic import db


_windows: Dict[Tuple[int, torch.dtype, torch.device], torch.Tensor] = {}


def hann_window(win_size: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """numpy's ``hanning(win_size + 1)[:-1]`` on ``device``, made once per
    size, dtype and device: a training step captured in a CUDA graph must
    copy nothing from the host."""
    key = (win_size, dtype, device)
    if key not in _windows:
        _windows[key] = torch.as_tensor(np.hanning(win_size + 1)[:-1], dtype=dtype,
                                        device=device)
    return _windows[key]


def stft(
    x: torch.Tensor,
    win_size: int = 2 ** 12,
    hop_size: int = 2 ** 11,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-sided STFT without centering: (..., T) real -> (..., win/2+1, n_frames) complex."""
    t = x.shape[-1]
    pad = max(0, win_size - t)
    pad += (-(t + pad - win_size)) % hop_size
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    tp = x.shape[-1]
    n_frames = (tp - win_size) // hop_size + 1
    if window is None:
        window = hann_window(win_size, x.dtype, x.device)
    if win_size == 2 * hop_size:
        blocks = x.reshape(x.shape[:-1] + (tp // hop_size, hop_size))
        frames = torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)
    else:
        idx = (
            torch.arange(win_size, device=x.device)[None, :]
            + hop_size * torch.arange(n_frames, device=x.device)[:, None]
        )
        frames = x[..., idx]
    spec = torch.fft.rfft(frames * window, n=win_size, dim=-1)
    return spec.transpose(-1, -2)


def edr_from_stft(s: torch.Tensor, in_db: bool = True) -> torch.Tensor:
    """Energy decay relief: EDR[f, m] = sum_{u>=m} |S[f, u]|^2 (optionally in
    dB); ``s`` complex, or real (ERB-grouped magnitudes)."""
    power = s.real * s.real + s.imag * s.imag if s.is_complex() else s * s
    edr = torch.flip(torch.cumsum(torch.flip(power, dims=(-1,)), dim=-1), dims=(-1,))
    return db(edr, is_squared=True) if in_db else edr


def erb_filterbank(
    sample_rate: float,
    nfft: int,
    num_bands: int,
    freq_lims_hz: Tuple[float, float] = (63.0, 16e3),
) -> Tuple[np.ndarray, np.ndarray]:
    """Triangular mel-spaced filterbank over the rFFT grid (host numpy).

    Returns (weights (num_bands, nfft // 2 + 1) float64, band centres in Hz):
    triangles between mel-spaced points of ``freq_lims_hz``, each scaled by
    2 / its width (Slaney's constant-energy normalization); the ERB-grouped
    EDR loss sums |STFT| through them.
    """
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    fft_freqs = np.fft.rfftfreq(nfft, d=1.0 / sample_rate)
    mel_pts = np.linspace(hz_to_mel(freq_lims_hz[0]), hz_to_mel(freq_lims_hz[1]), num_bands + 2)
    hz_pts = mel_to_hz(mel_pts)
    weights = np.zeros((num_bands, len(fft_freqs)))
    for b in range(num_bands):
        lo, ctr, hi = hz_pts[b], hz_pts[b + 1], hz_pts[b + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        weights[b] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return weights, hz_pts[1:-1]
