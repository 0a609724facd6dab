"""STFT and energy-decay relief (port of ``diffgfdn_tpu/ops/stft.py``, EDR subset).

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
    """Energy decay relief: EDR[f, m] = sum_{u>=m} |S[f, u]|^2 (optionally in dB)."""
    power = s.real * s.real + s.imag * s.imag
    edr = torch.flip(torch.cumsum(torch.flip(power, dims=(-1,)), dim=-1), dims=(-1,))
    return db(edr, is_squared=True) if in_db else edr
