"""The int8 block codec of the target RIRs (port of ``utils/cio.py:109-163``).

A grid's target RIRs at or above :data:`QUANT_MIN_BYTES` of float32 go to
the device as per-block int8 with one float32 scale a block, and are
dequantized there; every target feature (EDC, EDR, spectra) is computed
from the dequantized RIRs, as in the JAX package, so both packages train on
the same targets. Below the threshold the upload is exact float32. The
JAX package's re/im codec and its other transport helpers are not ported:
they work around the TPU's host transfers and change no numbers.
"""

from typing import Tuple

import numpy as np
import torch

# below this byte count the targets go to the device as exact float32
QUANT_MIN_BYTES = 64 * 1024 * 1024
QUANT_BLOCK = 256


def quantize_int8_blocks(x: np.ndarray, block: int = QUANT_BLOCK
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(q, scale, T): per-block max-scaled int8 quantization of (R, T) float32.

    Each length-``block`` slice (the last zero padded) is scaled by its own
    |max| and rounded to int8, q (R, ceil(T / block), block); scale (R,
    ceil(T / block), 1) float32 is that |max| / 127, or 1 / 127 for an
    all-zero block, which stays exactly zero. The error of a sample is at
    most half a step, |max| / 254 of its block.
    """
    r, t = x.shape
    pad = (-t) % block
    if pad:
        x = np.pad(x, ((0, 0), (0, pad)))
    blocks = x.reshape(r, -1, block)
    scale = np.abs(blocks).max(axis=-1, keepdims=True).astype(np.float32)
    safe = np.where(scale == 0, np.float32(1.0), scale)
    q = np.clip(np.round(blocks / safe * 127.0), -127, 127).astype(np.int8)
    return q, (safe / np.float32(127.0)), t


def dequantize_int8_blocks(q: torch.Tensor, scale: torch.Tensor, t: int) -> torch.Tensor:
    """(R, t) float32 from the blocks and scales of :func:`quantize_int8_blocks`,
    on their device: ``q.float() * scale``, cut to t."""
    return (q.to(torch.float32) * scale).reshape(q.shape[0], -1)[:, :t]


def upload_target_rirs(rirs: np.ndarray, device: torch.device) -> torch.Tensor:
    """(R, T) float32 target RIRs on ``device``: int8 blocks and their scales
    uploaded and dequantized there when the float32 array has at least
    :data:`QUANT_MIN_BYTES`, else the exact float32 array."""
    t = np.ascontiguousarray(rirs, np.float32)
    if t.nbytes < QUANT_MIN_BYTES:
        return torch.as_tensor(t, device=device)
    q, scale, length = quantize_int8_blocks(t)
    return dequantize_int8_blocks(torch.as_tensor(q, device=device),
                                  torch.as_tensor(scale, device=device), length)
