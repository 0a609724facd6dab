"""Minimal wav I/O (32-bit float), as ``diffgfdn_tpu/data/audio.py`` reads and writes it."""

from pathlib import Path
from typing import Tuple, Union

import numpy as np
from scipy.io import wavfile


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, float]:
    """Read a wav file, returning (float32 samples in [-1, 1], sample rate)."""
    fs, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, float(fs)


def write_wav(path: Union[str, Path], data: np.ndarray, fs: float) -> None:
    """Write a float32 wav; the array is written as-is (mono stays mono)."""
    wavfile.write(str(path), int(fs), np.asarray(data, dtype=np.float32))
