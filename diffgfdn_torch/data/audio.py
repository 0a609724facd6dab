"""Minimal wav output (32-bit float), as ``diffgfdn_tpu/data/audio.py`` writes it."""

from pathlib import Path
from typing import Union

import numpy as np
from scipy.io import wavfile


def write_wav(path: Union[str, Path], data: np.ndarray, fs: float) -> None:
    """Write a float32 wav; the array is written as-is (mono stays mono)."""
    wavfile.write(str(path), int(fs), np.asarray(data, dtype=np.float32))
