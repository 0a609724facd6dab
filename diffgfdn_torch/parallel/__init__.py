"""Band-parallel subband training on one card."""

from .band_parallel import BandParallelTrainer

__all__ = ["BandParallelTrainer"]
