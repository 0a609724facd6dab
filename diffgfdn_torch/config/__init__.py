"""Config schema (stdlib dataclasses), YAML loader and the slice presets."""

from .loader import load_and_validate_config
from .presets import PRESETS, preset_config
from .schema import (
    BeamformerType,
    ColorlessFDNConfig,
    CouplingMatrixType,
    DecayFilterConfig,
    DiffGFDNConfig,
    FeatureEncodingType,
    FeedbackLoopConfig,
    OutputFilterConfig,
    TrainerConfig,
)

__all__ = [
    "BeamformerType",
    "ColorlessFDNConfig",
    "CouplingMatrixType",
    "DecayFilterConfig",
    "DiffGFDNConfig",
    "FeatureEncodingType",
    "FeedbackLoopConfig",
    "OutputFilterConfig",
    "PRESETS",
    "TrainerConfig",
    "load_and_validate_config",
    "preset_config",
]
