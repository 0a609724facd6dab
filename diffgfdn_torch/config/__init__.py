"""Config schema (stdlib dataclasses), YAML loader and the slice presets."""

from .loader import load_and_validate_config
from .presets import PRESETS, preset_config, SPATIAL_PRESETS, spatial_preset_config
from .schema import (
    BeamformerType,
    CNNConfig,
    ColorlessFDNConfig,
    CouplingMatrixType,
    DecayFilterConfig,
    DiffGFDNConfig,
    DNNConfig,
    DNNType,
    FeatureEncodingType,
    FeedbackLoopConfig,
    MLPConfig,
    OutputFilterConfig,
    SpatialSamplingConfig,
    TrainerConfig,
)

__all__ = [
    "BeamformerType",
    "CNNConfig",
    "ColorlessFDNConfig",
    "CouplingMatrixType",
    "DecayFilterConfig",
    "DiffGFDNConfig",
    "DNNConfig",
    "DNNType",
    "FeatureEncodingType",
    "FeedbackLoopConfig",
    "MLPConfig",
    "OutputFilterConfig",
    "PRESETS",
    "SPATIAL_PRESETS",
    "SpatialSamplingConfig",
    "TrainerConfig",
    "load_and_validate_config",
    "preset_config",
    "spatial_preset_config",
]
