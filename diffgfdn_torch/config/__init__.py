"""Config schema (stdlib dataclasses), YAML loader and the slice presets."""

from .loader import dump_config, load_and_validate_config
from .presets import (
    preset_config,
    preset_library,
    PRESETS,
    SPATIAL_PRESETS,
    spatial_preset_config,
    write_preset_library,
)
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
    "dump_config",
    "load_and_validate_config",
    "preset_config",
    "preset_library",
    "spatial_preset_config",
    "write_preset_library",
]
