"""YAML config loading and validation.

``yaml`` is imported only when a file is read, so the rest of the port (and
``chip_smoke.py``, which takes its configs from :mod:`.presets`) runs where
PyYAML is not installed.
"""

from pathlib import Path
from typing import Type, TypeVar, Union

from .schema import _Config, DiffGFDNConfig

T = TypeVar("T", bound=_Config)


def load_and_validate_config(
    path: Union[str, Path], model: Type[T] = DiffGFDNConfig
) -> T:
    """Load a YAML file and validate it against a config dataclass."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return model.from_dict(raw or {})
