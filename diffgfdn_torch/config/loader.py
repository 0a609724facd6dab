"""YAML config loading, validation and writing.

``yaml`` is imported only when a file is read or written, so the rest of the
port (and ``chip_smoke.py``, which takes its configs from :mod:`.presets`)
runs where PyYAML is not installed.
"""

import dataclasses
from enum import Enum
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


def _plain(x):
    """Enums as their values and tuples as lists, as pydantic's JSON dump."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x.value if isinstance(x, Enum) else x


def dump_config(config: _Config, path: Union[str, Path]) -> None:
    """Write a config to YAML, every field included (explicit nulls stay
    null on reload). The computed values (``delay_length_samps``,
    ``network_type``, ``load_fixed_parameters``) are properties, not fields,
    so they are not written, as the JAX package's ``dump_config`` drops them."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(_plain(dataclasses.asdict(config)), f)
