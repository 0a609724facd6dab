"""Common-slopes spatial sampling in the port: the 17 presets against the JAX
schema, the two preset mappings against their YAML, the models the 16 MLP
presets build against JAX's parameter trees, and the CNN preset's error.
"""

import dataclasses
from enum import Enum
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from diffgfdn_torch.config import (
    load_and_validate_config,
    SPATIAL_PRESETS,
    spatial_preset_config,
    SpatialSamplingConfig,
)
from diffgfdn_torch.data import SpatialThreeRoomDataset
from diffgfdn_torch.inference import get_output_from_trained_model
from diffgfdn_torch.training import (
    build_spatial_model,
    run_training_spatial_sampling,
    SpatialSamplingTrainer,
)
from diffgfdn_torch.utils.params import jax_params_from_torch
from diffgfdn_tpu.config import load_and_validate_config as jax_load_config
from diffgfdn_tpu.config.schema import SpatialSamplingConfig as JaxSpatialSamplingConfig
from diffgfdn_tpu.training.spatial_trainer import build_spatial_model as jax_build
from torch_port_helpers import cs_raw_config, cs_room_path

ROOT = Path(__file__).resolve().parents[1]
SPATIAL_DIR = ROOT / "configs/presets/spatial"
PRESET_FILES = {p.stem: p for p in sorted(SPATIAL_DIR.glob("*.yml"))}
MLP_PRESETS = sorted(n for n in PRESET_FILES if not n.endswith("_cnn"))
NUM_SLOPES, AMBI_ORDER = 3, 2


def _normalize(x):
    """Enums as values and tuples as lists, as in pydantic's JSON dump."""
    if isinstance(x, dict):
        return {k: _normalize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normalize(v) for v in x]
    return x.value if isinstance(x, Enum) else x


def test_all_seventeen_presets_are_covered():
    assert len(PRESET_FILES) == 17 and len(MLP_PRESETS) == 16


@pytest.mark.parametrize("name", sorted(PRESET_FILES))
def test_spatial_presets_load_like_the_jax_schema(name):
    """Every field, ``network_type`` included, equals JAX's ``model_dump()``."""
    port = load_and_validate_config(PRESET_FILES[name], SpatialSamplingConfig)
    ref = jax_load_config(PRESET_FILES[name], JaxSpatialSamplingConfig)
    dumped = _normalize(dataclasses.asdict(port))
    dumped["network_type"] = port.network_type.value
    assert dumped == ref.model_dump(mode="json")


@pytest.mark.parametrize("name", sorted(SPATIAL_PRESETS))
def test_spatial_preset_mappings_equal_their_yaml(name):
    with open(SPATIAL_DIR / f"{name}.yml") as f:
        assert SPATIAL_PRESETS[name] == yaml.safe_load(f)
    assert spatial_preset_config(name) == load_and_validate_config(
        SPATIAL_DIR / f"{name}.yml", SpatialSamplingConfig)


@pytest.mark.parametrize("name", MLP_PRESETS)
def test_mlp_presets_build_jax_shaped_models(name):
    """The port's model of each MLP preset carries the parameter tree JAX's
    ``build_spatial_model`` initializes (every leaf's path and shape)."""
    cfg = load_and_validate_config(PRESET_FILES[name], SpatialSamplingConfig)
    model = build_spatial_model(cfg, NUM_SLOPES, AMBI_ORDER, device="cpu")
    jcfg = jax_load_config(PRESET_FILES[name], JaxSpatialSamplingConfig)
    jmodel = jax_build(jcfg, NUM_SLOPES, AMBI_ORDER)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        {"norm_listener_position": jax.ShapeDtypeStruct((4, 3), np.float32)})
    ref = jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes)
    port = jax.tree_util.tree_map(lambda x: tuple(x.shape), jax_params_from_torch(model))
    assert port == ref
    assert type(model).__name__ == type(jmodel).__name__


def test_cnn_preset_raises_naming_a12(tmp_path):
    cfg = load_and_validate_config(SPATIAL_DIR / "spatial_directional_1000Hz_cnn.yml",
                                   SpatialSamplingConfig)
    assert cfg.network_type.value == "cnn"
    room = SpatialThreeRoomDataset(cs_room_path(tmp_path))
    with pytest.raises(NotImplementedError, match="A12"):
        build_spatial_model(cfg, NUM_SLOPES, AMBI_ORDER, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        run_training_spatial_sampling(cfg, room, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        SpatialSamplingTrainer(None, cfg, room, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        get_output_from_trained_model(cfg, room, room.receiver_position[:2], device="cpu")


def test_generator_batch_fit_raises_naming_a12(tmp_path):
    cfg = SpatialSamplingConfig.from_dict(cs_raw_config(tmp_path, True))
    room = SpatialThreeRoomDataset(cs_room_path(tmp_path))
    model = build_spatial_model(cfg, NUM_SLOPES, AMBI_ORDER, device="cpu")
    trainer = SpatialSamplingTrainer(model, cfg, room, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        trainer.fit(lambda epoch: iter(()))


def test_spatial_config_rejects_unknown_keys_and_bad_values():
    with pytest.raises(ValueError, match="num_grid_spacings"):
        SpatialSamplingConfig.from_dict({"num_grid_spacings": 3})
    with pytest.raises(ValueError, match="num_neurons"):
        SpatialSamplingConfig.from_dict({"dnn_config": {"mlp_config": {"num_neurons": 3}}})
    with pytest.raises(ValueError):
        SpatialSamplingConfig.from_dict({"dnn_config": {"beamformer_type": "nope"}})
    with pytest.raises(ValueError, match="kernel_size"):
        SpatialSamplingConfig.from_dict({"dnn_config": {"cnn_config": {"kernel_size": [3]}}})
